"""Tensors a step builds from host arrays at call time (the ``host_constants``
tallies of SSIM's blur, the resize backward and the resize's row taps)."""
from portbench.program import tally_per_unit


def read(run):
    return tally_per_unit(run, "_blur.host_constants", "resize_rows_backward.host_constants",
                          "_row_taps.host_constants")
