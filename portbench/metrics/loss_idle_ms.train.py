"""Device idle ms a step while the host is in ``train.loss`` (SSIM's band
matrices copied from the host)."""
from portbench.program import idle_ms


def read(run):
    return idle_ms(run, "train.loss")
