"""MiB a ``predict_many`` call uploads from pageable host memory
(``PlannerEngine.pageable_h2d_bytes``)."""
from portbench.program import tally_per_unit


def read(run):
    n = tally_per_unit(run, "PlannerEngine.pageable_h2d_bytes")
    return None if n is None else n / 2**20
