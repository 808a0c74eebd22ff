"""Device idle ms a step while the host is in ``train.backward`` (the resize
backward's matrices copied from the host)."""
from portbench.program import idle_ms


def read(run):
    return idle_ms(run, "train.backward")
