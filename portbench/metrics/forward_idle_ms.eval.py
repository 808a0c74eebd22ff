"""Device idle ms a batch while the host is in ``eval.forward`` (the
forward's dispatch)."""
from portbench.program import idle_ms


def read(run):
    return idle_ms(run, "eval.forward")
