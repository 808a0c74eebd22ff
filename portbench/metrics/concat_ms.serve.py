"""Host ms a ``predict_many`` call spends in ``engine.concat``: the requests'
arrays joined into one batch."""
from portbench.program import span_ms


def read(run):
    return span_ms(run, "engine.concat")
