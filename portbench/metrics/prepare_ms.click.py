"""Host ms a click spends in the engine's two ``prepare_input`` calls."""
from portbench.readers import span_ms


def read(run):
    return span_ms(run, "portbench.prepare")
