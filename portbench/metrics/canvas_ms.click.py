"""Host ms a click spends in the engine's ``engine.canvas_to_dw`` (the painted
canvas to a Dynamic World map, in the painted ``prepare_input``)."""
from portbench.program import span_ms


def read(run):
    return span_ms(run, "engine.canvas_to_dw")
