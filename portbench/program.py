"""The program's own spans and tallies (``maunet_tpu_torch.utils.profiling``)
of the traced window, placed on the trace's clock.

The program records them while the profiler runs, on ``time.time_ns``; the
window is the benchmark's ``portbench.window`` span, on the same clock, so
an event at ``t_ns`` lies at ``trace.window[0] + (t_ns - w_ns) / 1e9``, with
``w_ns`` the window's raw start.  Every reader returns None where the
program recorded nothing in the window (a program without spans), never 0.
"""

from __future__ import annotations

import dataclasses
import types

from portbench import readers
from portbench.trace import WINDOW


def _window_ns(run) -> tuple[int, int] | None:
    found = [(a, b) for n, a, b in run.state.ctx.spans if n == WINDOW]
    return found[-1] if found else None


def recorded(run):
    """(spans as (name, start, end) in seconds on the trace's clock, tallies
    as (name, t, n)), those inside the window; None without a trace, a
    window or the program's recorder."""
    try:
        from maunet_tpu_torch.utils.profiling import recorded as program_recorded
    except ImportError:
        return None
    window = _window_ns(run) if run.trace is not None else None
    if window is None:
        return None
    w0, w1 = window
    at = lambda t: run.trace.window[0] + (t - w0) / 1e9
    spans, tallies = program_recorded()
    return ([(s.name, at(s.start_ns), at(s.end_ns)) for s in spans
             if w0 <= s.start_ns and s.end_ns <= w1],
            [(t.name, at(t.t_ns), t.n) for t in tallies if w0 <= t.t_ns <= w1])


def span_ms(run, name: str) -> float | None:
    """Host ms a unit of the window spends in the program's spans ``name``."""
    got = recorded(run)
    if got is None or not run.units:
        return None
    lengths = [e - s for n, s, e in got[0] if n == name]
    return 1e3 * sum(lengths) / run.units if lengths else None


def idle_ms(run, name: str) -> float | None:
    """Device idle a unit while the host is in the program's spans ``name``:
    each span's length minus the device's busy time inside it, summed over
    the window and divided by the units (``readers.host_minus_device_ms``,
    which takes it per span)."""
    got = recorded(run)
    if got is None or not run.units:
        return None
    view = dataclasses.replace(run.trace, spans=got[0])
    per_span = readers.host_minus_device_ms(types.SimpleNamespace(trace=view), name)
    return None if per_span is None else per_span * len(view.span_list(name)) / run.units


def tally_per_unit(run, *names: str) -> float | None:
    """The tallies ``names`` summed over the window, a unit."""
    got = recorded(run)
    if got is None or not run.units:
        return None
    counts = [n for name, _, n in got[1] if name in names]
    return sum(counts) / run.units if counts else None
