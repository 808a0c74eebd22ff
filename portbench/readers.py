"""What the per-layer readers share.  Each reader returns None where its
trace has nothing to read, never 0 for a share of a peak or a roofline."""

from __future__ import annotations

from portbench import counts

A_KERNEL = "conv3x3_fused_kernel"


def idle_share(run) -> float | None:
    """Percent of the traced window in which no kernel, copy or memset ran."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def mfu(run) -> float | None:
    """The model's operations over the traced window, as a percent of the
    card's bf16 peak."""
    if run.trace is None or not run.trace.device or not run.units:
        return None
    flops = run.state.flops_per_unit * run.units
    return 100.0 * flops / (run.trace.window_s * counts.PEAK_FLOPS["bf16"])


def a_roofline(run) -> float | None:
    """Kernel A's bound over its kernel time, in percent, where the trace
    holds exactly the launches the configuration's shapes predict."""
    if run.trace is None:
        return None
    launches = run.trace.kernels(A_KERNEL)
    forwards = run.units * run.state.forwards_per_unit
    if not launches or len(launches) != forwards * run.state.a_launches_per_forward:
        return None
    busy = sum(e - s for _, s, e in launches)
    return 100.0 * forwards * run.state.a_bound_per_forward / busy


def span_ms(run, name: str) -> float | None:
    """Host ms a unit of the traced window spends in the spans ``name``."""
    if run.trace is None or not run.units:
        return None
    spans = run.trace.span_list(name)
    return 1e3 * sum(e - s for s, e in spans) / run.units if spans else None


def family_ms(run, label: str, families) -> float | None:
    """Device ms a unit spends in kernels of one family."""
    if run.trace is None or not run.trace.device or not run.units:
        return None
    return 1e3 * run.trace.family_s(families).get(label, 0.0) / run.units


def host_minus_device_ms(run, name: str) -> float | None:
    """Per call of the spans ``name`` in the trace: the span's length minus
    the device's busy time inside it, in ms."""
    if run.trace is None or not run.trace.device:
        return None
    spans = run.trace.span_list(name)
    if not spans:
        return None
    return 1e3 * sum((e - s) - run.trace.busy_s(s, e) for s, e in spans) / len(spans)

