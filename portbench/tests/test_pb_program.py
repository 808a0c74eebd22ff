"""The readers of the program's own spans and tallies (``portbench/program.py``
and the eight ``metrics/`` files that use it): events placed on the trace's
clock and kept to the window, each reader's arithmetic on a synthetic trace,
None wherever the program recorded nothing, and, on the card, spans recorded
under a device-only profile as the harness traces."""

import time
import types

import pytest
import torch

from portbench import harness, program
from portbench.tests import tiny
from portbench.trace import WINDOW, TraceView

W0 = 5_000_000_000_000  # the window's raw start, time.time_ns
UNITS = 2


def ns(ms: float) -> int:
    return W0 + round(ms * 1e6)


def span(name, a, b, parent=-1):
    from maunet_tpu_torch.utils.profiling import Span

    return Span(name, ns(a), ns(b), parent, 1)


def tally(name, at, n):
    from maunet_tpu_torch.utils.profiling import Tally

    return Tally(name, ns(at), n)


# Spans and tallies of a 100 ms window, in ms from its start; the trace's
# window is (10.0, 10.1) s, and the device is busy over [2, 3] and [50, 60].
SPANS = [
    span("engine.canvas_to_dw", 1, 4), span("engine.canvas_to_dw", 20, 26),
    span("engine.concat", 30, 31.5), span("engine.concat", -5, -1),
    span("engine.concat", 99, 101),
    span("eval.forward", 1, 4), span("eval.forward", 45, 65), span("eval.metrics", 70, 72),
    span("train.loss", 48, 52), span("train.backward", 55, 75),
]
TALLIES = [
    tally("PlannerEngine.pageable_h2d_bytes", 10, 3 * 2**20),
    tally("PlannerEngine.pageable_h2d_bytes", 80, 2**20),
    tally("PlannerEngine.pageable_h2d_bytes", 150, 2**30),
    tally("_blur.host_constants", 10, 2), tally("resize_rows_backward.host_constants", 11, 8),
    tally("_row_taps.host_constants", 12, 4), tally("_blur.host_constants", 60, 2),
    tally("Other.count", 13, 100),
]
# Each reader's value on them: span ms, idle ms (a span's length less the
# device's busy time inside it), tallies, each over the two units.
EXPECTED = {
    "canvas_ms.click": (3 + 6) / UNITS,
    "concat_ms.serve": 1.5 / UNITS,
    "pageable_h2d_mib.serve": 4 / UNITS,
    "forward_idle_ms.eval": ((3 - 1) + (20 - 10)) / UNITS,
    "metrics_idle_ms.eval": 2 / UNITS,
    "loss_idle_ms.train": (4 - 2) / UNITS,
    "backward_idle_ms.train": (20 - 5) / UNITS,
    "constant_copies.train": (2 + 8 + 4 + 2) / UNITS,
}
READERS = sorted(EXPECTED)


class Owner:
    n = 0


def synthetic_run(trace=True):
    view = TraceView((10.0, 10.1), [("kernel", "k", 10.002, 10.003),
                                    ("gpu_memcpy", "Memcpy HtoD", 10.050, 10.060)])
    ctx = types.SimpleNamespace(spans=[(WINDOW, W0, ns(100))])
    return harness.Run(view if trace else None, UNITS, types.SimpleNamespace(ctx=ctx))


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder returning the synthetic events, or those set."""
    from maunet_tpu_torch.utils import profiling

    events = {"spans": SPANS, "tallies": TALLIES}
    monkeypatch.setattr(profiling, "recorded", lambda: (events["spans"], events["tallies"]))
    return events


def test_events_are_placed_on_the_traces_clock_inside_the_window(recorded):
    spans, tallies = program.recorded(synthetic_run())
    assert [s for s in spans if s[0] == "engine.concat"] == [
        ("engine.concat", pytest.approx(10.030), pytest.approx(10.0315))]
    assert len(spans) == len(SPANS) - 2
    assert [n for name, _, n in tallies if name.startswith("PlannerEngine")] == [3 * 2**20, 2**20]
    assert tallies[0][1] == pytest.approx(10.010)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_its_spans_or_tallies(name, recorded):
    value = harness.load_reader(tiny.ROOT, name)(synthetic_run())
    assert value == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_where_the_program_recorded_nothing(name, recorded):
    read = harness.load_reader(tiny.ROOT, name)
    assert read(synthetic_run(trace=False)) is None
    recorded["spans"], recorded["tallies"] = [], []
    assert read(synthetic_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_without_the_programs_recorder(name, monkeypatch):
    """A program without spans, as before they were added."""
    from maunet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    assert harness.load_reader(tiny.ROOT, name)(synthetic_run()) is None


@pytest.mark.parametrize("cell, name, value", [
    # Two requests of 32² a call: maps, series (T = 32) and metadata in f32, lengths in int32.
    ("serve_unet64_b8", "pageable_h2d_mib.serve", 2 * (32 * 32 * 23 + 32 + 8 + 1) * 4 / 2**20),
    # One SSIM blur (2), four upsamples' backward (8) and their plain forward on the CPU (32).
    ("train_unet64_b16", "constant_copies.train", 42.0),
    ("click_unet64_512", "canvas_ms.click", None),
    ("serve_unet64_b8", "concat_ms.serve", None),
])
def test_a_traced_tiny_cell_reads_the_programs_metrics(cell, name, value, tiny_root_f32):
    """The harness's traced run on the CPU: counts exactly, host times as
    numbers (the device's idle, without a device, reads None)."""
    res, _ = harness.run_cell(tiny_root_f32, cell, 17, 0.2, True, torch.device("cpu"),
                              time.perf_counter())
    got = res["metrics"][name]["value"]
    if value is None:
        assert got > 0
    else:
        assert got == pytest.approx(value)


@pytest.mark.card
def test_spans_record_under_a_device_only_profile(card):
    """The harness traces the device alone: the program's spans must record
    under that profile too, or no reader of them reads anything."""
    from torch.profiler import ProfilerActivity, profile

    from maunet_tpu_torch.utils import profiling

    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        with profiling.span("card.outer"):
            with profiling.span("card.inner"):
                torch.ones(512, 512, device=card) @ torch.ones(512, 512, device=card)
                torch.cuda.synchronize(card)
            profiling.tally(Owner, "n", 3)
    spans, tallies = profiling.recorded()
    assert [(s.name, s.parent) for s in spans] == [("card.outer", -1), ("card.inner", 0)]
    assert [(t.name, t.n) for t in tallies] == [("Owner.n", 3)]
