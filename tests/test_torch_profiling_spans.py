"""The program's spans and tallies (``maunet_tpu_torch/utils/profiling.py``):
nothing recorded outside a profiler, nesting and order under one, tallies
that always count, the Chrome trace's clock, the events ``trace`` writes,
and the spans and tallies of a train step, a batch of serving and an
evaluation batch at tiny sizes."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from maunet_tpu_torch.apps.engine import PlannerEngine
from maunet_tpu_torch.evaluate.evaluator import batch_metrics
from maunet_tpu_torch.losses import get_loss_fn
from maunet_tpu_torch.losses.ssim import _blur
from maunet_tpu_torch.models.factory import build_model
from maunet_tpu_torch.ops.kernels import resize_pack
from maunet_tpu_torch.train.optimizers import make_optimizer
from maunet_tpu_torch.train.state import TrainState
from maunet_tpu_torch.train.steps import train_step
from maunet_tpu_torch.utils import profiling

HW, T = 32, 8
HYPERPARAMS = {"model_type": "unet", "base_filters": 4, "temporal_dim": 4, "meta_dim": 4,
               "lstm_hidden": 8, "temporal_embeddings": True, "metadata_embeddings": True,
               "deep_supervision": False, "metadata_input_length": 8, "spatial_channels": 23}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class Owner:
    seen = 0


def tiny_model():
    torch.manual_seed(0)
    return build_model(HYPERPARAMS, compute_dtype=torch.float32)


def tiny_batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {
        "maps": rng.normal(size=(b, HW, HW, 23)),
        "targets": rng.uniform(-0.5, 1.0, (b, HW, HW, 2)),
        "metadata": rng.normal(size=(b, 4)),
        "temp_series": rng.normal(size=(b, T)),
        "t1_dates": np.tile([2019.0, 3.0], (b, 1)),
        "t2_dates": np.tile([2023.0, 5.0], (b, 1)),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()}
    batch["temp_lengths"] = torch.tensor([T, 3][:b], dtype=torch.int32)
    return batch


def names(spans):
    return [s.name for s in spans]


def test_outside_a_profiler_spans_record_nothing_and_share_one_object():
    profiling.clear()
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second
    with first:
        with second:
            pass
    assert profiling.recorded() == ([], [])


def test_nested_spans_keep_their_names_order_and_parents():
    profiling.clear()
    with cpu_profile():
        with profiling.span("outer"):
            with profiling.span("inner.a"):
                pass
            with profiling.span("inner.b"):
                with profiling.span("leaf"):
                    pass
        with profiling.span("next"):
            pass
    spans, tallies = profiling.recorded()
    assert names(spans) == ["outer", "inner.a", "inner.b", "leaf", "next"]
    assert [s.parent for s in spans] == [-1, 0, 0, 2, -1]
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[2].start_ns <= spans[3].start_ns
    assert spans[3].end_ns <= spans[2].end_ns <= spans[0].end_ns <= spans[4].start_ns
    assert tallies == []
    profiling.clear()
    assert profiling.recorded() == ([], [])


def test_tally_counts_always_and_logs_only_under_a_profiler():
    profiling.clear()
    Owner.seen = 0
    profiling.tally(Owner, "seen", 3)
    assert Owner.seen == 3 and profiling.recorded() == ([], [])
    with cpu_profile():
        profiling.tally(Owner, "seen")
        profiling.tally(Owner, "seen", 5)
    assert Owner.seen == 9
    _, tallies = profiling.recorded()
    assert [(t.name, t.n) for t in tallies] == [("Owner.seen", 1), ("Owner.seen", 5)]
    assert tallies[0].t_ns <= tallies[1].t_ns


def test_spans_lie_on_the_traces_clock(tmp_path):
    """A ``record_function`` block inside a program span lies inside the
    span once the span is shifted by the trace's ``baseTimeNanoseconds``."""
    profiling.clear()
    with cpu_profile() as prof:
        with profiling.span("outer"):
            with record_function("inside"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    (inside,) = [e for e in doc["traceEvents"]
                 if e.get("name") == "inside" and e.get("ph") == "X"]
    (outer,), _ = profiling.recorded()
    start_us, end_us = (outer.start_ns - base) / 1e3, (outer.end_ns - base) / 1e3
    assert start_us <= inside["ts"] and inside["ts"] + inside["dur"] <= end_us


def test_trace_writes_the_programs_events(tmp_path):
    Owner.seen = 0
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.tally(Owner, "seen", 2)
            profiling.tally(Owner, "seen", 3)
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == profiling.CATEGORY]
    spans = [e for e in mine if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["outer", "inner"]
    assert spans[0]["ts"] <= spans[1]["ts"]
    assert spans[1]["ts"] + spans[1]["dur"] <= spans[0]["ts"] + spans[0]["dur"]
    counters = [(e["name"], e["args"]["total"]) for e in mine if e["ph"] == "C"]
    assert counters == [("Owner.seen", 2), ("Owner.seen", 5)]


def test_train_step_records_its_phases_and_host_constants():
    """One step at the loss ``l1-gradient-ssim``: one SSIM blur (2 band
    matrices), four upsamples' backward (2 matrices each) and, on the CPU,
    their plain forward (2 ``_row_taps`` of 4 tensors each)."""
    model = tiny_model().train()
    state = TrainState(model, make_optimizer(model.parameters(), "adamw", 1e-3, 1e-3), 0)
    counters = ((_blur, 2), (resize_pack.resize_rows_backward, 8),
                (resize_pack._row_taps, 32))
    before = [f.host_constants for f, _ in counters]
    profiling.clear()
    with cpu_profile():
        train_step(state, tiny_batch(), get_loss_fn("l1-gradient-ssim"))
    assert [f.host_constants - b for (f, _), b in zip(counters, before)] == [n for _, n in counters]
    spans, tallies = profiling.recorded()
    assert names(spans) == ["train.step", "train.forward", "train.loss", "train.backward",
                            "train.optimizer"]
    assert [s.parent for s in spans] == [-1, 0, 0, 0, 0]
    logged = {}
    for t in tallies:
        logged[t.name] = logged.get(t.name, 0) + t.n
    assert logged == {"_blur.host_constants": 2, "resize_rows_backward.host_constants": 8,
                      "_row_taps.host_constants": 32}


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({"model_state_dict": tiny_model().state_dict(), "hyperparameters": HYPERPARAMS,
                "model_type": "unet", "metadata_input_length": 8, "trial_id": 0}, path)
    return PlannerEngine(path, device="cpu", temporal_length=T, img_size=HW)


def test_predict_many_tallies_its_pageable_bytes(engine):
    rng = np.random.default_rng(1)
    layers = [{"dw": rng.integers(0, 9, (HW, HW)), "rgb": rng.uniform(0, 255, (3, HW, HW)),
               "ndvi": rng.uniform(-1, 1, (HW, HW)), "temp": rng.uniform(10, 40, (HW, HW))}
              for _ in range(2)]
    canvas = np.zeros((HW, HW, 4), np.uint8)
    canvas[4:12, 4:12] = (57, 125, 73, 255)
    requests = [engine.prepare_input(layers[0], None, 41.9, 12.5, 2.8e6, 2023, 7, 2025, 7),
                engine.prepare_input(layers[1], canvas, -23.5, -46.6, 1e6, 2022, 1, 2024, 6)]
    before = PlannerEngine.pageable_h2d_bytes
    profiling.clear()
    with cpu_profile():
        out = engine.predict_many(requests)
    # maps, series and metadata in f32, lengths in int32, two requests.
    want = 2 * (HW * HW * 23 + T + 8 + 1) * 4
    assert len(out) == 2 and PlannerEngine.pageable_h2d_bytes - before == want
    spans, tallies = profiling.recorded()
    assert names(spans) == ["engine.predict_many", "engine.concat", "engine.forward",
                            "engine.upload", "engine.model", "engine.download"]
    assert [s.parent for s in spans] == [-1, 0, 0, 2, 2, 2]
    uploads = [(t.name, t.n) for t in tallies if t.name.startswith("PlannerEngine.")]
    assert uploads == [("PlannerEngine.pageable_h2d_bytes", want)]

    profiling.clear()
    with cpu_profile():
        engine.prepare_input(layers[1], canvas, -23.5, -46.6, 1e6, 2022, 1, 2024, 6)
        engine.prepare_input(layers[0], None, 41.9, 12.5, 2.8e6, 2023, 7, 2025, 7)
    spans, _ = profiling.recorded()
    assert names(spans) == ["engine.prepare_input", "engine.canvas_to_dw", "engine.assemble",
                            "engine.prepare_input", "engine.assemble"]
    assert [s.parent for s in spans] == [-1, 0, 0, -1, 3]


def test_batch_metrics_records_its_forward_and_metrics():
    model = tiny_model().eval()
    profiling.clear()
    with cpu_profile():
        batch_metrics(model, tiny_batch(), None, 8)
    spans, _ = profiling.recorded()
    assert names(spans) == ["eval.batch", "eval.forward", "eval.metrics"]
    assert [s.parent for s in spans] == [-1, 0, 0]
