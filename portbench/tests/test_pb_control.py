"""The comparison that decides ``correct`` fails what it must.

The control (the plain reference in the next precision below the
configuration's, in the program's place) fails at least one number of each
cell at the cell's limits.  A run whose timed path is broken underneath (an
answer altered where the model produces it; a training step that leaves the
state unchanged, or that leaves half of the batch out) comes out not
correct, while the same run unbroken comes out correct.  On the CPU at a
tiny size, in f32, so that the sound run's numbers are rounding; the
``card`` test reads the control at each cell's own size.
"""

import time

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests import tiny


def run(root, name):
    res, _ = harness.run_cell(root, name, 11, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
    return res


def fails(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.fixture
def f32_engine(monkeypatch):
    """The planner engine loads its checkpoint in f32."""
    from maunet_tpu_torch.evaluate import checkpoint

    load = checkpoint.load_any_checkpoint
    monkeypatch.setattr(checkpoint, "load_any_checkpoint",
                        lambda path, *a, **k: load(path, *a, **{**k, "compute_dtype": torch.float32}))


def altered_forward(monkeypatch):
    from maunet_tpu_torch.apps.engine import PlannerEngine

    forward = PlannerEngine._forward

    def wrong(self, *a):
        return forward(self, *a) * 1.3

    monkeypatch.setattr(PlannerEngine, "_forward", wrong)


@pytest.mark.parametrize("name", ["click_unet64_512", "serve_unet64_b8"])
def test_engine_answer_altered(name, f32_engine, tiny_root_f32, monkeypatch):
    assert run(tiny_root_f32, name)["correct"]
    altered_forward(monkeypatch)
    assert not run(tiny_root_f32, name)["correct"]


def test_serve_one_slot_altered(f32_engine, tiny_root_f32, monkeypatch):
    """One tile of a call altered: judged tile by tile, it is not diluted by
    the call's others."""
    from maunet_tpu_torch.apps.engine import PlannerEngine

    name = "serve_unet64_b8"
    assert run(tiny_root_f32, name)["correct"]
    many = PlannerEngine.predict_many

    def wrong(self, inputs):
        out = many(self, inputs)
        return [(out[0][0] * 1.3, out[0][1])] + out[1:]

    monkeypatch.setattr(PlannerEngine, "predict_many", wrong)
    assert not run(tiny_root_f32, name)["correct"]


def test_eval_answers_altered(tiny_root_f32, monkeypatch):
    from maunet_tpu_torch.evaluate import evaluator

    name = "eval_unetpp32_b16"
    assert run(tiny_root_f32, name)["correct"]
    forward = evaluator.forward_fn
    with monkeypatch.context() as m:
        m.setattr(evaluator, "forward_fn", lambda *a: forward(*a) * 1.3)
        assert not run(tiny_root_f32, name)["correct"]
    metrics = evaluator.eval_metrics

    def wrong(*a, **k):
        out = metrics(*a, **k)
        out["class_mae"] = out["class_mae"] * 1.01
        return out

    monkeypatch.setattr(evaluator, "eval_metrics", wrong)
    assert not run(tiny_root_f32, name)["correct"]


def test_train_step_unchanged_or_half_batch(tiny_root_f32, monkeypatch):
    from maunet_tpu_torch.train import optimizers, steps

    name = "train_unet64_b16"
    assert run(tiny_root_f32, name)["correct"]
    make = optimizers.make_optimizer

    def frozen(*a, **k):
        opt = make(*a, **k)
        opt.step = lambda *_: None
        return opt

    with monkeypatch.context() as m:
        m.setattr(optimizers, "make_optimizer", frozen)
        assert not run(tiny_root_f32, name)["correct"]
    step = steps.train_step

    def half(state, batch, *a, **k):
        n = batch["maps"].shape[0] // 2
        return step(state, {key: v[:n] for key, v in batch.items()}, *a, **k)

    monkeypatch.setattr(steps, "train_step", half)
    assert not run(tiny_root_f32, name)["correct"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_the_limits(name, tiny_root):
    rows = calibrate.readings(tiny_root, name, 11, True, torch.device("cpu"))
    limits = harness.find(tiny_root, name).limits
    assert fails(rows[1]["numbers"], limits), rows[1]


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_at_the_cells_size(name, card):
    limits = harness.find(tiny.ROOT, name).limits
    for seed in (21, 22, 23):
        rows = calibrate.readings(tiny.ROOT, name, seed, True, card)
        assert not fails(rows[0]["numbers"], limits), rows[0]
        assert fails(rows[1]["numbers"], limits), rows[1]
