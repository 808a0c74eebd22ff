"""The port's ``remat`` and training-time prediction plots, on the CPU at a
small size (32² tiles, base 4, T = 16, f32).

``remat`` runs each VGGBlock under ``torch.utils.checkpoint``; its
recompute must leave BatchNorm's running statistics alone, as flax discards
the recompute's mutations.  The plot step (``train_step_with_outputs``)
must update the state as ``train_step`` does, bit for bit, and the
``Trainer`` must draw every ``frequency_plt`` steps where matplotlib exists
and train on without it.
"""

import functools
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maunet_tpu.interop.torch_export import _params_to_torch_arrays
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.train.visualize import plot_predictions_vs_targets as jax_plot

from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.losses import get_loss_fn
from maunet_tpu_torch.models import UrbanPredictor
from maunet_tpu_torch.train import loop
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.optimizers import make_optimizer
from maunet_tpu_torch.train.state import TrainState
from maunet_tpu_torch.train.steps import train_step, train_step_with_outputs
from maunet_tpu_torch.train.visualize import plot_predictions_vs_targets

KW = dict(base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8)
T = 16


def _batch(seed=0, b=3, hw=32):
    rng = np.random.default_rng(seed)
    return {
        "maps": rng.normal(size=(b, hw, hw, 23)).astype(np.float32),
        "targets": rng.uniform(-0.8, 0.8, (b, hw, hw, 2)).astype(np.float32),
        "metadata": rng.normal(size=(b, 4)).astype(np.float32),
        "temp_series": rng.normal(size=(b, T)).astype(np.float32),
        "temp_lengths": np.array([T, 0, 9][:b], np.int32),
        "t1_dates": rng.uniform(0, 1, (b, 2)).astype(np.float32),
        "t2_dates": rng.uniform(0, 1, (b, 2)).astype(np.float32),
        "valid": np.ones(b, bool),
    }


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state(model_type, remat=False, seed=0):
    model = UrbanPredictor(model_type, compute_dtype=torch.float32, remat=remat,
                           deep_supervision=model_type == "unet++",
                           generator=torch.Generator().manual_seed(seed), **KW)
    with torch.no_grad():   # BN affine off its ones and zeros, as after training
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if ".bn" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return TrainState(model, make_optimizer(model.parameters(), "adamw", 1e-3, 1e-2, 0.9), 0)


def _same_state(a: TrainState, b: TrainState):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for (ka, sa), (_, sb) in zip(a.optimizer.state.items(), b.optimizer.state.items()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step


# --- remat -------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_remat_step_equals_the_plain_step(model_type):
    """From the same state, one remat step and one plain step give the same
    loss, gradients, parameters and running statistics, bit for bit, and
    ``num_batches_tracked`` rises by 1, not 2: the recompute in the backward
    pass leaves the statistics alone."""
    plain, remat = _state(model_type), _state(model_type, remat=True)
    _same_state(plain, remat)
    batch = _torch(_batch())
    loss_fn = get_loss_fn("l1-gradient-ssim")
    a = train_step(plain, batch, loss_fn, gradient_clipping=0.5)
    b = train_step(remat, batch, loss_fn, gradient_clipping=0.5)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for (k, p), (_, q) in zip(plain.model.named_parameters(), remat.model.named_parameters()):
        assert torch.equal(p.grad, q.grad), k
    _same_state(plain, remat)
    tracked = [v for k, v in remat.model.state_dict().items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 1 for v in tracked)


@pytest.fixture(scope="module")
def jax_remat():
    """The JAX U-Net with ``remat=True``: weights, train-mode loss mean(y^2)
    and its gradients (jitted)."""
    inputs = _batch(1)
    meta = np.concatenate([inputs["metadata"], inputs["t1_dates"], inputs["t2_dates"]], 1)
    args = (inputs["maps"], inputs["temp_series"], meta, inputs["temp_lengths"])
    model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, remat=True, **KW)
    # Initialised in train mode: the eval forward's lane-packed blocks do not
    # pass through JAX's remat.
    variables = jax.jit(functools.partial(model.init, train=True))(jax.random.PRNGKey(0), *args)

    def objective(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             *args, train=True, mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    loss, grads = jax.jit(jax.value_and_grad(objective))(variables["params"])
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return numpy(variables), args, float(loss), _params_to_torch_arrays(numpy(grads))


def test_remat_gradients_match_jax_remat(jax_remat):
    """The port's remat gradients against JAX's ``remat=True`` ones at rtol
    1e-4, with a floor of 1e-4 of the largest gradient for sums that cancel
    (as ``tests/test_torch_train_step.py``)."""
    variables, args, want_loss, want = jax_remat
    model = UrbanPredictor(compute_dtype=torch.float32, remat=True, **KW)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    y = model(*(torch.from_numpy(np.asarray(a)) for a in args))
    loss = (y ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    floor = 1e-4 * max(np.abs(g).max() for g in want.values())
    for k, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(got, want[k], rtol=1e-4, atol=floor, err_msg=k)


# --- the plot step ------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_plot_step_updates_the_state_as_train_step_does(model_type):
    """Bit for bit; it returns the loss components (no ``grad_norm``, as
    JAX's ``make_train_step_with_outputs``) and the last head's outputs."""
    a, b = _state(model_type), _state(model_type)
    loss_fn = get_loss_fn("mse-gradient")
    for seed in (0, 1):
        batch = _torch(_batch(seed))
        m_a = train_step(a, batch, loss_fn, gradient_clipping=0.5)
        m_b, outputs = train_step_with_outputs(b, batch, loss_fn, gradient_clipping=0.5)
        assert sorted(m_b) == sorted(k for k in m_a if k != "grad_norm")
        for k in m_b:
            assert torch.equal(m_a[k], m_b[k]), k
        assert outputs.shape == (3, 32, 32, 2) and not outputs.requires_grad
        _same_state(a, b)


def test_prediction_plot_matches_the_jax_plot(tmp_path):
    """The same arrays drawn by both packages' functions: the same file name
    and image size."""
    batch = _batch(2)
    outputs = np.random.default_rng(3).uniform(-1, 1, (3, 32, 32, 2)).astype(np.float32)
    args = ("study", 0, 7, 0.25, None)
    got = plot_predictions_vs_targets(batch, outputs, str(tmp_path / "port"), *args)
    want = jax_plot(batch, outputs, str(tmp_path / "jax"), *args)
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == ["study_t0_step7.png"]
    assert os.path.basename(got) == os.path.basename(want)
    assert Image.open(got).size == Image.open(want).size


# --- the Trainer --------------------------------------------------------------

class ImageRecorder:
    def __init__(self):
        self.rows, self.images = [], []

    def log(self, row, step=None):
        self.rows.append((step, dict(row)))

    def log_image(self, key, image_path, step=None):
        self.images.append((key, image_path, step))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("synth")), {"train": 12, "val": 4},
                            hw=32, temporal_len=T, seed=5)


def _cfg(**kw):
    return TrainConfig(batch_size=4, base_filters=4, temporal_dim=4, meta_dim=4,
                       lstm_hidden=8, compute_dtype="float32", loss="mse",
                       temporal_length=T, frequency_log=1, **kw)


def test_trainer_plots_every_frequency_plt_steps(data, tmp_path):
    """Three steps at ``frequency_plt=2``: plots at steps 0 and 2, each a
    PNG handed to the trackers; the rows of the plot steps lack
    ``loss_grad_norm``, as the JAX loop's do."""
    rec = ImageRecorder()
    work = tmp_path / "w"
    loop.Trainer(_cfg(frequency_plt=2), data, work_dir=str(work), study_name="p",
                 device="cpu", trackers=[rec]).train(epochs=1)
    assert [(k, s) for k, _, s in rec.images] == [("train/predictions", 0),
                                                  ("train/predictions", 2)]
    assert sorted(os.listdir(work / "visualizations")) == ["p_t0_step0.png", "p_t0_step2.png"]
    assert all(os.path.exists(path) for _, path, _ in rec.images)
    steps = {s: row for s, row in rec.rows if "batch_loss" in row}
    assert sorted(steps) == [0, 1, 2]
    assert "loss_grad_norm" in steps[1]
    assert "loss_grad_norm" not in steps[0] and "loss_grad_norm" not in steps[2]


def test_trainer_without_matplotlib_logs_one_line_and_trains_on(data, tmp_path, monkeypatch,
                                                                caplog):
    """matplotlib blocked: one logged line for the Trainer, no figure, no
    warning per step, and the same state as a run with plots off."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rec = ImageRecorder()
    with caplog.at_level(logging.INFO, logger=loop.log.name):
        trainer = loop.Trainer(_cfg(frequency_plt=1), data, work_dir=str(tmp_path / "a"),
                               device="cpu", trackers=[rec])
        trainer.train(epochs=1)
    lines = [r.getMessage() for r in caplog.records if "matplotlib" in r.getMessage()]
    assert lines == ["matplotlib is not installed: training without prediction plots"]
    assert not any(r.levelno >= logging.WARNING for r in caplog.records)
    assert rec.images == [] and not os.path.exists(tmp_path / "a" / "visualizations")
    off = loop.Trainer(_cfg(frequency_plt=0), data, work_dir=str(tmp_path / "b"), device="cpu")
    off.train(epochs=1)
    _same_state(trainer.state, off.state)


def test_a_failing_plot_does_not_stop_training(data, tmp_path, monkeypatch, caplog):
    import maunet_tpu_torch.train.visualize as visualize

    def broken(*args, **kw):
        raise RuntimeError("no display")

    monkeypatch.setattr(visualize, "plot_predictions_vs_targets", broken)
    with caplog.at_level(logging.WARNING, logger=loop.log.name):
        result = loop.Trainer(_cfg(frequency_plt=1), data, work_dir=str(tmp_path),
                              device="cpu").train(epochs=1)
    assert result.epochs_run == 1
    assert [r.getMessage() for r in caplog.records] == [
        f"Prediction plot failed at step {s}: no display" for s in range(3)]
