"""The port's ``Trainer`` against the JAX package's over two epochs.

The science loop's tempemb variant (``maunet_tpu/analysis/science.py``
``_science_config``: AdamW at 2e-3, weight decay 1e-5, clip 1.0, MSE, LSTM
32, embeddings 16) at the cut size of ``test_torch_analysis_science.py``
(32², T = 32, base 4, batch 4, 16/4/8 samples of the planted-signal data),
in f32, trains two epochs in each package from one initial state: the one
the JAX ``Trainer`` makes with ``create_train_state``, carried into the
port's ``Trainer.init_state`` through ``interop.from_jax``.

Under the recipe's AdamW the two runs drift apart: every step's loss agrees
at rtol 1e-4 through step 2, step 3 is 1.4e-4 apart and the second epoch's
mean train loss 3.4e-3.  The drift is Adam's: its first updates are
``-lr g / (|g| + eps)``, so a gradient element at the level of f32 rounding
(the 2x2 bottleneck's convs here) moves by up to lr in either package with
the sign its rounding gives it.  So the recipe is held two ways:

- each of JAX's sixteen steps, taken by the port from JAX's own state
  (parameters, BatchNorm statistics, Adam moments and count) on the batch
  JAX's loader gave, gives JAX's loss at rtol 1e-4 and its gradient norm at
  rtol 1e-3 (a ReLU input within rounding of 0 moves one step's norm by
  8e-5), and the port's own loader gives those batches bit for bit;
- with SGD (momentum 0.9) in AdamW's place, and nothing else changed, the
  two loops agree over both epochs: every step's loss at rtol 1e-4, each
  epoch's train and val loss and every val component at rtol 1e-3.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maunet_tpu.analysis import science as jax_science
from maunet_tpu.interop.torch_export import _find_state, _params_to_torch_arrays
from maunet_tpu.train import loop as jax_loop
from maunet_tpu.train.state import TrainState as JaxState

from maunet_tpu_torch.analysis import science
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.train import loop
from maunet_tpu_torch.train.loop import Trainer
from maunet_tpu_torch.train.steps import train_step

EPOCHS = 2
# The cut size of test_torch_analysis_science.py's loop.
HW, T, BASE, BATCH = 32, 32, 4, 4
SAMPLES = {"train": 16, "val": 4, "test": 8}
STEPS = EPOCHS * SAMPLES["train"] // BATCH


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _csv_losses(path):
    with open(path) as f:
        return [(int(r["epoch"]), float(r["batch_loss"])) for r in csv.DictReader(f)]


def _epoch_means(rows):
    return [float(np.mean([v for e, v in rows if e == epoch])) for epoch in range(EPOCHS)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("parity") / "data"), SAMPLES,
                            hw=HW, temporal_len=T, seed=0, meta_signal=1.0,
                            temporal_signal=0.5)


def _train_both(data, work, optimizer):
    """Both trainers, two epochs of the tempemb recipe in f32 with
    ``optimizer``.  Returns, per package, the result and each step's logged
    loss; for JAX also each step's (state before, batch, metrics), for the
    port each step's batch."""
    temporal, metadata = science.VARIANTS["tempemb"]
    jax_cfg = jax_science._science_config(temporal, metadata, HW, T, BASE, BATCH, EPOCHS)
    jax_cfg = jax_cfg.with_overrides(**{"training.compute_dtype": "float32",
                                        "training.optimizer": optimizer,
                                        "logging.frequency_log": 1})
    cfg = dataclasses.replace(
        science._science_config(temporal, metadata, HW, T, BASE, BATCH, EPOCHS),
        compute_dtype="float32", optimizer=optimizer, frequency_log=1)
    initial, jax_steps, port_batches = {}, [], []

    def create_train_state(model, tx, rng, batch, metadata_features=8):
        """JAX's own initialisation, with ``model.init`` jitted (run op by op
        it takes most of a minute on the CPU); the state is kept for the port."""
        meta = np.concatenate([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], 1)
        v = jax.jit(model.init)(rng, batch["maps"], batch["temp_series"], meta,
                                batch["temp_lengths"])
        initial["variables"] = _numpy(v)
        return JaxState(params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))

    jax_trainer = jax_loop.Trainer(jax_cfg, data_dir=data, work_dir=str(work / "jax"),
                                   study_name="p", use_mesh=False)
    jitted = jax_trainer.train_step

    def recording_step(state, batch):
        before = (jax.device_get(state), jax.device_get(batch))   # the step donates state
        state, metrics = jitted(state, batch)
        jax_steps.append((*before, jax.device_get(metrics)))
        return state, metrics

    jax_trainer.train_step = recording_step
    init_state = Trainer.init_state

    def from_jax(self, in_channels):
        state = init_state(self, in_channels)
        state.model.load_state_dict(state_dict_from_jax(initial["variables"]), strict=True)
        return state

    def port_step(state, batch, *args, **kw):
        port_batches.append({k: v.numpy().copy() for k, v in batch.items()})
        return train_step(state, batch, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", create_train_state)
        jax_result = jax_trainer.train()
        mp.setattr(Trainer, "init_state", from_jax)
        mp.setattr(loop, "train_step", port_step)
        port = Trainer(cfg, data, work_dir=str(work / "port"), study_name="p", device="cpu")
        port_result = port.train()
    name = "p_trial0_train_log.csv"
    return {"jax": (jax_result, _csv_losses(work / "jax" / name), jax_steps),
            "port": (port_result, _csv_losses(work / "port" / name), port_batches),
            "trainer": port}


def test_two_epochs_with_sgd_match_jax(data, tmp_path):
    runs = _train_both(data, tmp_path, "sgd")
    (jax_result, jax_rows, _), (port_result, port_rows, _) = runs["jax"], runs["port"]
    assert len(jax_rows) == len(port_rows) == STEPS
    for step, ((e_j, a), (e_p, b)) in enumerate(zip(jax_rows, port_rows)):
        assert e_j == e_p
        np.testing.assert_allclose(b, a, rtol=1e-4, err_msg=f"step {step}")
    assert [h["epoch"] for h in port_result.history] == list(range(EPOCHS))
    np.testing.assert_allclose([h["train_loss"] for h in port_result.history],
                               _epoch_means(jax_rows), rtol=1e-3)
    for h_p, h_j in zip(port_result.history, jax_result.history, strict=True):
        assert sorted(h_j) == sorted(k for k in h_p if k != "train_loss")
        for k in h_j:
            np.testing.assert_allclose(h_p[k], h_j[k], rtol=1e-3, err_msg=k)
    assert port_result.best_val_loss == pytest.approx(jax_result.best_val_loss, rel=1e-3)


def _port_state_from(trainer, state):
    """The port's state set to JAX's ``state``: parameters, statistics, the
    Adam moments and count, by parameter name."""
    pstate = trainer.init_state(23)
    pstate.model.load_state_dict(state_dict_from_jax(_numpy(state.variables)), strict=True)
    adam = _find_state(state.opt_state, optax.ScaleByAdamState)
    mu, nu = (_params_to_torch_arrays(_numpy(t)) for t in (adam.mu, adam.nu))
    count = torch.tensor(float(adam.count))
    for name, p in pstate.model.named_parameters():
        pstate.optimizer.state[p] = {"step": count.clone(),
                                     "exp_avg": torch.from_numpy(np.array(mu[name])),
                                     "exp_avg_sq": torch.from_numpy(np.array(nu[name]))}
    pstate.step = int(state.step)
    return pstate


def test_each_step_of_the_adamw_recipe_matches_jax_from_its_state(data, tmp_path):
    runs = _train_both(data, tmp_path, "adamw")
    _, _, jax_steps = runs["jax"]
    _, _, port_batches = runs["port"]
    trainer = runs["trainer"]
    assert len(jax_steps) == len(port_batches) == STEPS
    for k, ((state, batch, metrics), ours) in enumerate(zip(jax_steps, port_batches)):
        assert int(state.step) == k
        for key, v in batch.items():
            np.testing.assert_array_equal(ours[key], v, err_msg=f"step {k}: {key}")
        pstate = _port_state_from(trainer, state)
        got = train_step(pstate, {key: torch.from_numpy(np.array(v)) for key, v in batch.items()},
                         trainer.loss_fn, gradient_clipping=trainer.cfg.gradient_clipping)
        np.testing.assert_allclose(float(got["total"]), float(metrics["total"]), rtol=1e-4,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]),
                                   rtol=1e-3, err_msg=f"step {k}")
