"""Data-parallel training of the PyTorch port against the JAX package's mesh.

Ranks are worker processes (``tests/torch_multihost_worker.py``) joined
over Gloo through a ``file://`` store under ``tmp_path``, so no TCP port is
taken.  Held here:

- one f32 SGD step of two ranks (4 + 4 rows) against JAX's step on its
  8-device mesh (``make_train_step`` on ``batch_shardings_for``, as JAX
  ``tests/test_train.py::test_data_parallel_matches_single_device``): the
  parameters at atol 1e-5, the loss at rtol 1e-5 and the BatchNorm running
  statistics at rtol 1e-5 with a floor of 1e-5 of each tensor's largest,
  with ``remat`` off and on; both ranks end with the same bits;
- a two-rank and a four-rank ``Trainer`` epoch under the conditions of JAX's
  ``tests/test_multiprocess.py::_check_common``: each rank's slice of the
  global batch, disjoint epoch rows that cover the split, one val loss on
  every rank, and rank 0's checkpoint restored into a state of another seed
  reproducing it;
- each rank's flips in a resumed run equal an unbroken run's;
- the configuration checks: the batch size must divide over the ranks,
  ``use_mesh=False`` refuses a group, the spatial guard refuses 32² tiles
  (the spatial axis itself: ``test_torch_parallel_spatial.py``);
- ``make_batches``' ``sample_slice`` and ``pad_final`` bit for bit against
  JAX's.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.data.dataset import NpzDataset as JaxNpzDataset
from maunet_tpu.data.dataset import make_batches as jax_make_batches
from maunet_tpu.data.transforms import RandomFlip as JaxRandomFlip
from maunet_tpu.losses import get_loss_fn as jax_loss_fn
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.parallel import mesh as jax_mesh
from maunet_tpu.train import make_optimizer as jax_optimizer
from maunet_tpu.train import make_train_step
from maunet_tpu.train.state import TrainState as JaxState

from maunet_tpu_torch import cli
from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.data.transforms import RandomFlip
from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.parallel import mesh, multihost
from maunet_tpu_torch.train import loop
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
MODEL = dict(model_type="unet", base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8)
# JAX tests/test_multiprocess.py's Trainer run: 8/2/2 samples of 32², T = 32.
EPOCH_CFG = dict(base_filters=2, temporal_dim=2, meta_dim=2, lstm_hidden=4,
                 compute_dtype="float32", loss="mse", temporal_length=32, frequency_plt=0)


def run_cluster(tmp_path, name: str, world: int, tasks: list[dict], timeout: float = 600):
    """Run the worker as ``world`` Gloo ranks over a ``file://`` store; every
    rank must exit 0.  Returns the directory the ranks wrote to."""
    out = tmp_path / f"out_{name}"
    out.mkdir()
    spec = {"store": f"file://{tmp_path}/store_{name}", "world": world, "backend": "gloo",
            "device": "cpu", "threads": 1, "out": str(out), "tasks": tasks}
    spec_path = tmp_path / f"spec_{name}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [open(tmp_path / f"log_{name}_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec_path), str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    # A rank that fails leaves the others waiting in a collective: stop them.
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r} of {name} exited {p.returncode}:\n{text[-4000:]}"
    return out


# --------------------------------------------------------------------------
# One step of two ranks against JAX's 8-device mesh step.

@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    data = generate_dataset(str(tmp / "data"), {"train": 12, "val": 4, "test": 4},
                            hw=32, temporal_len=64)
    batch = next(make_batches(NpzDataset(os.path.join(data, "train"), 64), 8)).as_dict()

    model = JaxUrbanPredictor("unet", base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8,
                              compute_dtype=jnp.float32)
    # SGD, so that the update is -lr * grad (JAX's test's choice: Adam's
    # first step would turn rounding into +-lr).
    tx = jax_optimizer("sgd", 1e-2, momentum=0.0)
    meta = np.concatenate([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], 1)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), batch["maps"],
                                    batch["temp_series"], meta, batch["temp_lengths"])
    state = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                     opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step = make_train_step(model, jax_loss_fn("mse-gradient"), tx, donate=False)
    assert len(jax.devices()) == 8
    m = jax_mesh.make_mesh()
    shardings = jax_mesh.batch_shardings_for(m, batch)
    sharded = {k: jax.device_put(v, shardings[k]) for k, v in batch.items()}
    new_state, metrics = step(jax.device_put(state, jax_mesh.replicated(m)), sharded)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_state.variables))

    torch.save(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables)),
               tmp / "state.pt")
    np.savez(tmp / "batch.npz", **batch)
    tasks = [{"kind": "step", "name": f"remat{int(remat)}", "state": str(tmp / "state.pt"),
              "batch": str(tmp / "batch.npz"), "model": {**MODEL, "remat": remat},
              "optimizer": ["sgd", 1e-2, 0.0, 0.0], "loss": "mse-gradient"}
             for remat in (False, True)]
    out = run_cluster(tmp, "step", 2, tasks)
    got = {name: [torch.load(out / f"{name}_rank{r}.pt", weights_only=True) for r in range(2)]
           for name in ("remat0", "remat1")}
    return want, float(metrics["total"]), got


@pytest.mark.parametrize("remat", [False, True])
def test_two_rank_step_matches_jax_mesh_step(step_runs, remat):
    want, loss, got = step_runs
    ranks = got[f"remat{int(remat)}"]
    assert [r["rows"] for r in ranks] == [[0, 4], [4, 8]]
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["total"], loss, rtol=1e-5)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = ranks[0]["state_dict"][k]
        torch.testing.assert_close(ranks[1]["state_dict"][k], a, rtol=0, atol=0, msg=k)
        if k.endswith(("running_mean", "running_var")):
            # A channel's mean can cancel to 1e-4 of the largest: there the
            # floor, 1e-5 of the tensor's largest statistic, holds it.
            np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(v.abs().max()), err_msg=k)
        else:
            np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# Trainer epochs: JAX's _check_common conditions.

@pytest.fixture(scope="module")
def epoch_data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("dp_epoch") / "d"),
                            {"train": 8, "val": 2, "test": 2}, hw=32, temporal_len=32)


def _check_common(results, global_batch, n_train=8):
    """JAX tests/test_multiprocess.py::_check_common, for ranks: the port's
    restore needs no example batch, so ``seen`` is the state's example batch
    and the epoch's batches."""
    per_rank = global_batch // len(results)
    r0 = results[0]
    for p, r in enumerate(results):
        assert r["host_slice"] == [p * per_rank, (p + 1) * per_rank], r
        assert r["data_parallel"] == len(results)
        assert r["best_val_loss"] == r0["best_val_loss"]
        assert r["best_checkpoint"] == r0["best_checkpoint"]
        assert r["val_restored"] == pytest.approx(r["best_val_loss"], rel=1e-6)
        assert r["restored_epoch"] == 0 and r["restored_step"] >= 1
    assert r0["csv"] is True
    n_epoch_batches = n_train // global_batch
    passes = []
    for r in results:
        assert len(r["seen"]) == per_rank * (1 + n_epoch_batches), r["seen"]
        assert set(r["seen"][:per_rank]) == set(range(*r["host_slice"]))
        passes.append(set(r["seen"][per_rank:]))
    union = set()
    for s in passes:
        assert not union & s, "ranks read overlapping epoch rows"
        union |= s
    assert union == set(range(n_train))


@pytest.fixture(scope="module")
def two_rank_runs(epoch_data, tmp_path_factory):
    """One cluster of two ranks: a Trainer epoch at global batch 8, then the
    flip streams of an unbroken and a resumed run at global batch 4."""
    tmp = tmp_path_factory.mktemp("dp_two")
    tasks = [{"kind": "epoch", "name": "epoch", "data": epoch_data, "work": str(tmp / "work"),
              "cfg": {**EPOCH_CFG, "batch_size": 8}},
             {"kind": "resume", "name": "resume", "data": epoch_data,
              "work": str(tmp / "flips"), "cfg": {**EPOCH_CFG, "batch_size": 4}}]
    out = run_cluster(tmp, "two", 2, tasks)
    return {t["name"]: [json.loads((out / f"{t['name']}_rank{r}.json").read_text())
                        for r in range(2)] for t in tasks}


def test_two_rank_trainer_epoch(two_rank_runs):
    _check_common(two_rank_runs["epoch"], global_batch=8)


def test_four_rank_trainer_epoch(epoch_data, tmp_path):
    tasks = [{"kind": "epoch", "name": "epoch", "data": epoch_data, "work": str(tmp_path / "w"),
              "cfg": {**EPOCH_CFG, "batch_size": 4}}]
    out = run_cluster(tmp_path, "four", 4, tasks)
    _check_common([json.loads((out / f"epoch_rank{r}.json").read_text()) for r in range(4)],
                  global_batch=4)


def test_resumed_ranks_flip_as_an_unbroken_run(two_rank_runs):
    """Each rank draws one flip per row it loads: the state's example batch
    (2 rows) and two epochs of 2 batches.  Resumed, the second trainer draws
    its example batch, skips the first epoch's 4 draws and goes on as the
    unbroken run does."""
    per_rank = []
    for r in two_rank_runs["resume"]:
        (full,), (first, second) = r["full"], r["split"]
        assert len(full) == 2 + 2 * 4 and len(first) == 2 + 4 and len(second) == 2 + 4
        assert first == full[:6]
        assert second[:2] == full[:2] and second[2:] == full[6:]
        per_rank.append(full)
    assert per_rank[0] == per_rank[1]      # one seed: each rank draws the same stream


# --------------------------------------------------------------------------
# Configuration checks, in this process.

def test_batch_size_and_data_parallel_checked_against_the_ranks(epoch_data, tmp_path,
                                                                monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="divisible"):
        Trainer(TrainConfig(**EPOCH_CFG, batch_size=5), epoch_data, work_dir=str(tmp_path),
                device="cpu")
    with pytest.raises(ValueError, match="data_parallel=4"):
        Trainer(TrainConfig(**EPOCH_CFG, batch_size=8, data_parallel=4), epoch_data,
                work_dir=str(tmp_path), device="cpu")
    monkeypatch.setattr(loop, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="use_mesh=False"):
        Trainer(TrainConfig(**EPOCH_CFG), epoch_data, work_dir=str(tmp_path), device="cpu",
                use_mesh=False)


def test_spatial_guard_rejects_32_tiles(epoch_data, tmp_path, monkeypatch):
    """A 2 x 2 mesh is made, but 32² tiles (a 2-row bottleneck) are refused
    over 2 and 4 spatial ranks, as JAX's guard refuses them, and so is a
    Trainer whose spatial axis the process group was not laid out with."""
    assert mesh.make_mesh(2, 2, devices=["cpu"] * 4).shape == {"data": 2, "spatial": 2}
    for sp in (2, 4):
        with pytest.raises(ValueError, match="bottleneck"):
            mesh.validate_spatial_sharding(32, sp)
    mesh.validate_spatial_sharding(64, 4)
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="spatial_parallel=2 to initialize_multihost"):
        Trainer(TrainConfig(**EPOCH_CFG, spatial_parallel=2), epoch_data,
                work_dir=str(tmp_path), device="cpu")


def test_single_process_makes_no_group_and_takes_every_row():
    assert multihost.initialize_multihost(None, None, None, device="cpu") == torch.device("cpu")
    assert multihost.initialize_multihost("localhost:1", 1, 0, device="cpu").type == "cpu"
    assert not torch.distributed.is_initialized()
    assert multihost.world_size() == 1 and multihost.rank() == 0
    assert multihost.host_batch_slice(16) == slice(0, 16)
    assert mesh.data_axis_size() == 1 and mesh.data_axis_size(1) == 1


def test_config_has_the_parallel_keys_and_the_cli_none():
    """The mesh sizes are JAX's parallel.* keys on the command line, and no
    other section's."""
    cfg = TrainConfig()
    assert (cfg.data_parallel, cfg.spatial_parallel) == (-1, 1)
    assert cli.with_overrides(cfg, {"parallel.data_parallel": 2,
                                    "parallel.spatial_parallel": 4}) == TrainConfig(
        data_parallel=2, spatial_parallel=4)
    for key in ("parallel.data_axis", "training.data_parallel",
                "training.spatial_parallel"):
        with pytest.raises(ValueError, match="unknown config key"):
            cli.with_overrides(cfg, {key: 2})


@pytest.mark.parametrize("shuffle,drop_last,pad_final,rows", [
    (True, True, True, slice(0, 2)), (True, False, True, slice(2, 4)),
    (False, False, False, slice(1, 3)), (False, False, True, slice(3, 4)),
    (False, False, False, None)])
def test_make_batches_sample_slice_and_pad_final_match_jax(epoch_data, shuffle, drop_last,
                                                           pad_final, rows):
    """9 samples in global batches of 4: the last batch has one real row,
    so a slice past it is skipped unless ``pad_final`` pads it."""
    split = os.path.join(epoch_data, "train")
    ds9 = NpzDataset(split, 32, transform=RandomFlip(3))
    ds9.files = ds9.files + ds9.files[:1]
    ref9 = JaxNpzDataset(split, 32, transform=JaxRandomFlip(3), backend="numpy")
    ref9.files = ref9.files + ref9.files[:1]
    kw = dict(shuffle=shuffle, seed=5, epoch=1, drop_last=drop_last, pad_final=pad_final,
              sample_slice=rows)
    pairs = list(zip(make_batches(ds9, 4, **kw), jax_make_batches(ref9, 4, **kw), strict=True))
    assert pairs
    for a, b in pairs:
        da, db = a.as_dict(), b.as_dict()
        assert sorted(da) == sorted(db)
        for k in da:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
