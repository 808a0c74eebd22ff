"""The spatial mesh axis of the PyTorch port against the JAX package's.

Ranks are worker processes (``tests/torch_multihost_worker.py``) joined over
Gloo through a ``file://`` store, one cluster of two and one of four ranks,
each task laying its ranks out data x spatial.  Held here:

- kernel C's row window in its plain version: for every band of 2 and 4
  spatial ranks of the U-Net's and U-Net++'s 2x upsamples (4 -> 8 through
  128 -> 256), the rows of the whole resize bit for bit, from the band and a
  halo row of each neighbour (the window reaches one row into the band
  above and, but for the last band, one into the band below);
- the guard: ``validate_spatial_sharding`` accepts and rejects the (tile,
  axis) pairs that JAX's does;
- each rank's (data, spatial) coordinates against JAX's device grid;
- JAX ``tests/test_train.py::test_spatial_sharding_matches_single_device``'s
  recipe (64² tiles, base 4, f32, eval mode, loss sum(out²)): the port's
  forward and parameter gradient at (1, 2), (2, 2) and (1, 4) against JAX's
  single-device result and its sharded ones on meshes (4, 2) and (2, 4),
  outputs within 1e-5 and gradients within 2e-4 * max(1, max|g|), JAX's
  tolerances; U-Net++ at (2, 2) against the port's own unsharded forward
  and gradient in this process, with the same tolerances (the unsharded
  U-Net++ is held against JAX in ``test_torch_port_unetpp.py``);
- one f32 SGD step with the l1-gradient-ssim loss at (1, 2) and (2, 2)
  against JAX's step on a (4, 2) mesh with the rows sharded: parameters
  within 1e-5, the loss within 1e-5 relative, the running statistics
  within 1e-5 relative with a floor of 1e-5 of each tensor's largest;
- a (2, 2) ``Trainer`` epoch under JAX's 2-axis multiprocess checks (each
  rank's slice by its data index, disjoint across data indices and
  covering the split, one val loss on every rank, rank 0's checkpoint
  restored reproducing it), its val loss within 1e-5 of a (2, 1) epoch's.
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

from maunet_tpu.losses import get_loss_fn as jax_loss_fn
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.parallel import mesh as jax_mesh
from maunet_tpu.train import make_optimizer as jax_optimizer
from maunet_tpu.train import make_train_step
from maunet_tpu.train.state import TrainState as JaxState

from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.models import UrbanPredictor
from maunet_tpu_torch.ops.kernels import resize_pack as rp
from maunet_tpu_torch.parallel import mesh, multihost
from maunet_tpu_torch.train.steps import model_outputs

from test_torch_parallel_train import REPO, WORKER

MODEL = dict(model_type="unet", base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8)
UNETPP = {**MODEL, "model_type": "unet++"}
LAYOUTS = [(1, 2), (2, 2), (1, 4)]
JAX_MESHES = [(4, 2), (2, 4)]
STEP_LAYOUTS = [(1, 2), (2, 2)]
# The Trainer epoch: tiles of 64², the smallest the guard takes at spatial 2.
EPOCH_CFG = dict(base_filters=2, temporal_dim=2, meta_dim=2, lstm_hidden=4,
                 compute_dtype="float32", loss="mse", temporal_length=32, frequency_plt=0,
                 batch_size=4)


# --------------------------------------------------------------------------
# Kernel C's row window, in its plain version.

@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128])
def test_row_window_gives_the_whole_resize_rows(n, sp):
    """2x upsample n -> 2n (the U-Net's four and U-Net++'s level resizes
    from 64² to 256² tiles) of n/sp-row bands: each band's rows of the
    whole resize, bit for bit, in f32 and bf16, from the band and the halo
    rows that ``ops/resize.py`` adds; the taps reach one row above the band
    (none for the first) and one below (none for the last)."""
    rng = np.random.default_rng(n * 10 + sp)
    band = n // sp
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((2, n, 6, 3)).astype(np.float32)).to(dtype)
        whole = rp.resize_pack_plain(x, (2 * n, 12))
        for s in range(sp):
            first, stop = rp.window_rows(n, 2 * n, s * 2 * band, 2 * band)
            assert first == s * band - (s > 0)
            assert stop == (s + 1) * band + (s < sp - 1)
            lo, hi = max(s * band - 1, 0), min((s + 1) * band + 1, n)
            got = rp.resize_rows(x[:, lo:hi].contiguous(), (2 * band, 12), n, 2 * n, lo,
                                 s * 2 * band)
            assert torch.equal(got, whole[:, s * 2 * band:(s + 1) * 2 * band]), (dtype, s)


def test_row_window_refuses_a_window_short_of_its_taps():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="do not hold"):
        rp.resize_rows(x, (8, 8), 8, 16, 4, 0)       # rows [4, 8) cannot give row 0


# --------------------------------------------------------------------------
# The guard and the grid, in this process.

@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_guard_matches_jax(sp):
    jax_m = jax_mesh.make_mesh(data_parallel=8 // sp, spatial_parallel=sp)
    for tile in (16, 32, 48, 64, 96, 128, 192, 250, 256, 512, 1024):
        try:
            jax_mesh.validate_spatial_sharding(jax_m, tile)
            want = True
        except ValueError:
            want = False
        try:
            mesh.validate_spatial_sharding(tile, sp)
            got = True
        except ValueError as e:
            assert "no halo reaches past a neighbour" in str(e)
            got = False
        assert got == want, (tile, sp)


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_rank_coordinates_match_jax_device_grid(dp, sp):
    """Rank r holds the place of JAX's device r in ``make_mesh(dp, sp)``, and
    the port's ``make_mesh`` lays a device list out alike."""
    grid = jax_mesh.make_mesh(data_parallel=dp, spatial_parallel=sp).devices
    for d in range(dp):
        for s in range(sp):
            assert multihost.coordinates(int(grid[d, s].id), sp) == (d, s)
    devices = [torch.device("cpu", i) for i in range(8)]
    port = mesh.make_mesh(dp, sp, devices=devices)
    assert port.shape == {"data": dp, "spatial": sp} and port.size == 8
    for d in range(dp):
        for s in range(sp):
            assert port.devices[d * sp + s].index == int(grid[d, s].id)
    assert mesh.make_mesh(-1, sp, devices=devices).shape == {"data": 8 // sp, "spatial": sp}


# --------------------------------------------------------------------------
# JAX's recipe, and the port's ranks on it.

def _fwd_grad(model):
    def fwd_loss(v, b):
        out = model.apply(
            v, b["maps"], b["temp_series"],
            jnp.concatenate([b["metadata"], b["t1_dates"], b["t2_dates"]], axis=1),
            b["temp_lengths"])
        return jnp.sum(out ** 2), out

    return jax.jit(lambda v, b: (
        fwd_loss(v, b)[1],
        jax.grad(lambda p: fwd_loss({**v, "params": p}, b)[0])(v["params"])))


def _torch_grads(grads, variables) -> dict[str, np.ndarray]:
    """JAX's parameter gradients under the port's parameter names."""
    sd = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads),
                              "batch_stats": variables["batch_stats"]})
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("weight", "bias", "l0"))}


def _port_forward_grad(state_path, model_kw, batch):
    """The port's unsharded eval-mode output and gradient of sum(out²)."""
    model = UrbanPredictor(**model_kw, compute_dtype=torch.float32)
    model.load_state_dict(torch.load(state_path, weights_only=True), strict=True)
    model.eval()
    named = list(model.named_parameters())
    out = model_outputs(model, {k: torch.from_numpy(x) for k, x in batch.items()})
    grads = torch.autograd.grad((out ** 2).sum(), [p for _, p in named], allow_unused=True)
    return out.detach().numpy(), {n: (np.zeros(tuple(p.shape), np.float32) if g is None
                                      else g.numpy()) for (n, p), g in zip(named, grads)}


def start_cluster(tmp, name: str, world: int, tasks: list[dict]):
    """Start the worker as ``world`` Gloo ranks over a ``file://`` store
    (``test_torch_parallel_train.run_cluster``, without waiting)."""
    out = tmp / f"out_{name}"
    out.mkdir()
    spec = {"store": f"file://{tmp}/store_{name}", "world": world, "backend": "gloo",
            "device": "cpu", "threads": 1, "out": str(out), "tasks": tasks}
    spec_path = tmp / f"spec_{name}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [open(tmp / f"log_{name}_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec_path), str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return name, out, procs, logs


def finish_cluster(cluster, timeout: float = 600):
    """Wait for a started cluster; every rank must exit 0.  A rank that
    fails leaves the others waiting in a collective: they are stopped."""
    name, out, procs, logs = cluster
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for r, (p, log) in enumerate(zip(procs, logs)):
        p.wait()
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r} of {name} exited {p.returncode}:\n{text[-4000:]}"
    return out


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """JAX's results, and the port's ranks' results, on one batch: the
    ranks run while JAX compiles."""
    tmp = tmp_path_factory.mktemp("spatial")
    root = generate_dataset(str(tmp / "d"), {"train": 4}, hw=64, temporal_len=64)
    batch = next(make_batches(NpzDataset(os.path.join(root, "train"), 64), 4)).as_dict()
    meta = np.concatenate([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], 1)
    np.savez(tmp / "batch.npz", **batch)
    models, variables = {}, {}
    for kind in ("unet", "unet++"):
        models[kind] = JaxUrbanPredictor(kind, base_filters=4, temporal_dim=4, meta_dim=4,
                                         lstm_dim=8, compute_dtype=jnp.float32)
        variables[kind] = jax.tree_util.tree_map(np.asarray, jax.jit(models[kind].init)(
            jax.random.PRNGKey(0), batch["maps"], batch["temp_series"], meta,
            batch["temp_lengths"]))
        torch.save(state_dict_from_jax(variables[kind]), tmp / f"{kind}.pt")

    def forward(name, kind, sp):
        return {"kind": "forward", "name": name, "grad": True, "spatial": sp,
                "state": str(tmp / f"{kind}.pt"), "batch": str(tmp / "batch.npz"),
                "model": MODEL if kind == "unet" else UNETPP}

    def step_task(name, sp):
        return {"kind": "step", "name": name, "spatial": sp, "state": str(tmp / "unet.pt"),
                "batch": str(tmp / "batch.npz"), "model": MODEL,
                "optimizer": ["sgd", 1e-2, 0.0, 0.0], "loss": "l1-gradient-ssim"}

    epoch_data = generate_dataset(str(tmp / "e"), {"train": 8, "val": 2, "test": 2}, hw=64,
                                  temporal_len=32)

    def epoch(name, sp):
        return {"kind": "epoch", "name": name, "spatial": sp, "data": epoch_data,
                "work": str(tmp / f"work_{name}"),
                "cfg": {**EPOCH_CFG, "spatial_parallel": sp}}

    plans = {2: [forward("fwd_1x2", "unet", 2), step_task("step_1x2", 2),
                 epoch("epoch_2x1", 1)],
             4: [forward("fwd_2x2", "unet", 2), forward("fwd_1x4", "unet", 4),
                 forward("fwd_pp_2x2", "unet++", 2), step_task("step_2x2", 2),
                 epoch("epoch_2x2", 2)]}
    clusters = {world: start_cluster(tmp, f"w{world}", world, tasks)
                for world, tasks in plans.items()}

    v, vg_unet = variables["unet"], _fwd_grad(models["unet"])
    out, grads = jax.device_get(vg_unet(v, jax.device_put(batch)))
    want = {"unet": {"single": (out, _torch_grads(grads, v))},
            "unet++": {"port": _port_forward_grad(tmp / "unet++.pt", UNETPP, batch)}}
    for dp, sp in JAX_MESHES:
        m = jax_mesh.make_mesh(data_parallel=dp, spatial_parallel=sp)
        shardings = jax_mesh.batch_shardings_for(m, batch, shard_spatial=True)
        sharded = {k: jax.device_put(x, shardings[k]) for k, x in batch.items()}
        out, grads = jax.device_get(vg_unet(
            jax.device_put(v, jax_mesh.replicated(m)), sharded))
        want["unet"][(dp, sp)] = (out, _torch_grads(grads, v))
    # One SGD step on a (4, 2) mesh with the rows sharded.
    tx = jax_optimizer("sgd", 1e-2, momentum=0.0)
    state = JaxState(params=v["params"], batch_stats=v["batch_stats"],
                     opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    step = make_train_step(models["unet"], jax_loss_fn("l1-gradient-ssim"), tx, donate=False)
    m = jax_mesh.make_mesh(data_parallel=4, spatial_parallel=2)
    shardings = jax_mesh.batch_shardings_for(m, batch, shard_spatial=True)
    sharded = {k: jax.device_put(x, shardings[k]) for k, x in batch.items()}
    new_state, metrics = step(jax.device_put(state, jax_mesh.replicated(m)), sharded)
    want["step"] = (state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, new_state.variables)), float(metrics["total"]))

    got = {}
    for world, tasks in plans.items():
        out = finish_cluster(clusters[world])
        for t in tasks:
            got[t["name"]] = [
                json.loads((out / f"{t['name']}_rank{r}.json").read_text())
                if t["kind"] == "epoch" else
                torch.load(out / f"{t['name']}_rank{r}.pt", weights_only=True)
                for r in range(world)]
    return want, got


def _assemble(ranks, dp: int, sp: int) -> np.ndarray:
    """The whole batch from the ranks' gathered outputs, the same bits on
    every rank of a data index, samples over the data index."""
    for d in range(dp):
        for s in range(1, sp):
            assert torch.equal(ranks[d * sp + s]["out"], ranks[d * sp]["out"])
    return np.concatenate([ranks[d * sp]["out"].numpy() for d in range(dp)], axis=0)


def _check_forward(ranks, dp, sp, references):
    out = _assemble(ranks, dp, sp)
    for label, (want_out, want_grads) in references.items():
        np.testing.assert_allclose(out, want_out, atol=1e-5, err_msg=f"{label} {dp}x{sp}")
        for r in ranks:
            assert sorted(r["grads"]) == sorted(want_grads)
            for k, g in want_grads.items():
                scale = max(1.0, float(np.max(np.abs(g))))
                np.testing.assert_allclose(r["grads"][k].numpy(), g, atol=2e-4 * scale,
                                           err_msg=f"{label} {dp}x{sp} {k}")


@pytest.mark.parametrize("dp,sp", LAYOUTS)
def test_sharded_forward_and_gradient_match_jax(recipe, dp, sp):
    want, got = recipe
    ranks = got[f"fwd_{dp}x{sp}"]
    assert [r["rows"] for r in ranks] == [[d * (4 // dp), (d + 1) * (4 // dp)]
                                          for d in range(dp) for _ in range(sp)]
    assert all(r["out"].shape[1] == 64 for r in ranks)
    _check_forward(ranks, dp, sp, want["unet"])


def test_sharded_unetpp_matches_unsharded(recipe):
    want, got = recipe
    _check_forward(got["fwd_pp_2x2"], 2, 2, want["unet++"])


@pytest.mark.parametrize("dp,sp", STEP_LAYOUTS)
def test_sharded_sgd_step_matches_jax_mesh_step(recipe, dp, sp):
    want, got = recipe
    state, loss = want["step"]
    ranks = got[f"step_{dp}x{sp}"]
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["total"], loss, rtol=1e-5)
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = ranks[0]["state_dict"][k]
        for r in ranks[1:]:
            torch.testing.assert_close(r["state_dict"][k], a, rtol=0, atol=0, msg=k)
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(v.abs().max()), err_msg=k)
        else:
            np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_spatial_trainer_epoch_meets_jax_2axis_checks(recipe):
    """JAX ``tests/test_multiprocess.py::_check_common`` on a 2 x 2 layout:
    the two ranks of a data index load the same rows, the data indices
    disjoint rows that cover the split; every rank ends with the same val
    loss, which rank 0's checkpoint, restored into a state of another seed,
    reproduces; and it is the (2, 1) run's within 1e-5."""
    _, got = recipe
    results, reference = got["epoch_2x2"], got["epoch_2x1"]
    global_batch, n_train, sp = EPOCH_CFG["batch_size"], 8, 2
    per_rank = global_batch // 2
    r0 = results[0]
    for r, res in enumerate(results):
        d = r // sp
        assert res["host_slice"] == [d * per_rank, (d + 1) * per_rank], res
        assert (res["data_parallel"], res["spatial_parallel"]) == (2, 2)
        assert res["best_val_loss"] == r0["best_val_loss"]
        assert res["val_restored"] == pytest.approx(res["best_val_loss"], rel=1e-6)
        assert res["restored_epoch"] == 0 and res["restored_step"] >= 1
        assert res["seen"] == results[d * sp]["seen"]
    assert r0["csv"] is True
    passes = [set(results[d * sp]["seen"][per_rank:]) for d in range(2)]
    for d in range(2):
        assert set(results[d * sp]["seen"][:per_rank]) == set(range(*results[d * sp]["host_slice"]))
    assert not passes[0] & passes[1] and passes[0] | passes[1] == set(range(n_train))
    assert all(r["spatial_parallel"] == 1 for r in reference)
    assert r0["best_val_loss"] == pytest.approx(reference[0]["best_val_loss"], rel=1e-5)
