"""Data-parallel inference of the PyTorch port against the JAX package's.

The counterparts of JAX ``tests/test_parallel_infer.py`` on meshes of CPU
devices (a mesh may name one device several times; each entry gets its own
replica of the model): the sharded forward of both families against JAX's
``shard_batch_fn`` over its 4x2 mesh of virtual devices (Pallas kernels in
interpret mode, as there), ``make_sharded_forward_fn``'s metadata concat,
``round_up_to_mesh``, ``evaluate_checkpoint(use_mesh=True)`` against the
unsharded call, and ``predict_many`` of 7 requests over a mesh of two
entries (padded to 8) against the unsharded call.  The forwards run in f32,
where the port and JAX agree to 1e-5 (``test_torch_port_model.py``'s
tolerance).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.ops.pallas import packed_vgg as jax_pvgg
from maunet_tpu.parallel import infer as jax_infer
from maunet_tpu.parallel import mesh as jax_mesh

from maunet_tpu_torch.apps.engine import PlannerEngine, PlannerInput
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.models import UrbanPredictor
from maunet_tpu_torch.parallel import infer
from maunet_tpu_torch.parallel.mesh import make_mesh
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.steps import forward_fn

from test_torch_eval_evaluator import SPLITS, T, _export

TOL = 1e-5
KW = dict(base_filters=16, temporal_dim=8, meta_dim=8, lstm_dim=8)


def _inputs(rng, b=8, hw=64, t=24):
    return (rng.normal(size=(b, hw, hw, 23)).astype(np.float32),
            rng.normal(size=(b, t)).astype(np.float32),
            rng.normal(size=(b, 8)).astype(np.float32),
            rng.integers(1, t, size=(b,)).astype(np.int32))


def _port_model(model_type, variables):
    model = UrbanPredictor(model_type, compute_dtype=torch.float32, **KW).eval()
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables)),
                          strict=True)
    return model


@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_sharded_forward_matches_jax_sharded_forward(model_type, monkeypatch):
    """JAX's model as its own test builds it (lane-packed, the fused Pallas
    rows in interpret mode) over the 4x2 mesh flattened; the port's over a
    mesh of 8 entries of the CPU, one sample each."""
    monkeypatch.setattr(jax_pvgg, "INTERPRET", True)
    jmodel = JaxUrbanPredictor(model_type, compute_dtype=jnp.float32, pack_lanes=True,
                               pack_min_s=2, **KW)
    maps, series, meta, lengths = _inputs(np.random.default_rng(0))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), maps, series, meta, lengths)
    batch = {"maps": maps, "temp_series": series, "metadata": meta, "temp_lengths": lengths}

    def fwd(variables, batch):
        return jmodel.apply(variables, batch["maps"], batch["temp_series"], batch["metadata"],
                            batch["temp_lengths"])

    want = np.asarray(jax_infer.shard_batch_fn(fwd, jax_mesh.make_mesh(4, 2))(variables, batch))

    model = _port_model(model_type, variables)
    mesh = make_mesh(devices=["cpu"] * 8)

    def port_fwd(replica, b):
        with torch.inference_mode():
            return replica(b["maps"], b["temp_series"], b["metadata"], b["temp_lengths"])

    sharded = infer.shard_batch_fn(port_fwd, mesh)
    got = sharded(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == want.shape == (8, 64, 64, 2) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    whole = port_fwd(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=TOL)


def test_sharded_forward_fn_concats_metadata_and_keeps_its_replicas(monkeypatch):
    jmodel = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, **KW)
    maps, series, meta, lengths = _inputs(np.random.default_rng(1), hw=32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), maps, series, meta, lengths)
    batch = {"maps": maps, "temp_series": series, "metadata": meta[:, :4],
             "temp_lengths": lengths, "t1_dates": meta[:, 4:6], "t2_dates": meta[:, 6:8]}
    want = np.asarray(jax_infer.make_sharded_forward_fn(jmodel, 8, jax_mesh.make_mesh(8, 1))(
        variables, batch))

    model = _port_model("unet", variables)
    copies = []
    replicate = infer.replicate
    monkeypatch.setattr(infer, "replicate",
                        lambda m, mesh: copies.append(mesh.size) or replicate(m, mesh))
    forward = infer.make_sharded_forward_fn(model, 8, make_mesh(devices=["cpu"] * 4))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = forward(tensors)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    with torch.inference_mode():
        np.testing.assert_allclose(got.numpy(), forward_fn(model, tensors, 8).numpy(), atol=TOL)
    torch.testing.assert_close(forward(tensors), got, rtol=0, atol=0)
    assert copies == [4]                     # made at the first call only
    with pytest.raises(ValueError, match="round_up_to_mesh"):
        forward({k: v[:6] for k, v in tensors.items()})


def test_round_up_to_mesh():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8, "spatial": 1} and mesh.size == 8
    assert infer.round_up_to_mesh(1, mesh) == 8
    assert infer.round_up_to_mesh(8, mesh) == 8
    assert infer.round_up_to_mesh(9, mesh) == 16
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="needs 5 devices"):
        make_mesh(5, devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("pinfer") / "data"), SPLITS,
                            hw=32, temporal_len=T, seed=5)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("pinfer_ckpt"), "unet", False)


def _rows(output_dir):
    name = next(f for f in os.listdir(output_dir) if f.endswith("_evaluation.csv"))
    with open(os.path.join(output_dir, name), newline="") as f:
        return list(csv.reader(f))


def test_evaluate_checkpoint_use_mesh(checkpoint, data_root, tmp_path):
    """Batch size 3 rounds up to 4 over two entries: 6 test samples in two
    batches, the second padded.  A mesh of one entry writes the unsharded
    call's bytes.  One of two entries writes the same rows, the numbers
    within rtol 1e-4 (JAX's test's tolerance): the checkpoint's LSTM runs
    each sample to its batch's longest series, and the shards keep the whole
    batch's, but a half batch's Laplacian variance can round otherwise on
    the CPU (measured: 7.6e-8 relative, in one value)."""
    kw = dict(cfg=TrainConfig(temporal_length=T), data_dir=data_root, study_name="mesh",
              precision="float32", batch_size=3, device="cpu")
    evaluate_checkpoint(checkpoint, output_dir=str(tmp_path / "single"), **kw)
    evaluate_checkpoint(checkpoint, output_dir=str(tmp_path / "one"), use_mesh=True, **kw)
    evaluate_checkpoint(checkpoint, output_dir=str(tmp_path / "two"),
                        mesh=make_mesh(devices=["cpu", "cpu"]), **kw)
    single = _rows(tmp_path / "single")
    assert len(single) > 1 + 6 * 2
    assert _rows(tmp_path / "one") == single
    two = _rows(tmp_path / "two")
    header = single[0]
    numeric = [header.index(c) for c in ("mae", "rmse", "laplacian_var_pred",
                                         "laplacian_var_gt")]
    assert len(two) == len(single) and two[0] == header
    for a, b in zip(two[1:], single[1:]):
        assert [v for i, v in enumerate(a) if i not in numeric] == \
            [v for i, v in enumerate(b) if i not in numeric]
        for i in numeric:
            assert (a[i] == "") == (b[i] == "")
            if b[i]:
                np.testing.assert_allclose(float(a[i]), float(b[i]), rtol=1e-4,
                                           err_msg=header[i])


def test_engine_predict_many_over_a_mesh(checkpoint):
    """7 requests over a mesh of two entries pad to 8; the pad row is
    dropped, and the answers are the unsharded call's."""
    rng = np.random.default_rng(3)
    inputs = [PlannerInput(maps=rng.normal(size=(1, 32, 32, 23)).astype(np.float32),
                           metadata=rng.normal(size=(1, 8)).astype(np.float32),
                           temp_series=rng.normal(size=(1, T)).astype(np.float32),
                           temp_lengths=np.array([length], np.int32))
              for length in (T, 1, 9, 20, 33, 2, 39)]
    engine = PlannerEngine(checkpoint, device="cpu", temporal_length=T,
                           mesh=make_mesh(devices=["cpu", "cpu"]))
    single = PlannerEngine(checkpoint, device="cpu", temporal_length=T)
    many, want = engine.predict_many(inputs), single.predict_many(inputs)
    assert len(many) == len(want) == 7
    for (ndvi, lst), (ndvi1, lst1) in zip(many, want):
        assert ndvi.shape == lst.shape == (32, 32)
        np.testing.assert_array_equal(ndvi, ndvi1)
        np.testing.assert_array_equal(lst, lst1)


def test_cli_evaluate_use_mesh(checkpoint, data_root, tmp_path):
    """``maunet-torch evaluate --use-mesh`` on the CPU: a mesh of the one
    device, the unsharded call's bytes."""
    from maunet_tpu_torch import cli

    common = [checkpoint, "--data-dir", data_root, "--device", "cpu", "--precision",
              "float32", "--n-visualize", "0", "-o", f"dataset.temporal_length={T}"]
    assert cli.main(["evaluate", *common, "--output-dir", str(tmp_path / "plain")]) == 0
    assert cli.main(["evaluate", *common, "--use-mesh",
                     "--output-dir", str(tmp_path / "mesh")]) == 0
    assert _rows(tmp_path / "mesh") == _rows(tmp_path / "plain")
