"""The PyTorch port's PlannerEngine against the JAX PlannerEngine, and the
numpy pieces the port carries copies of against their JAX originals.

JAX variables are exported to a reference ``.pth`` with
``maunet_tpu.interop.torch_export.export_torch_checkpoint``; both engines load
that file (bf16 compute, ``batch_max`` LSTM masking, as for any ``.pth``) and
serve the same requests at 32².  The requests carry raw years (about 2000)
in their metadata, as the reference app builds them, so with random weights
the model's outputs reach magnitude 2.5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.apps.engine import DEFAULT_SERVING_STATS as JAX_SERVING_STATS
from maunet_tpu.apps.engine import PlannerEngine as JaxPlannerEngine
from maunet_tpu.evaluate.evaluator import load_any_checkpoint as jax_load
from maunet_tpu.interop.torch_export import export_torch_checkpoint
from maunet_tpu.interop.torch_import import infer_hyperparams as jax_infer_hyperparams
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from test_torch_port_model import random_jax_variables

from maunet_tpu_torch.apps.engine import CANVAS_RGB, DEFAULT_SERVING_STATS, PlannerEngine
from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
from maunet_tpu_torch.interop.torch_import import infer_hyperparams
from maunet_tpu_torch.models.factory import build_model

HW, T = 32, 64
# bf16 engines against each other: the large metadata embedding is rounded to
# bf16 at other points in the two frameworks (measured: at most 0.07 on
# normalized outputs of magnitude 2.5).
BF16_TOL = 0.15
# f32: summation order only (measured: at most 5e-6 at magnitude 2.5).
F32_TOL = 2e-5
HP = {"model_type": "unet", "base_filters": 8, "temporal_dim": 8, "meta_dim": 8,
      "lstm_hidden": 8, "temporal_embeddings": True, "metadata_embeddings": True}


class StubTempQuery:
    """Seeded CRU series, shorter than the engine's length south of 0°."""

    def query(self, lat, lon, year, month):
        rng = np.random.default_rng(int(abs(lat) * 100))
        return 20.0 + 5.0 * rng.standard_normal(T if lat >= 0 else 40)


def _layers(rng):
    return {"dw": rng.integers(0, 9, size=(HW, HW)).astype(np.float32),
            "rgb": rng.uniform(0, 255, size=(3, HW, HW)).astype(np.float32),
            "ndvi": rng.uniform(-1, 1, size=(HW, HW)).astype(np.float32),
            "temp": rng.uniform(10, 45, size=(HW, HW)).astype(np.float32)}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(3)
    inputs = (rng.normal(size=(1, HW, HW, 23)).astype(np.float32),
              rng.normal(size=(1, T)).astype(np.float32),
              rng.normal(size=(1, 8)).astype(np.float32), np.array([T], np.int32))
    model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, base_filters=8,
                              temporal_dim=8, meta_dim=8, lstm_dim=8)
    path = str(tmp_path_factory.mktemp("ckpt") / "unet.pth")
    export_torch_checkpoint(path, random_jax_variables(rng, model, inputs), HP)
    kw = dict(temp_query=StubTempQuery(), temporal_length=T)
    return (JaxPlannerEngine(path, img_size=HW, **kw),
            PlannerEngine(path, device="cpu", **kw), path)


def _requests(engine, seed):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((HW, HW, 4), np.uint8)
    canvas[8:24, 8:24, :3] = CANVAS_RGB[1]
    canvas[8:24, 8:24, 3] = 255
    args = (2_800_000, 2023, 7, 2025, 7)
    return [engine.prepare_input(_layers(rng), None, 41.9, 12.5, *args),
            engine.prepare_input(_layers(rng), canvas, 41.9, 12.5, *args),
            engine.prepare_input(_layers(rng), None, -23.5, -46.6, *args)]


def _assert_close(jax_out, port_out, temp_std):
    (nd_j, lst_j), (nd_p, lst_p) = jax_out, port_out
    assert nd_p.shape == lst_p.shape == (HW, HW)
    assert np.abs(nd_p).max() <= 1.0 and np.isfinite(lst_p).all()
    np.testing.assert_allclose(nd_p, nd_j, atol=BF16_TOL)
    # LST leaves the model normalized; the engine scales it to °C.
    np.testing.assert_allclose(lst_p, lst_j, atol=BF16_TOL * temp_std)


def test_prepare_input_matches_jax(engines):
    jax_engine, port_engine, _ = engines
    for a, b in zip(_requests(jax_engine, 0), _requests(port_engine, 0)):
        for field in ("maps", "metadata", "temp_series", "temp_lengths"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field))


def test_predict_matches_jax(engines):
    jax_engine, port_engine, _ = engines
    reqs = _requests(port_engine, 1)
    outs = []
    for inp in reqs:
        port_out = port_engine.predict(inp)
        _assert_close(jax_engine.predict(inp), port_out, port_engine.stats.temp_std)
        outs.append(port_out)
    cooling = port_engine.cooling_metric(outs[0][1], outs[1][1])
    assert np.isfinite(cooling)


def test_predict_many_matches_jax(engines):
    jax_engine, port_engine, _ = engines
    reqs = _requests(port_engine, 2)
    many = port_engine.predict_many(reqs)
    assert len(many) == len(reqs)
    for jax_out, port_out in zip(jax_engine.predict_many(reqs), many):
        _assert_close(jax_out, port_out, port_engine.stats.temp_std)


def test_loaded_model_matches_jax_f32(engines):
    """Both loaders' models in f32 on one batch of engine requests."""
    _, port_engine, path = engines
    reqs = _requests(port_engine, 3)
    batch = [np.concatenate([getattr(r, f) for r in reqs])
             for f in ("maps", "temp_series", "metadata", "temp_lengths")]
    jax_loaded = jax_load(path, compute_dtype=jnp.float32)
    ref = np.asarray(jax_loaded.model.apply(jax_loaded.variables, *batch))
    port_loaded = load_any_checkpoint(path, compute_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        got = port_loaded.model(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in batch)).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_TOL)


def test_carried_stats_match_jax(tmp_path):
    """The port's copies of NormalizationStats and the serving defaults read
    what the JAX package writes."""
    path = str(tmp_path / "normalization_metrics.json")
    JAX_SERVING_STATS.to_json(path)
    want = dataclasses.asdict(JAX_SERVING_STATS)
    assert dataclasses.asdict(NormalizationStats.from_json(path)) == want
    assert dataclasses.asdict(DEFAULT_SERVING_STATS) == want


@pytest.mark.parametrize("prefix", ["model.", ""])
@pytest.mark.parametrize("checkpoint,study_name", [
    ({}, ""),
    ({"hyperparameters": {"temporal_embeddings": False, "metadata_embeddings": True,
                          "base_filters": 4}}, ""),
    ({"study_name": "s-noemb", "metadata_only_embeddings": True}, ""),
    ({"additional_embeddings": False, "metadata_input_length": 8}, "run"),
    ({"model_type": "unet++"}, "noemb"),
])
def test_carried_infer_hyperparams_matches_jax(prefix, checkpoint, study_name):
    """The port's copy of infer_hyperparams and resolve_embedding_flags
    against the JAX originals, on one state_dict with and without the
    ``model.`` prefix and on each generation of embedding flags."""
    sd = build_model({"base_filters": 4, "temporal_dim": 4, "meta_dim": 6,
                      "lstm_hidden": 8}).state_dict()
    sd = {prefix + k[len("model."):]: v for k, v in sd.items()}
    assert (infer_hyperparams(sd, checkpoint, study_name)
            == jax_infer_hyperparams(sd, checkpoint, study_name))


def test_engine_keeps_img_size(engines):
    jax_engine, _, path = engines
    port = PlannerEngine(path, device="cpu", img_size=HW)
    assert port.img_size == jax_engine.img_size == HW
    assert PlannerEngine(path, device="cpu").img_size == 512
