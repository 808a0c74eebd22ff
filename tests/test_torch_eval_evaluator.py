"""The PyTorch port's evaluator against the JAX package's: one ``.pth``
written by ``maunet_tpu.interop.torch_export``, one synthetic split (32²
tiles, T = 40, base 4, 6 test samples in batches of 4, so the last batch is
padded), both ``evaluate_checkpoint``s in f32 on the CPU."""

import csv
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from maunet_tpu.config import Config
from maunet_tpu.evaluate.evaluator import evaluate_checkpoint as jax_evaluate_checkpoint
from maunet_tpu.interop.torch_export import export_torch_checkpoint
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor

from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
from maunet_tpu_torch.data.shards import pack_dataset
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.evaluate import evaluator
from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
from maunet_tpu_torch.evaluate.evaluator import (
    evaluate_checkpoint,
    known_cities_from_train_dir,
    predict_batch,
    write_csv,
)
from maunet_tpu_torch.train.config import TrainConfig

from test_torch_port_model import random_jax_variables

T = 40
SPLITS = {"train": 5, "test": 6}
HP = {"batch_size": 4, "temporal_dim": 4, "meta_dim": 6, "lstm_hidden": 8,
      "base_filters": 4, "temporal_embeddings": True, "metadata_embeddings": True}
NUMERIC = ("mae", "rmse", "laplacian_var_pred", "laplacian_var_gt", "lat", "lon")
COLUMNS = ["sample_idx", "channel", "dw_class", "mae", "rmse", "laplacian_var_pred",
           "laplacian_var_gt", "is_known_city", "t1_year", "t1_month", "t2_year",
           "t2_month", "time_delta", "city", "lat", "lon"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("eval") / "data"), SPLITS,
                            hw=32, temporal_len=T, seed=5)


class _JittedInit:
    def __init__(self, model):
        self.init = jax.jit(model.init)


def _export(tmp_path, model_type, ds):
    """A checkpoint with random weights and BatchNorm statistics, written by
    the JAX package's exporter."""
    rng = np.random.default_rng(7)
    inputs = (rng.normal(size=(2, 32, 32, 23)).astype(np.float32),
              rng.normal(size=(2, T)).astype(np.float32),
              rng.normal(size=(2, 8)).astype(np.float32), np.array([T, 9], np.int32))
    model = JaxUrbanPredictor(model_type, temporal_dim=4, meta_dim=6, lstm_dim=8,
                              base_filters=4, deep_supervision=ds,
                              compute_dtype=jnp.float32)
    variables = random_jax_variables(rng, _JittedInit(model), inputs)
    path = str(tmp_path / "model.pth")
    export_torch_checkpoint(path, variables,
                            {**HP, "model_type": model_type, "deep_supervision": ds},
                            study_name="exported", trial_id=7)
    return path


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("model_type,ds", [("unet", False), ("unet++", True)])
def test_evaluators_write_matching_csvs(data_root, tmp_path, model_type, ds):
    path = _export(tmp_path, model_type, ds)
    name = f"t_{model_type}_emb_7_job42_evaluation.csv"
    kw = dict(data_dir=data_root, study_name="t", jobid="42", n_visualize=1,
              precision="float32")
    jax_evaluate_checkpoint(path, Config().with_overrides(**{"dataset.temporal_length": T}),
                            output_dir=str(tmp_path / "jax"), **kw)
    rows = evaluate_checkpoint(path, TrainConfig(temporal_length=T),
                               output_dir=str(tmp_path / "port"), device="cpu", **kw)

    want, got = _read(tmp_path / "jax" / name), _read(tmp_path / "port" / name)
    assert got[0] == want[0] == COLUMNS
    assert len(got) == len(want) == len(rows) + 1
    for line, (g, w) in enumerate(zip(got[1:], want[1:]), start=2):
        for col, a, b in zip(COLUMNS, g, w):
            if col in NUMERIC and a != "" and b != "":
                assert math.isclose(float(a), float(b), rel_tol=1e-4, abs_tol=1e-7), (line, col)
            else:
                assert a == b, (line, col)      # names, dates, flags, empty cells
    # What the rows must hold: six samples (the padded tail dropped), two
    # overall rows each, class rows only for present classes, known cities.
    assert sorted({r["sample_idx"] for r in rows}) == list(range(6))
    overall = [r for r in rows if r["dw_class"] == "overall"]
    assert len(overall) == 12 and all(math.isfinite(r["mae"]) for r in overall)
    assert all(r["laplacian_var_pred"] is None for r in rows if r["dw_class"] != "overall")
    ds_test = NpzDataset(os.path.join(data_root, "test"), T)
    classes0 = set(np.argmax(ds_test[0]["maps"][..., :9], -1).ravel())
    assert {r["dw_class"] for r in rows if r["sample_idx"] == 0} - {"overall"} == {
        evaluator.DW_CLASSES[int(k)] for k in classes0}
    known = known_cities_from_train_dir(os.path.join(data_root, "train"))
    assert known and all(r["is_known_city"] == (r["city"] in known) for r in rows)

    info = name.replace("_evaluation.csv", "_info.csv")
    got_info, want_info = _read(tmp_path / "port" / info), _read(tmp_path / "jax" / info)
    assert got_info[0] == want_info[0]
    assert got_info[1][1:] == want_info[1][1:] == ["emb", "t", "7", model_type]
    assert got_info[1][0] == str(tmp_path / "port" / name)
    for side in ("port", "jax"):
        assert len(os.listdir(tmp_path / side / "visualizations")) == 1
    assert os.listdir(tmp_path / "port" / "visualizations") == os.listdir(
        tmp_path / "jax" / "visualizations")


@pytest.fixture(scope="module")
def unet_checkpoint(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("ckpt"), "unet", False)


def test_visuals_count_valid_samples_and_batches_in_flight_are_bounded(
        data_root, unet_checkpoint, tmp_path, monkeypatch):
    """Five figures from six samples in batches of four: both batches keep
    their images, the padded tail draws nothing, and with one batch allowed
    in flight the first batch is fetched before the third is dispatched."""
    import maunet_tpu_torch.evaluate.visualize as visualize

    events, drawn = [], []
    real_metrics, real_to_host = evaluator.batch_metrics, evaluator._to_host

    def spy_metrics(*a, **k):
        events.append("dispatch")
        return real_metrics(*a, **k)

    def spy_to_host(tree):
        if isinstance(tree, dict) and "mae" in tree:
            events.append("fetch")
        return real_to_host(tree)

    monkeypatch.setattr(evaluator, "batch_metrics", spy_metrics)
    monkeypatch.setattr(evaluator, "_to_host", spy_to_host)
    monkeypatch.setattr(evaluator, "MAX_IN_FLIGHT", 1)
    monkeypatch.setattr(visualize, "plot_evaluation_sample",
                        lambda *a, **k: drawn.append(a[9]))
    rows = evaluate_checkpoint(unet_checkpoint, TrainConfig(temporal_length=T),
                               data_dir=data_root, n_visualize=5, batch_size=2,
                               output_dir=str(tmp_path), precision="float32", device="cpu")
    assert drawn == [0, 1, 2, 3, 4]
    assert events == ["dispatch", "dispatch", "fetch", "dispatch", "fetch", "fetch"]
    assert len({r["sample_idx"] for r in rows}) == 6

    drawn.clear()
    evaluate_checkpoint(unet_checkpoint, TrainConfig(temporal_length=T), data_dir=data_root,
                        n_visualize=5, batch_size=4, output_dir=str(tmp_path),
                        precision="float32", device="cpu")
    assert drawn == [0, 1, 2, 3, 4]        # the second batch's two valid samples: one drawn


def test_predict_batch_is_the_models_forward(data_root, unet_checkpoint):
    loaded = load_any_checkpoint(unet_checkpoint, compute_dtype=torch.float32, device="cpu")
    batch = next(make_batches(NpzDataset(os.path.join(data_root, "test"), T), 4))
    got = predict_batch(loaded, batch)
    meta = np.concatenate([batch.metadata, batch.t1_dates, batch.t2_dates], 1)
    with torch.inference_mode():
        want = loaded.model(*(torch.from_numpy(a) for a in (
            batch.maps, batch.temp_series, meta, batch.temp_lengths)))
    assert got.shape == (4, 32, 32, 2)
    np.testing.assert_array_equal(got, want.numpy())


def test_known_cities_reads_a_shard_index_and_sharded_splits_are_refused(
        data_root, unet_checkpoint, tmp_path):
    """Known cities come from a packed train split's index; a packed test
    split is refused where it holds a shorter series than the evaluator asks
    for (one of the right length is read: test_packed_split_writes_the_same_csv)."""
    train = tmp_path / "data" / "train"
    train.mkdir(parents=True)
    names = os.listdir(os.path.join(data_root, "train"))
    (train / evaluator.SHARD_INDEX_FILE).write_text(json.dumps({"names": names[:2]}))
    want = known_cities_from_train_dir(os.path.join(data_root, "train"))
    got = known_cities_from_train_dir(str(train))
    assert got and got <= want
    assert known_cities_from_train_dir(str(tmp_path / "missing")) == set()
    pack_dataset(os.path.join(data_root, "test"), str(tmp_path / "data" / "test"),
                 shard_size=4, temporal_length=T // 2)
    with pytest.raises(ValueError, match="exceeds packed length"):
        evaluate_checkpoint(unet_checkpoint, TrainConfig(temporal_length=T),
                            data_dir=str(tmp_path / "data"),
                            output_dir=str(tmp_path / "out"), device="cpu")
    with pytest.raises(ValueError, match="data_dir"):
        evaluate_checkpoint(unet_checkpoint, device="cpu")


def test_packed_split_writes_the_same_csv(data_root, unet_checkpoint, tmp_path):
    """``evaluate_checkpoint`` reads a packed test split (and a packed train
    split's index for the known cities) and writes the per-sample split's CSV."""
    packed = tmp_path / "packed"
    for split in SPLITS:
        pack_dataset(os.path.join(data_root, split), str(packed / split), shard_size=4,
                     temporal_length=T)
    shutil.copy(os.path.join(data_root, "normalization_metrics.json"), packed)
    name = "t_unet_emb_7_job1_evaluation.csv"
    for root, out in ((data_root, "flat"), (str(packed), "packed")):
        evaluate_checkpoint(unet_checkpoint, TrainConfig(temporal_length=T), data_dir=root,
                            study_name="t", jobid="1", batch_size=4,
                            output_dir=str(tmp_path / out), precision="float32", device="cpu")
    flat = (tmp_path / "flat" / name).read_text()
    assert (tmp_path / "packed" / name).read_text() == flat and flat.count("\n") > 12


def test_write_csv_writes_what_pandas_writes(tmp_path):
    rows = [
        {"sample_idx": 0, "channel": "after_ndvi", "dw_class": "overall",
         "mae": float(np.float32(0.1234567)), "lap": 1e-12, "known": True,
         "city": "San, Jose", "lat": -0.18},
        {"sample_idx": 1, "channel": "after_temp", "dw_class": "water",
         "mae": float("nan"), "lap": None, "known": False, "city": 'Quo"te', "lat": 41.9},
        {"sample_idx": 2, "channel": "after_temp", "dw_class": "trees",
         "mae": 3.0, "lap": 2.5e20, "known": False, "city": "Rome", "lat": 45.0,
         "extra": "late column"},
    ]
    write_csv(str(tmp_path / "ours.csv"), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "pandas.csv").read_text()
