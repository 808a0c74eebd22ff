"""The port's sensitivity sweeps against the JAX package's: one ``.pth``
written by the JAX exporter (32² tiles, base 4, T = 40), one synthetic split
of 8 test samples over 6 cities and one evaluation CSV; both packages'
sweeps in f32 on the CPU (each sweep module's ``load_any_checkpoint``
patched to load at f32: the JAX sweep loads at bf16 and offers no switch).
Sample selection, labels, ``x`` arrays and keys must be equal, and every
mean and std within 1e-5 + 1e-5·max|value| of its channel."""

import csv
import functools
import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import maunet_tpu.analysis.sensitivity as jax_sensitivity
from maunet_tpu.analysis.compare import compare_sensitivity as jax_compare_sensitivity
from maunet_tpu.analysis.gt_sensitivity import run_gt_sensitivity as jax_run_gt_sensitivity
from maunet_tpu.config import Config
from maunet_tpu.evaluate.evaluator import load_any_checkpoint as jax_load_any_checkpoint

import maunet_tpu_torch.analysis.sensitivity as sensitivity
from maunet_tpu_torch.analysis.compare import compare_sensitivity
from maunet_tpu_torch.analysis.gt_sensitivity import run_gt_sensitivity
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
from maunet_tpu_torch.train.config import TrainConfig

from test_torch_eval_evaluator import T, _export

MAX_SAMPLES = 7       # 6 highlighted (one per city) and 1 of the other 2, seeded


def _close(got, want):
    """Every number of two sweep exports within 1e-5 + 1e-5·max|value| of
    its channel; keys, labels and x arrays equal."""
    assert got.keys() == want.keys()
    assert (got["model_name"], got["model_type"]) == (want["model_name"], want["model_type"])
    for sweep in want["sweeps"]:
        assert got["sweeps"][sweep]["x"] == want["sweeps"][sweep]["x"]
        for ch, curves in want["sweeps"][sweep]["channels"].items():
            scale = max(abs(v) for v in curves["mean"])
            for key in ("mean", "std"):
                np.testing.assert_allclose(got["sweeps"][sweep]["channels"][ch][key],
                                           curves[key], rtol=0, atol=1e-5 + 1e-5 * scale)
    assert got["heatmaps"].keys() == want["heatmaps"].keys()
    for idx, hm in want["heatmaps"].items():
        mine = got["heatmaps"][idx]
        assert (mine["sample_label"], mine["orig_lat"], mine["orig_lon"]) == (
            hm["sample_label"], hm["orig_lat"], hm["orig_lon"])
        for ch, data in hm["channels"].items():
            scale = float(np.abs(data["values"]).max())
            assert (mine["channels"][ch]["lats"], mine["channels"][ch]["lons"]) == (
                data["lats"], data["lons"])
            np.testing.assert_allclose(mine["channels"][ch]["values"], data["values"],
                                       rtol=0, atol=1e-5 + 1e-5 * scale)


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Data, checkpoint, evaluation CSV, and both packages' exports."""
    root = tmp_path_factory.mktemp("sens")
    data = generate_dataset(str(root / "data"), {"train": 5, "test": 8}, hw=32,
                            temporal_len=T, seed=11)
    ckpt = _export(root, "unet", False)
    evaluate_checkpoint(ckpt, TrainConfig(temporal_length=T), data_dir=data,
                        study_name="s", output_dir=str(root / "eval"),
                        precision="float32", device="cpu")
    eval_csv = str(root / "eval" / "s_unet_emb_7_job_evaluation.csv")
    out = {"data": data, "ckpt": ckpt, "csv": eval_csv,
           "jax": str(root / "jax"), "port": str(root / "port")}
    jax_cfg = Config().with_overrides(**{"dataset.temporal_length": T})
    port_cfg = TrainConfig(temporal_length=T)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sensitivity, "load_any_checkpoint",
                   functools.partial(jax_load_any_checkpoint, compute_dtype=jnp.float32))
        mp.setattr(sensitivity, "load_any_checkpoint",
                   functools.partial(load_any_checkpoint, compute_dtype=torch.float32))
        out["jax_meta"] = jax_sensitivity.run_sensitivity(
            ckpt, eval_csv, jax_cfg, data_dir=data, output_dir=out["jax"],
            max_samples=MAX_SAMPLES, make_plots=False)
        out["jax_temporal"] = jax_sensitivity.run_temporal_sensitivity(
            ckpt, eval_csv, jax_cfg, data_dir=data, output_dir=out["jax"], max_samples=MAX_SAMPLES)
        out["port_meta"] = sensitivity.run_sensitivity(
            ckpt, eval_csv, port_cfg, data_dir=data, output_dir=out["port"],
            max_samples=MAX_SAMPLES, make_plots=False, device="cpu")
        out["port_temporal"] = sensitivity.run_temporal_sensitivity(
            ckpt, eval_csv, port_cfg, data_dir=data, output_dir=out["port"],
            max_samples=MAX_SAMPLES, device="cpu")
    return out


def test_metadata_sweep_matches_jax(case):
    assert os.path.basename(case["port_meta"]) == os.path.basename(case["jax_meta"]) \
        == "sensitivity_data_emb.json"
    got, want = _load(case["port_meta"]), _load(case["jax_meta"])
    assert len(want["heatmaps"]) == 6
    assert all(len(c["mean"]) == 50 for s in want["sweeps"].values()
               for c in s["channels"].values())
    _close(got, want)


def test_temporal_sweep_matches_jax(case):
    assert os.path.basename(case["port_temporal"]) == os.path.basename(
        case["jax_temporal"]) == "sensitivity_data_temporal_emb.json"
    got, want = _load(case["port_temporal"]), _load(case["jax_temporal"])
    assert list(want["sweeps"]) == ["temporal_offset"] and not want["heatmaps"]
    _close(got, want)
    # The offsets move the LST response: the series reaches the output.
    lst = np.asarray(got["sweeps"]["temporal_offset"]["channels"]["after_temp"]["mean"])
    assert np.ptp(lst) > 0


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _hand_made_rows(n_samples, nan_at=()):
    """Evaluation rows of ``n_samples`` samples over 7 cities with distinct
    RMSEs, in a scrambled sample order; NaN (an empty field) at the samples
    of ``nan_at``."""
    rng = np.random.default_rng(3)
    order = rng.permutation(n_samples)
    rmses = rng.permutation(np.arange(1, 2 * n_samples + 1)) / 7.0
    rows = []
    for k, idx in enumerate(order):
        for c, channel in enumerate(("after_ndvi", "after_temp")):
            rmse = "" if idx in nan_at else repr(float(rmses[2 * k + c]))
            rows.append({"sample_idx": int(idx), "channel": channel, "dw_class": "overall",
                         "mae": "0.5", "rmse": rmse, "city": f"city{idx % 7}"})
            rows.append({"sample_idx": int(idx), "channel": channel, "dw_class": "trees",
                         "mae": "0.1", "rmse": "9.0", "city": f"city{idx % 7}"})
    return rows


@pytest.mark.parametrize("n_samples,max_samples,nan_at", [
    (40, 12, ()),          # more samples than max_samples: the seeded subsample
    (25, 1000, (4, 11)),   # NaN RMSEs: skipped in city means, sorted last
    (9, 1000, (0, 7)),     # a city whose every RMSE is NaN sorts last of all
])
def test_select_samples_matches_jax(tmp_path, n_samples, max_samples, nan_at):
    path = str(tmp_path / "eval.csv")
    _write_csv(path, _hand_made_rows(n_samples, nan_at))
    got = sensitivity.select_samples(sensitivity.read_eval_csv(path), max_samples, seed=5)
    want = jax_sensitivity.select_samples(pd.read_csv(path), max_samples, seed=5)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(got[0]) == min(n_samples, max_samples)
    # The labels' mean RMSE skips NaN, as pandas' mean does (which sums in
    # another order: the last bit may differ; the label prints three digits).
    for idx in got[1]:
        rows = [r for r in got[3] if r["sample_idx"] == idx]
        want_mean = want[3][want[3]["sample_idx"] == idx]["rmse"].mean()
        got_mean = sensitivity._nanmean([r["rmse"] for r in rows])
        assert (math.isnan(got_mean) and math.isnan(want_mean)) or math.isclose(
            got_mean, want_mean, rel_tol=1e-12)
        assert str(rows[0]["city"]).title() == str(
            want[3][want[3]["sample_idx"] == idx].iloc[0]["city"]).title()


def _tied_rows(seed):
    """Rows of 40 cities whose RMSEs take three values, so city means tie;
    one city has 24 samples, so its own rows tie past numpy's 16-element
    insertion sort.  Sample order and city order scrambled."""
    rng = np.random.default_rng(seed)
    rows, idx = [], 0
    for city in rng.permutation(40):
        for _ in range(24 if city == 0 else int(rng.integers(1, 3))):
            rmse = repr(float(rng.choice([1.5, 2.5, 3.5])))
            for channel in ("after_ndvi", "after_temp"):
                rows.append({"sample_idx": idx, "channel": channel, "dw_class": "overall",
                             "mae": "0.5", "rmse": rmse, "city": f"city{city:02d}"})
            idx += 1
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_samples_matches_jax_on_tied_rmses(tmp_path, seed):
    """Equal RMSEs over more than 16 cities (and 16 rows of one city) pick
    the samples pandas' unstable default sort picks, not a stable sort's."""
    path = str(tmp_path / "eval.csv")
    _write_csv(path, _tied_rows(seed))
    got = sensitivity.select_samples(sensitivity.read_eval_csv(path), 1000, seed=5)
    want = jax_sensitivity.select_samples(pd.read_csv(path), 1000, seed=5)
    assert got[:3] == want[:3]
    assert sensitivity._pandas_order([2.0, 1.0, math.nan, 1.0]) == [1, 3, 0, 2]


@pytest.fixture(scope="module")
def two_sample_csv(case, tmp_path_factory):
    """The evaluation CSV cut to two samples of two cities, both highlighted."""
    with open(case["csv"], newline="") as f:
        rows = list(csv.DictReader(f))
    first = {}                      # city -> its first sample
    for r in rows:
        first.setdefault(r["city"], r["sample_idx"])
    keep = sorted(first.values(), key=int)[:2]
    rows = [r for r in rows if r["sample_idx"] in keep]
    path = str(tmp_path_factory.mktemp("two") / "eval.csv")
    _write_csv(path, rows)
    return path


def test_rows_do_not_depend_on_the_chunk_size(case, two_sample_csv, tmp_path, monkeypatch):
    monkeypatch.setattr(sensitivity, "load_any_checkpoint",
                        functools.partial(load_any_checkpoint, compute_dtype=torch.float32))
    forwards = []
    real = sensitivity.Sweeper.means

    def counting(self, maps, *args):
        forwards.append(maps.shape[0])
        assert maps.is_contiguous()
        return real(self, maps, *args)

    monkeypatch.setattr(sensitivity.Sweeper, "means", counting)
    paths = {}
    for chunk in (50, 7):
        monkeypatch.setattr(sensitivity, "VARIANT_CHUNK", chunk)
        forwards.clear()
        paths[chunk] = sensitivity.run_sensitivity(
            case["ckpt"], two_sample_csv, TrainConfig(temporal_length=T),
            data_dir=case["data"], output_dir=str(tmp_path / str(chunk)),
            make_plots=False, device="cpu")
        # Per sample: the latitude and longitude sweeps and the 400-point heatmap.
        per_sample = [-(-n // chunk) for n in (50, 50, 400)]
        assert len(forwards) == 2 * sum(per_sample) and max(forwards) == min(chunk, 50)
    got, want = _load(paths[7]), _load(paths[50])
    assert len(want["heatmaps"]) == 2
    _close(got, want)


def test_json_is_written_before_the_plots(case, two_sample_csv, tmp_path, monkeypatch):
    """Without matplotlib the sweep raises after the JSON is on disk."""
    monkeypatch.setattr(sensitivity, "load_any_checkpoint",
                        functools.partial(load_any_checkpoint, compute_dtype=torch.float32))
    monkeypatch.setattr(sensitivity, "HEAT_STEPS", 2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        sensitivity.run_sensitivity(case["ckpt"], two_sample_csv, TrainConfig(temporal_length=T),
                                    data_dir=case["data"], output_dir=str(tmp_path),
                                    device="cpu")
    assert os.listdir(tmp_path) == ["sensitivity_data_emb.json"]


def test_gt_sensitivity_matches_jax(case, tmp_path):
    got = run_gt_sensitivity(TrainConfig(temporal_length=T), data_dir=case["data"],
                             output_dir=str(tmp_path / "port"))
    want = jax_run_gt_sensitivity(Config().with_overrides(**{"dataset.temporal_length": T}),
                                  data_dir=case["data"], output_dir=str(tmp_path / "jax"))
    with open(got) as a, open(want) as b:
        text = a.read()
        assert text == b.read()
    assert "NaN" in text and os.path.basename(got) == "sensitivity_data_ground_truth.json"


def test_compare_sensitivity_writes_the_jax_figures(case, tmp_path):
    """Both packages' comparison over the port's metadata, temporal and
    ground-truth exports writes the same figures."""
    run_gt_sensitivity(TrainConfig(temporal_length=T), data_dir=case["data"],
                       output_dir=case["port"])
    got = compare_sensitivity(case["port"], output_dir=str(tmp_path / "port"))
    want = jax_compare_sensitivity(case["port"], output_dir=str(tmp_path / "jax"))
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want]
    assert "compare_temporal_offset_after_temp.pdf" in names
    assert "avg_heatmap_emb_after_ndvi.pdf" in names
    assert all(os.path.getsize(p) > 0 for p in got)
