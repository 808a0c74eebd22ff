"""The port's ``analysis/stats.py`` against the JAX package's, on
evaluation CSVs written by both packages' evaluators (32² tiles, T = 40,
base 4, 12 test samples): one ``.pth`` from the JAX exporter evaluated by
both, and two seeded port models (one without embeddings) by the port.
Rows, groups and winners are equal; every number, p-values included,
within 1e-12 (the same scipy calls on the same values)."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import maunet_tpu.analysis.stats as jax_stats
from maunet_tpu.config import Config
from maunet_tpu.evaluate.evaluator import evaluate_checkpoint as jax_evaluate_checkpoint

from maunet_tpu_torch.analysis import stats
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
from maunet_tpu_torch.models.factory import build_model
from maunet_tpu_torch.train.config import TrainConfig

from test_torch_eval_evaluator import T, _export

TOL = 1e-12


def _port_model(path, seed, embeddings):
    hp = {"model_type": "unet", "base_filters": 4, "temporal_dim": 4, "meta_dim": 6,
          "lstm_hidden": 8, "batch_size": 4, "temporal_embeddings": embeddings,
          "metadata_embeddings": embeddings, "metadata_input_length": 8}
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = build_model(hp)
    torch.save({"model_state_dict": model.state_dict(), "hyperparameters": hp,
                "model_type": "unet", "metadata_input_length": 8, "trial_id": seed}, path)
    return path


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats")
    data = generate_dataset(str(root / "data"), {"train": 5, "test": 12}, hw=32,
                            temporal_len=T, seed=8)
    kw = dict(data_dir=data, precision="float32")
    exported = _export(root, "unet", False)
    jax_evaluate_checkpoint(exported, Config().with_overrides(**{"dataset.temporal_length": T}),
                            study_name="a", output_dir=str(root / "jax"), **kw)
    cfg = TrainConfig(temporal_length=T)
    evaluate_checkpoint(exported, cfg, study_name="a", output_dir=str(root / "port"),
                        device="cpu", **kw)
    for study, seed, emb in (("b", 1, True), ("c", 2, False)):
        evaluate_checkpoint(_port_model(str(root / f"{study}.pth"), seed, emb), cfg,
                            study_name=study, output_dir=str(root / "port"), device="cpu",
                            **kw)
    port = sorted(os.path.join(root, "port", f) for f in os.listdir(root / "port")
                  if f.endswith("_evaluation.csv"))
    (jax_a,) = [os.path.join(root, "jax", f) for f in os.listdir(root / "jax")
                if f.endswith("_evaluation.csv")]
    assert [os.path.basename(p)[0] for p in port] == ["a", "b", "c"]
    return {"port": port, "jax_a": jax_a, "root": root}


def _same_frames(got, want):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=0, atol=TOL)


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert (np.isnan(v) and np.isnan(g[k])) or abs(g[k] - v) <= TOL, k
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("which", ["port_a", "jax_a", "port_c"])
def test_interpret_metrics_matches_jax(csvs, which, tmp_path):
    path = {"port_a": csvs["port"][0], "jax_a": csvs["jax_a"], "port_c": csvs["port"][2]}[which]
    got = stats.interpret_metrics(path, output_dir=str(tmp_path / "port"))
    want = jax_stats.interpret_metrics(path, output_dir=str(tmp_path / "jax"))
    assert got and {r["channel"] for r in got} == {"after_ndvi", "after_temp"}
    _same_rows(got, want)
    (name,) = os.listdir(tmp_path / "port")
    assert os.listdir(tmp_path / "jax") == [name] and name.endswith("_interpretation.csv")
    # A DataFrame in, with the model's name given, as the research app calls it.
    df = pd.read_csv(path)
    _same_rows(stats.interpret_metrics(df, "m"), jax_stats.interpret_metrics(df, "m"))


def test_comparative_analysis_matches_jax(csvs, tmp_path):
    for paths in (csvs["port"], [csvs["jax_a"], csvs["port"][1]]):
        got = stats.comparative_analysis(paths, output_dir=str(tmp_path / "port"))
        want = jax_stats.comparative_analysis(paths, output_dir=str(tmp_path / "jax"))
        assert not got.empty and (got["winner"] != "insignificant").any()
        _same_frames(got, want)
        assert list(got["winner"]) == list(want["winner"])
        read = [pd.read_csv(tmp_path / side / "comparative_ttests.csv")
                for side in ("port", "jax")]
        _same_frames(*read)
    names = ["x", "y", "z"]
    _same_frames(stats.comparative_analysis(csvs["port"], names),
                 jax_stats.comparative_analysis(csvs["port"], names))


def test_nonparametric_tests_match_jax(csvs):
    for paths in (csvs["port"], [csvs["jax_a"], csvs["port"][2]]):
        for metric in ("mae", "rmse"):
            got = stats.nonparametric_tests(paths, metric=metric)
            want = jax_stats.nonparametric_tests(paths, metric=metric)
            assert len(got) == len(paths) * (len(paths) - 1) // 2
            _same_frames(got, want)
            assert list(got["significant"]) == list(want["significant"])


@pytest.mark.parametrize("year", [2015, 2021, 2022, 2023, 2024, 2030])
def test_interpretation_helpers_match_jax(year):
    assert stats.get_temporal_distance(year) == jax_stats.get_temporal_distance(year)
    for channel, mae in (("after_temp", 1.0), ("after_temp", 3.0), ("after_temp", 5.0),
                         ("after_ndvi", 0.01), ("after_ndvi", 0.07), ("after_ndvi", 0.2),
                         ("other", 0.0)):
        assert stats.interpret_channel(channel, mae) == jax_stats.interpret_channel(channel, mae)
    for ratio in (0.1, 1.0, 2.0):
        assert stats.interpret_smoothness(ratio) == jax_stats.interpret_smoothness(ratio)
