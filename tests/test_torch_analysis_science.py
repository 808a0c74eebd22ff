"""The port's science loop at a miniature size on the CPU (32² tiles,
T = 32, base 4, 16/4/8 samples, one epoch per variant): the artifacts that
``tests/test_science.py`` asks of the JAX loop, a summary with the key
structure of the committed run (``reports/science/summary.json``), and the
helpers that turn sweeps and statistics into the summary and the report,
against the JAX package's on the same inputs.  The JAX loop itself is not
run.  matplotlib is blocked for the loop, as on the GPU host: the sweeps
write their JSONs only and the comparison is skipped, each with a logged
line (``test_torch_analysis_sensitivity.py`` draws the comparison)."""

import glob
import json
import logging
import os
import sys

import numpy as np
import pandas as pd
import pytest

import maunet_tpu.analysis.science as jax_science

from maunet_tpu_torch import cli
from maunet_tpu_torch.analysis import science
from maunet_tpu_torch.train.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _structure(value):
    """The nested key structure of a summary; lists and leaves as their kind."""
    if isinstance(value, dict):
        return {k: _structure(v) for k, v in value.items()}
    return type(value).__name__ if not isinstance(value, (int, float)) else "number"


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("science") / "science")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(science.__name__)
    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        summary = science.run_science_loop(
            work_dir=work, hw=32, temporal_len=32, base_filters=4, batch_size=4,
            epochs=1, samples={"train": 16, "val": 4, "test": 8},
            meta_signal=1.0, temporal_signal=0.5, device="cpu")
    logger.removeHandler(handler)
    logger.setLevel(level)
    return work, summary, records


def test_science_loop_writes_the_jax_artifacts(loop):
    work, summary, records = loop
    assert set(summary["variants"]) == {"noemb", "tempemb", "metaemb", "emb"}
    for row in summary["variants"].values():
        assert np.isfinite(row["lst_mae_c"]) and np.isfinite(row["ndvi_mae"])
        assert row["checkpoint"].endswith(".pth") and os.path.exists(row["checkpoint"])
    assert sorted(summary["lst_mae_ranking"]) == sorted(summary["variants"])
    assert len(glob.glob(f"{work}/tests/*_evaluation.csv")) == 4
    assert os.path.exists(f"{work}/comparative_ttests.csv")
    assert os.path.exists(f"{work}/nonparametric_tests.csv")
    names = sorted(os.path.basename(p)
                   for p in glob.glob(f"{work}/sensitivity/sensitivity_data_*.json"))
    assert names == ["sensitivity_data_emb.json", "sensitivity_data_ground_truth.json",
                     "sensitivity_data_noemb.json", "sensitivity_data_temporal_noemb.json",
                     "sensitivity_data_temporal_tempemb.json"]
    with open(f"{work}/REPORT.md") as f:
        report = f.read()
    assert "LST MAE" in report and "noemb" in report and "Temporal sweep" in report
    sens = summary["sensitivity"]
    for key in ("emb_lat_response", "noemb_lat_response", "gt_lat_response"):
        assert np.isfinite(sens[key]["slope_per_degree"])
    for key in ("tempemb_temporal_response", "noemb_temporal_response"):
        assert np.isfinite(sens[key]["slope_per_zunit"])
    assert sens["expected_temporal_slope_c_per_zunit"] > 0
    ttests = pd.read_csv(f"{work}/comparative_ttests.csv")
    assert {"model_1", "model_2", "winner"} <= set(ttests.columns)
    with open(f"{work}/summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    # Without matplotlib: no figure, no comparison, and a line for each.
    assert not glob.glob(f"{work}/sensitivity/*.pdf")
    assert not os.path.exists(f"{work}/sensitivity/comparison")
    assert any("JSONs only" in r for r in records)
    assert any("compare_sensitivity is skipped" in r for r in records)


def test_summary_has_the_committed_runs_structure(loop):
    _, summary, _ = loop
    with open(os.path.join(REPO, "reports", "science", "summary.json")) as f:
        committed = json.load(f)
    got, want = _structure(summary), _structure(committed)
    assert got == want


def test_sweep_response_and_report_match_jax(loop, tmp_path):
    work, summary, _ = loop
    sens = f"{work}/sensitivity"
    for name, sweep, slope in (("emb", "latitude", "slope_per_degree"),
                               ("ground_truth", "latitude", "slope_per_degree"),
                               ("temporal_tempemb", "temporal_offset", "slope_per_zunit"),
                               ("noemb", "longitude", "x")):
        path = f"{sens}/sensitivity_data_{name}.json"
        assert science._sweep_response(path, sweep, slope) == \
            jax_science._sweep_response(path, sweep, slope)
    # A flat curve and one with fewer than three finite bins.
    flat = str(tmp_path / "flat.json")
    with open(flat, "w") as f:
        json.dump({"sweeps": {"s": {"x": [0, 1, 2, 3], "channels": {"after_temp": {
            "mean": [1.0, 1.0, float("nan"), 1.0]}}}}}, f)
    assert science._sweep_response(flat, "s", "k") == jax_science._sweep_response(flat, "s", "k")
    ttests = pd.read_csv(f"{work}/comparative_ttests.csv")
    nonpar = pd.read_csv(f"{work}/nonparametric_tests.csv")
    science._write_report(summary, ttests, nonpar, str(tmp_path / "port.md"))
    jax_science._write_report(summary, ttests, nonpar, str(tmp_path / "jax.md"))
    with open(tmp_path / "port.md") as a, open(tmp_path / "jax.md") as b:
        assert a.read() == b.read()


def test_science_config_matches_jax():
    for temporal, metadata in science.VARIANTS.values():
        got = science._science_config(temporal, metadata, 64, 828, 16, 8, 64)
        want = jax_science._science_config(temporal, metadata, 64, 828, 16, 8, 64)
        t = want.training
        assert got == TrainConfig(
            batch_size=t.batch_size, base_filters=t.base_filters, temporal_dim=t.temporal_dim,
            meta_dim=t.meta_dim, lstm_hidden=t.lstm_hidden, learning_rate=t.learning_rate,
            weight_decay=t.weight_decay, optimizer=t.optimizer,
            gradient_clipping=t.gradient_clipping, loss=t.loss, epochs=t.epochs,
            temporal_embeddings=t.temporal_embeddings,
            metadata_embeddings=t.metadata_embeddings,
            temporal_length=want.dataset.temporal_length, seed=want.seed,
            frequency_plt=want.logging.frequency_plt)
    assert science.VARIANTS == jax_science.VARIANTS


def test_cli_stats_and_science_loop(loop, monkeypatch, tmp_path):
    work, _, _ = loop
    csvs = sorted(glob.glob(f"{work}/tests/*_evaluation.csv"))
    assert cli.main(["stats", *csvs, "--output-dir", str(tmp_path / "many")]) == 0
    assert os.listdir(tmp_path / "many") == ["comparative_ttests.csv"]
    assert cli.main(["stats", csvs[0], "--output-dir", str(tmp_path / "one")]) == 0
    (name,) = os.listdir(tmp_path / "one")
    assert name.endswith("_interpretation.csv")
    calls = []
    monkeypatch.setattr(science, "run_science_loop", lambda **kw: calls.append(kw))
    assert cli.main(["science-loop", "--work-dir", "w", "--device", "cpu"]) == 0
    assert cli.main(["science-loop"]) == 0
    assert calls == [{"work_dir": "w", "hw": 64, "epochs": 6, "device": "cpu"},
                     {"work_dir": "reports/science", "hw": 64, "epochs": 6,
                      "device": "cuda"}]
