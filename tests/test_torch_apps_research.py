"""The port's research app (``apps/research.py``) against the JAX package's,
page by page, through both headless harnesses on the same answers
(``tests/test_headless_apps.py``'s research tests, run on both apps).

Every page's frames are held equal: both apps run the same pandas and scipy
calls on the same CSVs.  The model browser serves one ``.pth`` written by
``maunet_tpu.interop.torch_export`` (32², base 4, T = 64) through loaders
patched to f32; its two predicted maps (NDVI, and LST normalized) are held
within 2e-5, the f32 tolerance of ``test_torch_port_engine.py``, since the
two forwards differ by summation order only.  Its ``Parameters`` metric, the
interactive diagram's HTML and the text diagram are held equal."""

import functools
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import maunet_tpu.evaluate.evaluator as jax_evaluator
from maunet_tpu.apps.headless import run_research_page as jax_run_research_page
from maunet_tpu.data.synthetic import generate_dataset
from maunet_tpu.interop.torch_export import export_torch_checkpoint
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor

import maunet_tpu_torch.evaluate.checkpoint as checkpoint
import maunet_tpu_torch.evaluate.evaluator as evaluator
from maunet_tpu_torch.apps import research
from maunet_tpu_torch.apps.headless import FakeStreamlit, run_research_page

from test_headless_apps import _write_eval_csv
from test_torch_port_model import random_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, T = 32, 64
HP = {"model_type": "unet", "base_filters": 4, "temporal_dim": 4, "meta_dim": 6,
      "lstm_hidden": 8, "temporal_embeddings": True, "metadata_embeddings": True}
F32_TOL = 2e-5
CKPT = "Checkpoint path (.pth or orbax dir)"
PREDICT = "Predict a test sample (zoomed quadrants)"


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("reports")
    _write_eval_csv(root / "metaemb_evaluation.csv", rng, bias=0.0)
    _write_eval_csv(root / "noemb_evaluation.csv", rng, bias=0.5)
    return str(root)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("research_data")),
                            {"train": 2, "test": 2}, hw=HW, temporal_len=T)


class _JittedInit:
    def __init__(self, model):
        self.init = jax.jit(model.init)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    rng = np.random.default_rng(5)
    inputs = (rng.normal(size=(1, HW, HW, 23)).astype(np.float32),
              rng.normal(size=(1, T)).astype(np.float32),
              rng.normal(size=(1, 8)).astype(np.float32), np.array([T], np.int32))
    model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, base_filters=4,
                              temporal_dim=4, meta_dim=6, lstm_dim=8)
    path = str(tmp_path_factory.mktemp("research_ckpt") / "m.pth")
    export_torch_checkpoint(path, random_jax_variables(rng, _JittedInit(model), inputs), HP)
    return path


def _both(page, argv, answers=None):
    """The JAX app's page, then the port's on the CPU."""
    want = jax_run_research_page(page, argv, answers=answers)
    got = run_research_page(page, argv + ["--device", "cpu"], answers=answers)
    return got, want


def _same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, pd.Series):
            pd.testing.assert_series_equal(a, b)
        else:
            pd.testing.assert_frame_equal(a, b)


def _calls(st):
    return [(c, m) for (c, m, _a, _k) in st.calls]


def test_comparison_page_matches_jax(reports):
    got, want = _both("Model comparison", ["--reports-dir", reports])
    assert got.rendered("header") == ["Model comparison"]
    (df,) = got.rendered("dataframe")
    assert {"metaemb", "noemb"} == set(df.index)
    _same_frames(got.rendered("dataframe"), want.rendered("dataframe"))
    assert _calls(got) == _calls(want)


def test_analysis_page_matches_jax(reports):
    got, want = _both("Evaluation analysis", ["--reports-dir", reports],
                      answers={"Channel": "after_temp"})
    assert got.rendered("metric") == want.rendered("metric")
    assert {m[0] for m in got.rendered("metric")} == {"MAE", "RMSE", "Samples"}
    for method in ("bar_chart", "line_chart", "dataframe"):
        _same_frames(got.rendered(method), want.rendered(method))
        assert len(got.rendered(method)) == 1
    assert _calls(got) == _calls(want)


def test_statistics_page_matches_jax(reports):
    got, want = _both("Statistical comparison", ["--reports-dir", reports],
                      answers={"Runs to compare": ["metaemb", "noemb"], "Metric": "rmse"})
    tt, nonparametric = got.rendered("dataframe")
    assert not tt.empty and (tt["winner"] == "metaemb").all() and not nonparametric.empty
    _same_frames(got.rendered("dataframe"), want.rendered("dataframe"))
    assert len(got.rendered("pyplot")) == len(want.rendered("pyplot")) == 2
    assert _calls(got) == _calls(want)


def test_statistics_page_needs_two_runs(reports):
    got, want = _both("Statistical comparison", ["--reports-dir", reports],
                      answers={"Runs to compare": ["metaemb"]})
    assert got.rendered("info") == want.rendered("info") == ["Pick at least two runs."]


def test_dataset_page_matches_jax(data):
    got, want = _both("Dataset map", ["--data-dir", data])
    (counts,) = got.rendered("dataframe")
    assert counts.sum() == 4
    _same_frames(got.rendered("dataframe"), want.rendered("dataframe"))
    _same_frames(got.rendered("map"), want.rendered("map"))
    assert len(got.rendered("pyplot")) == 1 and _calls(got) == _calls(want)


def test_interpretation_page_matches_jax(reports):
    got, want = _both("Metric interpretation", ["--reports-dir", reports],
                      answers={"Run": "noemb"})
    (df,) = got.rendered("dataframe")
    assert "quality" in df.columns
    _same_frames(got.rendered("dataframe"), want.rendered("dataframe"))


@pytest.fixture()
def predictions(monkeypatch):
    """Both apps' loaders in f32, and what each ``predict_batch`` returned."""
    seen = {}

    def recording(module, key):
        real = module.predict_batch

        def predict_batch(loaded, batch):
            out = real(loaded, batch)
            seen[key] = (np.asarray(out), batch)
            return out
        monkeypatch.setattr(module, "predict_batch", predict_batch)

    recording(jax_evaluator, "jax")
    recording(evaluator, "port")
    monkeypatch.setattr(jax_evaluator, "load_any_checkpoint", functools.partial(
        jax_evaluator.load_any_checkpoint, compute_dtype=jnp.float32))
    monkeypatch.setattr(checkpoint, "load_any_checkpoint", functools.partial(
        checkpoint.load_any_checkpoint, compute_dtype=torch.float32))
    return seen


def test_model_browser_matches_jax(pth, data, predictions):
    got, want = _both("Model browser", ["--data-dir", data], {CKPT: pth, PREDICT: True})
    (preds, batch), (jax_preds, jax_batch) = predictions["port"], predictions["jax"]
    assert preds.shape == (1, HW, HW, 2) and np.isfinite(preds).all()
    np.testing.assert_array_equal(batch.maps, jax_batch.maps)
    np.testing.assert_allclose(preds, jax_preds, rtol=0, atol=F32_TOL)
    ((label, value, _),) = got.rendered("metric")
    n = sum(p.numel() for p in checkpoint.load_any_checkpoint(pth, device="cpu").model.parameters())
    assert label == "Parameters" and value == f"{n:,}"
    assert got.rendered("metric") == want.rendered("metric")
    assert got.rendered("json") == want.rendered("json")
    assert got.rendered("text") == want.rendered("text")
    (html,) = got.rendered("components_html")
    assert html == want.rendered("components_html")[0] and "conv0_0" in html
    # The static architecture figure and the two zoomed-quadrant figures.
    assert len(got.rendered("pyplot")) == len(want.rendered("pyplot")) == 3
    assert not got.rendered("info") and _calls(got) == _calls(want)


def test_model_browser_without_matplotlib(pth, data, predictions, monkeypatch):
    """Where matplotlib is absent (the GPU host), each figure is one info
    line and the prediction still runs; the other pages draw nothing and say
    so likewise."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    st = run_research_page("Model browser", ["--data-dir", data, "--device", "cpu"],
                           {CKPT: pth, PREDICT: True})
    assert "port" in predictions and np.isfinite(predictions["port"][0]).all()
    assert not st.rendered("pyplot") and len(st.rendered("components_html")) == 1
    assert st.rendered("info") == [
        f"{what}: not drawn, matplotlib not installed"
        for what in ("Static architecture figure", "Zoomed NDVI quadrants",
                     "Zoomed LST quadrants")]
    assert st.rendered("metric")[0][0] == "Parameters"


def test_other_pages_without_matplotlib(reports, data, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    stats = run_research_page("Statistical comparison", ["--reports-dir", reports],
                              {"Runs to compare": ["metaemb", "noemb"]})
    assert len(stats.rendered("dataframe")) == 2 and not stats.rendered("pyplot")
    missing = "matplotlib" if importlib.util.find_spec("seaborn") else "matplotlib and seaborn"
    assert stats.rendered("info") == [
        f"{what}: not drawn, {missing} not installed" for what in
        ("Pairwise significance matrix", "Sample-wise error correlation")]
    dataset = run_research_page("Dataset map", ["--data-dir", data])
    assert dataset.rendered("info") == [
        "Dataset geo-distribution figure: not drawn, matplotlib not installed"]
    assert dataset.rendered("map") and not dataset.rendered("pyplot")


def test_model_browser_refuses_what_is_not_a_pth(tmp_path):
    st = run_research_page("Model browser", ["--device", "cpu"], {CKPT: str(tmp_path)})
    (error,) = st.rendered("error")
    assert "orbax" in error and not st.rendered("metric")


def test_main_routes_every_page(reports, data):
    for page in research.PAGES:
        argv = ["--reports-dir", reports, "--data-dir", data]
        got, want = _both("main", argv, answers={"Page": page})
        assert got.rendered("set_page_config") == ["MAUNet Research"]
        assert got.rendered("header") == want.rendered("header") and got.rendered("header")
        assert _calls(got) == _calls(want), page


def test_fake_has_the_research_apps_surface():
    """Every ``st.*`` the research app calls exists on the fake; a call that
    streamlit lacks raises AttributeError (no catch-all)."""
    with open(research.__file__) as f:
        used = set(re.findall(r"\bst\.(\w+)", f.read()))
    fake = FakeStreamlit()
    assert {"multiselect", "pyplot", "components"} <= used
    assert all(hasattr(fake, name) for name in used), used
    for misspelled in ("textinput", "dataframes", "plot", "sucess"):
        with pytest.raises(AttributeError):
            getattr(fake, misspelled)("x")
        with pytest.raises(AttributeError):
            getattr(fake.sidebar, misspelled)("x")


def test_headless_research_command_on_the_cpu(reports, data, pth):
    proc = subprocess.run(
        [sys.executable, "-m", "maunet_tpu_torch.apps.headless", "research",
         "--reports-dir", reports, "--data-dir", data, "--checkpoint", pth, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == len(research.PAGES)
    assert all("render calls, no AttributeErrors" in line for line in lines)
