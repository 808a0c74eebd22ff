"""The port's planner apps against the JAX package's: ``data/tiles.py``,
``apps/planner_core.py``, the cache readers of ``apps/gee_fetch.py``, the
headless fake and both ``run_planner``s side by side.

The pure functions are held bit for bit (both sides call cv2 and PIL).  The
two apps serve one ``.pth`` written by ``maunet_tpu.interop.torch_export``
(32², base 4, T = 64) through engines whose ``load_any_checkpoint`` is
patched to f32.  They differ by summation order only: the predicted NDVI
within 1e-5; the predicted LST within 3e-4 °C (2e-5 of the normalized
output, the f32 tolerance of ``test_torch_port_engine.py``, times temp_std
13.36), its change within twice that; the mean-ΔT metric within 1e-4 °C;
the rendered images within 1e-5, except the ΔLST view, which divides the
change by its largest magnitude and is held within 1e-4 (measured: 2e-4 °C
in the change, 3.1e-5 in the ΔLST view)."""

import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maunet_tpu.apps.gee_fetch as jax_gee_fetch
import maunet_tpu.apps.planner as jax_planner
import maunet_tpu.apps.planner_core as jax_core
import maunet_tpu.data.tiles as jax_tiles
import maunet_tpu.evaluate.evaluator as jax_evaluator
from maunet_tpu.apps.headless import run_planner as jax_run_planner
from maunet_tpu.interop.torch_export import export_torch_checkpoint
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor

import maunet_tpu_torch.apps.planner as planner
import maunet_tpu_torch.evaluate.checkpoint as checkpoint
from maunet_tpu_torch.apps import gee_fetch, planner_core
from maunet_tpu_torch.apps.engine import CANVAS_RGB
from maunet_tpu_torch.apps.headless import FakeStreamlit, run_planner
from maunet_tpu_torch.data import tiles

from test_torch_port_model import random_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, T = 32, 64
HP = {"model_type": "unet", "base_filters": 4, "temporal_dim": 4, "meta_dim": 6,
      "lstm_hidden": 8, "temporal_embeddings": True, "metadata_embeddings": True}
IMAGE_TOL = 1e-5       # display images in [0, 1]
DELTA_VIEW_TOL = 1e-4  # the ΔLST view, scaled by 1 / max|ΔLST|
LST_TOL = 3e-4         # predicted LST in °C
METRIC_TOL = 1e-4      # mean ΔT in °C


def _same_layers(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_views(got, want):
    assert [c for _, c in got] == [c for _, c in want]
    for (a, _), (b, _) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# data/tiles.py and the demo tiles
# ---------------------------------------------------------------------------

def test_demo_tiles_are_a_byte_equal_copy():
    with open(jax_core.DEMO_CACHE, "rb") as a, open(planner_core.DEMO_CACHE, "rb") as b:
        assert a.read() == b.read()
    assert planner_core.DEMO_CACHE != jax_core.DEMO_CACHE
    assert planner_core.DEMO_LOCATION == jax_core.DEMO_LOCATION


def test_tile_names_and_grouping_match_jax(tmp_path):
    names = ["rome_3_41.8990_12.4690_0.0100_-0.0200_2019_08_dw.npy",
             "rome_3_41.8990_12.4690_0.0100_-0.0200_2019_08_rgb.npy",
             "new_york_7_40.7128_-74.0060_0.0000_0.0000_2021_12_temp.npy",
             "notes.txt", "broken_name_dw.npy"]
    for n in names:
        np.save(tmp_path / n, np.zeros((2, 2), np.float32))
        assert tiles.parse_tile_filename(n) == jax_tiles.parse_tile_filename(n)
    assert tiles.group_files_by_location_and_time(str(tmp_path)) == \
        jax_tiles.group_files_by_location_and_time(str(tmp_path))


@pytest.mark.parametrize("shape", [(20, 20), (48, 40)])
def test_tile_readers_match_jax(tmp_path, shape):
    rng = np.random.default_rng(1)
    band = tmp_path / "band.npy"
    rgb = tmp_path / "rgb.npy"
    np.save(band, rng.uniform(0, 40, size=(1, 24, 30)).astype(np.float32))
    np.save(rgb, rng.uniform(0, 255, size=(3, 24, 30)).astype(np.float32))
    for nearest in (False, True):
        np.testing.assert_array_equal(
            tiles.load_and_resize_image(str(band), shape, nearest),
            jax_tiles.load_and_resize_image(str(band), shape, nearest))
    np.testing.assert_array_equal(tiles.load_and_resize_rgb(str(rgb), shape),
                                  jax_tiles.load_and_resize_rgb(str(rgb), shape))


# ---------------------------------------------------------------------------
# apps/planner_core.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("proj", "sa@x"), ("proj", None), (None, "sa@x"), ("", ""), ("proj", "", True)])
def test_resolve_data_mode_matches_jax(args):
    got, want = planner_core.resolve_data_mode(*args), jax_core.resolve_data_mode(*args)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("img_size", [32, 256, 512])
def test_load_demo_layers_matches_jax(img_size):
    got = planner_core.load_demo_layers(img_size)
    _same_layers(got, jax_core.load_demo_layers(img_size))
    assert got["dw"].shape == (img_size, img_size) and got["rgb"].shape == (3, img_size, img_size)


def test_canvas_background_and_views_match_jax():
    layers = planner_core.load_demo_layers(HW)
    got, want = (np.asarray(m.canvas_background(layers["dw"])) for m in (planner_core, jax_core))
    assert got.shape == (HW, HW, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    _same_views(planner_core.layer_views(layers), jax_core.layer_views(layers))

    rng = np.random.default_rng(2)
    ndvi, lst, base = rng.uniform(-1, 1, (HW, HW)), rng.uniform(20, 40, (HW, HW)), \
        rng.uniform(20, 40, (HW, HW))
    (views, delta), (jviews, jdelta) = (m.prediction_views(ndvi, lst, base)
                                        for m in (planner_core, jax_core))
    _same_views(views, jviews)
    assert delta == jdelta


def test_generate_demo_cache_matches_jax(tmp_path):
    got = planner_core.generate_demo_cache(str(tmp_path / "port" / "d.npz"), hw=32, seed=3)
    want = jax_core.generate_demo_cache(str(tmp_path / "jax" / "d.npz"), hw=32, seed=3)
    with np.load(got) as a, np.load(want) as b:
        _same_layers(dict(a), dict(b))


# ---------------------------------------------------------------------------
# the cache readers of apps/gee_fetch.py
# ---------------------------------------------------------------------------

def test_cache_readers_match_jax(tmp_path):
    _same_layers(gee_fetch.make_synthetic_cache(str(tmp_path / "port"), 24, seed=4),
                 jax_gee_fetch.make_synthetic_cache(str(tmp_path / "jax"), 24, seed=4))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    # The .npy files, read at another size (resized) and at their own.
    for size in (40, 24):
        _same_layers(gee_fetch.load_cached_layers(str(tmp_path / "port"), size),
                     jax_gee_fetch.load_cached_layers(str(tmp_path / "port"), size))
    # A cache without a layer falls back to the bundled demo tiles.
    os.remove(tmp_path / "port" / "fetched_temp.npy")
    got = gee_fetch.load_cached_layers(str(tmp_path / "port"), HW)
    _same_layers(got, jax_gee_fetch.load_cached_layers(str(tmp_path / "port"), HW))
    _same_layers(got, planner_core.load_demo_layers(HW))
    with pytest.raises(NotImplementedError, match="Earth Engine"):
        gee_fetch.get_satellite_data(41.9, 12.5, 2019, 8, str(tmp_path), HW)


# ---------------------------------------------------------------------------
# the headless fake
# ---------------------------------------------------------------------------

def test_fake_has_exactly_the_planners_surface():
    """Every ``st.*`` the planner calls exists on the fake; a misspelled one
    raises AttributeError (no catch-all)."""
    with open(planner.__file__) as f:
        used = set(re.findall(r"\bst\.(\w+)", f.read()))
    fake = FakeStreamlit()
    assert used and all(hasattr(fake, name) for name in used), used
    for misspelled in ("sucess", "subheader", "dataframe", "pyplot"):
        with pytest.raises(AttributeError):
            getattr(fake, misspelled)("x")
        with pytest.raises(AttributeError):
            getattr(fake.sidebar, misspelled)("x")


def test_planner_without_checkpoints_stops(tmp_path):
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "orbax_dir").mkdir()    # the port lists no directories
    st = run_planner(["--models-dir", str(tmp_path / "models"),
                      "--cache-dir", str(tmp_path / "cache"), "--device", "cpu"])
    assert any("No checkpoints" in str(e) for e in st.rendered("error"))
    assert not st.rendered("image")


# ---------------------------------------------------------------------------
# both apps side by side
# ---------------------------------------------------------------------------

class _JittedInit:
    def __init__(self, model):
        self.init = jax.jit(model.init)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    rng = np.random.default_rng(5)
    inputs = (rng.normal(size=(1, HW, HW, 23)).astype(np.float32),
              rng.normal(size=(1, T)).astype(np.float32),
              rng.normal(size=(1, 8)).astype(np.float32), np.array([T], np.int32))
    model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, base_filters=4,
                              temporal_dim=4, meta_dim=6, lstm_dim=8)
    root = tmp_path_factory.mktemp("planner") / "models"
    root.mkdir()
    export_torch_checkpoint(str(root / "m.pth"),
                            random_jax_variables(rng, _JittedInit(model), inputs), HP)
    return str(root)


def _canvas():
    """Trees painted over the left half; the rest undrawn."""
    rgba = np.zeros((HW, HW, 4), np.uint8)
    rgba[:, : HW // 2, :3] = CANVAS_RGB[1]
    rgba[:, : HW // 2, 3] = 255
    return rgba


def _run_both(models_dir, tmp_path, monkeypatch, answers):
    """Both apps on the same answers and canvas; the environment variables
    that the app writes are restored afterwards."""
    seen = {}
    monkeypatch.setenv("GEE_PROJECT_ID", "")
    monkeypatch.setenv("GEE_SERVICE_ACCOUNT", "")

    def recording(module, key):
        real = module.prediction_views

        def views(*a):
            out = real(*a)
            seen[key] = (*a, out[1])     # ndvi, lst, lst_base, mean ΔT
            return out
        monkeypatch.setattr(module, "prediction_views", views)

    recording(jax_planner, "jax")
    recording(planner, "port")
    monkeypatch.setattr(jax_evaluator, "load_any_checkpoint", functools.partial(
        jax_evaluator.load_any_checkpoint, compute_dtype=jnp.float32))
    monkeypatch.setattr(checkpoint, "load_any_checkpoint", functools.partial(
        checkpoint.load_any_checkpoint, compute_dtype=torch.float32))
    tail = ["--models-dir", models_dir, "--cache-dir", str(tmp_path / "cache"),
            "--img-size", str(HW), "--temporal-length", str(T)]
    want = jax_run_planner(tail, answers=answers, canvas_rgba=_canvas())
    got = run_planner(tail + ["--device", "cpu"], answers=answers, canvas_rgba=_canvas())
    return got, want, seen


def test_planner_matches_the_jax_planner(models_dir, tmp_path, monkeypatch):
    got, want, seen = _run_both(models_dir, tmp_path, monkeypatch,
                                {"Run Prediction": True})
    (ndvi, lst, base, delta), (j_ndvi, j_lst, j_base, j_delta) = seen["port"], seen["jax"]
    np.testing.assert_allclose(ndvi, j_ndvi, rtol=0, atol=IMAGE_TOL)
    np.testing.assert_allclose(lst, j_lst, rtol=0, atol=LST_TOL)
    np.testing.assert_allclose(lst - base, j_lst - j_base, rtol=0, atol=2 * LST_TOL)
    assert abs(delta - j_delta) <= METRIC_TOL and np.isfinite(delta)
    assert np.abs(lst - base).max() > 0           # the painted trees moved the LST
    assert got.rendered("title") == ["🌳 Urban Greening Planner (H100)"]
    assert any("cache-only" in str(w) for w in got.rendered("warning"))
    assert got.rendered("st_canvas") == ["canvas"] == want.rendered("st_canvas")
    images = [(args[0], kw["caption"]) for (_, m, args, kw) in got.calls if m == "image"]
    jax_images = [(args[0], kw["caption"]) for (_, m, args, kw) in want.calls if m == "image"]
    assert len(images) == len(jax_images) == 7
    for (a, cap), (b, jcap) in zip(images, jax_images):
        assert a.shape == b.shape and a.shape[:2] == (HW, HW)
        tol = DELTA_VIEW_TOL if jcap.startswith("ΔLST") else IMAGE_TOL
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=jcap)
        # the captions print ranges to 0.1 °C
        assert cap.split(" [")[0] == jcap.split(" [")[0]
    ((label, value, _),) = got.rendered("metric")
    assert "temperature" in label.lower() and value == f"{delta:+.2f} °C"
    # The non-default renders of the two runs are the same calls.
    strip = [(c, m) for (c, m, _a, _k) in got.calls]
    assert strip == [(c, m) for (c, m, _a, _k) in want.calls]


def test_live_mode_falls_back_to_the_demo_tiles(models_dir, tmp_path, monkeypatch):
    """With credentials the app tries the live fetch, which the port does not
    have; it then warns and serves the demo tiles, as the JAX app does where
    ``ee`` is missing."""
    answers = {"GEE Project ID": "p", "GEE Service Account": "sa@p"}
    got, want, _ = _run_both(models_dir, tmp_path, monkeypatch, answers)
    (warning,) = got.rendered("warning")
    assert "not ported" in warning and "bundled demo tiles" in warning
    assert len(want.rendered("warning")) == 1
    _same_layers(got.session_state.layers, want.session_state.layers)
    assert len(got.rendered("image")) == 4 and not got.rendered("metric")


def test_headless_command_renders_on_the_cpu(models_dir, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "maunet_tpu_torch.apps.headless", "planner",
         "--models-dir", models_dir, "--cache-dir", str(tmp_path / "cache"),
         "--img-size", str(HW), "--temporal-length", str(T), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "render calls, no AttributeErrors" in proc.stdout
