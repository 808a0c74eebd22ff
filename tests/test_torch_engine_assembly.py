"""The port's planner input assembly against the JAX package's, bit for bit.

The JAX engine searches every pixel's distance to each palette colour in
float64 and merges through ``np.where``; its stack is a float64 ``vstack`` of
``np.eye`` one-hots and the normalised layers, cast to f32 and viewed as NHWC.
The port's integer search and channel-by-channel assembly must give the same
bits, shapes, dtypes and strides, and a fresh array per call;
``PlannerEngine.canvas_colours_searched`` counts the distinct colours each
painted canvas's search ran over."""

import types

import numpy as np
import pytest
import torch
from maunet_tpu.apps.engine import PlannerEngine as JaxPlannerEngine
from maunet_tpu.apps.engine import canvas_to_dw_map as jax_canvas_to_dw_map
from test_torch_profiling_spans import HYPERPARAMS, cpu_profile, tiny_model

from maunet_tpu_torch.apps.engine import CANVAS_RGB, PlannerEngine, canvas_to_dw_map
from maunet_tpu_torch.utils import profiling

T = 16
ARGS = (41.9, 12.5, 2.8e6, 2023, 7, 2025, 7)
FIELDS = ("maps", "metadata", "temp_series", "temp_lengths")


def jax_prepare_input(engine, layers, canvas_rgba, *args):
    """The JAX engine's ``prepare_input`` on the port engine's settings."""
    settings = types.SimpleNamespace(
        stats=engine.stats, metadata_features=engine.metadata_features,
        temporal_length=engine.temporal_length, temp_query=engine.temp_query)
    return JaxPlannerEngine.prepare_input(settings, layers, canvas_rgba, *args)


class StubTempQuery:
    def query(self, lat, lon, year, month):
        return 20.0 + 5.0 * np.random.default_rng(int(abs(lat) * 100)).standard_normal(T - 3)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({"model_state_dict": tiny_model().state_dict(), "hyperparameters": HYPERPARAMS,
                "model_type": "unet", "metadata_input_length": 8, "trial_id": 0}, path)
    return PlannerEngine(path, device="cpu", temporal_length=T, img_size=256,
                         temp_query=StubTempQuery())


def tied_colours() -> np.ndarray:
    """Colours whose two nearest palette colours are at the same squared
    distance: the first in palette order must win."""
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 3)] * 3, indexing="ij"), -1).reshape(-1, 3)
    d = ((grid[:, None, :] - CANVAS_RGB[None].astype(np.int64)) ** 2).sum(-1)
    two = np.sort(d, 1)[:, :2]
    tied = grid[two[:, 0] == two[:, 1]]
    assert len(tied) >= 20
    return tied.astype(np.uint8)


def make_canvas(rng, side, kind):
    canvas = np.zeros((side, side, 4), np.uint8)
    if kind == "one":
        y, x = rng.integers(0, side // 2, 2)
        canvas[y:y + side // 3, x:x + side // 4, :3] = CANVAS_RGB[rng.integers(0, 9)]
        canvas[y:y + side // 3, x:x + side // 4, 3] = 255
    elif kind == "several":
        for k in range(9):
            y, x = rng.integers(0, side - side // 5, 2)
            canvas[y:y + side // 5, x:x + side // 6, :3] = CANVAS_RGB[k]
            canvas[y:y + side // 5, x:x + side // 6, 3] = rng.integers(1, 256)
    elif kind == "off_palette":
        canvas[...] = rng.integers(0, 256, canvas.shape)
        tied = tied_colours()
        rows = rng.integers(0, side, len(tied) * 4)
        canvas[rows[:len(tied)], rows[len(tied):2 * len(tied)], :3] = tied
        canvas[..., 3] *= rng.random((side, side)) < 0.7  # about 30% unpainted
    elif kind == "unpainted":
        # Colours under alpha == 0 must not reach the map.
        canvas[..., :3] = rng.integers(0, 256, (side, side, 3))
    return canvas


def make_layers(rng, side, dw_kind, rgb_dtype):
    dw = rng.integers(0, 9, (side, side))
    # Out-of-range classes: the one-hot clips them, unpainted pixels keep them cast to uint8.
    bad = rng.random((side, side)) < 0.02
    if dw_kind == "int":
        dw = np.where(bad, rng.choice([-3, -1, 9, 12, 300], (side, side)), dw)
    else:
        dw = np.where(bad, rng.choice([-2.5, -0.5, 8.7, 9.0, 17.25, 255.5], (side, side)),
                      dw + rng.uniform(0, 0.99, (side, side))).astype(np.float32)
    rgb = rng.uniform(0, 255, (3, side, side))
    rgb = np.rint(rgb).astype(np.uint8) if rgb_dtype == "uint8" else rgb.astype(rgb_dtype)
    return {"dw": dw, "rgb": rgb,
            "ndvi": rng.uniform(-1, 1, (side, side)).astype(np.float32),
            "temp": rng.uniform(10, 45, (side, side)).astype(np.float32)}


CASES = [
    (256, "one", "float32", "float32"),
    (512, "one", "float32", "float32"),
    (256, "several", "int", "uint8"),
    (512, "several", "float32", "float64"),
    (256, "off_palette", "float32", "uint8"),
    (256, "off_palette", "int", "float64"),
    (512, "off_palette", "int", "float32"),
    (256, "unpainted", "float32", "float32"),
    (256, "resized", "int", "float32"),
    (512, "resized", "float32", "uint8"),
]


@pytest.mark.parametrize("side,canvas_kind,dw_kind,rgb_dtype", CASES)
def test_prepare_input_matches_jax(engine, side, canvas_kind, dw_kind, rgb_dtype):
    rng = np.random.default_rng([side, CASES.index((side, canvas_kind, dw_kind, rgb_dtype))])
    layers = make_layers(rng, side, dw_kind, rgb_dtype)
    if canvas_kind == "resized":  # a canvas of another size, resized NEAREST
        canvas = make_canvas(rng, side // 2, "off_palette")
    else:
        canvas = make_canvas(rng, side, canvas_kind)
    for c in (None, canvas):
        got = engine.prepare_input(layers, c, *ARGS)
        want = jax_prepare_input(engine, layers, c, *ARGS)
        for field in FIELDS:
            g, w = getattr(got, field), getattr(want, field)
            assert (g.shape, g.dtype, g.strides) == (w.shape, w.dtype, w.strides), field
            assert np.array_equal(g, w), field
    # An NHWC view of a channel-major (23, H, W) f32 array, as the upload reads it.
    assert got.maps.shape == (1, side, side, 23) and got.maps.dtype == np.float32
    assert got.maps.strides == (0, side * 4, 4, side * side * 4)


def test_prepare_input_returns_fresh_arrays(engine):
    rng = np.random.default_rng(11)
    layers = make_layers(rng, 256, "float32", "float32")
    a, b = (engine.prepare_input(layers, None, *ARGS) for _ in range(2))
    assert not np.shares_memory(a.maps, b.maps)
    a.maps[...] = 0
    assert np.array_equal(b.maps, jax_prepare_input(engine, layers, None, *ARGS).maps)


@pytest.mark.parametrize("side,canvas_kind", [(256, "one"), (256, "several"),
                                              (256, "off_palette"), (512, "off_palette"),
                                              (256, "unpainted"), (256, "full")])
def test_canvas_to_dw_map_matches_jax(side, canvas_kind):
    rng = np.random.default_rng([side, len(canvas_kind)])
    if canvas_kind == "full":  # every colour of a random canvas, ties added
        canvas = rng.integers(0, 256, (side, side, 4)).astype(np.uint8)
        tied = tied_colours()
        canvas.reshape(-1, 4)[:len(tied), :3] = tied
    else:
        canvas = make_canvas(rng, side, canvas_kind)
    dw = rng.integers(0, 9, (side, side))
    for original in (None, dw, dw.astype(np.uint8), dw[None].astype(np.float32)):
        got = canvas_to_dw_map(canvas, (side, side), original_map=original)
        want = jax_canvas_to_dw_map(canvas, (side, side), original_map=original)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)


def painted_colours(canvas):
    return len(np.unique(canvas[canvas[..., 3] > 0][:, :3], axis=0))


@pytest.mark.parametrize("canvas_kind", ["one", "several", "off_palette", "unpainted"])
def test_canvas_colours_searched_counts_painted_colours(engine, canvas_kind):
    rng = np.random.default_rng(len(canvas_kind))
    layers = make_layers(rng, 256, "float32", "float32")
    canvas = make_canvas(rng, 256, canvas_kind)
    want = painted_colours(canvas)
    assert want == {"one": 1, "several": 9, "unpainted": 0}.get(canvas_kind, want)
    before = PlannerEngine.canvas_colours_searched
    engine.prepare_input(layers, None, *ARGS)
    assert PlannerEngine.canvas_colours_searched == before
    profiling.clear()
    with cpu_profile():
        engine.prepare_input(layers, canvas, *ARGS)
        engine.prepare_input(layers, None, *ARGS)
    assert PlannerEngine.canvas_colours_searched - before == want
    _, tallies = profiling.recorded()
    assert [(t.name, t.n) for t in tallies] == [("PlannerEngine.canvas_colours_searched", want)]
