"""The port's EDA tools and research figures (``analysis/eda.py``,
``figures.py``, ``tile_viz.py`` and ``maunet-torch eda``) against the JAX
package's, on one synthetic dataset (32², T = 64), two evaluation CSVs and
the raw-tile environment of ``tests/test_processing.py``.

The CSV text and every frame are held equal (both sides run the same numpy,
pandas and scipy calls on the same decoded bits); the figures by their axes
count and titles, which is what the two packages decide."""

import os
import sys

import matplotlib
import matplotlib.pyplot
import numpy as np
import pandas as pd
import pytest
from matplotlib.figure import Figure

from maunet_tpu.analysis import eda as jax_eda
from maunet_tpu.analysis import figures as jax_figures
from maunet_tpu.analysis.tile_viz import visualize_raw_tiles as jax_visualize_raw_tiles
from maunet_tpu.data.synthetic import generate_dataset

from maunet_tpu_torch import cli
from maunet_tpu_torch.analysis import eda, figures
from maunet_tpu_torch.analysis.tile_viz import visualize_raw_tiles

from test_headless_apps import _write_eval_csv
from test_processing import HW as TILE_HW
from test_processing import _write_raw_tiles

HW, T = 32, 64
matplotlib.use("Agg")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("eda")),
                            {"train": 4, "val": 1, "test": 3}, hw=HW, temporal_len=T)


@pytest.fixture(scope="module")
def metrics_csvs(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("eda_csv")
    port = eda.extract_metrics_csv(data, str(out / "port.csv"), temporal_length=T)
    want = jax_eda.extract_metrics_csv(data, str(out / "jax.csv"), temporal_length=T)
    return port, want, str(out / "port.csv"), str(out / "jax.csv")


@pytest.fixture(scope="module")
def eval_csvs(tmp_path_factory):
    rng = np.random.default_rng(7)
    reports = tmp_path_factory.mktemp("reports")
    paths = [str(reports / "metaemb_evaluation.csv"), str(reports / "noemb_evaluation.csv")]
    _write_eval_csv(paths[0], rng, bias=0.0)
    _write_eval_csv(paths[1], rng, bias=0.5)
    return paths


@pytest.fixture(scope="module")
def raw_tiles(tmp_path_factory):
    image_dir = str(tmp_path_factory.mktemp("raw") / "raw_tiles")
    _write_raw_tiles(image_dir, np.random.default_rng(0),
                     [("rome", 1, 41.9, 12.5), ("lagos", 2, 6.5, 3.4)])
    return image_dir


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    matplotlib.pyplot.close("all")


def _axes(fig):
    return [ax.get_title() for ax in fig.axes], (fig._suptitle.get_text()
                                                 if fig._suptitle else None)


@pytest.fixture()
def saved(monkeypatch):
    """Every figure saved while the test runs, as its axes' titles."""
    seen = []
    real = Figure.savefig

    def savefig(self, *args, **kwargs):
        seen.append(_axes(self))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", savefig)
    return seen


def test_metrics_csv_text_equals_jax(metrics_csvs):
    port, want, port_csv, jax_csv = metrics_csvs
    with open(port_csv) as a, open(jax_csv) as b:
        text = a.read()
        assert text == b.read()
    assert len(port) == 8 and list(port["split"]) == ["train"] * 4 + ["val"] + ["test"] * 3
    assert port["temp_series_slope"].notna().all()
    pd.testing.assert_frame_equal(port, want)


def test_analyze_csv_frame_equals_jax(metrics_csvs):
    _, _, port_csv, _ = metrics_csvs
    got, want = eda.analyze_csv(port_csv), jax_eda.analyze_csv(port_csv)
    assert not got.empty and list(got.columns) == ["driver", "target", "pearson_r", "p_value", "n"]
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("matrix", ["significance_matrix", "error_correlation_matrix"])
@pytest.mark.parametrize("channel,metric", [("after_temp", "mae"), ("after_ndvi", "rmse")])
def test_matrices_equal_jax(eval_csvs, matrix, channel, metric):
    names = ["metaemb", "noemb"]
    got, fig = getattr(figures, matrix)(eval_csvs, names, channel, metric)
    want, jax_fig = getattr(jax_figures, matrix)(eval_csvs, names, channel, metric)
    pd.testing.assert_frame_equal(got, want)
    assert _axes(fig) == _axes(jax_fig) and len(fig.axes) == 2   # heatmap and colorbar


def test_figures_match_jax(data, raw_tiles, tmp_path, saved):
    rng = np.random.default_rng(3)
    gt, pred = rng.normal(size=(HW, HW)), rng.normal(size=(HW, HW))
    for error in (False, True):
        fig = figures.plot_zoomed_views(gt, pred, "NDVI", error=error)
        assert _axes(fig) == _axes(jax_figures.plot_zoomed_views(gt, pred, "NDVI", error=error))
        assert len(fig.axes) == 4 * (3 if error else 2) * 2     # panels and colorbars
    fig = figures.plot_zoomed_comparison(gt, [pred, -pred], ["a", "b"], "LST")
    assert _axes(fig) == _axes(jax_figures.plot_zoomed_comparison(gt, [pred, -pred],
                                                                  ["a", "b"], "LST"))
    for hp in ({"base_filters": 8}, {"model_type": "unet++", "base_filters": 32,
                                      "temporal_embeddings": False}):
        fig, jax_fig = figures.plot_architecture_diagram(hp), \
            jax_figures.plot_architecture_diagram(hp)
        assert _axes(fig) == _axes(jax_fig)
        assert [t.get_text() for t in fig.axes[0].texts] == \
            [t.get_text() for t in jax_fig.axes[0].texts]
    df = pd.DataFrame({"split": ["train", "train", "test"], "city": ["a", "a", "b"],
                       "lat": [1.0, 1.0, -2.0], "lon": [3.0, 3.0, 4.0]})
    assert _axes(figures.plot_dataset_geomap(df)) == _axes(jax_figures.plot_dataset_geomap(df))

    sample = sorted(os.listdir(os.path.join(data, "test")))[0]
    npz = os.path.join(data, "test", sample)
    out = eda.visualize_sample(npz, out_path=str(tmp_path / "port.png"))
    jax_eda.visualize_sample(npz, out_path=str(tmp_path / "jax.png"))
    out_tiles = visualize_raw_tiles(raw_tiles, out_path=str(tmp_path / "tiles.png"), edge=TILE_HW)
    jax_visualize_raw_tiles(raw_tiles, out_path=str(tmp_path / "jax_tiles.png"), edge=TILE_HW)
    assert os.path.exists(out) and os.path.exists(out_tiles)
    (sample_fig, jax_sample_fig, tiles_fig, jax_tiles_fig) = saved
    assert sample_fig == jax_sample_fig and len(sample_fig[0]) == 8 + 4   # 4 colorbars
    assert tiles_fig == jax_tiles_fig and len(tiles_fig[0]) == 4 * 4 + 4 * 2


def test_eda_command_line(data, raw_tiles, tmp_path, monkeypatch, capsys, saved):
    out_csv = str(tmp_path / "metrics.csv")
    assert cli.main(["eda", "extract", data, out_csv]) == 0
    assert len(pd.read_csv(out_csv)) == 8
    assert cli.main(["eda", "analyze-csv", out_csv]) == 0
    npz = os.path.join(data, "test", sorted(os.listdir(os.path.join(data, "test")))[0])
    assert cli.main(["eda", "visualize", npz, "--out", str(tmp_path / "s.png")]) == 0
    assert cli.main(["eda", "visualize-tiles", raw_tiles, "--out", str(tmp_path / "t.png")]) == 0
    assert os.path.exists(tmp_path / "s.png") and os.path.exists(tmp_path / "t.png")
    assert len(saved) == 2
    capsys.readouterr()
    # Where matplotlib is absent (the GPU host) the figure commands exit 1
    # with one line; extract and analyze-csv need none of it.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for argv in (["visualize", npz], ["visualize-tiles", raw_tiles]):
        assert cli.main(["eda", *argv]) == 1
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and "matplotlib is not installed" in err[0]
    assert cli.main(["eda", "extract", data, str(tmp_path / "again.csv")]) == 0
    assert cli.main(["eda", "analyze-csv", str(tmp_path / "again.csv")]) == 0
    assert len(saved) == 2
