"""The port's data preparation (``data/processing.py``, ``split.py``,
``temperature.py`` and the ``process`` and ``process-temperature``
subcommands) against the JAX package's, on the synthetic raw environment of
``tests/test_processing.py``: raw ``.npy`` tiles of three cities at four
dates, a synthetic CRU cube and a cities CSV; no GEE, rasterio or xarray.
"""

import os
import zipfile

import numpy as np
import pandas as pd
import pytest

from maunet_tpu.config import Config
from maunet_tpu.data.acquisition import tile_basename
from maunet_tpu.data.processing import process_future_data as jax_process
from maunet_tpu.data.split import train_test_val_split as jax_split
from maunet_tpu.data.temperature import TemperatureQuery as JaxTemperatureQuery
from maunet_tpu.data.temperature import write_cube as jax_write_cube
from maunet_tpu.data.tiles import one_hot_encode as jax_one_hot

from maunet_tpu_torch import cli
from maunet_tpu_torch.data import processing
from maunet_tpu_torch.data.split import train_test_val_split
from maunet_tpu_torch.data.temperature import TemperatureQuery, process_temperature, write_cube
from maunet_tpu_torch.data.tiles import one_hot_encode

HW = 24
CITIES = [("rome", 1, 41.9, 12.5), ("lagos", 2, 6.5, 3.4), ("lyon", 3, 45.7, 4.8)]


@pytest.fixture()
def raw_env(tmp_path):
    """``tests/test_processing.py``'s environment, built here: tiles with a
    land-cover change between every two dates, a cube from 1951 to 2025 on
    an 8 x 12 grid, the cities' populations."""
    rng = np.random.default_rng(0)
    image_dir = str(tmp_path / "raw_tiles")
    os.makedirs(image_dir)
    for city, cid, lat, lon in CITIES:
        base = tile_basename(city, cid, lat, lon, 0.0, 0.0)
        for i, year in enumerate((2019, 2023, 2024, 2025)):
            dw = np.full((HW, HW), 1, np.float32)
            dw[: HW // 2] = (i + 1) % 9
            np.save(f"{image_dir}/{base}_{year}_07_dw.npy", dw)
            np.save(f"{image_dir}/{base}_{year}_07_rgb.npy",
                    rng.uniform(0, 255, size=(3, HW, HW)).astype(np.float32))
            np.save(f"{image_dir}/{base}_{year}_07_ndvi.npy",
                    rng.uniform(-1, 1, size=(HW, HW)).astype(np.float32))
            np.save(f"{image_dir}/{base}_{year}_07_temp.npy",
                    rng.uniform(10, 45, size=(HW, HW)).astype(np.float32))
    temp_dir = str(tmp_path / "temperature" / "processed")
    cube = rng.normal(size=((2025 - 1951 + 1) * 12, 8, 12)).astype(np.float32)
    jax_write_cube(temp_dir, cube, lats=np.linspace(-60, 70, 8),
                   lons=np.linspace(-180, 180, 12), start_year=1951)
    cities_csv = str(tmp_path / "worldcities_processed.csv")
    pd.DataFrame({"city": [c[0] for c in CITIES], "lat": [c[2] for c in CITIES],
                  "lng": [c[3] for c in CITIES], "population": [2.8e6, 1.4e7, 5e5],
                  "id": [c[1] for c in CITIES]}).to_csv(cities_csv, index=False)
    return tmp_path, image_dir, temp_dir, cities_csv


def _tree(root):
    """Every file under ``root``: a ``.npz`` as its members' bytes (the zip
    container stamps the time of writing), any other file as its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            key = os.path.relpath(path, root)
            if name.endswith(".npz"):
                with zipfile.ZipFile(path) as z:
                    out[key] = {m: z.read(m) for m in sorted(z.namelist())}
            else:
                with open(path, "rb") as f:
                    out[key] = f.read()
    return out


def test_process_writes_the_jax_package_bytes(raw_env):
    """Every ``.npz`` member and ``normalization_metrics.json`` byte-equal,
    the same files in each split; a second run writes nothing new."""
    tmp_path, image_dir, temp_dir, cities_csv = raw_env
    cfg = Config().with_overrides(**{"paths.data_root": str(tmp_path),
                                     "dataset.image_shape_edge": HW})
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_process(cfg, image_dir=image_dir, output_dir=jax_out, cities_csv=cities_csv,
                target_shape=(HW, HW))
    got = processing.process_future_data(
        str(tmp_path), image_dir=image_dir, output_dir=port_out, cities_csv=cities_csv,
        target_shape=(HW, HW))
    assert got == port_out
    want, have = _tree(jax_out), _tree(port_out)
    assert sorted(have) == sorted(want)
    assert "normalization_metrics.json" in have
    assert {k.split(os.sep)[0] for k in have if k.endswith(".npz")} == {"train", "val", "test"}
    for k in want:
        assert have[k] == want[k], k
    processing.process_future_data(str(tmp_path), image_dir=image_dir, output_dir=port_out,
                                   cities_csv=cities_csv, target_shape=(HW, HW))
    assert sorted(_tree(port_out)) == sorted(want)


def test_process_subcommand_lays_paths_out_under_data_root(raw_env):
    """``process --data-root R`` reads the JAX layout under R (the tiles,
    the CRU cube, the cities CSV) and writes what the function writes;
    ``-o seed=`` reaches the split."""
    tmp_path, image_dir, temp_dir, cities_csv = raw_env
    root = tmp_path / "root"
    os.makedirs(root / "temperature")
    os.makedirs(root / "processed" / "cities")
    os.rename(image_dir, root / processing.IMAGE_DATASET)
    os.rename(temp_dir, root / processing.PROCESSED_TEMPERATURE_DIR)
    os.rename(cities_csv, root / processing.CITIES_CSV)
    assert cli.main(["process", "--data-root", str(root), "--tile-size", str(HW),
                     "-o", "seed=7"]) == 0
    direct = str(tmp_path / "direct")
    processing.process_future_data(str(root), output_dir=direct, target_shape=(HW, HW), seed=7)
    assert _tree(root / processing.PROCESSED_IMAGE_DATASET) == _tree(direct)


def test_temperature_query_and_cube_match_jax(raw_env, tmp_path):
    _, _, temp_dir, _ = raw_env
    port, ref = TemperatureQuery(temp_dir), JaxTemperatureQuery(temp_dir)
    for lat, lon, year, month in [(41.9, 12.5, 1952, 3), (6.5, 3.4, 2030, 12),
                                  (-90, 200, 1951, 1), (45.7, 4.8, 1940, 5)]:
        assert port.query(lat, lon, year, month) == ref.query(lat, lon, year, month)
    lats, lons = np.array([41.9, 6.5, 45.7]), np.array([12.5, 3.4, 4.8])
    np.testing.assert_array_equal(port.query_batch(lats, lons, 1990, 7),
                                  ref.query_batch(lats, lons, 1990, 7))
    assert port.timestamps == ref.timestamps
    cube = np.random.default_rng(1).normal(size=(24, 3, 4)).astype(np.float64)
    a = write_cube(str(tmp_path / "a"), cube, np.arange(3.0), np.arange(4.0))
    b = jax_write_cube(str(tmp_path / "b"), cube, np.arange(3.0), np.arange(4.0))
    assert _tree(os.path.dirname(a)) == _tree(os.path.dirname(b))


def test_process_temperature_without_xarray(raw_env, tmp_path, monkeypatch):
    """An existing cube is kept; without one, a missing xarray says so, and
    so does the subcommand."""
    _, _, temp_dir, _ = raw_env
    assert process_temperature(str(tmp_path / "raw"), temp_dir) == os.path.join(
        temp_dir, "cru_cube.npz")
    monkeypatch.setitem(__import__("sys").modules, "xarray", None)
    with pytest.raises(RuntimeError, match="xarray is not installed"):
        process_temperature(str(tmp_path / "raw"), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="xarray is not installed"):
        cli.main(["process-temperature", "--data-root", str(tmp_path / "none")])


def test_split_and_one_hot_match_jax():
    samples = [{"city_id": cid, "t2_year": year, "n": i}
               for i, (cid, year) in enumerate((c, y) for c in range(60)
                                               for y in (2019, 2023, 2024, 2025))]
    for ratio, seed in [(0.01, 42), (0.05, 7), (0.5, 0)]:
        assert train_test_val_split(samples, ratio, seed) == jax_split(samples, ratio, seed)
    img = np.random.default_rng(2).integers(-2, 12, (5, 7)).astype(np.float32)
    np.testing.assert_array_equal(one_hot_encode(img), jax_one_hot(img))
