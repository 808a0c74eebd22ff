"""CRU historical-temperature pipeline and query.

A copy of ``maunet_tpu/data/temperature.py`` (which imports JAX through its
package); ``cdsapi`` and ``xarray`` are imported inside the functions that
need them.  Capability parity with reference
src/data/retrieve_temperature.py and src/data/process_temperature.py:

- ``download_temperature``: Copernicus CDS download of CRU TS monthly 0.5°
  temperature (gated on ``cdsapi``; host-only, offline in CI);
- ``process_temperature``: per-gridpoint 1901-1950 baseline mean/std, then
  z-scored per-year files for 1951-2019 (reference :9-57).  NetCDF input is
  read via xarray when available; the processed artifact here is a single
  compressed ``cru_cube.npz`` {data (n_months, nlat, nlon), lats, lons,
  start_year} instead of 69 per-year NetCDFs — one mmap-able file the query
  loads in O(1);
- ``TemperatureQuery``: nearest-gridpoint lookup returning the month series
  truncated at (t1_year, t1_month) (reference :60-114), plus a vectorized
  ``query_batch``.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

log = logging.getLogger(__name__)

CUBE_FILE = "cru_cube.npz"


def download_temperature(out_dir: str, start_year: int = 1901,
                         end_year: int = 2019) -> None:
    """Download CRU monthly mean temperature via the Copernicus CDS API
    (reference retrieve_temperature.py:7-64).  Requires ``cdsapi`` and
    network access — both host-side concerns outside CI."""
    try:
        import cdsapi
    except ImportError as e:
        raise RuntimeError(
            "cdsapi is not installed; CRU download is unavailable in this "
            "environment. Provide raw CRU NetCDFs (or a cru_cube.npz) "
            "manually.") from e

    os.makedirs(out_dir, exist_ok=True)
    client = cdsapi.Client()
    for year in range(start_year, end_year + 1):
        target = os.path.join(
            out_dir, f"CRU_mean_temperature_mon_0.5x0.5_global_{year}_v4.03.nc")
        if os.path.exists(target):
            continue
        client.retrieve(
            "insitu-gridded-observations-global-and-regional",
            {"origin": "cru", "variable": "temperature",
             "statistic": "mean", "horizontal_aggregation": "0_5_x_0_5",
             "year": str(year), "version": "v4.03", "format": "zip"},
            target)
        log.info(f"Downloaded CRU year {year}")


def process_temperature(raw_dir: str, processed_dir: str,
                        baseline_years: tuple[int, int] = (1901, 1950),
                        norm_years: tuple[int, int] = (1951, 2019)) -> str:
    """z-score monthly temperature against the per-gridpoint baseline and
    write one ``cru_cube.npz``.  Idempotent (reference :16-18 skips when
    outputs exist)."""
    cube_path = os.path.join(processed_dir, CUBE_FILE)
    if os.path.exists(cube_path):
        log.info("Processed temperature cube already exists. Skipping.")
        return cube_path

    try:
        import xarray as xr
    except ImportError as e:
        raise RuntimeError(
            "xarray is not installed; cannot read raw CRU NetCDFs. Provide "
            f"a prebuilt {CUBE_FILE} in {processed_dir}.") from e

    os.makedirs(processed_dir, exist_ok=True)

    def year_path(year):
        return os.path.join(
            raw_dir, f"CRU_mean_temperature_mon_0.5x0.5_global_{year}_v4.03.nc")

    log.info("Computing 1901-1950 baseline...")
    tas = [xr.open_dataset(year_path(y))["tas"]
           for y in range(baseline_years[0], baseline_years[1] + 1)]
    baseline = xr.concat(tas, dim="time")
    mean = baseline.mean(dim="time", skipna=True)
    std = baseline.std(dim="time", skipna=True)

    with open(os.path.join(processed_dir, "baseline_metrics.json"), "w") as f:
        json.dump({"mean": mean.values.tolist(), "std": std.values.tolist()}, f)

    chunks, lats, lons = [], None, None
    for year in range(norm_years[0], norm_years[1] + 1):
        ds = xr.open_dataset(year_path(year))
        normed = ((ds["tas"] - mean) / std).values.astype(np.float32)
        chunks.append(normed)
        if lats is None:
            lats = ds["lat"].values
            lons = ds["lon"].values
    cube = np.concatenate(chunks, axis=0)
    np.savez_compressed(cube_path, data=cube, lats=lats, lons=lons,
                        start_year=norm_years[0])
    log.info(f"Wrote normalized temperature cube {cube.shape} → {cube_path}")
    return cube_path


def write_cube(processed_dir: str, data: np.ndarray, lats: np.ndarray,
               lons: np.ndarray, start_year: int = 1951) -> str:
    """Write a cube directly (synthetic fixtures / external preprocessing)."""
    os.makedirs(processed_dir, exist_ok=True)
    path = os.path.join(processed_dir, CUBE_FILE)
    np.savez_compressed(path, data=data.astype(np.float32), lats=lats,
                        lons=lons, start_year=start_year)
    return path


class TemperatureQuery:
    """In-RAM monthly cube with nearest-gridpoint series lookup
    (reference process_temperature.py:60-114)."""

    def __init__(self, processed_dir: str):
        path = os.path.join(processed_dir, CUBE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — run process_temperature first.")
        with np.load(path) as z:
            self.data = z["data"]          # (n_months, nlat, nlon)
            self.lats = z["lats"]
            self.lons = z["lons"]
            self.start_year = int(z["start_year"])
        n_months = self.data.shape[0]
        self.timestamps = [(self.start_year + i // 12, i % 12 + 1)
                           for i in range(n_months)]
        log.info(f"Temperature cube loaded: {n_months} months, "
                 f"{len(self.lats)}×{len(self.lons)} grid.")

    def _n_months(self, max_year: int, max_month: int) -> int:
        """Months to include, truncating after (max_year, max_month)
        (reference :109-112)."""
        n = (max_year - self.start_year) * 12 + max_month
        return int(np.clip(n, 0, self.data.shape[0]))

    def query(self, lat: float, lon: float, max_year: int,
              max_month: int) -> list[float]:
        lat_idx = int(np.abs(self.lats - lat).argmin())
        lon_idx = int(np.abs(self.lons - lon).argmin())
        series = self.data[:self._n_months(max_year, max_month), lat_idx, lon_idx]
        return series.tolist()

    def query_batch(self, lats: np.ndarray, lons: np.ndarray,
                    max_year: int, max_month: int) -> np.ndarray:
        """Vectorized lookup for many locations with a common cutoff →
        (N, n_months)."""
        lat_idx = np.abs(self.lats[None, :] - np.asarray(lats)[:, None]).argmin(1)
        lon_idx = np.abs(self.lons[None, :] - np.asarray(lons)[:, None]).argmin(1)
        n = self._n_months(max_year, max_month)
        return self.data[:n, lat_idx, lon_idx].T
