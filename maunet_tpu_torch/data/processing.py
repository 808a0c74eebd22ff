"""Tile processor: raw GeoTIFFs → per-sample ``.npz`` training tiles.

A copy of ``maunet_tpu/data/processing.py`` (which imports JAX through its
package) on the port's ``data/tiles.py`` and ``data/schema.py``.  Its
entry point takes the paths and sizes that the JAX one reads from its
``Config`` as arguments, with the same defaults (:data:`DATA_ROOT` and the
layout under it, a 250² tile, 1% of cities held out, seed 42).  pandas is
imported inside it.  Capability parity with reference src/data/processing_10m/process.py:26-256:
- group tiles by location, build all (t1, t2) timestamp pairs per location;
- filter pairs with negligible change (mean |ΔNDVI| < 0.1, mean |ΔLST| < 0.1,
  max per-class one-hot DW change < 0.1 — thresholds process.py:22-24);
- single-pass streaming mean/std over the TRAIN split only (RGB, LST,
  metadata, CRU series) → ``normalization_metrics.json`` (or reload cached);
- normalize, stack the 23-channel input, z-score metadata and CRU series,
  and write compressed ``.npz`` per sample (skipping existing files —
  idempotent restart, process.py:161-162).

The live-path RGB statistics divide by the RGB pixel count (the reference's
legacy normalization.py:63 bug — dividing RGB sums by the temperature pixel
count — is NOT replicated; the reference's live path process.py:130-137 is
the correct one and is what we match).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field

import numpy as np

from maunet_tpu_torch.data.schema import NormalizationStats, make_sample_filename
from maunet_tpu_torch.data.temperature import TemperatureQuery
from maunet_tpu_torch.data.tiles import (
    group_files_by_location_and_time,
    load_and_resize_image,
    load_and_resize_rgb,
    one_hot_encode,
)

log = logging.getLogger(__name__)

# The JAX package's ``PathsConfig`` layout and dataset defaults
# (``maunet_tpu/config/config.py:28-54, 67, 93``).
DATA_ROOT = "data"
IMAGE_DATASET = "output_changes_future"
PROCESSED_IMAGE_DATASET = "processed_future"
RAW_TEMPERATURE_DIR = os.path.join("temperature", "raw_cru")
PROCESSED_TEMPERATURE_DIR = os.path.join("temperature", "processed")
CITIES_CSV = os.path.join("processed", "cities", "worldcities_processed.csv")
TILE_EDGE = 250
HOLDOUT_CITY_RATIO = 0.01

NDVI_CHANGE_THRESHOLD = 0.1
TEMP_CHANGE_THRESHOLD = 0.1
DW_CHANGE_THRESHOLD = 0.1


def build_sample_list(image_dir: str, city_population: dict) -> list[dict]:
    """All valid (t1, t2) pairs per location (reference process.py:206-228)."""
    locations = group_files_by_location_and_time(image_dir)
    samples = []
    for (city_id, lat, lon), loc in locations.items():
        stamps = sorted(loc["timestamps"])
        for i in range(len(stamps)):
            for j in range(i + 1, len(stamps)):
                t1, t2 = stamps[i], stamps[j]
                files_t1 = loc["timestamps"][t1]
                files_t2 = loc["timestamps"][t2]
                if not all(k in files_t1 for k in ("dw", "rgb", "ndvi", "temp")):
                    continue
                if not all(k in files_t2 for k in ("ndvi", "temp", "dw")):
                    continue
                samples.append({
                    "city_id": city_id, "lat": lat, "lon": lon,
                    "city_name": loc["city_name"],
                    "population": city_population.get(city_id, 0),
                    "t1_year": t1[0], "t1_month": t1[1],
                    "t2_year": t2[0], "t2_month": t2[1],
                    "delta_time_years": (t2[0] - t1[0]) + (t2[1] - t1[1]) / 12.0,
                    "files": {**files_t1,
                              "ndvi_t2": files_t2["ndvi"],
                              "temp_t2": files_t2["temp"],
                              "dw_t2": files_t2["dw"]},
                })
    return samples


def _load_pair(sample: dict, target_shape) -> dict[str, np.ndarray]:
    f = sample["files"]
    return {
        "ndvi_t1": load_and_resize_image(f["ndvi"], target_shape),
        "temp_t1": load_and_resize_image(f["temp"], target_shape),
        "dw_t1": load_and_resize_image(f["dw"], target_shape, nearest=True),
        "ndvi_t2": load_and_resize_image(f["ndvi_t2"], target_shape),
        "temp_t2": load_and_resize_image(f["temp_t2"], target_shape),
        "dw_t2": load_and_resize_image(f["dw_t2"], target_shape, nearest=True),
    }


def _passes_change_filter(tiles: dict[str, np.ndarray]) -> bool:
    dw1 = one_hot_encode(tiles["dw_t1"])
    dw2 = one_hot_encode(tiles["dw_t2"])
    ndvi_diff = np.abs(tiles["ndvi_t2"] - tiles["ndvi_t1"]).mean()
    temp_diff = np.abs(tiles["temp_t2"] - tiles["temp_t1"]).mean()
    dw_diff = np.mean(np.abs(dw2 - dw1), axis=(1, 2)).max()
    return not (ndvi_diff < NDVI_CHANGE_THRESHOLD
                and temp_diff < TEMP_CHANGE_THRESHOLD
                and dw_diff < DW_CHANGE_THRESHOLD)


def filter_subset(samples: list[dict], target_shape, subset_name: str) -> list[dict]:
    """(reference process.py:26-64)"""
    kept = []
    for sample in samples:
        try:
            if _passes_change_filter(_load_pair(sample, target_shape)):
                kept.append(sample)
        except Exception as e:
            log.error(f"Filtering failed for {sample.get('city_name')}"
                      f"_{sample.get('city_id')}: {e}. Skipping.")
    log.info(f"Kept {len(kept)}/{len(samples)} samples for {subset_name}.")
    return kept


@dataclass
class _Streaming:
    rgb_sum: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rgb_sum_sq: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rgb_count: int = 0
    temp_sum: float = 0.0
    temp_sum_sq: float = 0.0
    temp_count: int = 0
    meta: list = field(default_factory=list)
    series_sum: float = 0.0
    series_sum_sq: float = 0.0
    series_count: int = 0


def filter_and_calculate_metrics(samples: list[dict], target_shape,
                                 temp_query: TemperatureQuery
                                 ) -> tuple[NormalizationStats, list[dict]]:
    """Single-pass filter + streaming normalization stats over the train
    split (reference process.py:66-148)."""
    kept = []
    acc = _Streaming()
    for sample in samples:
        try:
            tiles = _load_pair(sample, target_shape)
            if not _passes_change_filter(tiles):
                continue
            kept.append(sample)

            rgb = load_and_resize_rgb(sample["files"]["rgb"], target_shape) / 255.0
            acc.rgb_sum += rgb.sum(axis=(1, 2))
            acc.rgb_sum_sq += (rgb ** 2).sum(axis=(1, 2))
            acc.rgb_count += rgb.shape[1] * rgb.shape[2]

            temp = tiles["temp_t1"]
            acc.temp_sum += float(temp.sum())
            acc.temp_sum_sq += float((temp ** 2).sum())
            acc.temp_count += temp.size

            acc.meta.append([sample["lat"], sample["lon"],
                             sample["population"], sample["delta_time_years"]])

            series = np.asarray(temp_query.query(
                sample["lat"], sample["lon"],
                int(sample["t1_year"]), int(sample["t1_month"])))
            acc.series_sum += float(series.sum())
            acc.series_sum_sq += float(np.square(series).sum())
            acc.series_count += len(series)
        except Exception as e:
            log.error(f"Metric calculation failed for {sample.get('city_name')}"
                      f"_{sample.get('city_id')}: {e}. Skipping.")

    rgb_mean = acc.rgb_sum / acc.rgb_count
    rgb_std = np.sqrt(acc.rgb_sum_sq / acc.rgb_count - rgb_mean ** 2)
    temp_mean = acc.temp_sum / acc.temp_count
    temp_std = float(np.sqrt(acc.temp_sum_sq / acc.temp_count - temp_mean ** 2))
    meta = np.asarray(acc.meta)
    series_mean = acc.series_sum / acc.series_count
    series_std = float(np.sqrt(acc.series_sum_sq / acc.series_count - series_mean ** 2))

    stats = NormalizationStats(
        rgb_mean=tuple(rgb_mean.tolist()),
        rgb_std=tuple(rgb_std.tolist()),
        temp_mean=float(temp_mean), temp_std=temp_std,
        meta_mean=tuple(meta.mean(axis=0).tolist()),
        meta_std=tuple(meta.std(axis=0).tolist()),
        temp_series_mean=float(series_mean), temp_series_std=series_std,
    )
    log.info(f"Kept {len(kept)}/{len(samples)} training samples.")
    return stats, kept


def process_and_save_subset(samples: list[dict], stats: NormalizationStats,
                            temp_query: TemperatureQuery, output_dir: str,
                            target_shape) -> int:
    """Normalize + stack + save (reference process.py:150-190)."""
    os.makedirs(output_dir, exist_ok=True)
    written = 0
    # Guard degenerate stds (constant features in small datasets) — the
    # reference would emit NaNs here.
    safe = lambda x: np.where(np.asarray(x) == 0, 1.0, np.asarray(x))
    rgb_mean = np.array(stats.rgb_mean)[:, None, None]
    rgb_std = safe(stats.rgb_std)[:, None, None]
    meta_mean = np.array(stats.meta_mean)
    meta_std = safe(stats.meta_std)

    for sample in samples:
        name = make_sample_filename(
            sample["city_name"], sample["city_id"], sample["lat"], sample["lon"],
            sample["t1_year"], sample["t1_month"],
            sample["t2_year"], sample["t2_month"])
        out_path = os.path.join(output_dir, name)
        if os.path.exists(out_path):
            continue
        try:
            tiles = _load_pair(sample, target_shape)
            rgb = load_and_resize_rgb(sample["files"]["rgb"], target_shape)
            rgb = (rgb / 255.0 - rgb_mean) / rgb_std
            dw_t1 = one_hot_encode(tiles["dw_t1"])
            dw_t2 = one_hot_encode(tiles["dw_t2"])
            temp_std = stats.temp_std or 1.0
            temp_t1 = (tiles["temp_t1"] - stats.temp_mean) / temp_std
            temp_t2 = (tiles["temp_t2"] - stats.temp_mean) / temp_std

            input_stack = np.vstack([
                dw_t1, rgb, tiles["ndvi_t1"][None], temp_t1[None], dw_t2])
            target_stack = np.stack([tiles["ndvi_t2"], temp_t2])
            meta = (np.array([sample["lat"], sample["lon"],
                              sample["population"], sample["delta_time_years"]])
                    - meta_mean) / meta_std
            series = (np.asarray(temp_query.query(
                sample["lat"], sample["lon"],
                int(sample["t1_year"]), int(sample["t1_month"])))
                - stats.temp_series_mean) / (stats.temp_series_std or 1.0)

            np.savez_compressed(
                out_path,
                input=input_stack.astype(np.float32),
                target=target_stack.astype(np.float32),
                metadata=meta.astype(np.float32),
                temperature_serie=series.astype(np.float32))
            written += 1
        except Exception as e:
            log.error(f"Failed to process {name}: {e}")
    log.info(f"Wrote {written} samples to {output_dir}")
    return written


def process_future_data(data_root: str = DATA_ROOT, image_dir: str | None = None,
                        output_dir: str | None = None,
                        cities_csv: str | None = None,
                        target_shape: tuple[int, int] | None = None,
                        temperature_dir: str | None = None,
                        holdout_ratio: float = HOLDOUT_CITY_RATIO,
                        seed: int = 42) -> str:
    """Full stage-B pipeline (reference process.py:192-252).  Paths left
    None take the JAX package's layout under ``data_root``."""
    import pandas as pd

    from maunet_tpu_torch.data.split import train_test_val_split

    image_dir = image_dir or os.path.join(data_root, IMAGE_DATASET)
    output_dir = output_dir or os.path.join(data_root, PROCESSED_IMAGE_DATASET)
    os.makedirs(output_dir, exist_ok=True)

    temp_query = TemperatureQuery(
        temperature_dir or os.path.join(data_root, PROCESSED_TEMPERATURE_DIR))

    cities_csv = cities_csv or os.path.join(data_root, CITIES_CSV)
    population = {}
    if os.path.exists(cities_csv):
        cities_df = pd.read_csv(cities_csv)
        population = cities_df.set_index("id")["population"].to_dict()

    samples = build_sample_list(image_dir, population)
    log.info(f"Found {len(samples)} candidate (t1, t2) pairs.")
    if target_shape is None:
        target_shape = (TILE_EDGE, TILE_EDGE)

    train_s, val_s, test_s = train_test_val_split(
        samples, holdout_ratio=holdout_ratio, seed=seed)

    stats_path = os.path.join(output_dir, "normalization_metrics.json")
    if os.path.exists(stats_path):
        log.info(f"Loading existing normalization metrics from {stats_path}")
        stats = NormalizationStats.from_json(stats_path)
        train_f = filter_subset(train_s, target_shape, "train")
    else:
        stats, train_f = filter_and_calculate_metrics(train_s, target_shape,
                                                      temp_query)
        stats.to_json(stats_path)

    val_f = filter_subset(val_s, target_shape, "validation")
    test_f = filter_subset(test_s, target_shape, "test")

    for subset, name in [(train_f, "train"), (val_f, "val"), (test_f, "test")]:
        process_and_save_subset(subset, stats, temp_query,
                                os.path.join(output_dir, name), target_shape)
    with open(stats_path) as f:
        json.load(f)  # validate artifact
    log.info("Finished processing all data.")
    return output_dir
