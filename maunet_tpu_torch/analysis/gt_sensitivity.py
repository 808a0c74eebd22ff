"""Ground-truth sensitivity: the dataset-side counterpart of the metadata sweeps.

Port of ``maunet_tpu/analysis/gt_sensitivity.py`` (reference
test/generate_ground_truth_sensitivity.py): bins each test sample's mean
un-normalised target (NDVI, LST °C) by its true latitude and longitude into
the 50-step grids the model sweeps use, and writes
``sensitivity_data_ground_truth.json`` in the shared comparison format (mean
and std per bin, NaN for an empty bin).
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from maunet_tpu_torch.analysis.sensitivity import LAT_RANGE, LON_RANGE
from maunet_tpu_torch.data.dataset import NpzDataset
from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.train.config import TrainConfig

log = logging.getLogger(__name__)


def compute_bin_stats(x: np.ndarray, y: np.ndarray, centers: np.ndarray):
    """Bin y by x into bins centred at ``centers`` (edges at the midpoints);
    returns (means, stds) with NaN for empty bins (reference :102-131)."""
    edges = np.concatenate([
        [centers[0] - (centers[1] - centers[0]) / 2],
        (centers[:-1] + centers[1:]) / 2,
        [centers[-1] + (centers[-1] - centers[-2]) / 2],
    ])
    indices = np.digitize(x, edges)
    means, stds = [], []
    for i in range(1, len(centers) + 1):
        mask = indices == i
        if mask.any():
            means.append(float(np.mean(y[mask])))
            stds.append(float(np.std(y[mask])))
        else:
            means.append(float("nan"))
            stds.append(float("nan"))
    return means, stds


def run_gt_sensitivity(
    cfg: TrainConfig | None = None,
    data_dir: str | None = None,
    output_dir: str = "reports/sensitivity",
    split: str = "test",
) -> str:
    cfg = cfg or TrainConfig()
    if data_dir is None:
        raise ValueError("run_gt_sensitivity needs data_dir: the directory that "
                         "holds the split and normalization_metrics.json")
    os.makedirs(output_dir, exist_ok=True)

    stats = NormalizationStats.from_json(
        os.path.join(data_dir, "normalization_metrics.json"))
    meta_mean = np.array(stats.meta_mean)
    meta_std = np.array(stats.meta_std)

    ds = NpzDataset(os.path.join(data_dir, split), temporal_length=cfg.temporal_length)
    channels = list(cfg.target_channels)

    lats, lons, target_means = [], [], []
    for i in range(len(ds)):
        s = ds[i]
        lats.append(s["metadata"][0] * meta_std[0] + meta_mean[0])
        lons.append(s["metadata"][1] * meta_std[1] + meta_mean[1])
        means = s["targets"].mean(axis=(0, 1))  # (C,) NHWC spatial mean
        means[1] = means[1] * stats.temp_std + stats.temp_mean  # LST -> °C
        target_means.append(means)
    lats = np.asarray(lats)
    lons = np.asarray(lons)
    target_means = np.stack(target_means)

    export = {
        "model_name": "ground_truth",
        "model_type": "dataset",
        "sweeps": {
            "latitude": {"x": LAT_RANGE.tolist(), "channels": {}},
            "longitude": {"x": LON_RANGE.tolist(), "channels": {}},
        },
        "heatmaps": {},
    }
    for c, ch in enumerate(channels):
        for key, xs, centers in [("latitude", lats, LAT_RANGE),
                                 ("longitude", lons, LON_RANGE)]:
            means, stds = compute_bin_stats(xs, target_means[:, c], centers)
            export["sweeps"][key]["channels"][ch] = {"mean": means, "std": stds}

    path = os.path.join(output_dir, "sensitivity_data_ground_truth.json")
    with open(path, "w") as f:
        json.dump(export, f, indent=4)
    log.info(f"Ground-truth sensitivity saved to {path}")
    return path
