"""Metadata and temporal sensitivity sweeps.

Port of ``maunet_tpu/analysis/sensitivity.py`` (reference
test/metadata_sensitivity.py:41-712).  For each analysed tile: the 50-point
latitude and longitude sweeps, for the highlighted tiles a 20×20 lat-lon
heatmap, and, in the temporal sweep, 41 offsets of the CRU series.  The JSON
files, their schema and their names are the JAX package's
(``sensitivity_data_<model>.json``, ``sensitivity_data_temporal_<model>.json``),
so ``compare_sensitivity`` of either package reads them.

Each chunk of at most :data:`VARIANT_CHUNK` variants of one tile is one
forward of the loaded model under ``torch.no_grad()`` on the model's device
(50, as the JAX package's ``variant_chunk``; a 400-variant heatmap is eight
chunks).  It returns the per-channel spatial means with LST un-normalised on
the device, so a chunk copies back (N, 2) floats.  The tile is uploaded once
per sample in the model's compute dtype; each chunk's maps are expanded and
made contiguous on the device (kernel A reads contiguous parts only).  A
short last chunk runs at its own size: nothing is compiled per shape.

The evaluation CSV is read with ``csv`` (the evaluator writes NaN as an empty
field), and :func:`select_samples` keeps the pandas semantics the JAX
package's selection has: city means over the ``overall`` rows with NaN
skipped, NaN sorted last, a city's median row at ``len // 2`` of its
RMSE-sorted rows, samples in the CSV's order, a seeded subsample.  Both
rankings sort as ``sort_values`` does, so equal RMSEs pick the same rows
(:func:`_pandas_order`).
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
import random

import numpy as np
import torch

from maunet_tpu_torch.data.dataset import NpzDataset
from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.evaluate.checkpoint import LoadedModel, load_any_checkpoint
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.steps import last_head
from maunet_tpu_torch.utils.tracking import make_emb_tag

log = logging.getLogger(__name__)

LAT_STEPS = 50
LON_STEPS = 50
LAT_RANGE = np.linspace(-60, 70, LAT_STEPS)     # avoid extreme poles (ref :218)
LON_RANGE = np.linspace(-180, 180, LON_STEPS)
HEAT_STEPS = 20
TEMP_OFFSET_STEPS = 41
# z-scored CRU units: ±2σ of local climate level
TEMP_OFFSET_RANGE = np.linspace(-2.0, 2.0, TEMP_OFFSET_STEPS)
# Variants per forward: bounds device memory (400 broadcast 256² tiles
# would take about 12 GB of inputs in f32), as the reference's mini-batches
# of 50 (metadata_sensitivity.py:385) and the JAX package's chunks do.
VARIANT_CHUNK = LAT_STEPS


def _float(field: str) -> float:
    return float(field) if field != "" else math.nan


def read_eval_csv(path: str) -> list[dict]:
    """The rows of an evaluation CSV, with ``sample_idx`` an int and
    ``mae`` and ``rmse`` floats (NaN where the field is empty)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        row["sample_idx"] = int(row["sample_idx"])
        row["mae"] = _float(row["mae"])
        row["rmse"] = _float(row["rmse"])
    return rows


def _pandas_order(values: list[float]) -> list[int]:
    """The positions of ``values`` in the order pandas' ``sort_values`` puts
    them (its ``nargsort``): numpy's default quicksort over the non-NaN
    values, which is not stable past 16 of them, then the NaN in order."""
    v = np.asarray(values, dtype=np.float64)
    nan = np.isnan(v)
    kept = np.flatnonzero(~nan)
    return np.concatenate([kept[np.argsort(v[kept], kind="quicksort")],
                           np.flatnonzero(nan)]).tolist()


def _nanmean(values: list[float]) -> float:
    """pandas' ``mean``: NaN skipped, NaN if nothing is left."""
    kept = [v for v in values if not math.isnan(v)]
    return sum(kept) / len(kept) if kept else math.nan


def select_samples(rows: list[dict], max_samples: int = 1000, seed: int = 0):
    """Pick the 5 best and 5 worst cities by mean RMSE, one median-RMSE
    sample each, plus a subsample of at most ``max_samples`` for averaging
    (reference :135-188; the reference's ``random.sample`` is unseeded,
    here it is seeded).  Returns (all indices, highlighted indices, their
    group, the ``overall`` rows)."""
    overall = [r for r in rows if r["dw_class"] == "overall"]
    by_city: dict[str, list[float]] = {}
    for r in overall:
        by_city.setdefault(r["city"], []).append(r["rmse"])
    cities = sorted(by_city)                  # groupby's key order
    ranked = [cities[i] for i in _pandas_order([_nanmean(by_city[c]) for c in cities])]
    best_cities, worst_cities = ranked[:5], ranked[-5:]

    def median_sample(city):
        city_rows = [r for r in overall if r["city"] == city]
        order = _pandas_order([r["rmse"] for r in city_rows])
        return city_rows[order[len(order) // 2]]["sample_idx"]

    target_indices, groups = [], {}
    for city in best_cities:
        idx = median_sample(city)
        target_indices.append(idx)
        groups[idx] = "Best"
    for city in worst_cities:
        idx = median_sample(city)
        groups.setdefault(idx, "Worst")
        if idx not in target_indices:
            target_indices.append(idx)

    all_indices = list(dict.fromkeys(r["sample_idx"] for r in overall))
    if len(all_indices) > max_samples:
        remaining = sorted(set(all_indices) - set(target_indices))
        rng = random.Random(seed)
        sampled = rng.sample(remaining, min(len(remaining),
                                            max_samples - len(target_indices)))
        all_indices = target_indices + sampled
    return all_indices, target_indices, groups, overall


def _model_name(loaded: LoadedModel) -> str:
    hp = loaded.hyperparams
    name = make_emb_tag(bool(hp.get("temporal_embeddings", True)),
                        bool(hp.get("metadata_embeddings", True)))
    return name + "++" if "++" in hp.get("model_type", "unet") else name


class Sweeper:
    """Runs the variants of one tile through a loaded model in chunks."""

    def __init__(self, loaded: LoadedModel, stats: NormalizationStats):
        self.model = loaded.model
        self.stats = stats
        self.device = next(loaded.model.parameters()).device
        self.dtype = loaded.model.model.compute_dtype
        self.metadata_features = int(loaded.hyperparams.get(
            "metadata_input_length", loaded.meta.get("metadata_input_length", 4)))

    def upload(self, sample: dict) -> dict[str, torch.Tensor]:
        """One tile on the device: maps (1, H, W, C) in the compute dtype,
        the series (1, T), its length, and the (1, 4) t1/t2 dates."""
        dates = np.concatenate([sample["t1_dates"], sample["t2_dates"]])
        return {"maps": torch.from_numpy(sample["maps"]).to(self.device, self.dtype)[None],
                "series": torch.from_numpy(sample["temp_series"]).to(self.device)[None],
                "length": int(sample["temp_lengths"]),
                "dates": torch.from_numpy(dates).to(self.device)[None]}

    def chunk_inputs(self, tile: dict, meta: torch.Tensor,
                     series: torch.Tensor | None = None) -> tuple:
        """The model's arguments for N variants of ``tile``: N metadata rows
        (z-scored, 4 features) and, optionally, N series."""
        n = meta.shape[0]
        maps = tile["maps"].expand(n, -1, -1, -1).contiguous()
        if series is None:
            series = tile["series"].expand(n, -1).contiguous()
        if self.metadata_features == 8:
            meta = torch.cat([meta, tile["dates"].expand(n, -1)], dim=1)
        lengths = torch.full((n,), tile["length"], dtype=torch.int32, device=self.device)
        return maps, series, meta, lengths

    def means(self, maps, series, meta, lengths) -> torch.Tensor:
        """One forward over N variants -> (N, 2) per-channel spatial means,
        LST un-normalised, on the device."""
        with torch.no_grad():
            out = last_head(self.model(maps, series, meta, lengths))
        means = out.float().mean(dim=(1, 2))
        lst = means[:, 1] * self.stats.temp_std + self.stats.temp_mean
        return torch.stack([means[:, 0], lst], dim=1)

    def run(self, tile: dict, meta: np.ndarray, series: torch.Tensor | None = None
            ) -> np.ndarray:
        """(N, 4) z-scored metadata rows (and optionally (N, T) series) ->
        (N, 2) numpy, in chunks of at most ``VARIANT_CHUNK``."""
        pieces = []
        for start in range(0, meta.shape[0], VARIANT_CHUNK):
            stop = start + VARIANT_CHUNK
            chunk_meta = torch.from_numpy(np.ascontiguousarray(meta[start:stop])).to(self.device)
            chunk_series = None if series is None else series[start:stop].contiguous()
            pieces.append(self.means(*self.chunk_inputs(tile, chunk_meta, chunk_series))
                          .cpu().numpy())
        return np.concatenate(pieces)


def _stats(data_dir: str) -> NormalizationStats:
    return NormalizationStats.from_json(os.path.join(data_dir, "normalization_metrics.json"))


def _require_data_dir(data_dir: str | None) -> str:
    if data_dir is None:
        raise ValueError("the sweep needs data_dir: the directory that holds the "
                         "test split and normalization_metrics.json")
    return data_dir


def run_sensitivity(
    checkpoint_path: str,
    eval_csv: str,
    cfg: TrainConfig | None = None,
    data_dir: str | None = None,
    output_dir: str = "reports/sensitivity",
    max_samples: int = 1000,
    study_name: str = "sensitivity_analysis",
    seed: int = 0,
    make_plots: bool = True,
    trackers: list | None = None,
    device: str | torch.device = "cuda",
) -> str:
    """The metadata sweep; writes ``sensitivity_data_<model>.json`` (then,
    with ``make_plots``, the figures) under ``output_dir`` and returns the
    JSON's path."""
    cfg = cfg or TrainConfig()
    data_dir = _require_data_dir(data_dir)
    os.makedirs(output_dir, exist_ok=True)

    stats = _stats(data_dir)
    meta_mean = np.array(stats.meta_mean)
    meta_std = np.array(stats.meta_std)

    loaded = load_any_checkpoint(checkpoint_path, study_name, device=device)
    model_name = _model_name(loaded)
    model_type = loaded.hyperparams.get("model_type", "unet")

    all_indices, target_indices, groups, overall = select_samples(
        read_eval_csv(eval_csv), max_samples, seed)
    log.info(f"Analyzing {len(all_indices)} samples "
             f"({len(target_indices)} highlighted).")

    ds = NpzDataset(os.path.join(data_dir, "test"), temporal_length=cfg.temporal_length)
    channels = list(cfg.target_channels)
    sweeper = Sweeper(loaded, stats)

    lat_norms = (LAT_RANGE - meta_mean[0]) / meta_std[0]
    lon_norms = (LON_RANGE - meta_mean[1]) / meta_std[1]
    heat_lat = np.linspace(-60, 70, HEAT_STEPS)
    heat_lon = np.linspace(-180, 180, HEAT_STEPS)
    hl, ho = np.meshgrid(heat_lat, heat_lon, indexing="ij")

    lat_accum = {ch: [] for ch in channels}
    lon_accum = {ch: [] for ch in channels}
    results_lat, results_lon = [], []
    heatmaps = {}

    for sample_idx in all_indices:
        sample = ds[int(sample_idx)]
        tile = sweeper.upload(sample)
        base_meta = sample["metadata"]
        orig_lat = base_meta[0] * meta_std[0] + meta_mean[0]
        orig_lon = base_meta[1] * meta_std[1] + meta_mean[1]
        is_highlight = sample_idx in target_indices

        if is_highlight:
            rows = [r for r in overall if r["sample_idx"] == sample_idx]
            city = str(rows[0]["city"]).title()
            base_rmse = _nanmean([r["rmse"] for r in rows])
            label = f"{groups.get(sample_idx, 'Other')} {city} RMSE={base_rmse:.3f}"
        else:
            label = f"Sample {sample_idx}"

        def variants_with(col: int, values: np.ndarray) -> np.ndarray:
            m = np.tile(base_meta, (len(values), 1))
            m[:, col] = values
            return m

        lat_vals = sweeper.run(tile, variants_with(0, lat_norms))
        lon_vals = sweeper.run(tile, variants_with(1, lon_norms))
        for c, ch in enumerate(channels):
            lat_accum[ch].append(lat_vals[:, c])
            lon_accum[ch].append(lon_vals[:, c])
            if is_highlight:
                for j, v in enumerate(LAT_RANGE):
                    results_lat.append({"sample_label": label, "latitude": v,
                                        "orig_lat": orig_lat, ch: lat_vals[j, c]})
                for j, v in enumerate(LON_RANGE):
                    results_lon.append({"sample_label": label, "longitude": v,
                                        "orig_lon": orig_lon, ch: lon_vals[j, c]})

        if is_highlight:
            m = np.tile(base_meta, (HEAT_STEPS * HEAT_STEPS, 1))
            m[:, 0] = (hl.ravel() - meta_mean[0]) / meta_std[0]
            m[:, 1] = (ho.ravel() - meta_mean[1]) / meta_std[1]
            heat_vals = sweeper.run(tile, m)  # (400, C)
            heatmaps[str(int(sample_idx))] = {
                "sample_label": label,
                "orig_lat": float(orig_lat),
                "orig_lon": float(orig_lon),
                "channels": {
                    ch: {
                        "values": heat_vals[:, c].reshape(HEAT_STEPS, HEAT_STEPS).tolist(),
                        "lats": heat_lat.tolist(),
                        "lons": heat_lon.tolist(),
                    } for c, ch in enumerate(channels)
                },
            }

    export = {
        "model_name": model_name,
        "model_type": model_type,
        "sweeps": {
            "latitude": {"x": LAT_RANGE.tolist(), "channels": {}},
            "longitude": {"x": LON_RANGE.tolist(), "channels": {}},
        },
        "heatmaps": heatmaps,
    }
    for key, accum in [("latitude", lat_accum), ("longitude", lon_accum)]:
        for ch in channels:
            stack = np.stack(accum[ch])
            export["sweeps"][key]["channels"][ch] = {
                "mean": stack.mean(axis=0).tolist(),
                "std": stack.std(axis=0).tolist(),
            }

    export_path = os.path.join(output_dir, f"sensitivity_data_{model_name}.json")
    with open(export_path, "w") as f:
        json.dump(export, f, indent=4)
    log.info(f"Saved sensitivity data to {export_path}")

    if make_plots:
        from maunet_tpu_torch.analysis.plots import (
            plot_average_sensitivity,
            plot_heatmaps,
            plot_individual_sensitivity,
        )

        figure_paths = list(plot_average_sensitivity(export, output_dir))
        if results_lat:
            plot_individual_sensitivity(results_lat, "latitude", channels, output_dir)
            plot_individual_sensitivity(results_lon, "longitude", channels, output_dir)
        figure_paths += plot_heatmaps(export, output_dir)
        # The figures to the trackers (reference
        # test/metadata_sensitivity.py:685-712 logs them as wandb images),
        # as their .png twins: wandb.Image cannot read a PDF.
        for tracker in trackers or []:
            for fig_path in figure_paths:
                key = os.path.splitext(os.path.basename(fig_path))[0]
                tracker.log_image(f"sensitivity/{key}", fig_path[:-4] + ".png")
    return export_path


def run_temporal_sensitivity(
    checkpoint_path: str,
    eval_csv: str,
    cfg: TrainConfig | None = None,
    data_dir: str | None = None,
    output_dir: str = "reports/sensitivity",
    max_samples: int = 24,
    study_name: str = "temporal_sensitivity",
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> str:
    """Shift the valid prefix of each analysed tile's z-scored CRU series by
    each offset of :data:`TEMP_OFFSET_RANGE` and record the per-channel
    spatial-mean response (``maunet_tpu/analysis/sensitivity.py``
    ``run_temporal_sensitivity``); writes
    ``sensitivity_data_temporal_<model>.json`` with the metadata export's
    sweeps schema and returns its path."""
    cfg = cfg or TrainConfig()
    data_dir = _require_data_dir(data_dir)
    os.makedirs(output_dir, exist_ok=True)

    loaded = load_any_checkpoint(checkpoint_path, study_name, device=device)
    model_name = _model_name(loaded)
    all_indices, _, _, _ = select_samples(read_eval_csv(eval_csv), max_samples, seed)
    ds = NpzDataset(os.path.join(data_dir, "test"), temporal_length=cfg.temporal_length)
    channels = list(cfg.target_channels)
    sweeper = Sweeper(loaded, _stats(data_dir))
    n = TEMP_OFFSET_STEPS
    offsets = torch.tensor(TEMP_OFFSET_RANGE, dtype=torch.float32, device=sweeper.device)

    accum = {ch: [] for ch in channels}
    for sample_idx in all_indices:
        sample = ds[int(sample_idx)]
        tile = sweeper.upload(sample)
        # Shift only the valid prefix: the padding stays zero (batch_max
        # models, as the reference's checkpoints load, read it).
        t = sample["temp_series"].shape[0]
        valid = torch.from_numpy(
            (np.arange(t) < int(sample["temp_lengths"])).astype(np.float32)).to(sweeper.device)
        series = tile["series"] + offsets[:, None] * valid[None]
        meta = np.tile(sample["metadata"], (n, 1))
        vals = sweeper.run(tile, meta, series)
        for c, ch in enumerate(channels):
            accum[ch].append(vals[:, c])

    export = {
        "model_name": model_name,
        "model_type": loaded.hyperparams.get("model_type", "unet"),
        "sweeps": {"temporal_offset": {
            "x": TEMP_OFFSET_RANGE.tolist(),
            "channels": {
                ch: {"mean": np.stack(accum[ch]).mean(axis=0).tolist(),
                     "std": np.stack(accum[ch]).std(axis=0).tolist()}
                for ch in channels
            },
        }},
        "heatmaps": {},
    }
    export_path = os.path.join(output_dir, f"sensitivity_data_temporal_{model_name}.json")
    with open(export_path, "w") as f:
        json.dump(export, f, indent=4)
    log.info(f"Saved temporal sensitivity data to {export_path}")
    return export_path
