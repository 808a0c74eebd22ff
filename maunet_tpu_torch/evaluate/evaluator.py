"""Checkpoint evaluator.

Port of ``maunet_tpu/evaluate/evaluator.py`` (the reference's
test/evaluate.py): a long-format CSV with the reference's schema and file
name (test/evaluate.py:244-311): one row per (sample, channel, 'overall')
plus one per (sample, channel, DW class present), with MAE and RMSE in
physical units (degrees C for LST), Laplacian-variance sharpness,
known/unknown-city flags and the t1/t2 dates, so the reference's downstream
statistics read these CSVs unchanged.

The forward pass and the metrics run on the model's device
(``evaluate.metrics.eval_metrics``); the host only formats rows.  Differences
from the JAX evaluator, both deliberate:

- at most :data:`MAX_IN_FLIGHT` batches' metric tensors wait on the device;
  the oldest is fetched before another batch is dispatched (the JAX loop
  holds the whole epoch, evaluator.py:230-242);
- a batch keeps its images for the figures while fewer than ``n_visualize``
  *valid* samples came before it, so the padded tail of the last batch does
  not change which batches keep them (the JAX loop counts
  ``len(pending) * batch_size``, evaluator.py:238).

Both CSVs are written with the ``csv`` module as ``DataFrame.to_csv`` would
write them: ``None`` and NaN as empty fields, booleans as ``True``/``False``,
floats by ``repr``.  The test split is read packed or per sample
(``data.open_split``).  With a mesh (``mesh``, or ``use_mesh``: every
visible CUDA device) the forward and the metrics run data-parallel over its
devices (``parallel.infer``, JAX evaluator.py:161-215), the batch size
rounded up to a multiple of the mesh's size.  Left out: trackers.

Spans (``utils.profiling``, recorded while a profiler runs): ``eval.batch``
(:func:`batch_metrics`) holds ``eval.forward`` and ``eval.metrics``;
``evaluate_checkpoint`` adds ``eval.load_wait``, the wait for each batch
from the loader, and ``eval.fetch``, each batch's copy to the host, which
waits for the device's work.
"""

from __future__ import annotations

import collections
import csv
import itertools
import json
import logging
import math
import os
from typing import Any

import numpy as np
import torch

from maunet_tpu_torch.data import open_split
from maunet_tpu_torch.data.dataset import Batch, make_batches
from maunet_tpu_torch.data.pipeline import host_tensors, prefetch_to_device, to_device
from maunet_tpu_torch.data.schema import NormalizationStats, parse_sample_filename
from maunet_tpu_torch.data.shards import INDEX_FILE as SHARD_INDEX_FILE
from maunet_tpu_torch.evaluate.checkpoint import LoadedModel, load_any_checkpoint
from maunet_tpu_torch.evaluate.metrics import (
    NUM_CLASSES,
    dw_map_from_input,
    eval_metrics,
    unnormalize_targets,
)
from maunet_tpu_torch.parallel.infer import round_up_to_mesh, shard_batch_fn
from maunet_tpu_torch.parallel.mesh import Mesh, make_mesh
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.steps import forward_fn
from maunet_tpu_torch.utils.dw import DW_CLASSES
from maunet_tpu_torch.utils.profiling import span
from maunet_tpu_torch.utils.tracking import make_emb_tag

log = logging.getLogger(__name__)

# Batches whose metric tensors may wait on the device before the oldest is
# fetched: enough to keep the device busy while the host formats rows.
MAX_IN_FLIGHT = 4


def _metadata_features(loaded: LoadedModel, default: int) -> int:
    return int(loaded.hyperparams.get(
        "metadata_input_length", loaded.meta.get("metadata_input_length", default)))


def predict_batch(loaded: LoadedModel, batch: Batch) -> np.ndarray:
    """Run one host Batch through a loaded checkpoint -> (B, H, W, 2) numpy
    predictions, on the device the model lies on."""
    device = next(loaded.model.parameters()).device
    tensors = to_device(host_tensors(batch, pin=False), device)
    with torch.inference_mode():
        return forward_fn(loaded.model, tensors, _metadata_features(loaded, 8)).cpu().numpy()


def known_cities_from_train_dir(train_dir: str) -> set[str]:
    """Cities appearing in the train split, parsed from the file names
    (reference test/evaluate.py:66-79), or from a packed split's index."""
    if not os.path.isdir(train_dir):
        log.warning(f"Training directory not found at {train_dir}; "
                    "known/unknown cities unavailable.")
        return set()
    index_path = os.path.join(train_dir, SHARD_INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            names = json.load(f)["names"]
    else:
        names = [f for f in os.listdir(train_dir) if f.endswith(".npz")]
    return {parse_sample_filename(f)["city"] for f in names}


def batch_metrics(model: torch.nn.Module, batch: dict[str, torch.Tensor],
                  stats: NormalizationStats | None, metadata_features: int):
    """(metrics, outputs_un, targets_un) of one device batch.  Spans:
    ``eval.batch`` holds ``eval.forward`` and ``eval.metrics``."""
    with span("eval.batch"), torch.inference_mode():
        with span("eval.forward"):
            outputs = forward_fn(model, batch, metadata_features)
        with span("eval.metrics"):
            targets_un = unnormalize_targets(batch["targets"], stats)
            outputs_un = unnormalize_targets(outputs, stats)
            metrics = eval_metrics(outputs_un, targets_un, dw_map_from_input(batch["maps"]))
    return metrics, outputs_un, targets_un


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    return tree


def _csv_field(value: Any) -> Any:
    """A value as ``DataFrame.to_csv`` writes it."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    if isinstance(value, float):
        return repr(value)
    return value


def write_csv(path: str, rows: list[dict]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)``: the columns in
    first-seen order, a missing key as an empty field."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_field(row.get(c)) for c in columns])


def evaluate_checkpoint(
    checkpoint_path: str,
    cfg: TrainConfig | None = None,
    data_dir: str | None = None,
    study_name: str = "test",
    jobid: str = "",
    n_visualize: int = 0,
    output_dir: str = "reports/tests",
    batch_size: int | None = None,
    precision: str = "bfloat16",
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
    use_mesh: bool = False,
) -> list[dict]:
    """Evaluate a ``.pth`` checkpoint on ``<data_dir>/test``; writes the
    evaluation CSV and its ``_info.csv`` under ``output_dir`` and returns the
    CSV's rows.  ``mesh`` runs the batches data-parallel over its devices;
    ``use_mesh`` without a mesh makes one of every visible CUDA device (of
    ``device`` alone for a CPU device).  The model loads onto the mesh's
    first device, which the batches reach first."""
    cfg = cfg or TrainConfig()
    if data_dir is None:
        raise ValueError("evaluate_checkpoint needs data_dir: the directory "
                         "that holds the test split")
    device = torch.device(device)
    if mesh is None and use_mesh:
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
    if mesh is not None:
        device = mesh.devices[0]
    compute_dtype = torch.float32 if precision == "float32" else torch.bfloat16
    loaded = load_any_checkpoint(checkpoint_path, study_name,
                                 compute_dtype=compute_dtype, device=device)
    hp = loaded.hyperparams
    metadata_features = _metadata_features(loaded, 4)
    batch_size = batch_size or int(hp.get("batch_size", 16))
    trial_id = loaded.meta.get("trial_id", "unknown")
    model_type = hp.get("model_type", "unet")
    tag_emb = make_emb_tag(bool(hp.get("temporal_embeddings", True)),
                           bool(hp.get("metadata_embeddings", True)))

    stats_path = os.path.join(data_dir, "normalization_metrics.json")
    stats = NormalizationStats.from_json(stats_path) if os.path.exists(stats_path) else None
    if stats is None:
        log.warning("Normalization metrics not found. Using raw data.")

    train_cities = known_cities_from_train_dir(os.path.join(data_dir, "train"))
    ds = open_split(data_dir, "test", cfg.temporal_length)

    channels = list(cfg.target_channels)
    results: list[dict] = []
    sample_idx = 0
    created_visuals = 0

    def format_rows(entry: dict) -> None:
        """Fetch one batch's metrics (waiting for that batch alone) and
        append its samples' rows."""
        nonlocal sample_idx, created_visuals
        with span("eval.fetch"):
            metrics = _to_host(entry["metrics"])
            valid, t1, t2 = (_to_host(entry[k]) for k in ("valid", "t1", "t2"))
            maps_h = outputs_un = targets_un = None
            if "images" in entry:
                maps_h, outputs_un, targets_un = _to_host(entry["images"])

        if np.isnan(metrics["mae"][valid]).any():
            log.error(f"NaN values found in outputs near sample {sample_idx}")
        # Constant-output probe (reference test/evaluate.py:196-199 counts
        # unique values; zero Laplacian variance is the same signal).
        degenerate = metrics["lap_var_pred"][valid] == 0.0
        if degenerate.any():
            log.warning(
                f"Outputs have a single unique value (zero Laplacian variance) "
                f"for {int(degenerate.sum())} sample-channels near sample "
                f"{sample_idx}")

        for i in range(valid.shape[0]):
            if not valid[i]:
                continue
            info = ds.get_metadata_from_idx(sample_idx)
            t1y, t1m = int(t1[i, 0]), int(t1[i, 1])
            t2y, t2m = int(t2[i, 0]), int(t2[i, 1])
            base = {
                "is_known_city": info["city"] in train_cities,
                "t1_year": t1y, "t1_month": t1m,
                "t2_year": t2y, "t2_month": t2m,
                "time_delta": t2y - t1y,
                **info,
            }
            first_row = len(results)  # this sample's rows start here
            for c, ch_name in enumerate(channels):
                results.append({
                    "sample_idx": sample_idx, "channel": ch_name,
                    "dw_class": "overall",
                    "mae": float(metrics["mae"][i, c]),
                    "rmse": float(metrics["rmse"][i, c]),
                    "laplacian_var_pred": float(metrics["lap_var_pred"][i, c]),
                    "laplacian_var_gt": float(metrics["lap_var_gt"][i, c]),
                    **base,
                })
                for k in range(NUM_CLASSES):
                    if not metrics["class_present"][i, k]:
                        continue
                    results.append({
                        "sample_idx": sample_idx, "channel": ch_name,
                        "dw_class": DW_CLASSES[k],
                        "mae": float(metrics["class_mae"][i, c, k]),
                        "rmse": float(metrics["class_rmse"][i, c, k]),
                        "laplacian_var_pred": None, "laplacian_var_gt": None,
                        **base,
                    })

            if created_visuals < n_visualize and maps_h is not None:
                from maunet_tpu_torch.evaluate.visualize import plot_evaluation_sample

                plot_evaluation_sample(
                    maps_h[i].astype(np.float32), targets_un[i], outputs_un[i],
                    results[first_row:], channels, stats, info, study_name,
                    trial_id, sample_idx, os.path.join(output_dir, "visualizations"))
                created_visuals += 1
            sample_idx += 1

    if mesh is not None:
        batch_size = round_up_to_mesh(batch_size, mesh)
        sharded = shard_batch_fn(
            lambda model, batch: batch_metrics(model, batch, stats, metadata_features), mesh)
    pending: collections.deque[dict] = collections.deque()
    batches = prefetch_to_device(make_batches(ds, batch_size), device)
    for j in itertools.count():
        with span("eval.load_wait"):
            batch = next(batches, None)
        if batch is None:
            break
        metrics, outputs_un, targets_un = (
            sharded(loaded.model, batch) if mesh is not None
            else batch_metrics(loaded.model, batch, stats, metadata_features))
        entry = {"metrics": metrics, "valid": batch["valid"],
                 "t1": batch["t1_dates"], "t2": batch["t2_dates"]}
        # Valid samples before this batch: only the last batch is padded.
        if min(j * batch_size, len(ds)) < n_visualize:
            # Only the batches the figures are drawn from keep their images.
            entry["images"] = (batch["maps"], outputs_un, targets_un)
        pending.append(entry)
        if len(pending) > MAX_IN_FLIGHT:
            format_rows(pending.popleft())
    while pending:
        format_rows(pending.popleft())

    os.makedirs(output_dir, exist_ok=True)
    report_path = os.path.join(
        output_dir,
        f"{study_name}_{model_type}_{tag_emb}_{trial_id}_job{jobid}_evaluation.csv")
    write_csv(report_path, results)
    log.info(f"Full evaluation report saved to {report_path}")

    info_path = report_path.replace("_evaluation.csv", "_info.csv")
    write_csv(info_path, [{
        "evaluation_csv_path": report_path,
        "model_embedding_type": tag_emb,
        "study_name": study_name,
        "trial_id": trial_id,
        "model_architecture": model_type,
    }])

    for known, label in [(True, "Known"), (False, "Unknown")]:
        for ch_name in channels:
            maes = [r["mae"] for r in results
                    if r["dw_class"] == "overall" and r["channel"] == ch_name
                    and r["is_known_city"] == known]
            if maes:
                log.info(f"{label} cities, {ch_name}: mean MAE "
                         f"{sum(maes) / len(maes):.4f} over {len(maes)} samples")
    return results
