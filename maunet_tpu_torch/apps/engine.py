"""Serving inference engine for the Urban Greening Planner, on PyTorch.

Port of ``maunet_tpu/apps/engine.py``: checkpoint loading, canvas -> Dynamic
World map conversion, 23-channel input assembly, inference, physical-unit
denormalization and the mean-cooling headline metric.  The device is an
explicit argument; ``predict`` and ``predict_many`` move their inputs to it,
run under ``torch.inference_mode()`` and return numpy arrays.  The JAX
engine's device-mesh serving is not ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from maunet_tpu_torch.data.schema import NormalizationStats

log = logging.getLogger(__name__)

# The reference app's drawing palette (app/processing_utils.py:35-45) —
# note: deliberately different hexes from the Dynamic World display palette.
CANVAS_PALETTE = (
    "#419bdf",  # 0 water
    "#397d49",  # 1 trees
    "#88b053",  # 2 grass
    "#7a87c6",  # 3 flooded vegetation
    "#e49635",  # 4 crops
    "#dfc35a",  # 5 shrub and scrub
    "#c4281b",  # 6 built
    "#a59b8f",  # 7 bare
    "#b39fe1",  # 8 snow and ice
)

CANVAS_RGB = np.array(
    [[int(h[i:i + 2], 16) for i in (1, 3, 5)] for h in CANVAS_PALETTE],
    dtype=np.float64)

# The reference's hardcoded serving stats (app/processing_utils.py:15-24) —
# fallback ONLY; prefer stats loaded from the dataset or checkpoint metadata.
DEFAULT_SERVING_STATS = NormalizationStats(
    rgb_mean=(0.5045, 0.4785, 0.4885),
    rgb_std=(0.2355, 0.1755, 0.1391),
    temp_mean=32.1837, temp_std=13.3625,
    meta_mean=(19.9373, 11.3007, 1379817.47, 2.2468),
    meta_std=(23.0396, 71.8749, 5424837.30, 1.5172),
    temp_series_mean=0.1135, temp_series_std=1.0049,
)


def canvas_to_dw_map(canvas_rgba: np.ndarray, target_shape: tuple[int, int],
                     original_map: np.ndarray | None = None) -> np.ndarray:
    """Painted RGBA canvas -> (H, W) DW class map by nearest palette color;
    undrawn (alpha=0) pixels keep the original map
    (reference app/processing_utils.py:70-110).  Pillow is needed only when
    the canvas has to be resized: a NEAREST resize to the canvas's own size
    is the identity."""
    arr = np.asarray(canvas_rgba).astype("uint8")
    if arr.shape[:2] != tuple(target_shape):
        from PIL import Image

        img = Image.fromarray(arr)
        arr = np.array(img.resize((target_shape[1], target_shape[0]),
                                  Image.NEAREST))
    alpha = arr[:, :, 3]
    rgb = arr[:, :, :3].reshape(-1, 3).astype(np.float64)

    dists = ((rgb[:, None, :] - CANVAS_RGB[None, :, :]) ** 2).sum(-1)
    nearest = np.argmin(dists, axis=1).reshape(target_shape)

    if original_map is not None:
        if original_map.ndim == 3:
            original_map = original_map[0]
        nearest = np.where(alpha > 0, nearest, original_map)
    return nearest.astype(np.uint8)


@dataclass
class PlannerInput:
    maps: np.ndarray         # (1, H, W, 23)
    metadata: np.ndarray     # (1, 8)
    temp_series: np.ndarray  # (1, T)
    temp_lengths: np.ndarray  # (1,)


class PlannerEngine:
    """Loads a checkpoint once onto ``device`` and serves predictions."""

    def __init__(self, checkpoint_path: str, *, device: str | torch.device,
                 stats: NormalizationStats | None = None, temp_query=None,
                 temporal_length: int = 828):
        from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint

        self.device = torch.device(device)
        self.loaded = load_any_checkpoint(checkpoint_path, device=self.device)
        self.model = self.loaded.model
        self.stats = stats or DEFAULT_SERVING_STATS
        self.temp_query = temp_query
        self.temporal_length = temporal_length
        self.metadata_features = int(self.loaded.hyperparams.get(
            "metadata_input_length",
            self.loaded.meta.get("metadata_input_length", 8)))
        log.info(f"PlannerEngine ready: {self.loaded.hyperparams.get('model_type')} "
                 f"({checkpoint_path}) on {self.device}")

    # ------------------------------------------------------------------
    def prepare_input(self, layers: dict[str, np.ndarray], canvas_rgba, lat, lon,
                      population, year_t1, month_t1, year_t2, month_t2) -> PlannerInput:
        """Assemble the 23-channel stack from t1 layer arrays + painted canvas
        (reference app/processing_utils.py:112-177).

        layers: {'dw': (H,W) classes, 'rgb': (3,H,W) 0-255, 'ndvi': (H,W),
                 'temp': (H,W) °C} already at serving resolution.
        """
        s = self.stats
        hw = layers["dw"].shape[-2:]
        dw_t1 = layers["dw"]
        if canvas_rgba is not None:
            dw_t2 = canvas_to_dw_map(canvas_rgba, hw, original_map=dw_t1)
        else:
            dw_t2 = dw_t1

        onehot = lambda m: np.eye(9, dtype=np.float32)[
            np.clip(m.astype(int), 0, 8)].transpose(2, 0, 1)
        rgb = (layers["rgb"] / 255.0
               - np.array(s.rgb_mean)[:, None, None]) / np.array(s.rgb_std)[:, None, None]
        temp = (layers["temp"] - s.temp_mean) / s.temp_std

        stack = np.vstack([
            onehot(dw_t1), rgb, layers["ndvi"][None], temp[None], onehot(dw_t2),
        ]).astype(np.float32)
        maps = stack.transpose(1, 2, 0)[None]  # NHWC

        delta_t = (year_t2 - year_t1) + (month_t2 - month_t1) / 12.0
        meta = (np.array([lat, lon, population, delta_t])
                - np.array(s.meta_mean)) / np.array(s.meta_std)
        meta_full = np.concatenate(
            [meta, [year_t1, month_t1], [year_t2, month_t2]]).astype(np.float32)
        if self.metadata_features == 4:
            meta_full = meta_full[:4]

        series = np.zeros((self.temporal_length,), np.float32)
        length = 0
        if self.temp_query is not None:
            try:
                ts = np.asarray(self.temp_query.query(
                    lat, lon, int(year_t1), int(month_t1)))
                ts = (ts - s.temp_series_mean) / s.temp_series_std
                length = min(len(ts), self.temporal_length)
                series[:length] = ts[:length]
            except Exception as e:  # zero-series fallback (reference :169-175)
                log.warning(f"Temperature query failed: {e}; using zero series.")
        return PlannerInput(
            maps=maps,
            metadata=meta_full[None],
            temp_series=series[None],
            temp_lengths=np.array([max(length, 1)], np.int32),
        )

    def _forward(self, maps, temp_series, metadata, temp_lengths) -> np.ndarray:
        dev = self.device
        with torch.inference_mode():
            out = self.model(
                torch.as_tensor(maps, dtype=torch.float32, device=dev),
                torch.as_tensor(temp_series, dtype=torch.float32, device=dev),
                torch.as_tensor(metadata, dtype=torch.float32, device=dev),
                torch.as_tensor(temp_lengths, dtype=torch.int32, device=dev))
            return out.float().cpu().numpy()

    def predict(self, inp: PlannerInput) -> tuple[np.ndarray, np.ndarray]:
        """-> (ndvi (H, W) in [-1, 1], lst (H, W) in °C)."""
        out = self._forward(inp.maps, inp.temp_series, inp.metadata,
                            inp.temp_lengths)[0]
        ndvi = out[..., 0]
        lst = out[..., 1] * self.stats.temp_std + self.stats.temp_mean
        return ndvi, lst

    def predict_many(self, inputs: list[PlannerInput]
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched prediction over a request list, as one forward on the
        engine's device."""
        out = self._forward(
            np.concatenate([i.maps for i in inputs]),
            np.concatenate([i.temp_series for i in inputs]),
            np.concatenate([i.metadata for i in inputs]),
            np.concatenate([i.temp_lengths for i in inputs]))
        s = self.stats
        return [(o[..., 0], o[..., 1] * s.temp_std + s.temp_mean) for o in out]

    def cooling_metric(self, lst_baseline: np.ndarray,
                       lst_modified: np.ndarray) -> float:
        """Mean ΔLST (°C) of the proposed change vs baseline
        (reference app/Home.py:330-416 mean-cooling metric)."""
        return float(np.mean(lst_modified - lst_baseline))
