"""Serving inference engine for the Urban Greening Planner, on PyTorch.

Port of ``maunet_tpu/apps/engine.py``: checkpoint loading, canvas -> Dynamic
World map conversion, 23-channel input assembly, inference, physical-unit
denormalization and the mean-cooling headline metric.  The device is an
explicit argument; ``predict`` and ``predict_many`` move their inputs to it,
run under ``torch.inference_mode()`` and return numpy arrays.  With a mesh,
``predict_many`` serves a request batch data-parallel over its devices
(``parallel.infer``), padded to a multiple of the mesh's size with repeats
of the last request, whose rows are dropped again.

Spans (``utils.profiling``, recorded while a profiler runs):
``engine.prepare_input`` holds ``engine.canvas_to_dw`` (with a canvas) and
``engine.assemble``; ``engine.predict_many`` holds ``engine.concat``; a
forward, ``engine.forward``, holds ``engine.upload``, ``engine.model`` and
``engine.download``, whose ``.cpu()`` waits for the device's work.
``PlannerEngine.pageable_h2d_bytes`` tallies the bytes a forward uploads from
pageable host arrays (on the CPU, the bytes it would upload);
``PlannerEngine.canvas_colours_searched`` the distinct colours each painted
canvas's nearest-colour search ran over.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.parallel.infer import round_up_to_mesh, shard_batch_fn
from maunet_tpu_torch.parallel.mesh import Mesh
from maunet_tpu_torch.utils.profiling import span, tally

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
_CANVAS_RGB_INT = CANVAS_RGB.astype(np.int32)

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
    is the identity.

    Only painted pixels are searched when ``original_map`` is given.  Each
    searched pixel's RGB is packed into one integer; the distinct ones are
    compared with the palette in ``int32`` (squared distances at most
    3 * 255**2, so exact), ``argmin`` keeps the first of equal distances, and
    their number is tallied in ``PlannerEngine.canvas_colours_searched``."""
    arr = np.asarray(canvas_rgba).astype("uint8")
    if arr.shape[:2] != tuple(target_shape):
        from PIL import Image

        img = Image.fromarray(arr)
        arr = np.array(img.resize((target_shape[1], target_shape[0]),
                                  Image.NEAREST))
    alpha = arr[:, :, 3]
    # R | G << 8 | B << 16 | A << 24 per pixel, alpha masked off below.
    packed = np.ascontiguousarray(arr[:, :, :4]).view("<u4").reshape(-1)
    if original_map is None:
        out, searched = np.empty(alpha.shape, np.uint8), slice(None)
    else:
        if original_map.ndim == 3:
            original_map = original_map[0]
        # Unpainted pixels keep the map, cast to uint8 through its promotion
        # with intp (a float map through float64), as np.where would merge it.
        wide = original_map.astype(np.result_type(np.intp, original_map.dtype), copy=False)
        out = np.broadcast_to(wide, alpha.shape).astype(np.uint8, order="C")
        searched = np.flatnonzero(alpha)
    colours, inverse = np.unique(packed[searched] & 0xFFFFFF, return_inverse=True)
    rgb = np.stack([colours & 0xFF, colours >> 8 & 0xFF, colours >> 16], 1).astype(np.int32)
    nearest = ((rgb[:, None, :] - _CANVAS_RGB_INT[None]) ** 2).sum(-1).argmin(1)
    out.reshape(-1)[searched] = nearest.astype(np.uint8)[inverse]
    tally(PlannerEngine, "canvas_colours_searched", len(colours))
    return out


def _one_hot(classes: np.ndarray, planes: np.ndarray) -> None:
    """Writes the (9, H, W) one-hot planes of a class map, each class
    truncated to an integer and clipped to 0..8."""
    k = np.clip(classes.astype(int), 0, 8).astype(np.uint8)
    for c in range(9):
        np.equal(k, c, out=planes[c], casting="unsafe")


# A request batch's inputs, in the model's argument order, with their dtypes.
_INPUTS = (("maps", torch.float32), ("temp_series", torch.float32),
           ("metadata", torch.float32), ("temp_lengths", torch.int32))


def _apply(model: torch.nn.Module, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """The model on one shard of a request batch, in inference mode."""
    with torch.inference_mode():
        return model(*(batch[k] for k, _ in _INPUTS))


def _host_inputs(arrays) -> list[torch.Tensor]:
    """A request batch's arrays as host tensors of the model's dtypes, in
    ``_INPUTS``' order; tallies the bytes a forward uploads from them."""
    host = [torch.as_tensor(a, dtype=dtype) for a, (_, dtype) in zip(arrays, _INPUTS)]
    tally(PlannerEngine, "pageable_h2d_bytes", sum(t.nbytes for t in host))
    return host


@dataclass
class PlannerInput:
    maps: np.ndarray         # (1, H, W, 23)
    metadata: np.ndarray     # (1, 8)
    temp_series: np.ndarray  # (1, T)
    temp_lengths: np.ndarray  # (1,)


class PlannerEngine:
    """Loads a checkpoint once onto ``device`` and serves predictions."""

    # Bytes of host arrays the forwards of every engine uploaded from pageable memory.
    pageable_h2d_bytes = 0
    # Distinct colours the painted canvases' nearest-colour searches ran over.
    canvas_colours_searched = 0

    def __init__(self, checkpoint_path: str, *, device: str | torch.device,
                 stats: NormalizationStats | None = None, temp_query=None,
                 temporal_length: int = 828, img_size: int = 512,
                 mesh: Mesh | None = None):
        """``img_size``: the side of the layers the planner fetches and shows
        (the JAX engine's, kept for the app; the model takes any size).
        ``mesh``: the devices ``predict_many`` shards request batches over."""
        from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint

        self.device = torch.device(device)
        self.loaded = load_any_checkpoint(checkpoint_path, device=self.device)
        self.model = self.loaded.model
        self.stats = stats or DEFAULT_SERVING_STATS
        self.temp_query = temp_query
        self.temporal_length = temporal_length
        self.img_size = img_size
        self.metadata_features = int(self.loaded.hyperparams.get(
            "metadata_input_length",
            self.loaded.meta.get("metadata_input_length", 8)))
        self.mesh = mesh
        self._forward_many = None if mesh is None else shard_batch_fn(_apply, mesh)
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
        with span("engine.prepare_input"):
            dw_t1 = layers["dw"]
            if canvas_rgba is not None:
                with span("engine.canvas_to_dw"):
                    dw_t2 = canvas_to_dw_map(canvas_rgba, dw_t1.shape[-2:], original_map=dw_t1)
            with span("engine.assemble"):
                s = self.stats
                # Fresh and channel-major (a caller may keep every input it is
                # given); each channel is computed in the dtype numpy promotes
                # it to (RGB in float64) and rounded to f32 once, as it is stored.
                buf = np.empty((23, *dw_t1.shape), np.float32)
                _one_hot(dw_t1, buf[:9])
                rgb_mean, rgb_std = np.array(s.rgb_mean), np.array(s.rgb_std)
                for c in range(3):
                    buf[9 + c] = (layers["rgb"][c] / 255.0
                                  - rgb_mean[c:c + 1]) / rgb_std[c:c + 1]
                buf[12] = layers["ndvi"]
                buf[13] = (layers["temp"] - s.temp_mean) / s.temp_std
                if canvas_rgba is None:
                    buf[14:] = buf[:9]
                else:
                    _one_hot(dw_t2, buf[14:])
                maps = buf.transpose(1, 2, 0)[None]  # NHWC

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
        with span("engine.forward"), torch.inference_mode():
            with span("engine.upload"):
                host = _host_inputs((maps, temp_series, metadata, temp_lengths))
                args = [t.to(self.device) for t in host]
            with span("engine.model"):
                out = self.model(*args)
            with span("engine.download"):
                return out.float().cpu().numpy()

    def predict(self, inp: PlannerInput) -> tuple[np.ndarray, np.ndarray]:
        """-> (ndvi (H, W) in [-1, 1], lst (H, W) in °C)."""
        with span("engine.predict"):
            out = self._forward(inp.maps, inp.temp_series, inp.metadata,
                                inp.temp_lengths)[0]
        ndvi = out[..., 0]
        lst = out[..., 1] * self.stats.temp_std + self.stats.temp_mean
        return ndvi, lst

    def predict_many(self, inputs: list[PlannerInput]
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched prediction over a request list: one forward on the
        engine's device, or data-parallel over the engine's mesh.  On the mesh,
        ``engine.upload`` makes the padded host batch and each shard's copy runs
        inside ``engine.model``."""
        with span("engine.predict_many"):
            with span("engine.concat"):
                arrays = [np.concatenate([getattr(i, k) for i in inputs]) for k, _ in _INPUTS]
            if self._forward_many is None:
                out = self._forward(*arrays)
            else:
                n = len(inputs)
                pad = round_up_to_mesh(n, self.mesh) - n
                with span("engine.forward"):
                    with span("engine.upload"):
                        host = _host_inputs([np.concatenate([v] + [v[-1:]] * pad)
                                             for v in arrays])
                    with span("engine.model"):
                        out = self._forward_many(self.model, dict(zip(
                            (k for k, _ in _INPUTS), host)))
                    with span("engine.download"):
                        out = out.float().cpu().numpy()[:n]
        s = self.stats
        return [(o[..., 0], o[..., 1] * s.temp_std + s.temp_mean) for o in out]

    def cooling_metric(self, lst_baseline: np.ndarray,
                       lst_modified: np.ndarray) -> float:
        """Mean ΔLST (°C) of the proposed change vs baseline
        (reference app/Home.py:330-416 mean-cooling metric)."""
        return float(np.mean(lst_modified - lst_baseline))
