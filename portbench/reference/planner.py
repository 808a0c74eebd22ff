"""The planner's input assembly in NumPy, from the published app
(app/processing_utils.py:35-177 of the reference repository).

A painted canvas becomes a Dynamic World class map by the nearest colour of
the drawing palette (unpainted pixels keep the t1 map); the 23-channel stack
is one-hot(DW t1), the standardised RGB, NDVI, the standardised temperature
and one-hot(DW t2); the metadata are [lat, lon, population, years between the
dates] standardised, then the raw t1 and t2 year and month; the series is
standardised and zero-padded, its length at least 1.
"""

from __future__ import annotations

import numpy as np

# The app's drawing palette, in class order (water .. snow and ice).
PALETTE = ("#419bdf", "#397d49", "#88b053", "#7a87c6", "#e49635",
           "#dfc35a", "#c4281b", "#a59b8f", "#b39fe1")
PALETTE_RGB = np.array([[int(h[i:i + 2], 16) for i in (1, 3, 5)] for h in PALETTE], np.float64)


def canvas_classes(canvas: np.ndarray, dw_t1: np.ndarray) -> np.ndarray:
    """(H, W) classes of an (H, W, 4) uint8 canvas of the map's size."""
    rgb = canvas[..., :3].astype(np.float64)
    best = np.full(rgb.shape[:2], np.inf)
    cls = np.zeros(rgb.shape[:2], np.int64)
    for k, colour in enumerate(PALETTE_RGB):
        d = ((rgb - colour) ** 2).sum(-1)
        better = d < best  # the first of equal distances wins
        cls[better] = k
        best[better] = d[better]
    return np.where(canvas[..., 3] > 0, cls, dw_t1.astype(np.int64))


def one_hot(classes: np.ndarray) -> np.ndarray:
    c = np.clip(classes.astype(np.int64), 0, 8)
    return (c[..., None] == np.arange(9)).astype(np.float64)


def assemble(layers: dict, canvas, lat, lon, population, year_t1, month_t1, year_t2,
             month_t2, stats: dict, series: np.ndarray | None, temporal_length: int):
    """-> (maps (1, H, W, 23) f32, metadata (1, 8) f32, series (1, T) f32,
    lengths (1,) int32)."""
    dw1 = layers["dw"]
    dw2 = dw1 if canvas is None else canvas_classes(np.asarray(canvas), dw1)
    rgb = (np.moveaxis(layers["rgb"].astype(np.float64), 0, -1) / 255.0
           - np.array(stats["rgb_mean"])) / np.array(stats["rgb_std"])
    temp = (layers["temp"].astype(np.float64) - stats["temp_mean"]) / stats["temp_std"]
    stack = np.concatenate([one_hot(dw1), rgb, layers["ndvi"].astype(np.float64)[..., None],
                            temp[..., None], one_hot(dw2)], -1)
    years = (year_t2 - year_t1) + (month_t2 - month_t1) / 12.0
    meta = (np.array([lat, lon, population, years], np.float64)
            - np.array(stats["meta_mean"])) / np.array(stats["meta_std"])
    meta = np.concatenate([meta, [year_t1, month_t1, year_t2, month_t2]])
    out = np.zeros(temporal_length, np.float64)
    n = 0
    if series is not None:
        n = min(len(series), temporal_length)
        out[:n] = (np.asarray(series[:n], np.float64) - stats["temp_series_mean"]) \
            / stats["temp_series_std"]
    return (stack[None].astype(np.float32), meta[None].astype(np.float32),
            out[None].astype(np.float32), np.array([max(n, 1)], np.int32))
