"""Raw-tile IO: GeoTIFF filename parsing, location/time grouping,
load-and-resize readers and the one-hot class encoding.

A copy of ``maunet_tpu/data/tiles.py`` (which imports JAX through its
package).  Capability parity with reference src/data/processing_10m/utils.py:9-87.
Raw tile filenames (written by the acquisition layer):
    ``{city}_{city_id}_{lat:.4f}_{lon:.4f}_{off_x:.4f}_{off_y:.4f}_{year}_{month:02d}_{type}.tif``
with type ∈ {dw, rgb, ndvi, temp}.

Readers prefer rasterio (exact parity with the reference's resampling);
without it they fall back to OpenCV (reads single/multi-band TIFFs and
resizes with bilinear/nearest), and plain ``.npy`` arrays are supported for
hermetic tests.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

import numpy as np

log = logging.getLogger(__name__)

try:
    import rasterio
    from rasterio.warp import Resampling

    HAVE_RASTERIO = True
except ImportError:
    rasterio = None
    HAVE_RASTERIO = False


def parse_tile_filename(filename: str) -> Dict | None:
    """(reference utils.py:9-37)"""
    try:
        base = os.path.basename(filename)
        stem, img_type = base.rsplit(".", 1)[0], base.rsplit(".", 1)[0].split("_")[-1]
        parts = stem.split("_")
        return {
            "city_name": "_".join(parts[:-8]),
            "city_id": int(parts[-8]),
            "lat": float(parts[-7]),
            "lon": float(parts[-6]),
            "offset_x": float(parts[-5]),
            "offset_y": float(parts[-4]),
            "year": int(parts[-3]),
            "month": int(parts[-2]),
            "type": img_type,
            "filepath": filename,
        }
    except (IndexError, ValueError) as e:
        log.warning(f"Could not parse filename: {filename}. Error: {e}")
        return None


def group_files_by_location_and_time(image_dir: str,
                                     extensions: tuple[str, ...] = (".tif", ".npy")) -> Dict:
    """Group raw tiles by (city_id, lat, lon) then by (year, month)
    (reference utils.py:39-66)."""
    locations: Dict = {}
    for filename in sorted(os.listdir(image_dir)):
        if not filename.endswith(extensions):
            continue
        meta = parse_tile_filename(filename)
        if meta is None:
            continue
        key = (meta["city_id"], meta["lat"], meta["lon"])
        loc = locations.setdefault(key, {
            "lat": meta["lat"], "lon": meta["lon"],
            "city_id": meta["city_id"], "city_name": meta["city_name"],
            "timestamps": {},
        })
        ts = loc["timestamps"].setdefault((meta["year"], meta["month"]), {})
        ts[meta["type"]] = os.path.join(image_dir, filename)
    return locations


def _cv2_resize(data: np.ndarray, target_shape: Tuple[int, int],
                nearest: bool) -> np.ndarray:
    import cv2

    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    # cv2 wants (W, H)
    return cv2.resize(data, (target_shape[1], target_shape[0]), interpolation=interp)


def load_and_resize_image(path: str, target_shape: Tuple[int, int],
                          nearest: bool = False) -> np.ndarray:
    """Single-band tile → (H, W) float array at ``target_shape``
    (reference utils.py:68-76: bilinear default, nearest for DW class maps)."""
    if path.endswith(".npy"):
        data = np.load(path)
        if data.ndim == 3:
            data = data[0]
        if data.shape != tuple(target_shape):
            data = _cv2_resize(data.astype(np.float32), target_shape, nearest)
        return data
    if HAVE_RASTERIO:
        with rasterio.open(path) as src:
            return src.read(
                1, out_shape=tuple(target_shape),
                resampling=Resampling.nearest if nearest else Resampling.bilinear)
    import cv2

    data = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if data is None:
        raise IOError(f"Cannot read tile {path} (no rasterio; cv2 failed)")
    if data.ndim == 3:
        data = data[..., 0]
    return _cv2_resize(data.astype(np.float32), target_shape, nearest)


def load_and_resize_rgb(path: str, target_shape: Tuple[int, int]) -> np.ndarray:
    """3-band tile → (3, H, W) (reference utils.py:78-87)."""
    if path.endswith(".npy"):
        data = np.load(path)
        assert data.ndim == 3
        if data.shape[1:] != tuple(target_shape):
            data = np.stack([
                _cv2_resize(b.astype(np.float32), target_shape, False) for b in data])
        return data
    if HAVE_RASTERIO:
        with rasterio.open(path) as src:
            return src.read(
                [1, 2, 3], out_shape=(3, *target_shape),
                resampling=Resampling.bilinear)
    import cv2

    data = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if data is None or data.ndim != 3:
        raise IOError(f"Cannot read RGB tile {path}")
    data = data[..., :3][..., ::-1]  # BGR → RGB
    data = _cv2_resize(data.astype(np.float32), target_shape, False)
    return data.transpose(2, 0, 1)


def one_hot_encode(img: np.ndarray, num_classes: int = 9) -> np.ndarray:
    """(H, W) int class map in [0, num_classes) -> (num_classes, H, W) one-hot
    (reference src/data/processing_10m/normalization.py:96-100)."""
    clipped = np.clip(img.astype(int), 0, num_classes - 1)
    return np.eye(num_classes, dtype=np.float64)[clipped].transpose(2, 0, 1)
