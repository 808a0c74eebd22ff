"""Satellite layers for the planner app: the cache readers.

A copy of the cache readers of ``maunet_tpu/apps/gee_fetch.py``
(``make_synthetic_cache``, ``load_cached_layers``).  The live Earth Engine
fetch (reference app/gee_utils.py:40-201) needs ``ee``, ``geemap`` and the
network, and is not ported: :func:`get_satellite_data` raises, and the app
then serves the bundled demo tiles, as the JAX app does wherever ``ee`` is
missing.
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def get_satellite_data(lat: float, lon: float, year: int, month: int,
                       cache_dir: str, img_size: int = 512) -> dict[str, np.ndarray]:
    """The live Earth Engine fetch, which the port does not have."""
    raise NotImplementedError(
        "the live Earth Engine fetch (ee, geemap and the network) is not ported; "
        "use the cache readers")


def make_synthetic_cache(cache_dir: str, img_size: int = 512,
                         seed: int = 0) -> dict[str, np.ndarray]:
    """Write synthetic demo layers (the reference bundles real Rome tiles in
    app/cache; we fabricate structurally-faithful ones so the planner runs
    with zero network access)."""
    from maunet_tpu_torch.data.synthetic import _dw_map, _smooth_field

    rng = np.random.default_rng(seed)
    os.makedirs(cache_dir, exist_ok=True)
    dw = _dw_map(rng, img_size).astype(np.float32)
    green = np.isin(dw, [1, 2, 3, 4, 5]).astype(np.float32)
    layers = {
        "dw": dw,
        "rgb": np.clip(np.stack([_smooth_field(rng, img_size) * 60 + 110
                                 for _ in range(3)]), 0, 255).astype(np.float32),
        "ndvi": np.clip(0.25 + 0.5 * green + 0.15 * _smooth_field(rng, img_size),
                        -1, 1).astype(np.float32),
        "temp": (32.0 - 8.0 * green
                 + 3.0 * _smooth_field(rng, img_size)).astype(np.float32),
    }
    for kind, arr in layers.items():
        np.save(os.path.join(cache_dir, f"fetched_{kind}.npy"), arr)
    log.info(f"Synthetic demo cache written to {cache_dir}")
    return layers


def load_cached_layers(cache_dir: str, img_size: int = 512) -> dict[str, np.ndarray]:
    """Offline fallback: load previously fetched/bundled tiles (the reference
    bundles Rome tiles in app/cache, Home.py:50-126)."""
    from maunet_tpu_torch.data.tiles import load_and_resize_image, load_and_resize_rgb

    shape = (img_size, img_size)
    layers = {}
    for kind in ("dw", "rgb", "ndvi", "temp"):
        for ext in (".tif", ".npy"):
            path = os.path.join(cache_dir, f"fetched_{kind}{ext}")
            if os.path.exists(path):
                if kind == "rgb":
                    layers[kind] = load_and_resize_rgb(path, shape)
                else:
                    layers[kind] = load_and_resize_image(
                        path, shape, nearest=(kind == "dw"))
                break
        else:
            from maunet_tpu_torch.apps.planner_core import DEMO_CACHE, load_demo_layers

            if os.path.exists(DEMO_CACHE):
                log.info(f"No cached {kind} tile in {cache_dir}; using the "
                         "bundled demo tiles (reference bundles Rome tiles "
                         "in app/cache, Home.py:50-126).")
                return load_demo_layers(img_size)
            log.warning(f"No cached {kind} tile in {cache_dir}; "
                        "generating a synthetic demo cache.")
            return make_synthetic_cache(cache_dir, img_size)
    return layers
