"""Streamlit-free planner logic — the testable layer under apps/planner.py.

A copy of ``maunet_tpu/apps/planner_core.py`` on the port's ``utils/dw.py``,
``data/tiles.py`` and ``data/synthetic.py``, with its own copy of the demo
tiles (``demo_cache/demo_tiles.npz``, byte-equal to the JAX package's).

The reference app's session/button flow lives inline in app/Home.py and has
no tests; here every decision the UI makes (credential/cache-only mode,
canvas background, layer/prediction views, demo-cache discovery) is a pure
function so the suite can drive it without streamlit installed
(reference app/Home.py:50-126 credential flow, :280-328 canvas-over-DW,
:330-416 prediction views).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

from maunet_tpu_torch.utils.dw import dw_to_rgb

log = logging.getLogger(__name__)

DEMO_CACHE = os.path.join(os.path.dirname(__file__), "demo_cache",
                          "demo_tiles.npz")
# Metadata of the bundled demo tiles (the reference bundles Rome,
# app/cache/41.8990_12.4690_2019_08_*.tif; ours are synthetic but keep the
# same nominal location/date so the metadata path is exercised identically).
DEMO_LOCATION = {"lat": 41.899, "lon": 12.469, "year": 2019, "month": 8,
                 "population": 2_800_000.0}


@dataclass(frozen=True)
class DataMode:
    """Resolved data-source mode (reference app/Home.py:50-126)."""

    mode: str              # "live" | "cache"
    reason: str
    defaults: dict         # sidebar defaults (lat/lon/date/population)


def resolve_data_mode(project_id: str | None, service_account: str | None,
                      key_file_exists: bool = False) -> DataMode:
    """Credential-entry flow: live GEE only when a project id AND service
    account (or a private-key file) are supplied; otherwise cache-only mode
    pinned to the bundled demo location."""
    if project_id and (service_account or key_file_exists):
        return DataMode("live", "GEE credentials provided", dict(DEMO_LOCATION))
    reason = ("no GEE credentials — cache-only mode (pre-loaded demo "
              "location only)")
    return DataMode("cache", reason, dict(DEMO_LOCATION))


def load_demo_layers(img_size: int = 512) -> dict[str, np.ndarray]:
    """Load the committed demo tiles and resize to the serving resolution
    (reference bundles app/cache/ Rome GeoTIFFs; we commit a compact .npz)."""
    from maunet_tpu_torch.data.tiles import _cv2_resize

    with np.load(DEMO_CACHE) as z:
        layers = {k: z[k].astype(np.float32) for k in ("dw", "rgb", "ndvi", "temp")}
    shape = (img_size, img_size)
    if layers["dw"].shape != shape:
        layers["dw"] = _cv2_resize(layers["dw"], shape, nearest=True)
        layers["ndvi"] = _cv2_resize(layers["ndvi"], shape, nearest=False)
        layers["temp"] = _cv2_resize(layers["temp"], shape, nearest=False)
        layers["rgb"] = np.stack([_cv2_resize(b, shape, nearest=False)
                                  for b in layers["rgb"]])
    return layers


def canvas_background(dw: np.ndarray):
    """Colorized DW composite as a PIL RGBA image — the paint background
    (reference app/Home.py:284-297; the core 'paint on the map' UX)."""
    from PIL import Image

    rgb = dw_to_rgb(dw)  # (H, W, 3) float 0-1 or uint8
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(rgb).convert("RGBA")


def layer_views(layers: dict[str, np.ndarray]) -> list[tuple[np.ndarray, str]]:
    """Display-normalized views of the four t1 layers
    (reference app/Home.py:182-278)."""
    temp = layers["temp"]
    t_span = float(temp.max() - temp.min())
    return [
        (np.asarray(dw_to_rgb(layers["dw"])), "Land cover (t1)"),
        (np.clip(layers["rgb"].transpose(1, 2, 0) / 255, 0, 1), "RGB (t1)"),
        (np.clip((layers["ndvi"] + 1) / 2, 0, 1), "NDVI (t1)"),
        (np.clip((temp - temp.min()) / (t_span + 1e-9), 0, 1),
         f"LST °C (t1) [{temp.min():.1f}, {temp.max():.1f}]"),
    ]


def prediction_views(ndvi_mod: np.ndarray, lst_mod: np.ndarray,
                     lst_base: np.ndarray) -> tuple[list[tuple[np.ndarray, str]], float]:
    """Display views for a prediction + the mean-ΔT headline metric
    (reference app/Home.py:369-413)."""
    lo, hi = float(lst_mod.min()), float(lst_mod.max())
    delta = lst_mod - lst_base
    dmax = max(float(np.abs(delta).max()), 1e-9)
    views = [
        (np.clip((ndvi_mod + 1) / 2, 0, 1), "Predicted NDVI (t2)"),
        (np.clip((lst_mod - lo) / (hi - lo + 1e-9), 0, 1),
         f"Predicted LST °C (t2) [{lo:.1f}, {hi:.1f}]"),
        (np.clip((delta / dmax + 1) / 2, 0, 1), "ΔLST vs no-change baseline"),
    ]
    return views, float(delta.mean())


def generate_demo_cache(path: str = DEMO_CACHE, hw: int = 256,
                        seed: int = 7) -> str:
    """(Re)generate the bundled demo tiles — a compact, deterministic,
    structurally-faithful stand-in for the reference's Rome cache."""
    from maunet_tpu_torch.data.synthetic import _dw_map, _smooth_field

    rng = np.random.default_rng(seed)
    dw = _dw_map(rng, hw).astype(np.uint8)
    green = np.isin(dw, [1, 2, 3, 4, 5]).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        dw=dw,
        rgb=np.clip(np.stack([_smooth_field(rng, hw) * 60 + 110
                              for _ in range(3)]), 0, 255).astype(np.float16),
        ndvi=np.clip(0.25 + 0.5 * green + 0.15 * _smooth_field(rng, hw),
                     -1, 1).astype(np.float16),
        temp=(32.0 - 8.0 * green
              + 3.0 * _smooth_field(rng, hw)).astype(np.float16),
    )
    log.info(f"Demo cache written to {path}")
    return path
