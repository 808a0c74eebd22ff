"""Raw-tile overview figure.

The port's copy of ``maunet_tpu/analysis/tile_viz.py`` (reference
src/utils/dataset_visualize.py:12-77): the raw exported tiles (Dynamic
World, RGB, NDVI, LST) of one location across its timestamps, in a grid
with colorbars.  matplotlib is imported inside the function.
"""

from __future__ import annotations

import os

import numpy as np

from maunet_tpu_torch.data.tiles import (
    group_files_by_location_and_time,
    load_and_resize_image,
    load_and_resize_rgb,
)
from maunet_tpu_torch.utils.dw import dw_to_rgb
from maunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def visualize_raw_tiles(image_dir: str, out_path: str | None = None,
                        max_timestamps: int = 6, edge: int = 250) -> str:
    """Render the first location's tiles across timestamps to a PNG grid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    locations = group_files_by_location_and_time(image_dir)
    if not locations:
        raise FileNotFoundError(f"No parseable tiles in {image_dir}")
    loc = next(iter(locations.values()))
    stamps = sorted(loc["timestamps"])[:max_timestamps]
    shape = (edge, edge)

    fig, axes = plt.subplots(len(stamps), 4,
                             figsize=(18, 4 * len(stamps)), squeeze=False)
    for row, stamp in enumerate(stamps):
        files = loc["timestamps"][stamp]
        panels = []
        if "dw" in files:
            panels.append((dw_to_rgb(load_and_resize_image(
                files["dw"], shape, nearest=True).astype(int)), "DW", {}))
        if "rgb" in files:
            rgb = load_and_resize_rgb(files["rgb"], shape)
            panels.append((np.clip(rgb.transpose(1, 2, 0) / 255, 0, 1), "RGB", {}))
        if "ndvi" in files:
            panels.append((load_and_resize_image(files["ndvi"], shape), "NDVI",
                           dict(cmap="RdYlGn", vmin=-1, vmax=1)))
        if "temp" in files:
            panels.append((load_and_resize_image(files["temp"], shape),
                           "LST (°C)", dict(cmap="inferno")))
        for col, (img, title, kw) in enumerate(panels):
            ax = axes[row][col]
            im = ax.imshow(img, **kw)
            ax.set_title(f"{loc['city_name']} {stamp[0]}-{stamp[1]:02d} {title}")
            ax.axis("off")
            if kw:
                plt.colorbar(im, ax=ax, fraction=0.045)
    fig.tight_layout()
    out_path = out_path or os.path.join(image_dir, "tiles_overview.png")
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    log.success(f"Raw-tile overview → {out_path}")
    return out_path
