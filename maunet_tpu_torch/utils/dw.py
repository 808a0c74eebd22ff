"""Dynamic World land-cover constants and colouring.

A copy of ``maunet_tpu/utils/dw.py`` (reference src/utils/visualization.py:
5-48: the class names and the official Dynamic World hex palette), carried
so that the port imports nothing of ``maunet_tpu``.
"""

from __future__ import annotations

import numpy as np

DW_CLASSES: dict[int, str] = {
    0: "water",
    1: "trees",
    2: "grass",
    3: "flooded_vegetation",
    4: "crops",
    5: "shrub_and_scrub",
    6: "built",
    7: "bare",
    8: "snow_and_ice",
}

NUM_DW_CLASSES = len(DW_CLASSES)

HEX_COLORS: tuple[str, ...] = (
    "#419bdf",  # water
    "#547551",  # trees
    "#88b053",  # grass
    "#153d1a",  # flooded_vegetation
    "#e49635",  # crops
    "#517075",  # shrub_and_scrub
    "#616161",  # built
    "#4a3b25",  # bare
    "#fcfcfc",  # snow_and_ice
)

RGB_COLORS = np.array(
    [[int(h[i:i + 2], 16) for i in (1, 3, 5)] for h in HEX_COLORS], dtype=np.uint8
)


def dw_to_rgb(dw_map: np.ndarray) -> np.ndarray:
    """(H, W) int class map in [0, 8] -> (H, W, 3) uint8 RGB by palette lookup."""
    return RGB_COLORS[np.clip(dw_map.astype(np.int64), 0, NUM_DW_CLASSES - 1)]


def get_dw_legend_patches():
    """Matplotlib legend patches for the 9 classes."""
    import matplotlib.patches as mpatches

    return [
        mpatches.Patch(color=HEX_COLORS[i], label=f"{i}: {DW_CLASSES[i]}")
        for i in range(NUM_DW_CLASSES)
    ]
