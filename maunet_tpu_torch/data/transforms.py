"""Data augmentation (host-side, HWC numpy).

A copy of ``maunet_tpu/data/transforms.py`` (reference src/dataset.py:134-141),
carried so that the port imports nothing of ``maunet_tpu``.
"""

from __future__ import annotations

import numpy as np


class RandomFlip:
    """Horizontal flip of input and target with probability 0.5 (the
    reference flips axis 2 of CHW, the width; here axis 1 of HWC), from a
    seeded stateful generator: one draw per sample."""

    def __init__(self, seed: int = 42):
        self.rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray, y: np.ndarray):
        if self.rng.random() < 0.5:
            x = np.ascontiguousarray(x[:, ::-1, :])
            y = np.ascontiguousarray(y[:, ::-1, :])
        return x, y

    def skip(self, n: int) -> None:
        """Advance the generator past ``n`` samples' draws, as if they had
        been loaded: a resumed run then flips as an unbroken one does."""
        self.rng.random(n)
