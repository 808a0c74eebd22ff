"""Running loss trackers and CSV metric logging.

A copy of ``maunet_tpu/train/metrics.py`` (reference src/utils/metrics.py:3-54),
carried because ``maunet_tpu.train`` imports JAX.
"""

from __future__ import annotations

import csv
import os
from collections import deque


class RunningLoss:
    """Multi-mode running loss tracker: 'cumulative', 'ema', 'sma'."""

    def __init__(self, mode: str = "cumulative", window_size: int = 100,
                 ema_alpha: float = 0.98):
        if mode not in ("cumulative", "ema", "sma"):
            raise ValueError(f"Unknown mode {mode}")
        self.mode = mode
        self.window_size = window_size
        self.ema_alpha = ema_alpha
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.avg = 0.0
        self.ema = None
        self.window: deque = deque(maxlen=self.window_size)

    def update(self, val: float, n: int = 1) -> float:
        if self.mode == "cumulative":
            self.sum += val * n
            self.count += n
            self.avg = self.sum / max(self.count, 1)
            return self.avg
        if self.mode == "ema":
            self.ema = val if self.ema is None else (
                self.ema_alpha * self.ema + (1 - self.ema_alpha) * val)
            return self.ema
        for _ in range(n):
            self.window.append(val)
        self.avg = sum(self.window) / max(len(self.window), 1)
        return self.avg

    def get(self) -> float | None:
        return self.ema if self.mode == "ema" else self.avg


class CSVLogger:
    """Append-only CSV metric log, one row per logging event.  Columns are
    taken from the first row (or an existing file's header) and kept."""

    def __init__(self, path: str):
        self.path = path
        self._fieldnames: list[str] | None = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fieldnames = header

    def log(self, row: dict) -> None:
        if self._fieldnames is None:
            self._fieldnames = list(row)
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                writer.writeheader()
                writer.writerow(row)
            return
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames,
                                    extrasaction="ignore")
            writer.writerow({k: row.get(k, "") for k in self._fieldnames})
