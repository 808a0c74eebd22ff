"""Host-side ``.npz`` tile dataset and fixed-shape batching.

A numpy-only copy of ``maunet_tpu/data/dataset.py`` (reference
src/dataset.py:18-131), carried so that the port imports nothing of
``maunet_tpu``: ``maunet_tpu/data/__init__.py`` imports its JAX input
pipeline.  The series is padded to the configured length with an explicit
length vector, batches are dicts of NHWC numpy arrays, and the last partial
batch is padded with a ``valid`` mask.  Left out: the native C++ npz decoder
(numpy reads every file), the multi-host ``sample_slice`` and ``pad_final``,
which no caller turns off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from maunet_tpu_torch.data.schema import parse_sample_filename


@dataclass
class Batch:
    """One fixed-shape batch (host numpy, NHWC)."""

    maps: np.ndarray          # (B, H, W, 23) f32
    targets: np.ndarray       # (B, H, W, 2)  f32
    metadata: np.ndarray      # (B, 4) f32  (z-scored lat/lon/pop/dt)
    temp_series: np.ndarray   # (B, T) f32, zero-padded
    temp_lengths: np.ndarray  # (B,) i32 true lengths
    t1_dates: np.ndarray      # (B, 2) f32 (year, month)
    t2_dates: np.ndarray      # (B, 2) f32
    valid: np.ndarray         # (B,) bool, False for tail padding
    sample_idx: np.ndarray    # (B,) i32 dataset indices

    def as_dict(self) -> dict[str, np.ndarray]:
        return self.__dict__.copy()


class NpzDataset:
    """Sorted list of per-sample ``.npz`` files for one split
    (reference src/dataset.py:18-82)."""

    def __init__(self, data_dir: str, temporal_length: int = 828,
                 transform: Callable | None = None):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(f"Split directory not found: {data_dir}")
        self.data_dir = data_dir
        self.temporal_length = temporal_length
        self.transform = transform
        self.files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                            if f.endswith(".npz"))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        path = self.files[idx]
        info = parse_sample_filename(path)
        with np.load(path) as data:
            maps = np.ascontiguousarray(
                data["input"].astype(np.float32).transpose(1, 2, 0))   # HWC
            target = np.ascontiguousarray(
                data["target"].astype(np.float32).transpose(1, 2, 0))
            metadata = data["metadata"].astype(np.float32)
            series = data["temperature_serie"].astype(np.float32)
        if self.transform is not None:
            maps, target = self.transform(maps, target)
        t = self.temporal_length
        length = min(len(series), t)
        padded = np.zeros((t,), np.float32)
        padded[:length] = series[:length]
        return {
            "maps": maps,
            "targets": target,
            "metadata": metadata,
            "temp_series": padded,
            "temp_lengths": np.int32(length),
            "t1_dates": np.array([info["t1_year"], info["t1_month"]], np.float32),
            "t2_dates": np.array([info["t2_year"], info["t2_month"]], np.float32),
        }


def make_batches(dataset: NpzDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, epoch: int = 0, drop_last: bool = False) -> Iterator[Batch]:
    """Yield fixed-shape Batches.  Shuffling is seeded and epoch-keyed, the
    same permutation as the JAX package's.  A last partial batch is dropped
    (``drop_last``) or padded with its last sample and marked in ``valid``."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        valid = np.ones(len(idx), bool)
        if len(idx) < batch_size:
            if drop_last:
                return
            pad = np.full(batch_size - len(idx), idx[-1], idx.dtype)
            valid = np.concatenate([valid, np.zeros(len(pad), bool)])
            idx = np.concatenate([idx, pad])
        samples = [dataset[int(i)] for i in idx]
        stack = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        yield Batch(valid=valid, sample_idx=idx.astype(np.int32), **stack)
