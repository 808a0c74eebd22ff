"""Normalization statistics contract.

A copy of ``NormalizationStats`` from ``maunet_tpu/data/schema.py`` (fields
and JSON schema of ``normalization_metrics.json``, reference
process.py:140-145), carried so that the port imports nothing of
``maunet_tpu``: ``maunet_tpu/data/__init__.py`` imports its JAX input
pipeline.  Only reading is carried; the data pipeline that writes the file
is not ported.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass(frozen=True)
class NormalizationStats:
    """Train-split normalization statistics (reference process.py:140-145)."""

    rgb_mean: tuple[float, float, float]
    rgb_std: tuple[float, float, float]
    temp_mean: float
    temp_std: float
    meta_mean: tuple[float, float, float, float]
    meta_std: tuple[float, float, float, float]
    temp_series_mean: float
    temp_series_std: float

    @classmethod
    def from_json(cls, path: str) -> "NormalizationStats":
        with open(path) as f:
            d = json.load(f)
        return cls(
            rgb_mean=tuple(d["rgb_mean"]),
            rgb_std=tuple(d["rgb_std"]),
            temp_mean=float(d["temp_mean"]),
            temp_std=float(d["temp_std"]),
            meta_mean=tuple(d["meta_mean"]),
            meta_std=tuple(d["meta_std"]),
            temp_series_mean=float(d["temp_series_mean"]),
            temp_series_std=float(d["temp_series_std"]),
        )
