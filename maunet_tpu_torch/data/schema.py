"""Data contracts: the ``normalization_metrics.json`` schema and the sample
filename codec.

Copies of ``NormalizationStats``, ``make_sample_filename`` and
``parse_sample_filename`` from ``maunet_tpu/data/schema.py`` (reference
process.py:140-145,158, src/dataset.py:47-52,74-82), carried so that the
port imports nothing of ``maunet_tpu``: ``maunet_tpu/data/__init__.py``
imports its JAX input pipeline.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass


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

    def to_json(self, path: str) -> None:
        d = asdict(self)
        d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
        with open(path, "w") as f:
            json.dump(d, f, indent=4)


def make_sample_filename(city: str, city_id, lat: float, lon: float,
                         t1_year: int, t1_month: int,
                         t2_year: int, t2_month: int) -> str:
    return (f"{city}_{city_id}_{lat:.4f}_{lon:.4f}_"
            f"{t1_year}_{t1_month:02d}_to_{t2_year}_{t2_month:02d}.npz")


def parse_sample_filename(filename: str) -> dict:
    """City, lat/lon and t1/t2 dates from a sample filename, by the
    reference's positional parsing: split on '_'; t1 = (parts[-5],
    parts[-4]), t2 = (parts[-2], parts[-1]), lat = parts[-7],
    lon = parts[-6], city = ' '.join(parts[:-8])."""
    base = os.path.basename(filename)
    if base.endswith(".npz"):
        base = base[:-4]
    parts = base.split("_")
    return {
        "city": " ".join(parts[:-8]),
        "city_id": parts[-8],
        "lat": float(parts[-7]),
        "lon": float(parts[-6]),
        "t1_year": int(parts[-5]),
        "t1_month": int(parts[-4]),
        "t2_year": int(parts[-2]),
        "t2_month": int(parts[-1]),
    }
