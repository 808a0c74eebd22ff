"""Synthetic dataset fixtures.

A numpy-only copy of ``maunet_tpu/data/synthetic.py``, carried so that the
port imports nothing of ``maunet_tpu``: the same seed writes the same arrays
under the same file names.  Blobby Dynamic World class maps, smooth NDVI/LST
fields correlated with land cover, plausible metadata and CRU series, in the
on-disk ``.npz`` / ``normalization_metrics.json`` / file-name contracts of
``maunet_tpu_torch.data.schema``.
"""

from __future__ import annotations

import os

import numpy as np

from maunet_tpu_torch.data.schema import NormalizationStats, make_sample_filename

_CITIES = [
    ("Rome", 1001, 41.9, 12.5, 2_800_000),
    ("Lagos", 1002, 6.5, 3.4, 14_800_000),
    ("Lyon", 1003, 45.76, 4.84, 520_000),
    ("Osaka", 1004, 34.69, 135.5, 2_700_000),
    ("Quito", 1005, -0.18, -78.47, 1_900_000),
    ("Perth", 1006, -31.95, 115.86, 2_100_000),
]


def _smooth_field(rng: np.random.Generator, hw: int, scale: int = 8) -> np.ndarray:
    """Smooth random field in [-1, 1] via low-res upsampled noise."""
    low = rng.normal(size=(max(2, hw // scale),) * 2)
    reps = int(np.ceil(hw / low.shape[0]))
    up = np.kron(low, np.ones((reps, reps)))[:hw, :hw]
    # cheap separable box blur
    k = max(3, scale // 2)
    kernel = np.ones(k) / k
    up = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 0, up)
    up = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 1, up)
    up = up / (np.abs(up).max() + 1e-9)
    return up.astype(np.float32)


def _dw_map(rng: np.random.Generator, hw: int) -> np.ndarray:
    field = _smooth_field(rng, hw, scale=10)
    bins = np.quantile(field, np.linspace(0, 1, 10)[1:-1])
    return np.digitize(field, bins).astype(np.int64)  # values 0..8


def make_sample(rng: np.random.Generator, hw: int = 64, temporal_len: int = 828,
                meta_signal: float = 0.0, temporal_signal: float = 0.0,
                lat_norm: float = 0.0):
    """One (input, target, metadata, temperature_serie) tuple in reference
    channel order (process.py:182-183).

    ``meta_signal`` / ``temporal_signal`` plant a signal that spatial inputs
    cannot explain (the ablation-science fixture):

    - metadata: the target LST gains ``meta_signal * lat_norm`` — a uniform
      offset determined by the (z-scored) latitude.  Only models that read
      the metadata vector can predict it; a no-embedding model eats it as
      irreducible error.
    - temporal: the target LST gains ``temporal_signal * recent``, where
      ``recent`` is the mean of the last 12 months of the CRU series — a
      "recent local warming" signal only the LSTM branch can see.
    """
    dw_t1 = _dw_map(rng, hw)
    dw_t2 = dw_t1.copy()
    # plant a land-cover change blob so the change filter keeps the sample
    cx, cy = rng.integers(hw // 4, 3 * hw // 4, size=2)
    r = hw // 5
    yy, xx = np.mgrid[:hw, :hw]
    blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
    dw_t2[blob] = rng.integers(0, 9)

    onehot = lambda m: np.eye(9, dtype=np.float32)[m].transpose(2, 0, 1)
    green = np.isin(dw_t1, [1, 2, 3, 4, 5]).astype(np.float32)
    ndvi_t1 = np.clip(0.25 + 0.5 * green + 0.15 * _smooth_field(rng, hw), -1, 1)
    lst_t1 = (-0.6 * green + 0.4 * _smooth_field(rng, hw)).astype(np.float32)
    rgb = np.stack([_smooth_field(rng, hw) for _ in range(3)])

    green2 = np.isin(dw_t2, [1, 2, 3, 4, 5]).astype(np.float32)
    ndvi_t2 = np.clip(0.25 + 0.5 * green2 + 0.15 * _smooth_field(rng, hw), -1, 1)
    lst_t2 = (-0.6 * green2 + 0.4 * _smooth_field(rng, hw)).astype(np.float32)

    inputs = np.vstack([
        onehot(dw_t1), rgb,
        ndvi_t1[None], lst_t1[None],
        onehot(dw_t2),
    ]).astype(np.float32)
    target = np.stack([ndvi_t2, lst_t2]).astype(np.float32)

    length = int(rng.integers(temporal_len // 2, temporal_len + 1))
    # per-sample "local climate level": shifts the whole (z-scored) series so
    # its recent mean is informative and varies across samples
    level = float(rng.normal(scale=1.0))
    series = (level + 0.3 * rng.normal(size=(length,))
              + 0.002 * np.arange(length)).astype(np.float32)

    if meta_signal or temporal_signal:
        recent = float(series[-12:].mean())
        target[1] += (meta_signal * lat_norm
                      + temporal_signal * recent)
    return inputs, target, series


def generate_dataset(
    root: str,
    samples_per_split: dict[str, int] | None = None,
    hw: int = 64,
    temporal_len: int = 828,
    seed: int = 0,
    meta_signal: float = 0.0,
    temporal_signal: float = 0.0,
) -> str:
    """Write a synthetic processed dataset (train/val/test splits + stats
    json) under ``root``; returns ``root``.

    Non-zero ``meta_signal`` / ``temporal_signal`` plant a metadata-/
    series-dependent offset in the LST target (see :func:`make_sample`) —
    the fixture for the end-to-end ablation science loop."""
    samples_per_split = samples_per_split or {"train": 16, "val": 4, "test": 6}
    rng = np.random.default_rng(seed)

    stats = NormalizationStats(
        rgb_mean=(0.32, 0.31, 0.30), rgb_std=(0.18, 0.17, 0.16),
        temp_mean=31.5, temp_std=6.2,
        meta_mean=(20.0, 10.0, 3e6, 3.0), meta_std=(25.0, 60.0, 4e6, 2.0),
        temp_series_mean=0.1, temp_series_std=0.9,
    )
    os.makedirs(root, exist_ok=True)
    stats.to_json(os.path.join(root, "normalization_metrics.json"))

    # hold the last city out of train entirely (known/unknown eval axis)
    split_cities = {
        "train": _CITIES[:-1],
        "val": _CITIES[:-1],
        "test": _CITIES,
    }
    year_by_split = {"train": (2018, 2023), "val": (2018, 2024), "test": (2018, 2025)}

    for split, count in samples_per_split.items():
        out_dir = os.path.join(root, split)
        os.makedirs(out_dir, exist_ok=True)
        cities = split_cities[split]
        y0, y1 = year_by_split[split]
        for i in range(count):
            city, cid, lat, lon, pop = cities[i % len(cities)]
            t1y = int(rng.integers(y0, y1))
            t2y = y1 if split != "train" else int(rng.integers(t1y, y1 + 1))
            t1m, t2m = int(rng.integers(1, 13)), int(rng.integers(1, 13))
            # Latitude gets real per-sample spread (±12°): with only 6
            # cities a ±0.02° jitter leaves lat/lon/pop perfectly collinear,
            # so a model could attribute a planted *latitude* offset to any
            # of them and the latitude-only sensitivity sweep would read
            # flat.  The planted signal follows the jittered value (meta[0]
            # below), so latitude is identifiable.
            jitter = np.array([rng.uniform(-12.0, 12.0),
                               rng.uniform(-0.02, 0.02)])
            delta_t = (t2y - t1y) + (t2m - t1m) / 12.0
            meta = (np.array([lat + jitter[0], lon + jitter[1], pop, delta_t])
                    - np.array(stats.meta_mean)) / np.array(stats.meta_std)
            inputs, target, series = make_sample(
                rng, hw, temporal_len,
                meta_signal=meta_signal, temporal_signal=temporal_signal,
                lat_norm=float(meta[0]))
            name = make_sample_filename(city, cid, lat + jitter[0], lon + jitter[1],
                                        t1y, t1m, t2y, t2m)
            np.savez_compressed(
                os.path.join(out_dir, name),
                input=inputs, target=target,
                metadata=meta.astype(np.float32),
                temperature_serie=series,
            )
    return root
