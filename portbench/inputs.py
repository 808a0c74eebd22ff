"""Seeded inputs: tile batches made on the device, planner requests on the host.

A tile has the planner's 23 channels: one-hot Dynamic World classes at t1 in
blocks of 32 pixels, the standardised RGB, NDVI and temperature as smooth
fields, and the one-hot t2 classes, in which one block of 64 pixels changed.
Targets are a smooth NDVI in (-1, 1) and a smooth standardised LST.  Every
batch holds the same lengths, evenly spaced over the traffic's range, in an
order drawn from the seed, so seeds change the data and not the work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.planner import PALETTE_RGB

BLOCK = 32
CHANGE = 64


def spaced(lo: int, hi: int, n: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def _smooth(gen, b: int, c: int, side: int, device) -> torch.Tensor:
    low = torch.randn(b, c, max(2, side // 8), max(2, side // 8), generator=gen, device=device)
    return F.interpolate(low, size=(side, side), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def tile_batch(gen: torch.Generator, b: int, side: int, t: int, lengths: tuple[int, int],
               device) -> dict[str, torch.Tensor]:
    """One batch as the program's loaders hand it to the device."""
    cells = -(-side // BLOCK)
    dw1 = torch.randint(0, 9, (b, cells, cells), generator=gen, device=device)
    dw1 = dw1.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)[:, :side, :side]
    y0 = torch.randint(0, max(1, side - CHANGE), (b,), generator=gen, device=device)
    x0 = torch.randint(0, max(1, side - CHANGE), (b,), generator=gen, device=device)
    new = torch.randint(0, 9, (b,), generator=gen, device=device)
    r = torch.arange(side, device=device)
    inside = (((r[None, :] >= y0[:, None]) & (r[None, :] < y0[:, None] + CHANGE))[:, :, None]
              & ((r[None, :] >= x0[:, None]) & (r[None, :] < x0[:, None] + CHANGE))[:, None, :])
    dw2 = torch.where(inside, new[:, None, None], dw1)
    fields = _smooth(gen, b, 5, side, device)
    maps = torch.cat([F.one_hot(dw1, 9).float(), fields[..., :3],
                      torch.tanh(fields[..., 3:4]), fields[..., 4:5],
                      F.one_hot(dw2, 9).float()], -1).contiguous()
    order = torch.randperm(b, generator=gen, device=device)
    lens = torch.as_tensor(spaced(*lengths, b), device=device)[order].to(torch.int32)
    series = torch.randn(b, t, generator=gen, device=device)
    series = series * (torch.arange(t, device=device)[None, :] < lens[:, None])
    year1 = 2016 + torch.randint(0, 4, (b, 1), generator=gen, device=device)
    year2 = year1 + torch.randint(1, 4, (b, 1), generator=gen, device=device)
    month = torch.randint(1, 13, (b, 2), generator=gen, device=device)
    target = _smooth(gen, b, 2, side, device)
    return {
        "maps": maps,
        "temp_series": series.contiguous(),
        "temp_lengths": lens,
        "metadata": torch.randn(b, 4, generator=gen, device=device),
        "t1_dates": torch.cat([year1, month[:, :1]], 1).float(),
        "t2_dates": torch.cat([year2, month[:, 1:]], 1).float(),
        "targets": torch.cat([torch.tanh(target[..., :1]),
                              0.5 + 0.25 * target[..., 1:]], -1).contiguous(),
        "valid": torch.ones(b, dtype=torch.bool, device=device),
    }


def batch_pool(seed: int, n: int, b: int, side: int, t: int, lengths, device) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return [tile_batch(gen, b, side, t, lengths, device) for _ in range(n)]


def _fields(rng: np.random.Generator, c: int, side: int) -> np.ndarray:
    """(c, side, side) smooth fields in about [-1, 1]: 8-pixel cells of a
    normal draw, bilinearly joined."""
    low = torch.from_numpy(rng.standard_normal((1, c, side // 8, side // 8)).astype(np.float32))
    up = F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)
    return np.tanh(up[0].numpy())


def planner_layers(rng: np.random.Generator, side: int) -> dict[str, np.ndarray]:
    """The t1 layers of one location, as the planner fetches them."""
    cells = -(-side // BLOCK)
    dw = rng.integers(0, 9, (cells, cells)).repeat(BLOCK, 0).repeat(BLOCK, 1)[:side, :side]
    f = _fields(rng, 5, side)
    return {
        "dw": dw.astype(np.float32),
        "rgb": (127.5 + 127.5 * f[:3]).astype(np.float32),
        "ndvi": f[3].astype(np.float32),
        "temp": (27.5 + 17.5 * f[4]).astype(np.float32),
    }


def planner_place(rng: np.random.Generator) -> dict:
    """Where and when: latitude, longitude, population, the two dates."""
    year1 = int(rng.integers(2016, 2020))
    return {"lat": float(rng.uniform(-60, 60)), "lon": float(rng.uniform(-180, 180)),
            "population": float(rng.uniform(1e4, 1e7)),
            "year_t1": year1, "month_t1": int(rng.integers(1, 13)),
            "year_t2": year1 + int(rng.integers(1, 4)), "month_t2": int(rng.integers(1, 13))}


def canvas(rng: np.random.Generator, side: int, block: int) -> np.ndarray:
    """An RGBA canvas with one square of a drawn class painted on it."""
    out = np.zeros((side, side, 4), np.uint8)
    y, x = rng.integers(0, side - block + 1, 2)
    out[y:y + block, x:x + block, :3] = PALETTE_RGB[int(rng.integers(0, 9))].astype(np.uint8)
    out[y:y + block, x:x + block, 3] = 255
    return out


class SeriesSource:
    """The CRU query's stand-in: a fixed raw series (about 20 +- 5 degrees C)
    per location, its length given."""

    def __init__(self):
        self.series: dict[tuple[float, float], np.ndarray] = {}

    def add(self, rng: np.random.Generator, lat: float, lon: float, length: int) -> None:
        self.series[(lat, lon)] = 20.0 + 5.0 * rng.standard_normal(int(length))

    def query(self, lat, lon, year, month) -> np.ndarray:
        return self.series[(lat, lon)]
