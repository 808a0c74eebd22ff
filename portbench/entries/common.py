"""What the entries share: checkpoints, statistics, comparisons, the reference."""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import weights
from portbench.reference.model import Reference, f32_exact, identity


def hyperparams(cfg: dict) -> dict:
    """The hyperparameters a checkpoint of ``cfg`` carries."""
    return {"model_type": cfg["model_type"], "base_filters": cfg["base_filters"],
            "temporal_dim": cfg["temporal_dim"], "meta_dim": cfg["meta_dim"],
            "lstm_hidden": cfg["lstm_hidden"], "temporal_embeddings": True,
            "metadata_embeddings": True, "deep_supervision": False,
            "metadata_input_length": cfg["meta_features"], "spatial_channels": cfg["in_channels"]}


def write_checkpoint(cfg: dict, state: dict[str, torch.Tensor], tmp: str) -> str:
    """A published-layout ``.pth`` of ``state`` under ``tmp``."""
    path = os.path.join(tmp, "model.pth")
    torch.save({"model_state_dict": {k: v.cpu() for k, v in state.items()},
                "hyperparameters": hyperparams(cfg), "model_type": cfg["model_type"],
                "metadata_input_length": cfg["meta_features"], "trial_id": 0}, path)
    return path


def stats(cfg: dict):
    from maunet_tpu_torch.data.schema import NormalizationStats

    s = cfg["serving_stats"]
    return NormalizationStats(**{k: tuple(v) if isinstance(v, list) else v for k, v in s.items()})


def rel_err(got, want) -> float:
    """||got - want|| over the reference's spread about its mean,
    ||want - mean(want)||: an output's mean, which differs from seed to
    seed, moves neither side of the ratio."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - want.mean()), 1e-30))


def tile_errs(got, want) -> list[float]:
    """Each tile's RMS error over the RMS spread of all the tiles of its call
    about their mean: one tile's own spread can be nearly flat, and a fault
    in one tile is not diluted by the others."""
    want = [np.asarray(w, np.float64) for w in want]
    every = np.stack(want)
    spread = max(float(np.sqrt(np.mean((every - every.mean()) ** 2))), 1e-30)
    return [float(np.sqrt(np.mean((np.asarray(g, np.float64) - w) ** 2))) / spread
            for g, w in zip(got, want)]


def worst_mean_gap(got: dict, want: dict, channel: int = 2) -> float:
    """The widest gap between a map's mean on the two sides, over every kept
    map of ``channel`` (normalised LST: the gap in units of ``temp_std``).
    An offset of the un-normalisation moves it; it is reported, not
    compared, since sound runs and the fp8 control overlap on it."""
    gaps = [abs(float(np.mean(np.asarray(a, np.float64)) - np.mean(np.asarray(b, np.float64))))
            for i in want if i in got for a, b in zip(got[i][channel], want[i][channel])]
    return max(gaps, default=float("inf"))


def max_abs(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if got.size else 0.0


def reference(cfg: dict, seed: int, device) -> Reference:
    """The plain reference on ``device`` with the cell's seeded weights."""
    with torch.device("meta"):
        ref = Reference(cfg)
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights.make(cfg, seed, device))
    return ref.eval()


@torch.no_grad()
def ref_predict(ref: Reference, maps, series, meta, lengths, device, mask_mode: str,
                quant=identity) -> np.ndarray:
    """The reference's (B, H, W, 2) output in normalised units, f32, on the host."""
    def t(a, dt=torch.float32):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dt)
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    with f32_exact():
        out = ref(t(maps), t(series), t(meta), t(lengths, torch.int64),
                  mask_mode=mask_mode, quant=quant)
    return out.cpu().numpy()


def normalised_lst(lst, s) -> np.ndarray:
    """LST in degrees C back to the model's units, with the benchmark's stats."""
    return (np.asarray(lst, np.float64) - s["temp_mean"]) / s["temp_std"]


def seq(seed: int, n: int, k: int, count: int = 4096) -> np.ndarray:
    """A seeded sequence of ``count`` draws of ``k`` distinct indices below ``n``."""
    rng = np.random.default_rng([seed, 7])
    return np.stack([rng.choice(n, k, replace=False) for _ in range(count)])


def kept_units(seed: int, among: int, k: int) -> set[int]:
    """Which units of the window the check compares: ``k`` of the first ``among``."""
    return {int(i) for i in np.random.default_rng([seed, 11]).choice(among, k, replace=False)}
