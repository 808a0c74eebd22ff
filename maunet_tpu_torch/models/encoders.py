"""Non-spatial context encoders: metadata MLP and CRU-history LSTM.

Port of ``maunet_tpu/models/encoders.py``.  The input projection (input size
1) of all T steps is hoisted out of the recurrence into one broadcast
product; the recurrence itself is ``ops/kernels/lstm.py``.  Length handling
is explicit, and all three mask modes reduce to per-sample effective lengths:

- ``per_sample``: each sample's state freezes at its own true length;
- ``batch_max``: state freezes at the batch max length, the reference's
  unmasked zero-padding leak-through (reference src/model.py:23-34), needed
  to reproduce the public PyTorch checkpoints;
- ``none``: run the full padded length.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from maunet_tpu_torch.ops.kernels import lstm as lstm_k

MASK_MODES = ("per_sample", "batch_max", "none")


class LSTMParams(nn.Module):
    """Holder of ``nn.LSTM``'s one-layer parameters under its names
    (``weight_ih_l0`` (4H, in), ``weight_hh_l0`` (4H, H), ``bias_ih_l0``,
    ``bias_hh_l0``), so reference state_dicts load; the recurrence runs in
    the port's kernel, not in ``nn.LSTM``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * hidden_size))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * hidden_size))
        bound = 1.0 / math.sqrt(hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)


def effective_lengths(lengths: torch.Tensor | None, b: int, t: int,
                      mask_mode: str, device) -> torch.Tensor:
    """(B,) int32 lengths at which each sample's state freezes."""
    if lengths is None or mask_mode == "none":
        return torch.full((b,), t, dtype=torch.int32, device=device)
    lengths = lengths.to(device=device, dtype=torch.int32)
    if mask_mode == "batch_max":
        return lengths.max().expand(b).contiguous()
    return lengths.contiguous()


class TemporalEncoder(nn.Module):
    """LSTM(1 -> hidden) over the monthly CRU series, last hidden state ->
    Linear(hidden -> out_dim) (reference src/model.py:23-34).  Gate order
    (i, f, g, o), as torch packs it."""

    def __init__(self, hidden_dim: int, out_dim: int,
                 mask_mode: str = "per_sample",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if mask_mode not in MASK_MODES:
            raise ValueError(f"unknown mask_mode: {mask_mode!r}")
        self.mask_mode = mask_mode
        self.compute_dtype = compute_dtype
        self.lstm = LSTMParams(1, hidden_dim)
        self.fc = nn.Linear(hidden_dim, out_dim)

    def recurrence_inputs(self, series: torch.Tensor, lengths: torch.Tensor | None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x_proj (B, T, 4H), W_hh^T (H, 4H), effective lengths (B,)): the
        arguments of the recurrence."""
        b, t = series.shape
        p = self.lstm
        x_proj = (series.float()[..., None] * p.weight_ih_l0[:, 0]
                  + (p.bias_ih_l0 + p.bias_hh_l0)).contiguous()
        eff = effective_lengths(lengths, b, t, self.mask_mode, series.device)
        return x_proj, p.weight_hh_l0.t().contiguous(), eff

    def forward(self, series: torch.Tensor,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
        h = lstm_k.lstm_last_hidden(*self.recurrence_inputs(series, lengths))
        return self.fc(h).to(self.compute_dtype)


class MetadataEncoder(nn.Module):
    """MLP Linear(in -> 32) -> ReLU -> Linear(32 -> out_dim) over the 4- or
    8-feature metadata vector (reference src/model.py:38-48)."""

    def __init__(self, in_features: int, out_dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = nn.Sequential(nn.Linear(in_features, 32), nn.ReLU(),
                                nn.Linear(32, out_dim))

    def forward(self, meta: torch.Tensor) -> torch.Tensor:
        return self.fc(meta.float()).to(self.compute_dtype)
