"""Inference-time BatchNorm folding.

Port of ``maunet_tpu/models/fuse.py`` on a state_dict.  In eval mode
BatchNorm is an affine map with frozen statistics, so it folds exactly into
the conv before it:

    y = g * (conv(x) + b - m) / sqrt(v + eps) + beta
      = conv_{K * s}(x) + (b - m) * s + beta,      s = g / sqrt(v + eps)

Models built with ``bn_fused=True`` have no BatchNorm modules and load the
folded state_dict with ``strict=True``.  The result is exact up to float
re-association.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def fold_batchnorm(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold every ``<block>.bnN`` into its ``<block>.convN`` (N = 1, 2);
    returns a new state_dict without the BatchNorm entries."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        scope, _, leaf = key.rpartition(".")
        block, _, name = scope.rpartition(".")
        if name in ("bn1", "bn2") and leaf in _BN_LEAVES:
            continue  # consumed by its conv
        bn = f"{block}.bn{name[4:]}"
        if name in ("conv1", "conv2") and f"{bn}.running_var" in state_dict:
            s = state_dict[f"{bn}.weight"] / torch.sqrt(
                state_dict[f"{bn}.running_var"] + BN_EPS)
            if leaf == "weight":
                value = value * s[:, None, None, None]   # (O, I, kh, kw) * (O,)
            else:
                value = (value - state_dict[f"{bn}.running_mean"]) * s \
                    + state_dict[f"{bn}.bias"]
        out[key] = value
    return out
