"""Evaluation metrics on the model's device.

Port of ``maunet_tpu/evaluate/metrics.py`` (the reference computes them in
Python loops on the host, test/evaluate.py:210-275): per sample and channel
the MAE, the RMSE and the Laplacian-variance sharpness of prediction and
ground truth, and the MAE and RMSE within each of the 9 Dynamic World
classes.  The per-class sums run in ``ops/kernels/masked_stats.py``: the
CUDA kernel for a CUDA tensor, the one-hot einsum for a CPU tensor.

Parity notes, as in the JAX module:
- the Laplacian is ``scipy.ndimage.laplace``: the [[0,1,0],[1,-4,1],[0,1,0]]
  stencil under scipy's 'reflect' boundary, which duplicates the edge (numpy's
  'symmetric' padding; torch's 'replicate' for a pad of one);
- the class map is the reference's ``argmax_c(input[c] * c)``
  (test/evaluate.py:212-217), which for one-hot inputs is the class index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.ops.kernels import masked_stats

NUM_CLASSES = masked_stats.NUM_CLASSES


def dw_map_from_input(maps: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 23) input stack -> (B, H, W) int32 DW-t1 class map."""
    weighted = maps[..., :NUM_CLASSES] * torch.arange(
        NUM_CLASSES, dtype=maps.dtype, device=maps.device)
    return weighted.argmax(dim=-1).to(torch.int32)


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """``scipy.ndimage.laplace`` of the last two axes of (..., H, W)."""
    lead = x.shape[:-2]
    xp = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (1, 1, 1, 1), mode="replicate")
    xp = xp.reshape(*lead, *xp.shape[-2:])
    return (xp[..., :-2, 1:-1] + xp[..., 2:, 1:-1]
            + xp[..., 1:-1, :-2] + xp[..., 1:-1, 2:]
            - 4.0 * xp[..., 1:-1, 1:-1])


def laplacian_variance(x: torch.Tensor) -> torch.Tensor:
    """Variance of the Laplacian over the spatial axes (sharpness proxy,
    reference test/evaluate.py:241-242)."""
    return laplacian(x).var(dim=(-2, -1), correction=0)


def unnormalize_targets(arr: torch.Tensor,
                        stats: NormalizationStats | None) -> torch.Tensor:
    """Un-normalize (B, H, W, 2) [NDVI, LST]: LST back to degrees C, NDVI
    unchanged (reference test/evaluate.py:23-41)."""
    if stats is None:
        return arr
    lst = arr[..., 1:2] * stats.temp_std + stats.temp_mean
    return torch.cat([arr[..., 0:1], lst], dim=-1)


@torch.no_grad()
def eval_metrics(pred: torch.Tensor, target: torch.Tensor,
                 dw_map: torch.Tensor) -> dict[str, torch.Tensor]:
    """All reference evaluation metrics of one batch, on its device.

    pred, target: (B, H, W, C) un-normalized; dw_map: (B, H, W) int32.
    Returns ``mae``, ``rmse``, ``lap_var_pred``, ``lap_var_gt`` (B, C);
    ``class_mae``, ``class_rmse`` (B, C, 9), NaN where the class is absent;
    ``class_present`` (B, 9) bool.
    """
    err = (pred - target).float()
    mae = err.abs().mean(dim=(1, 2))
    rmse = (err * err).mean(dim=(1, 2)).sqrt()
    lap_pred = laplacian_variance(pred.float().permute(0, 3, 1, 2))
    lap_gt = laplacian_variance(target.float().permute(0, 3, 1, 2))

    sum_abs, sum_sq, counts = masked_stats.masked_class_sums(
        pred.contiguous(), target.contiguous(), dw_map.contiguous())
    present = counts[:, None, :] > 0
    safe = counts.clamp_min(1.0)[:, None, :]
    nan = torch.full_like(sum_abs, float("nan"))
    return {
        "mae": mae,
        "rmse": rmse,
        "lap_var_pred": lap_pred,
        "lap_var_gt": lap_gt,
        "class_mae": torch.where(present, sum_abs / safe, nan),
        "class_rmse": torch.where(present, (sum_sq / safe).sqrt(), nan),
        "class_present": counts > 0,
    }
