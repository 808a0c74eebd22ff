"""The published evaluation metrics (test/evaluate.py:200-275 of the
reference repository), in plain PyTorch.

Per sample and channel: MAE, RMSE and the variance of the Laplacian
(``scipy.ndimage.laplace``: the 5-point stencil, edges reflected, so the edge
value repeats) of prediction and target; per Dynamic World class of the t1
map (the argmax of the first 9 input channels, each weighted by its index):
MAE and RMSE over the class's pixels, NaN where it has none.  LST is
un-normalised to degrees C first.  ``quant`` rounds every input of a sum,
for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import f32_exact

CLASSES = 9


def unnormalise(x: torch.Tensor, stats: dict) -> torch.Tensor:
    return torch.cat([x[..., :1], x[..., 1:2] * stats["temp_std"] + stats["temp_mean"]], -1)


def dw_classes(maps: torch.Tensor) -> torch.Tensor:
    w = maps[..., :CLASSES].float() * torch.arange(CLASSES, device=maps.device)
    return w.argmax(-1)


def laplacian_var(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C)."""
    p = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    lap = p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:] \
        - 4 * p[..., 1:-1, 1:-1]
    return lap.var(dim=(-2, -1), unbiased=False)


def metrics(pred: torch.Tensor, target: torch.Tensor, maps: torch.Tensor,
            quant=lambda t: t) -> dict[str, torch.Tensor]:
    """pred, target (B, H, W, C) un-normalised; maps the input stack."""
    with f32_exact():
        return _metrics(pred, target, maps, quant)


def _metrics(pred, target, maps, quant):
    pred, target = quant(pred.float()), quant(target.float())
    err = quant(pred - target)
    cls = dw_classes(maps)
    onehot = F.one_hot(cls, CLASSES).float()  # (B, H, W, K)
    count = onehot.sum(dim=(1, 2))  # (B, K)
    sum_abs = torch.einsum("bhwc,bhwk->bck", quant(err.abs()), onehot)
    sum_sq = torch.einsum("bhwc,bhwk->bck", quant(err * err), onehot)
    present = count > 0
    denom = count.clamp_min(1)[:, None, :]
    nan = torch.full_like(sum_abs, float("nan"))
    return {
        "mae": quant(err.abs().mean(dim=(1, 2))),
        "rmse": quant((err * err).mean(dim=(1, 2)).sqrt()),
        "lap_var_pred": quant(laplacian_var(pred)),
        "lap_var_gt": quant(laplacian_var(target)),
        "class_mae": torch.where(present[:, None, :], quant(sum_abs / denom), nan),
        "class_rmse": torch.where(present[:, None, :], quant((sum_sq / denom).sqrt()), nan),
        "class_present": present,
    }
