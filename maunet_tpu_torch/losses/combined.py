"""Combined training losses, returning ``{'total': ..., components...}``.

Port of ``maunet_tpu/losses/combined.py`` (reference
src/utils/losses.py:27-115), including the per-channel rescaling before SSIM
(NDVI [-1, 1] -> [0, 1], LST clamped to [0, 1]).  NHWC: channel 0 is NDVI,
channel 1 is LST.

Under a spatial context (``parallel/spatial.py``) every training loss is this
rank's share of the global one, constant terms included
(``spatial.share``), so that the shares of the spatial group add up to it;
:func:`per_sample_losses` adds the shares up over the group itself.
"""

from __future__ import annotations

from typing import Callable

import torch

from maunet_tpu_torch.losses.basic import (gradient_loss, gradient_terms, jax_abs, l1_loss,
                                           mean, mse_loss)
from maunet_tpu_torch.losses.ssim import ssim
from maunet_tpu_torch.parallel import spatial

LossDict = dict[str, torch.Tensor]


def compute_loss_mse(outputs: torch.Tensor, targets: torch.Tensor) -> LossDict:
    m = mse_loss(outputs, targets)
    return {"total": m, "mse": m}


def compute_loss_mse_gradient(outputs: torch.Tensor, targets: torch.Tensor,
                              lambda_grad: float = 0.1) -> LossDict:
    m = mse_loss(outputs, targets)
    g = gradient_loss(outputs, targets)
    return {"total": m + lambda_grad * g, "mse": m, "gradient": g}


def _rescale_for_ssim(x: torch.Tensor) -> torch.Tensor:
    ndvi = (x[..., 0:1] + 1.0) / 2.0
    # jnp.clip's gradient: half at either bound, as min/max split ties.
    lst = torch.minimum(torch.maximum(x[..., 1:2], x.new_zeros(())), x.new_ones(()))
    return torch.cat([ndvi, lst], dim=-1)


def compute_loss_l1_grad_ssim(outputs: torch.Tensor, targets: torch.Tensor,
                              lambda_grad: float = 0.1,
                              lambda_ssim: float = 0.5) -> LossDict:
    pixel = l1_loss(outputs, targets)
    grad = gradient_loss(outputs, targets)
    ssim_val = ssim(_rescale_for_ssim(outputs.float()),
                    _rescale_for_ssim(targets.float()), data_range=1.0).mean()
    ssim_l = spatial.share(1.0) - ssim_val
    total = pixel + lambda_grad * grad + lambda_ssim * ssim_l
    return {"total": total, "pixel": pixel, "gradient": grad, "ssim": ssim_l}


def compute_all_loss(outputs: torch.Tensor, targets: torch.Tensor,
                     lambda_grad: float = 0.1, lambda_ssim: float = 0.5) -> LossDict:
    """Union of all components for validation logging (reference :101-115);
    'total' is the L1 + grad + SSIM total, by the reference's update order."""
    losses: LossDict = {}
    losses.update(compute_loss_mse_gradient(outputs, targets, lambda_grad))
    losses.update(compute_loss_l1_grad_ssim(outputs, targets, lambda_grad, lambda_ssim))
    return losses


def per_sample_losses(outputs: torch.Tensor, targets: torch.Tensor,
                      lambda_grad: float = 0.1,
                      lambda_ssim: float = 0.5) -> LossDict:
    """All loss components as per-sample (B,) vectors, for the masked
    validation step that excludes padded tail samples.  Under a spatial
    context each rank's shares are summed over the spatial group, so every
    rank of it gets the whole images' values (without a gradient)."""
    o, t = outputs.float(), targets.float()
    red = lambda v: mean(v, dim=(1, 2, 3))
    mse = red((o - t) ** 2)
    pixel = red(jax_abs(o - t))
    dy, dx, dy_rows = gradient_terms(o, t)
    grad = mean(dy, dim=(1, 2, 3), rows=dy_rows) + red(dx)
    ssim_v = ssim(_rescale_for_ssim(o), _rescale_for_ssim(t), data_range=1.0)
    if spatial.current() is not None:
        mse, pixel, grad, ssim_v = spatial.sum_over_bands(
            torch.stack([mse, pixel, grad, ssim_v]))
    ssim_l = 1.0 - ssim_v
    return {
        "mse": mse,
        "pixel": pixel,
        "gradient": grad,
        "ssim": ssim_l,
        "mse_gradient_total": mse + lambda_grad * grad,
        "total": pixel + lambda_grad * grad + lambda_ssim * ssim_l,
    }


LOSS_REGISTRY: dict[str, Callable[..., LossDict]] = {
    "mse": compute_loss_mse,
    "mse-gradient": compute_loss_mse_gradient,
    "l1-gradient-ssim": compute_loss_l1_grad_ssim,
}


def get_loss_fn(name: str) -> Callable[..., LossDict]:
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"Loss {name!r} not implemented (available: {sorted(LOSS_REGISTRY)})"
        ) from None
