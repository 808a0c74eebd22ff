"""Pixelwise and gradient losses (NHWC, f32 reductions).

Port of ``maunet_tpu/losses/basic.py`` (reference src/utils/losses.py:5-57).
Absolute values go through :func:`jax_abs`, whose gradient at 0 is +1 as
``jnp.abs``'s is (``torch.abs`` gives 0 there): bf16 outputs make exact
zeros in these differences common, and the port's gradients follow JAX's.
"""

from __future__ import annotations

import torch


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient: sign(x), and +1 at 0."""
    return torch.where(x >= 0, x, -x)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return jax_abs(pred.float() - target.float()).mean()


def gradient_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 difference of absolute finite-difference maps in both spatial
    directions (reference src/utils/losses.py:5-25).  NHWC: spatial axes 1, 2."""
    pred, target = pred.float(), target.float()
    dy_p = jax_abs(pred[:, 1:] - pred[:, :-1])
    dx_p = jax_abs(pred[:, :, 1:] - pred[:, :, :-1])
    dy_t = jax_abs(target[:, 1:] - target[:, :-1])
    dx_t = jax_abs(target[:, :, 1:] - target[:, :, :-1])
    return jax_abs(dy_p - dy_t).mean() + jax_abs(dx_p - dx_t).mean()
