"""Pixelwise and gradient losses (NHWC, f32 reductions).

Port of ``maunet_tpu/losses/basic.py`` (reference src/utils/losses.py:5-57).
Absolute values go through :func:`jax_abs`, whose gradient at 0 is +1 as
``jnp.abs``'s is (``torch.abs`` gives 0 there): bf16 outputs make exact
zeros in these differences common, and the port's gradients follow JAX's.

Under a spatial context (``parallel/spatial.py``) the tensors are this
rank's band of rows, and each loss is the rank's share of the global one:
its sum over its rows over the global count, so that the shares of the
spatial group add up to the loss (:func:`mean`).  The vertical differences
take one row from the band below.
"""

from __future__ import annotations

import math

import torch

from maunet_tpu_torch.parallel import spatial


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient: sign(x), and +1 at 0."""
    return torch.where(x >= 0, x, -x)


def mean(v: torch.Tensor, dim: tuple[int, ...] | None = None,
         rows: int | None = None) -> torch.Tensor:
    """``v``'s mean over ``dim`` (every axis if None).  Under a spatial
    context, this rank's share of the global mean: the sum over the band
    divided by the global count, in which axis 1 (which ``dim`` must hold)
    has ``rows`` rows, by default the band's rows times the spatial ranks."""
    ctx = spatial.current()
    if ctx is None:
        return v.mean() if dim is None else v.mean(dim=dim)
    dims = tuple(range(v.dim())) if dim is None else dim
    if 1 not in dims:
        raise ValueError("a spatial share needs the row axis among the reduced ones")
    rows = v.shape[1] * ctx.size if rows is None else rows
    count = math.prod(v.shape[d] for d in dims if d != 1) * rows
    return (v.sum() if dim is None else v.sum(dim=dim)) / count


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mean((pred.float() - target.float()) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mean(jax_abs(pred.float() - target.float()))


def with_rows_below(pred: torch.Tensor, target: torch.Tensor, rows: int):
    """Under a spatial context: ``pred`` and ``target`` with ``rows`` rows
    of the band below added (none at the image's bottom), in one exchange,
    the gradient of ``pred``'s halo going back to its owner."""
    c = pred.shape[-1]
    both, _ = spatial.halo_rows(torch.cat([pred, target], dim=-1), 0, rows)
    return both[..., :c], both[..., c:]


def gradient_terms(pred: torch.Tensor, target: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The two maps of :func:`gradient_loss`, |dy_p - dy_t| and |dx_p -
    dx_t|, in f32, and the global row count of the first (H - 1).  Under a
    spatial context the vertical differences of a band's last row take the
    first row of the band below."""
    pred, target = pred.float(), target.float()
    h = rows = pred.shape[1]
    ctx = spatial.current()
    if ctx is not None:
        rows = ctx.height
        pred, target = with_rows_below(pred, target, 1)
    dy_p = jax_abs(pred[:, 1:] - pred[:, :-1])
    dy_t = jax_abs(target[:, 1:] - target[:, :-1])
    pred, target = pred[:, :h], target[:, :h]
    dx_p = jax_abs(pred[:, :, 1:] - pred[:, :, :-1])
    dx_t = jax_abs(target[:, :, 1:] - target[:, :, :-1])
    return jax_abs(dy_p - dy_t), jax_abs(dx_p - dx_t), rows - 1


def gradient_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 difference of absolute finite-difference maps in both spatial
    directions (reference src/utils/losses.py:5-25).  NHWC: spatial axes 1, 2."""
    dy, dx, dy_rows = gradient_terms(pred, target)
    return mean(dy, rows=dy_rows) + mean(dx)
