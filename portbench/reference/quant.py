"""Lower precisions for the controls: a value rounded to the format and
back to float32.

``fp8`` is the usual float8 training recipe: every operand of a convolution
or product in e4m3 on the way forward, and the gradient that comes back
through it in e5m2 on the way back, each scaled per tensor to the format's
largest value.  ``bf16`` rounds forward and passes gradients through."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _FP8.apply(x)
    return _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)


def bf16(x: torch.Tensor) -> torch.Tensor:
    d = x.detach()
    return x + (d.to(torch.bfloat16).float() - d)
