"""align_corners=True bilinear resize of NHWC tensors.

Port of ``maunet_tpu/ops/resize.py``.  For output size M from input size N:
    src(i) = i * (N - 1) / (M - 1)        for M > 1, else 0
    out[i] = (1 - frac) * x[floor(src)] + frac * x[ceil(src)]
which is ``torch.nn.functional.interpolate(x_nchw, size, mode='bilinear',
align_corners=True)`` (reference src/model.py:121,219).  The resize itself
runs in ``ops/kernels/resize_pack.py``: the CUDA kernel on the card, the
separable interpolation products on the CPU, and under autograd a
``Function`` whose backward is the transposed-matrix resize.  The lane-packed output forms of
the JAX module are a TPU layout device and are not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from maunet_tpu_torch.ops.kernels import resize_pack as rp


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align-corners linear-interpolation matrix (float32).
    Callers must not write to the cached array."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        # torch align_corners with a single output (or input) row samples x[0]
        w[:, 0] = 1.0
        return w
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(n_out)
    w[rows, lo] = 1.0 - frac
    w[rows, hi] += frac
    return w


def resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of an NHWC tensor to ``out_hw``."""
    out_hw = tuple(int(v) for v in out_hw)
    if tuple(x.shape[1:3]) == out_hw:
        return x
    return rp.resize_pack(x.contiguous(), out_hw)


def upsample_like(x: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """The U-Net decoder's upsample-then-fix-size composition (reference
    src/model.py:243-246,279-282): a scale-2 upsample, then a resize to
    ``target_hw`` when the first one misses it.  For odd chains
    (15 -> 30 -> 31) this is a double interpolation whose result differs from
    one 15 -> 31 resize; both steps are reproduced."""
    h, w = x.shape[1:3]
    return resize_align_corners(resize_align_corners(x, (2 * h, 2 * w)), target_hw)
