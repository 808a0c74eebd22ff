"""Structural similarity (SSIM) of NHWC tensors.

Port of ``maunet_tpu/losses/ssim.py``: Wang et al. 2004 with ``piq.ssim``'s
defaults (11x11 gaussian window, sigma 1.5, k1 0.01, k2 0.03, VALID padding,
average-pool downsampling by max(1, round(min(H, W) / 256))), per-image
score averaged over space and channels.

The separable blur runs as two banded-matrix products.  Every step is full
f32 on the card with no flag to set: a matrix product in f32 is full f32 by
default (``torch.backends.cuda.matmul.allow_tf32`` is False), while an f32
``conv2d`` goes through cuDNN in TF32 by default, and on its backward too,
outside any local flag.  The E[x^2] - mu^2 moments cancel, and reduced
precision there drove SSIM to about -495 on the TPU (ssim.py:51-56).

Under a spatial context (``parallel/spatial.py``) the images are this rank's
band of rows: the pooling factor reads the global height, a band takes the
window's ten rows from the band below (the last band's window ends at H -
10), and each image's score is the band's share of it (``basic.mean``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from maunet_tpu_torch.losses.basic import mean, with_rows_below
from maunet_tpu_torch.parallel import spatial
from maunet_tpu_torch.utils.profiling import tally


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, size: int, sigma: float) -> np.ndarray:
    """(n - size + 1, n) matrix whose row i holds the window at columns
    i .. i + size - 1: the VALID 1-D blur as a product."""
    k = _gaussian_kernel(size, sigma)
    m = np.zeros((n - size + 1, n), np.float32)
    for i in range(n - size + 1):
        m[i, i:i + size] = k
    return m


def _blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """VALID separable gaussian blur of NHWC ``x``, per channel, in f32.
    ``_blur.host_constants`` counts the band matrices made from host arrays
    at call time (on the card, a blocking copy each)."""
    b, h, w, c = x.shape
    kh = torch.from_numpy(_band_matrix(h, size, sigma)).to(x.device)
    kw = torch.from_numpy(_band_matrix(w, size, sigma)).to(x.device)
    tally(_blur, "host_constants", 2)
    y = torch.matmul(kh, x.reshape(b, h, w * c))              # (b, h2, w*c)
    h2 = y.shape[1]
    y = torch.matmul(kw, y.reshape(b * h2, w, c))             # (b*h2, w2, c)
    return y.reshape(b, h2, -1, c)


_blur.host_constants = 0


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, kernel_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, downsample: bool = True) -> torch.Tensor:
    """Per-image SSIM of NHWC tensors -> (B,) f32 (piq reduction='none');
    under a spatial context, each image's share of it."""
    x = x.float() / data_range
    y = y.float() / data_range
    ctx = spatial.current()
    height = x.shape[1] if ctx is None else ctx.height
    if downsample:
        f = max(1, round(min(height, x.shape[2]) / 256))
        if f > 1:
            if x.shape[1] % f:
                raise ValueError(f"a band of {x.shape[1]} rows does not pool by {f}")
            pool = lambda t: F.avg_pool2d(t.permute(0, 3, 1, 2), f).permute(0, 2, 3, 1)
            x, y = pool(x), pool(y)
            height //= f
    if ctx is not None:
        x, y = with_rows_below(x, y, kernel_size - 1)
    c = x.shape[-1]
    planes = torch.cat([x, y, x * x, y * y, x * y], dim=-1)
    blurred = _blur(planes, kernel_size, kernel_sigma)
    mu_x, mu_y = blurred[..., :c], blurred[..., c:2 * c]
    e_xx, e_yy = blurred[..., 2 * c:3 * c], blurred[..., 3 * c:4 * c]
    e_xy = blurred[..., 4 * c:]
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    # The E[x^2] - mu^2 form can round below zero; the clamp bounds SSIM in
    # [-1, 1] and is inactive for healthy inputs (JAX ssim.py:112-116).  A
    # maximum, not clamp_min: at a tie (a flat window) its gradient is half,
    # as jnp.maximum's is.
    zero = x.new_zeros(())
    sigma_xx = torch.maximum(e_xx - mu_xx, zero)
    sigma_yy = torch.maximum(e_yy - mu_yy, zero)
    sigma_xy = e_xy - mu_xy
    c1, c2 = k1 ** 2, k2 ** 2
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ss = (2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1) * cs
    return mean(ss, dim=(1, 2, 3), rows=height - kernel_size + 1)
