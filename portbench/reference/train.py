"""The published training objective and optimizer, in plain PyTorch.

``l1-gradient-ssim`` (src/utils/losses.py:27-100 of the reference
repository): the mean absolute error, plus 0.1 times the mean absolute
difference of the absolute finite differences of prediction and target
along each spatial axis, plus 0.5 times one minus SSIM.  SSIM is computed
per image on the channels rescaled to [0, 1] (NDVI from [-1, 1], LST
clamped), with ``piq.ssim``'s defaults: an 11 x 11 Gaussian window of
sigma 1.5, k1 0.01, k2 0.03, no padding, average-pooled by
max(1, round(min(H, W) / 256)).  AdamW is decoupled weight decay, then Adam
with bias correction (b1 0.9, b2 0.999, eps 1e-8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    return (g / g.sum()).float().to(device)


def ssim(x: torch.Tensor, y: torch.Tensor, size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM of NCHW images in [0, 1] -> (B,)."""
    f = max(1, round(min(x.shape[-2:]) / 256))
    if f > 1:
        x, y = F.avg_pool2d(x, f), F.avg_pool2d(y, f)
    c = x.shape[1]
    g = _gaussian(size, sigma, x.device)
    win = (g[:, None] * g[None, :]).expand(c, 1, size, size)
    blur = lambda t: F.conv2d(t, win, groups=c)
    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    c1, c2 = k1 ** 2, k2 ** 2
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    s = (2 * mx * my + c1) / (mx * mx + my * my + c1) * cs
    return s.mean(dim=(1, 2, 3))


def loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The l1-gradient-ssim total of NHWC (B, H, W, 2) [NDVI, LST]."""
    p, t = pred.float(), target.float()
    pixel = (p - t).abs().mean()
    dy = ((p[:, 1:] - p[:, :-1]).abs() - (t[:, 1:] - t[:, :-1]).abs()).abs().mean()
    dx = ((p[:, :, 1:] - p[:, :, :-1]).abs() - (t[:, :, 1:] - t[:, :, :-1]).abs()).abs().mean()
    scaled = lambda v: torch.cat([(v[..., :1] + 1) / 2, v[..., 1:].clamp(0, 1)], -1) \
        .permute(0, 3, 1, 2)
    ssim_loss = 1 - ssim(scaled(p), scaled(t)).mean()
    return pixel + 0.1 * (dy + dx) + 0.5 * ssim_loss


class AdamW:
    """Decoupled weight decay, then the bias-corrected Adam step."""

    def __init__(self, params: dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def leaf_gaps(got: dict[str, float], want: dict[str, float], keep) -> list[tuple[float, str]]:
    """Each leaf's |got - want| over max(want, the median leaf's want), over
    the leaves in ``keep``, worst first (a NaN first of all)."""
    names = [k for k in want if k in keep]
    vals = sorted(want[k] for k in names)
    median = vals[len(vals) // 2] if vals else 0.0
    gaps = [(abs(got[k] - want[k]) / max(want[k], median, 1e-30), k) for k in names]
    return sorted(gaps, key=lambda g: (not math.isnan(g[0]), -g[0] if not math.isnan(g[0]) else 0))
