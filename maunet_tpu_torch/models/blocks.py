"""Core conv blocks.

Port of ``maunet_tpu/models/blocks.py``.  Tensors are NHWC in
``compute_dtype`` (bf16 by default) with f32 parameters.  In eval mode the
BatchNorm affine (eps 1e-5, running statistics) is folded into each conv's
epilogue in f32; in train mode BatchNorm runs on batch statistics
(:func:`conv_bn_relu_train`).

Two structural points carry over from the JAX module:

1. **Virtual concat.**  A block's first conv takes its input as parts
   (skip, upsampled, embeddings) and never builds the concatenated tensor:
   the conv weight is one parameter, sliced per part.
2. **Closed-form conv of broadcast embeddings.**  A part of spatial size
   (1, 1) while the block's target is larger is a broadcast embedding; its
   zero-padded 3x3 conv has only 9 distinct values per (sample, channel) and
   is computed in closed form (:func:`const_conv`).

Which convs run the fused kernel is a function of the output width alone
(:func:`uses_fused_kernel`).  Lane packing (``Packed``, ``BatchNormPacked``,
``PackedConv1x1``, ``_ConvParams``, the pair path) is a TPU layout device and
is not ported.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from maunet_tpu_torch.ops.kernels import packed_vgg as pvgg

# JAX sends exactly the convs of output width 64 (the U-Net's level-0 row) to
# the fused Pallas kernel at the serving config; wider convs are plain XLA
# convs there, and plain cuDNN convs here.
FUSED_KERNEL_MAX_COUT = 64


def uses_fused_kernel(out_channels: int) -> bool:
    """Whether a 3x3 conv with this output width runs the fused kernel."""
    return out_channels <= FUSED_KERNEL_MAX_COUT


@functools.lru_cache(maxsize=64)
def _border_mask(n: int) -> np.ndarray:
    """(n, 3) mask: A[y, k] = 1 if kernel row-tap k (dy = k-1) lands inside a
    zero-padded length-n axis for output position y."""
    y = np.arange(n)[:, None]
    k = np.arange(3)[None, :]
    return ((y + k - 1 >= 0) & (y + k - 1 < n)).astype(np.float32)


def const_conv(emb: torch.Tensor, kernel: torch.Tensor, h: int, w: int,
               compact_h: bool = False) -> torch.Tensor:
    """3x3 SAME (zero-pad) conv of a spatially constant (B, D) input with a
    (C, D, 3, 3) kernel, in closed form and f32 (JAX ``_const_conv``,
    blocks.py:131-165).  Returns (B, h, w, C); with ``compact_h`` only the
    rows {y=0, interior, y=h-1}, (B, 3, w, C), the fused kernel's ``add``."""
    e = emb.reshape(emb.shape[0], -1).float()
    taps = torch.einsum("bd,cdij->bijc", e, kernel.float())
    bm = _border_mask(h)
    a = np.stack([bm[0], np.ones(3, np.float32), bm[-1]]) if compact_h else bm
    dev = emb.device
    out = torch.einsum("hi,bijc->bhjc", torch.from_numpy(a).to(dev), taps)
    return torch.einsum("wj,bhjc->bhwc",
                        torch.from_numpy(_border_mask(w)).to(dev), out)


def bn_affine(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm after a biased conv as one f32 (scale, bias) pair:
    ``a = gamma / sqrt(var + eps)``, ``b = beta - mean * a + conv_bias * a``
    (JAX ``BatchNormPacked.affine`` and ``_fold_bias``)."""
    a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * a
    return a, b + conv.bias.float() * a


def conv_bn_relu(parts: Sequence[torch.Tensor], conv: nn.Conv2d,
                 bn: nn.BatchNorm2d, compute_dtype: torch.dtype) -> torch.Tensor:
    """relu(BN(conv3x3(concat(parts)))) without building the concat.

    Spatial parts are NHWC at the block's (H, W); (B, 1, 1, D) parts are
    broadcast embeddings.  Returns (B, H, W, out) NHWC-contiguous in
    ``compute_dtype``."""
    hw = next((tuple(p.shape[1:3]) for p in parts if tuple(p.shape[1:3]) != (1, 1)),
              tuple(parts[0].shape[1:3]))
    spatial, weights, bcast = [], [], []
    off = 0
    for p in parts:
        c = p.shape[-1]
        wt = conv.weight[:, off:off + c]
        off += c
        if tuple(p.shape[1:3]) == (1, 1) and hw != (1, 1):
            bcast.append((p, wt))
        else:
            spatial.append(p.to(compute_dtype).contiguous())
            weights.append(wt)
    scale, bias = bn_affine(conv, bn)
    if uses_fused_kernel(conv.out_channels):
        add = None
        for e, wt in bcast:
            term = const_conv(e, wt, *hw, compact_h=True)
            add = term if add is None else add + term
        return pvgg.conv3x3_fused(spatial, weights, scale=scale, bias=bias,
                                  add=add, relu=True)
    x = torch.cat(spatial, dim=-1) if len(spatial) > 1 else spatial[0]
    wt = torch.cat(weights, dim=1).to(compute_dtype).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1).float()
    for e, wt in bcast:
        y = y + const_conv(e, wt, *hw)
    return torch.relu(y * scale + bias).to(compute_dtype).contiguous()


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm of an NHWC tensor as flax computes it: batch
    mean and the biased variance E[y^2] - E[y]^2 (clamped at 0) in f32, and
    running statistics updated in place with momentum 0.1 from the biased
    variance (torch's own BatchNorm would use the unbiased one)."""
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    var = ((yf * yf).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
        bn.num_batches_tracked += 1
    return (yf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


def conv_bn_relu_train(parts: Sequence[torch.Tensor], conv: nn.Conv2d,
                       bn: nn.BatchNorm2d, compute_dtype: torch.dtype) -> torch.Tensor:
    """relu(BN(conv3x3(concat(parts)))) in train mode (JAX ``VGGBlock`` with
    ``train=True``, blocks.py:478-522).

    The spatial parts go through one ``compute_dtype`` cuDNN conv over their
    concatenation (JAX runs the train convs on XLA: ``train_fused_conv`` is
    off by default), the broadcast embeddings through the closed form
    :func:`const_conv`.  The conv bias is detached, as JAX
    ``stop_gradient``s it: batch-statistics BN cancels it exactly.  BN in
    f32, ReLU, then a cast to ``compute_dtype``."""
    hw = next((tuple(p.shape[1:3]) for p in parts if tuple(p.shape[1:3]) != (1, 1)),
              tuple(parts[0].shape[1:3]))
    spatial, weights, bcast = [], [], []
    off = 0
    for p in parts:
        c = p.shape[-1]
        wt = conv.weight[:, off:off + c]
        off += c
        if tuple(p.shape[1:3]) == (1, 1) and hw != (1, 1):
            bcast.append((p, wt))
        else:
            spatial.append(p.to(compute_dtype))
            weights.append(wt)
    x = torch.cat(spatial, dim=-1) if len(spatial) > 1 else spatial[0]
    wt = torch.cat(weights, dim=1) if len(weights) > 1 else weights[0]
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 wt.to(compute_dtype).contiguous(memory_format=torch.channels_last),
                 padding=1).permute(0, 2, 3, 1)
    for e, w_e in bcast:
        y = y + const_conv(e, w_e, *hw).to(compute_dtype)
    y = y + conv.bias.detach().to(compute_dtype)
    return torch.relu(batch_norm_train(y, bn)).to(compute_dtype).contiguous()


class VGGBlock(nn.Module):
    """(Conv3x3 -> BatchNorm -> ReLU) x 2 (reference src/model.py:9-21).

    Attribute names (conv1/bn1/conv2/bn2) match the reference state_dict.
    ``forward`` takes the input as a list of parts (see :func:`conv_bn_relu`).
    """

    def __init__(self, in_channels: int, middle_channels: int,
                 out_channels: int, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_channels, middle_channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(middle_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(middle_channels, out_channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5)

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        step = conv_bn_relu_train if self.training else conv_bn_relu
        x = step(list(parts), self.conv1, self.bn1, cd)
        return step([x], self.conv2, self.bn2, cd)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of an NHWC tensor, floor semantics for odd sizes
    (torch ``nn.MaxPool2d(2, 2)``, reference src/model.py:58,218): 31 -> 15.

    The where-chain of JAX (blocks.py:717-720): rows first, then columns,
    ``>=`` so the first of tied values wins, and the gradient goes to that
    one winner (``amax`` would split it over the ties)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, c)
    a, b2 = x[:, :, 0], x[:, :, 1]
    m = torch.where(a >= b2, a, b2)
    m0, m1 = m[:, :, :, 0], m[:, :, :, 1]
    return torch.where(m0 >= m1, m0, m1)
