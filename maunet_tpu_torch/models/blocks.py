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
(:func:`uses_fused_kernel`); in train mode with ``train_fused``, JAX's
``train_conv.supported`` rule picks them (``ops/train_conv.py``).  In eval
mode with gradients off, a block keeps what each conv needs beyond its input
(the BatchNorm affine, and the weights folded and laid out for the fused
kernel or for cuDNN) from one forward to the next (``VGGBlock._constants``).
Lane packing (``Packed``, ``BatchNormPacked``, ``PackedConv1x1``,
``_ConvParams``) is a TPU layout device and is not ported; the whole-block
pair kernel is, on plain NHWC (``VGGBlock.fuse_pair``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from maunet_tpu_torch.ops import train_conv
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
    out = torch.einsum("hi,bijc->bhjc", _row_mask(h, compact_h, emb.device), taps)
    return torch.einsum("wj,bhjc->bhwc", _row_mask(w, False, emb.device), out)


@functools.lru_cache(maxsize=64)
def _row_mask(n: int, compact: bool, device: torch.device) -> torch.Tensor:
    """:func:`_border_mask` on ``device``; with ``compact`` only its rows
    {0, interior, n-1}.  Kept per device: a blocking copy of a 3-column
    constant at every call would stall the host at every decoder node.  Made
    outside inference mode, so that a later training step can use it too."""
    bm = _border_mask(n)
    if compact:
        bm = np.stack([bm[0], np.ones(3, np.float32), bm[-1]])
    with torch.inference_mode(False):
        return torch.from_numpy(bm).to(device)


def bn_affine(conv: nn.Conv2d, bn: nn.BatchNorm2d | None
              ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Eval BatchNorm after a biased conv as one f32 (scale, bias) pair:
    ``a = gamma / sqrt(var + eps)``, ``b = beta - mean * a + conv_bias * a``
    (JAX ``BatchNormPacked.affine`` and ``_fold_bias``).  Without a BatchNorm
    (``bn_fused``: it is folded into the conv already) the scale is the
    identity, ``None``, and the bias is the conv's."""
    if bn is None:
        return None, conv.bias.float()
    a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * a
    return a, b + conv.bias.float() * a


def split_parts(parts: Sequence[torch.Tensor], conv: nn.Conv2d,
                compute_dtype: torch.dtype, contiguous: bool = True):
    """The block's (H, W); its spatial parts in ``compute_dtype`` with their
    slices of the conv weight; and its broadcast embeddings, (B, 1, 1, D)
    parts while the block is larger, each with its slice."""
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
            p = p.to(compute_dtype)
            spatial.append(p.contiguous() if contiguous else p)
            weights.append(wt)
    return hw, spatial, weights, bcast


def embedding_add(bcast, hw: tuple[int, int]) -> torch.Tensor | None:
    """The fused kernels' compact ``add``: the closed-form conv of every
    broadcast embedding, summed, or ``None`` without one."""
    add = None
    for e, wt in bcast:
        term = const_conv(e, wt, *hw, compact_h=True)
        add = term if add is None else add + term
    return add


def wide_conv_weight(weights: Sequence[torch.Tensor],
                     compute_dtype: torch.dtype) -> torch.Tensor:
    """The parts' weight slices as one channels-last ``compute_dtype`` weight
    for a cuDNN conv over the concatenated parts."""
    wt = torch.cat(list(weights), dim=1) if len(weights) > 1 else weights[0]
    return wt.to(compute_dtype).contiguous(memory_format=torch.channels_last)


def wide_conv_bn_relu(spatial: Sequence[torch.Tensor], wt: torch.Tensor,
                      scale: torch.Tensor | None, bias: torch.Tensor, bcast,
                      hw: tuple[int, int], compute_dtype: torch.dtype) -> torch.Tensor:
    """A conv too wide for the fused kernel: cuDNN over the concatenated
    parts, then the embeddings' closed form, the affine and ReLU in f32."""
    x = torch.cat(list(spatial), dim=-1) if len(spatial) > 1 else spatial[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1).float()
    for e, w_e in bcast:
        y = y + const_conv(e, w_e, *hw)
    if scale is not None:
        y = y * scale
    return torch.relu(y + bias).to(compute_dtype).contiguous()


def conv_bn_relu(parts: Sequence[torch.Tensor], conv: nn.Conv2d,
                 bn: nn.BatchNorm2d | None, compute_dtype: torch.dtype) -> torch.Tensor:
    """relu(BN(conv3x3(concat(parts)))) without building the concat.

    Spatial parts are NHWC at the block's (H, W); (B, 1, 1, D) parts are
    broadcast embeddings.  Returns (B, H, W, out) NHWC-contiguous in
    ``compute_dtype``.  Everything is derived from the parameters at this
    call, so a gradient reaches them (on CPU tensors: the fused kernel has no
    backward)."""
    hw, spatial, weights, bcast = split_parts(parts, conv, compute_dtype)
    scale, bias = bn_affine(conv, bn)
    if uses_fused_kernel(conv.out_channels):
        return pvgg.conv3x3_fused(spatial, weights, scale=scale, bias=bias,
                                  add=embedding_add(bcast, hw), relu=True)
    return wide_conv_bn_relu(spatial, wide_conv_weight(weights, compute_dtype),
                             scale, bias, bcast, hw, compute_dtype)


def _source_stamp(t: torch.Tensor | None):
    """What tells that a parameter or buffer is still the tensor, with the
    values, that a block's constants were made from: its storage, device and
    version counter.  The counter moves with every in-place write PyTorch
    knows of (``load_state_dict``, an optimizer step, ``mul_`` under
    ``no_grad``), but not with one made through ``.data``, which has a counter
    of its own.  A CPU tensor is cheap to read, so its bytes are hashed too and
    such a write shows; a CUDA tensor's would cost a synchronisation per conv,
    so there a write through ``.data`` needs ``VGGBlock.forget_constants``."""
    if t is None:
        return None
    version = 0 if t.is_inference() else t._version
    content = None
    if t.device.type == "cpu":
        content = hash(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return t.data_ptr(), t.device, version, content


_frozen = threading.local()


@contextlib.contextmanager
def frozen_batch_statistics():
    """Within it, :func:`batch_norm_train` normalises as always but leaves
    the running statistics alone.  A checkpointed block's forward runs
    again in the backward pass; flax discards what that recompute would
    write (``nn.remat``), and so does this."""
    before = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = before


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm of an NHWC tensor as flax computes it: batch
    mean and the biased variance E[y^2] - E[y]^2 (clamped at 0) in f32, and
    running statistics updated in place with momentum 0.1 from the biased
    variance (torch's own BatchNorm would use the unbiased one), except
    under :func:`frozen_batch_statistics`."""
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    var = ((yf * yf).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
    if not getattr(_frozen, "on", False):
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
            bn.num_batches_tracked += 1
    return (yf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


def conv_bn_relu_train(parts: Sequence[torch.Tensor], conv: nn.Conv2d,
                       bn: nn.BatchNorm2d, compute_dtype: torch.dtype,
                       fused: bool = False, grouped: bool = False) -> torch.Tensor:
    """relu(BN(conv3x3(concat(parts)))) in train mode (JAX ``VGGBlock`` with
    ``train=True``, blocks.py:478-522).

    The spatial parts go through one ``compute_dtype`` cuDNN conv over their
    concatenation (JAX runs the train convs on XLA), or, with ``fused`` and
    where JAX's ``splitconv_train_fused`` would act (``grouped``: JAX's
    ``group_spatial``), through kernel A's forward with the library's
    backward (:func:`~maunet_tpu_torch.ops.train_conv.train_conv3x3`).  The
    broadcast embeddings go through the closed form :func:`const_conv`.  The
    conv bias is detached, as JAX ``stop_gradient``s it: batch-statistics BN
    cancels it exactly.  BN in f32, ReLU, then a cast to ``compute_dtype``."""
    hw, spatial, weights, bcast = split_parts(parts, conv, compute_dtype,
                                              contiguous=False)
    if fused and train_conv.takes_kernel(spatial, conv.out_channels, grouped):
        y = train_conv.train_conv3x3(spatial, weights)
    else:
        x = torch.cat(spatial, dim=-1) if len(spatial) > 1 else spatial[0]
        wt = torch.cat(weights, dim=1) if len(weights) > 1 else weights[0]
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     wt.to(compute_dtype).contiguous(memory_format=torch.channels_last),
                     padding=1).permute(0, 2, 3, 1)
    for e, w_e in bcast:
        y = y + const_conv(e, w_e, *hw).to(compute_dtype)
    y = y + conv.bias.detach().to(compute_dtype)
    return torch.relu(batch_norm_train(y, bn)).to(compute_dtype).contiguous()


def _remat_contexts():
    """A checkpointed block's forward as it is; its recompute under
    :func:`frozen_batch_statistics`."""
    return contextlib.nullcontext(), frozen_batch_statistics()


class VGGBlock(nn.Module):
    """(Conv3x3 -> BatchNorm -> ReLU) x 2 (reference src/model.py:9-21).

    Attribute names (conv1/bn1/conv2/bn2) match the reference state_dict.
    ``forward`` takes the input as a list of parts (see :func:`conv_bn_relu`).

    ``bn_fused``: inference with BatchNorm already folded into the conv
    weights (``models/fuse.fold_batchnorm``): the block has no ``bn1``/``bn2``
    and runs conv -> ReLU (JAX blocks.py:501-505).  ``fuse_pair``: in eval
    mode a block whose two convs both take the fused kernel runs as one
    launch of the pair kernel instead of two (JAX blocks.py:462-471,554-581;
    off by default, as there).  ``train_fused``: in train mode the convs
    that JAX's ``train_conv.supported`` takes run kernel A's forward
    (:func:`conv_bn_relu_train`; ``group_spatial`` is JAX's flag of that
    name, which only enters that rule here).  ``remat``: in train mode the
    block runs under activation checkpointing (JAX ``nn.remat``), its
    recompute leaving the running statistics alone.  Both off by default,
    as in JAX.

    In eval mode with gradients off, each conv's constants (the BatchNorm
    affine; the :class:`~maunet_tpu_torch.ops.kernels.packed_vgg.PreparedConv`
    of a conv that takes the fused kernel, the channels-last weight of a wider
    one) are made at the first forward and kept.  They are made again when
    what they came from changes: the split of the input into parts, the
    compute dtype, or a source tensor (:func:`_source_stamp`).
    ``VGGBlock.constants_built`` counts every making, over all blocks.
    """

    constants_built = 0

    def __init__(self, in_channels: int, middle_channels: int,
                 out_channels: int, compute_dtype: torch.dtype = torch.bfloat16,
                 bn_fused: bool = False, fuse_pair: bool = False,
                 train_fused: bool = False, group_spatial: bool = False,
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fuse_pair = fuse_pair
        self.train_fused = train_fused
        self.group_spatial = group_spatial
        self.remat = remat
        self.conv1 = nn.Conv2d(in_channels, middle_channels, 3, padding=1)
        self.bn1 = None if bn_fused else nn.BatchNorm2d(middle_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(middle_channels, out_channels, 3, padding=1)
        self.bn2 = None if bn_fused else nn.BatchNorm2d(out_channels, eps=1e-5)
        self._kept: dict[str, tuple] = {}

    def forget_constants(self) -> None:
        """Drop the kept constants; the next eval forward makes them again."""
        self._kept.clear()

    def _constants(self, which: str, conv: nn.Conv2d, bn: nn.BatchNorm2d | None,
                   split: tuple, weights: Sequence[torch.Tensor]):
        """(scale, bias, weight) of conv ``which`` for this split of its input:
        ``weight`` is a ``PreparedConv`` (which then also holds the scale and
        bias) or the wide conv's channels-last weight."""
        sources = (conv.weight, conv.bias) + (
            () if bn is None else (bn.weight, bn.bias, bn.running_mean, bn.running_var))
        key = (split, self.compute_dtype, None if bn is None else bn.eps,
               tuple(_source_stamp(t) for t in sources))
        kept = self._kept.get(which)
        if kept is None or kept[0] != key:
            VGGBlock.constants_built += 1
            scale, bias = bn_affine(conv, bn)
            if uses_fused_kernel(conv.out_channels):
                made = (None, None, pvgg.prepare_conv3x3(weights, scale, bias,
                                                         self.compute_dtype))
            else:
                made = (scale, bias, wide_conv_weight(weights, self.compute_dtype))
            kept = self._kept[which] = (key, made)
        return kept[1]

    @staticmethod
    def _split(parts: Sequence[torch.Tensor], hw: tuple[int, int]) -> tuple:
        """What a conv's kept constants depend on in its input: each part's
        channels and whether it is a broadcast embedding."""
        return tuple((p.shape[-1], tuple(p.shape[1:3]) == (1, 1) and hw != (1, 1))
                     for p in parts)

    def _conv_kept(self, which: str, parts: Sequence[torch.Tensor], conv: nn.Conv2d,
                   bn: nn.BatchNorm2d | None) -> torch.Tensor:
        """:func:`conv_bn_relu` with the conv's constants kept between calls."""
        cd = self.compute_dtype
        hw, spatial, weights, bcast = split_parts(parts, conv, cd)
        scale, bias, weight = self._constants(which, conv, bn, self._split(parts, hw), weights)
        if uses_fused_kernel(conv.out_channels):
            return pvgg.conv3x3_fused(spatial, weight, add=embedding_add(bcast, hw),
                                      relu=True)
        return wide_conv_bn_relu(spatial, weight, scale, bias, bcast, hw, cd)

    def takes_pair_kernel(self) -> bool:
        return (self.fuse_pair and not self.training
                and uses_fused_kernel(self.conv1.out_channels)
                and uses_fused_kernel(self.conv2.out_channels))

    def _train_forward(self, *parts: torch.Tensor) -> torch.Tensor:
        cd, fused = self.compute_dtype, self.train_fused
        x = conv_bn_relu_train(list(parts), self.conv1, self.bn1, cd, fused,
                               self.group_spatial)
        return conv_bn_relu_train([x], self.conv2, self.bn2, cd, fused)

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        if self.training:
            if self.bn1 is None:
                raise RuntimeError("bn_fused is an inference-only mode")
            if self.remat and torch.is_grad_enabled():
                return checkpoint(self._train_forward, *parts, use_reentrant=False,
                                  context_fn=_remat_contexts)
            return self._train_forward(*parts)
        if self.takes_pair_kernel():
            hw, spatial, weights, bcast = split_parts(list(parts), self.conv1, cd)
            add = embedding_add(bcast, hw)
            if torch.is_grad_enabled():
                scale1, bias1 = bn_affine(self.conv1, self.bn1)
                scale2, bias2 = bn_affine(self.conv2, self.bn2)
                return pvgg.conv3x3_pair_fused(
                    spatial, weights, self.conv2.weight, scale1=scale1, bias1=bias1,
                    scale2=scale2, bias2=bias2, add=add)
            # The same kept constants as the two single-conv launches use.
            _, _, w1 = self._constants("conv1", self.conv1, self.bn1,
                                       self._split(parts, hw), weights)
            _, _, w2 = self._constants("conv2", self.conv2, self.bn2,
                                       ((self.conv2.in_channels, False),), [self.conv2.weight])
            return pvgg.conv3x3_pair_fused(spatial, w1, w2, add=add)
        if torch.is_grad_enabled():
            x = conv_bn_relu(list(parts), self.conv1, self.bn1, cd)
            return conv_bn_relu([x], self.conv2, self.bn2, cd)
        x = self._conv_kept("conv1", list(parts), self.conv1, self.bn1)
        return self._conv_kept("conv2", [x], self.conv2, self.bn2)


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
