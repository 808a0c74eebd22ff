"""Train-mode 3x3 conv with kernel A's forward under autograd.

Port of ``maunet_tpu/ops/train_conv.py``.  With ``train_fused_conv`` on, the
train step's narrow convs run their forward through kernel A
(``ops/kernels/packed_vgg.conv3x3_fused``: ``csrc/conv3x3_fused.cu`` in
bf16, ``csrc/conv3x3_f32.cu`` in f32) with no epilogue (JAX's
``affine=None, relu=False``), and their backward through the library's
dgrad and wgrad (``torch.ops.aten.convolution_backward``, cuDNN on
the card), as JAX's ``_conv_vc_bwd`` takes XLA's conv VJP.  Batch-statistics
BatchNorm then runs on the result as usual (``models/blocks.py``).

Which convs take this path is the JAX package's rule (:func:`supported`), so
both packages send the same convs through their kernel.  JAX's rule is
stated on its lane-packed layout; here it is written on the NHWC shapes it
comes from, in either dtype: bf16 parts take A's bf16 entry, f32 parts its
f32 entry.  Numerics: the forward sums every part in f32 and rounds once,
as JAX's kernel does; the backward is the library's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from maunet_tpu_torch.ops.kernels import packed_vgg as pvgg

# The JAX kernel's row-block quantum and its scoped-memory budget for a
# row block (``maunet_tpu/ops/pallas/packed_vgg.py:32, 67-83``).
_ROW_QUANTUM = 8
_ROW_BLOCKS = (64, 32, 16, 8)
_BLOCK_BUDGET = 14 << 20


def _pack_factor(features: int, width: int, min_s: int) -> int:
    """JAX's ``ops.packed_conv.pack_factor``: output columns per 128-lane
    group, up to 4, or 1 where that is below ``min_s``."""
    s = 1
    while s * 2 <= 4 and features * s * 2 <= 128 and width % (s * 2) == 0:
        s *= 2
    return s if s >= min_s else 1


def supported(shapes: Sequence[Sequence[int]], features: int,
              grouped: bool = False) -> bool:
    """Whether the JAX package's model, as its factory builds it, sends a
    train-mode conv over NHWC parts of these shapes with ``features``
    outputs through its kernel.

    Its train-mode convs lane-pack where four output columns fill a lane
    group (features <= 32, W a multiple of 4: ``pack_lanes`` on, ``min_s``
    4 in training, ``models/unet.py:72-75``) and take XLA's packed conv
    there, not the kernel.  Elsewhere ``train_conv.supported`` decides:
    features <= 64, an even width, one (B, H, W) for all parts, and the
    tiling its kernel needs, H a multiple of 8, W / s a multiple of 8 and a
    row block within its memory budget, each part's channels padded to 8.
    ``grouped``: the parts enter JAX's conv as one concatenated part
    (``SplitConv``'s ``group_spatial``, which U-Net++ sets)."""
    if not shapes:
        return False
    b, h, w = shapes[0][:3]
    if any(tuple(s[:3]) != (b, h, w) for s in shapes):
        return False
    if _pack_factor(features, w, min_s=4) > 1:
        return False
    s = _pack_factor(features, w, min_s=2)
    if s < 2:
        return False
    g = w // s
    if h % _ROW_QUANTUM or g % 8:
        return False
    cins = [sum(sh[3] for sh in shapes)] if grouped else [sh[3] for sh in shapes]
    in_row = sum(g * s * (c + (-c) % 8) * 2 for c in cins)
    out_row = g * s * features * 2
    for bh in _ROW_BLOCKS:
        if h % bh:
            continue
        blocks = (bh + 2) * in_row + 2 * bh * out_row
        if 2 * blocks + 6 * bh * g * s * features * 4 <= _BLOCK_BUDGET:
            return True
    return False


def takes_kernel(parts: Sequence[torch.Tensor], features: int,
                 grouped: bool = False, height: int | None = None) -> bool:
    """:func:`supported`, JAX's rule, which reads no dtype and no device: a
    CUDA tensor then launches kernel A's entry of its dtype (bf16 or f32; any
    other raises there), a CPU tensor takes the plain version.  ``height``:
    the whole map's, where ``parts`` are a band of its rows (the spatial mesh
    axis), which JAX's rule reads."""
    if not parts or len(parts) > pvgg.MAX_PARTS:
        return False
    shapes = [tuple(p.shape) for p in parts]
    if height is not None:
        shapes = [(s[0], height, *s[2:]) for s in shapes]
    return supported(shapes, features, grouped)


class TrainConv3x3(torch.autograd.Function):
    """``sum_p conv3x3(parts[p], weights[p])``, SAME, no bias: kernel A's
    forward (its plain version on CPU tensors), the library's dgrad and
    wgrad backward.  ``parts``: NHWC, contiguous, in one dtype;
    ``weights``: the (cout, cin_p, 3, 3) parameter slices, f32, rounded to
    the parts' dtype at every call (they change every step).  Returns
    (B, H, W, cout) in the parts' dtype, rounded once."""

    @staticmethod
    def forward(ctx, n_parts: int, *tensors: torch.Tensor) -> torch.Tensor:
        parts, weights = tensors[:n_parts], tensors[n_parts:]
        ctx.save_for_backward(*parts, *weights)
        ctx.n_parts = n_parts
        # Grad mode is off here, so A's wrapper launches.
        return pvgg.conv3x3_fused(list(parts), [w.to(parts[0].dtype) for w in weights])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        n = ctx.n_parts
        saved = ctx.saved_tensors
        parts, weights = saved[:n], saved[n:]
        dtype = parts[0].dtype
        g = grad.to(dtype).permute(0, 3, 1, 2)
        d_parts, d_weights = [], []
        for i, (p, w) in enumerate(zip(parts, weights)):
            need_x, need_w = ctx.needs_input_grad[1 + i], ctx.needs_input_grad[1 + n + i]
            if not (need_x or need_w):
                d_parts.append(None)
                d_weights.append(None)
                continue
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, p.permute(0, 3, 1, 2), w.to(dtype), None, (1, 1), (1, 1), (1, 1),
                False, (0, 0), 1, (need_x, need_w, False))
            d_parts.append(None if dx is None else dx.permute(0, 2, 3, 1))
            d_weights.append(None if dw is None else dw.to(w.dtype))
        return (None, *d_parts, *d_weights)


def train_conv3x3(parts: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """:class:`TrainConv3x3` over the spatial ``parts`` and their weight
    slices (JAX ``train_conv3x3``).  The caller checks :func:`takes_kernel`
    first; on a CUDA tensor this launches A or raises."""
    parts = [p.contiguous() for p in parts]
    return TrainConv3x3.apply(len(parts), *parts, *weights)
