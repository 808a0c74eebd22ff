"""Fused 3x3 conv over a virtual channel concat: CUDA kernel and its plain
version.

Port of ``maunet_tpu/ops/pallas/packed_vgg.py::packed_conv3x3_fused`` on plain
NHWC tensors: the TPU kernel's lane packing (``pack``, ``pack_weights``,
``s``) is a layout device of the TPU's matrix unit and is not carried over.
The kernel is ``csrc/conv3x3_fused.cu``; its header says what bounds it on
the H100.  The whole-block pair kernel (``packed_pair_fused``) is not ported
yet.

Both versions compute ``relu?((sum_p conv3x3(x_p, w_p) + add) * scale +
bias)`` with the scale folded into the weights and into ``add`` first, as
``packed_vgg.py:480-487`` does, and round once to the parts' dtype.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from maunet_tpu_torch.ops.kernels import _build

MAX_PARTS = 5


def _fold(weights: Sequence[torch.Tensor], scale: torch.Tensor | None,
          add: torch.Tensor | None, dtype: torch.dtype):
    """Scale folded into the (cout, cin_p, 3, 3) weights, rounded to
    ``dtype``, and into the compact ``add`` term, kept in f32."""
    if scale is not None:
        s = scale.float()
        weights = [w.float() * s[:, None, None, None] for w in weights]
        if add is not None:
            add = add.float() * s
    return ([w.to(dtype) for w in weights],
            None if add is None else add.float())


def expand_add(add: torch.Tensor, h: int) -> torch.Tensor:
    """Compact (B, 3, W, C) rows {y=0, interior, y=H-1} -> (B, H, W, C):
    row 0 at y = 0, row 2 at y = H-1 (H > 1), row 1 elsewhere."""
    sel = torch.ones(h, dtype=torch.long, device=add.device)
    sel[0] = 0
    if h > 1:
        sel[h - 1] = 2
    return add.index_select(1, sel)


def conv3x3_fused_plain(parts: Sequence[torch.Tensor],
                        weights: Sequence[torch.Tensor], *,
                        scale: torch.Tensor | None = None,
                        bias: torch.Tensor | None = None,
                        add: torch.Tensor | None = None,
                        relu: bool = False) -> torch.Tensor:
    """F.conv2d over the concatenated parts in f32 (operands rounded to the
    parts' dtype first, as the kernel reads them), then ``add``, ``bias``
    and ReLU in f32, rounded once to the parts' dtype."""
    dtype = parts[0].dtype
    ws, add = _fold(weights, scale, add, dtype)
    x = torch.cat([p.float() for p in parts], dim=-1).permute(0, 3, 1, 2)
    y = F.conv2d(x, torch.cat(ws, dim=1).float(), padding=1).permute(0, 2, 3, 1)
    if add is not None:
        y = y + expand_add(add, y.shape[1])
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(dtype).contiguous()


def conv3x3_fused(parts: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor], *,
                  scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  add: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """3x3 SAME conv over the virtual concat of ``parts``.

    parts[p]: (B, H, W, cin_p) NHWC, 1 to 5 of them; weights[p]: the
    (cout, cin_p, 3, 3) slice of the conv weight for that part; ``scale``,
    ``bias``: (cout,) epilogue vectors (``bias`` already holds the conv bias
    times the scale); ``add``: compact (B, 3, W, cout) pre-scale term of the
    broadcast embeddings.  Returns (B, H, W, cout) in the parts' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which takes bf16 parts of any H, W and cin.
    """
    what = "conv3x3_fused"
    if _build.on_cpu(parts[0], what):
        return conv3x3_fused_plain(parts, weights, scale=scale, bias=bias,
                                   add=add, relu=relu)
    # The kernel has no backward: train mode runs cuDNN convs
    # (models/blocks.conv_bn_relu_train).
    _build.require_no_grad(what, *parts, *weights, scale, bias, add)
    _build.require(1 <= len(parts) <= MAX_PARTS, what,
                   f"takes 1-{MAX_PARTS} parts, got {len(parts)}")
    _build.require(len(weights) == len(parts), what, "one weight slice per part")
    b, h, w = parts[0].shape[:3]
    cout = weights[0].shape[0]
    dev = parts[0].device
    for p, wt in zip(parts, weights):
        _build.require(p.dim() == 4 and tuple(p.shape[:3]) == (b, h, w), what,
                       f"parts must share (B, H, W), got {tuple(p.shape)}")
        _build.require(p.device == dev and p.dtype == torch.bfloat16, what,
                       f"parts must be bf16 on {dev}, got {p.dtype} on {p.device}")
        _build.require(p.is_contiguous(), what, "parts must be contiguous")
        _build.require(tuple(wt.shape) == (cout, p.shape[3], 3, 3), what,
                       f"weight {tuple(wt.shape)} does not match part "
                       f"{tuple(p.shape)}")
    for name, t in (*(("weight", wt) for wt in weights),
                    ("scale", scale), ("bias", bias), ("add", add)):
        if t is not None:
            _build.require(t.device == dev, what, f"{name} on {t.device}, not {dev}")
    if add is not None:
        _build.require(tuple(add.shape) == (b, 3, w, cout), what,
                       f"add must be {(b, 3, w, cout)}, got {tuple(add.shape)}")
    ws, add = _fold(weights, scale, add, torch.bfloat16)
    # Kernel weight layout (9, cout, cin_p): the input channels of one tap
    # and output channel are contiguous, as the kernel's K slices read them.
    ws = [wt.permute(2, 3, 0, 1).reshape(9, cout, -1).contiguous() for wt in ws]
    add = None if add is None else add.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    xs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    wps = (ctypes.c_void_p * len(parts))(*(wt.data_ptr() for wt in ws))
    cins = (ctypes.c_int * len(parts))(*(p.shape[3] for p in parts))
    fn = _build.function("maunet_conv3x3_fused",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    _build.check(fn(ctypes.addressof(xs), ctypes.addressof(wps),
                    ctypes.addressof(cins), len(parts),
                    None if add is None else add.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), b, h, w, cout, int(relu),
                    _build.stream_of(out)), what)
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0
