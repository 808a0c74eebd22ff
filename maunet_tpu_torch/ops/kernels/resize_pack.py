"""Align-corners bilinear resize: CUDA kernel and its plain version.

Port of ``maunet_tpu/ops/pallas/resize_pack.py::resize_pack`` without the
lane-packed input and output forms (``s``, ``s_in``), which are a TPU layout
device.  The kernel is ``csrc/resize_pack.cu``; its header says what bounds it
on the H100.  Both versions take any (h, w) -> (oh, ow) on NHWC tensors and
round once from f32 to the input dtype.

Under autograd the resize is the ``Function`` of ``resize_pack_vjp``
(resize_pack.py:276-306): the forward is the kernel, and the backward is the
transposed-matrix resize in plain torch, as JAX runs it on XLA (the backward
shapes are downsamples).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from maunet_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel walks a strip of output rows per thread (``_strip_rows``): the
# tallest of these that still leaves ``_MIN_THREADS`` threads, two
# 256-thread blocks a SM on the H100's 132 SMs.  Taller strips reuse each
# source row over more output rows, but on the card 8 rows beat 16 and 32 at
# the 128² and 256² upsamples (fewer, longer threads leave the last wave
# part-empty), and every path shape gets 8.
_STRIP_ROWS = (8, 4, 2, 1)
_MIN_THREADS = 132 * 2 * 256


def _strip_rows(b: int, oh: int, ow: int, groups: int) -> int:
    """Output rows per thread of the kernel for a (b, oh, ow) output of
    ``groups`` 16-byte channel groups per pixel."""
    columns = b * ow * groups
    for rows in _STRIP_ROWS:
        if columns * -(-oh // rows) >= _MIN_THREADS:
            return rows
    return 1


def resize_pack_plain(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The separable pair of interpolation products, in f32, rounded once."""
    from maunet_tpu_torch.ops.resize import _interp_matrix

    b, h, w, c = x.shape
    oh, ow = out_hw
    wh = torch.from_numpy(_interp_matrix(h, oh)).to(x.device)
    ww = torch.from_numpy(_interp_matrix(w, ow)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", wh, x.float())
    return torch.einsum("pw,bowc->bopc", ww, y).to(x.dtype)


def resize_pack_backward(g: torch.Tensor, in_hw: tuple[int, int]) -> torch.Tensor:
    """The resize's reverse rule: (B, oh, ow, C) cotangent -> (B, h, w, C),
    the W-pass then the H-pass with the transposed interpolation matrices,
    in the cotangent's dtype (JAX ``_rp_bwd``)."""
    from maunet_tpu_torch.ops.resize import _interp_matrix

    b, oh, ow, c = g.shape
    h, w = in_hw
    ww_t = torch.from_numpy(_interp_matrix(w, ow).T.copy()).to(g.device, g.dtype)
    wh_t = torch.from_numpy(_interp_matrix(h, oh).T.copy()).to(g.device, g.dtype)
    y = torch.matmul(ww_t, g.reshape(b * oh, ow, c))           # (b*oh, w, c)
    return torch.matmul(wh_t, y.reshape(b, oh, w * c)).reshape(b, h, w, c)


class _ResizePack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[1:3])
        return _resize_pack(x, out_hw)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return resize_pack_backward(g.contiguous(), ctx.in_hw), None


def resize_pack(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, oh, ow, C) align-corners resize.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.  With grad
    enabled and an input that needs a gradient, the call goes through the
    autograd ``Function`` whose backward is :func:`resize_pack_backward`."""
    out_hw = tuple(int(v) for v in out_hw)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizePack.apply(x, out_hw)
    return _resize_pack(x, out_hw)


def _resize_pack(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    what = "resize_pack"
    if _build.on_cpu(x, what):
        return resize_pack_plain(x, out_hw)
    _build.require(x.dim() == 4, what, f"expected NHWC, got {tuple(x.shape)}")
    _build.require(x.dtype in _DTYPES, what, f"unsupported dtype {x.dtype}")
    _build.require(x.is_contiguous(), what, "input must be contiguous")
    b, h, w, c = x.shape
    oh, ow = (int(v) for v in out_hw)
    _build.require(1 <= min(h, w, oh, ow) and max(h, w, oh, ow) < 1 << 16, what,
                   f"sides must lie in [1, 65535]: {(h, w)}->{(oh, ow)}")
    _build.require(b * oh * ow * c < 1 << 31, what, "2^31 or more output elements")
    return _launch(x, (oh, ow), _rows_for(x, (oh, ow)))


def _rows_for(x: torch.Tensor, out_hw: tuple[int, int]) -> int:
    """``_strip_rows`` for resizing ``x`` to ``out_hw``: the kernel takes 16
    bytes of channels a thread where C allows, else one channel."""
    b, _, _, c = x.shape
    vec = 16 // x.element_size()
    return _strip_rows(b, *out_hw, c // vec if c % vec == 0 else c)


def _launch(x: torch.Tensor, out_hw: tuple[int, int], rows: int) -> torch.Tensor:
    """Launch the kernel on a checked CUDA input with ``rows`` output rows per
    thread, and count the launch."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    _build.launch("resize_pack", "maunet_resize_align_corners",
                  [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p],
                  x, x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, h, w, c, oh, ow, rows)
    resize_pack.launches += 1
    return y


resize_pack.launches = 0
