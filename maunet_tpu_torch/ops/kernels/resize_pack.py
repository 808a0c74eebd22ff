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

:func:`resize_rows` is the row window of the spatial mesh axis
(``parallel/spatial.py``): a rank's output rows of the global resize from
the source rows it holds, through the kernel's second entry point, rows
equal to the whole resize's bit for bit.  It counts its launches apart from
the whole resize's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from maunet_tpu_torch.ops.kernels import _build
from maunet_tpu_torch.utils.profiling import tally

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


def window_rows(n_in: int, n_out: int, out_row0: int, out_rows: int) -> tuple[int, int]:
    """[first, stop) of the source rows that output rows [``out_row0``,
    ``out_row0 + out_rows``) of an align-corners n_in -> n_out resize load:
    the lower tap of the first and the upper one (lower + 1, at most n_in -
    1) of the last, which the kernel loads even at a zero weight."""
    if n_in == 1 or n_out == 1:
        return 0, 1
    first = out_row0 * (n_in - 1) // (n_out - 1)
    last = (out_row0 + out_rows - 1) * (n_in - 1) // (n_out - 1)
    return first, min(last + 2, n_in)


def _row_taps(n_in: int, n_out: int, out_row0: int, rows: int, src_row0: int, device):
    """Output rows [out_row0, out_row0 + rows) of an align-corners n_in ->
    n_out resize as (lo, hi, 1 - frac, frac): the two source rows, counted
    from ``src_row0``, and their f32 weights, the values of
    ``ops/resize._interp_matrix``.  ``_row_taps.host_constants`` counts the
    tensors made from host arrays."""
    from maunet_tpu_torch.ops.resize import axis_taps

    lo, hi, frac = (a[out_row0:out_row0 + rows] for a in axis_taps(n_in, n_out))
    tally(_row_taps, "host_constants", 4)
    w_lo = torch.from_numpy(np.float32(1.0) - frac).to(device)
    return (torch.from_numpy(lo - src_row0).to(device),
            torch.from_numpy(hi - src_row0).to(device), w_lo, torch.from_numpy(frac).to(device))


def resize_rows_plain(x: torch.Tensor, out_hw: tuple[int, int], h_total: int,
                      oh_total: int, src_row0: int, out_row0: int) -> torch.Tensor:
    """Output rows [out_row0, out_row0 + oh) of the h_total -> oh_total
    resize from the source rows [src_row0, src_row0 + h) that ``x`` holds:
    the two-tap interpolation of each axis in f32, the H-pass then the
    W-pass, rounded once.  Every output element is the same f32 expression
    of the same values as in the whole resize, so a window's rows are the
    whole resize's rows bit for bit."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    y = _two_taps(x.float(), 1, *_row_taps(h_total, oh_total, out_row0, oh, src_row0, x.device))
    return _two_taps(y, 2, *_row_taps(w, ow, 0, ow, 0, x.device)).to(x.dtype)


def _two_taps(x: torch.Tensor, dim: int, lo, hi, w_lo, w_hi) -> torch.Tensor:
    """(1 - frac) x[lo] + frac x[hi] along ``dim``: two rounded products and
    one rounded sum, in place on the gathered copies (fewer f32 temporaries
    at the card's comparison shapes; autograd needs neither's value)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    y = x.index_select(dim, lo).mul_(w_lo.view(shape))
    return y.add_(x.index_select(dim, hi).mul_(w_hi.view(shape)))


def resize_pack_plain(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The whole resize: :func:`resize_rows_plain` over every row."""
    return resize_rows_plain(x, out_hw, x.shape[1], out_hw[0], 0, 0)


def resize_rows_backward(g: torch.Tensor, in_hw: tuple[int, int], h_total: int,
                         oh_total: int, src_row0: int, out_row0: int) -> torch.Tensor:
    """The window's reverse rule: (B, oh, ow, C) cotangent -> (B, h, w, C),
    the W-pass then the H-pass with the transposed interpolation matrices
    (the H one cut to the window), in the cotangent's dtype (JAX
    ``_rp_bwd``).  ``resize_rows_backward.host_constants`` counts the
    matrices made from host arrays at call time (on the card, a blocking
    copy each)."""
    from maunet_tpu_torch.ops.resize import _interp_matrix

    b, oh, ow, c = g.shape
    h, w = in_hw
    wh = _interp_matrix(h_total, oh_total)[out_row0:out_row0 + oh, src_row0:src_row0 + h]
    ww_t = torch.from_numpy(_interp_matrix(w, ow).T.copy()).to(g.device, g.dtype)
    wh_t = torch.from_numpy(wh.T.copy()).to(g.device, g.dtype)
    tally(resize_rows_backward, "host_constants", 2)
    y = torch.matmul(ww_t, g.reshape(b * oh, ow, c))           # (b*oh, w, c)
    return torch.matmul(wh_t, y.reshape(b, oh, w * c)).reshape(b, h, w, c)


def resize_pack_backward(g: torch.Tensor, in_hw: tuple[int, int]) -> torch.Tensor:
    """The whole resize's reverse rule: (B, oh, ow, C) cotangent -> (B, h,
    w, C)."""
    return resize_rows_backward(g, in_hw, in_hw[0], g.shape[1], 0, 0)


class _ResizePack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_hw, window):
        ctx.in_hw = tuple(x.shape[1:3])
        ctx.window = window
        return _resize_pack(x, out_hw) if window is None else _resize_rows(x, out_hw, *window)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.window is None:
            return resize_pack_backward(g, ctx.in_hw), None, None
        return resize_rows_backward(g, ctx.in_hw, *ctx.window), None, None


def resize_pack(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, oh, ow, C) align-corners resize.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.  With grad
    enabled and an input that needs a gradient, the call goes through the
    autograd ``Function`` whose backward is :func:`resize_pack_backward`."""
    out_hw = tuple(int(v) for v in out_hw)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizePack.apply(x, out_hw, None)
    return _resize_pack(x, out_hw)


def resize_rows(x: torch.Tensor, out_hw: tuple[int, int], h_total: int, oh_total: int,
                src_row0: int, out_row0: int) -> torch.Tensor:
    """The row window of an align-corners resize: ``x`` (B, h, w, C) holds
    source rows [src_row0, src_row0 + h) of an image of ``h_total`` rows,
    and the result (B, oh, ow, C) is rows [out_row0, out_row0 + oh) of its
    resize to (oh_total, ow).  The window must hold every source row those
    outputs read.  A CPU tensor takes :func:`resize_rows_plain`; a CUDA
    tensor launches the kernel's row entry.  Under autograd the backward is
    the transposed window (:func:`resize_rows_backward`)."""
    out_hw = tuple(int(v) for v in out_hw)
    window = (int(h_total), int(oh_total), int(src_row0), int(out_row0))
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizePack.apply(x, out_hw, window)
    return _resize_rows(x, out_hw, *window)


def _check(x: torch.Tensor, what: str, out_hw: tuple[int, int], h_total: int,
           oh_total: int) -> None:
    _build.require(x.dim() == 4, what, f"expected NHWC, got {tuple(x.shape)}")
    _build.require(x.dtype in _DTYPES, what, f"unsupported dtype {x.dtype}")
    _build.require(x.is_contiguous(), what, "input must be contiguous")
    b, h, w, c = x.shape
    oh, ow = out_hw
    _build.require(1 <= min(h, w, oh, ow) and max(h_total, w, oh_total, ow) < 1 << 16, what,
                   f"sides must lie in [1, 65535]: {(h, w)}->{(oh, ow)}")
    _build.require(b * oh * ow * c < 1 << 31, what, "2^31 or more output elements")


def _resize_pack(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    what = "resize_pack"
    if _build.on_cpu(x, what):
        return resize_pack_plain(x, out_hw)
    _check(x, what, out_hw, x.shape[1], out_hw[0])
    return _launch(x, out_hw, _rows_for(x, out_hw))


def _resize_rows(x: torch.Tensor, out_hw: tuple[int, int], h_total: int, oh_total: int,
                 src_row0: int, out_row0: int) -> torch.Tensor:
    what = "resize_rows"
    first, stop = window_rows(h_total, oh_total, out_row0, out_hw[0])
    _build.require(0 <= src_row0 <= first and stop <= src_row0 + x.shape[1] <= h_total
                   and 0 <= out_row0 and out_row0 + out_hw[0] <= oh_total, what,
                   lambda: f"source rows [{src_row0}, {src_row0 + x.shape[1]}) of "
                   f"{h_total} do not hold rows [{first}, {stop}), which output rows "
                   f"[{out_row0}, {out_row0 + out_hw[0]}) of {oh_total} read")
    if _build.on_cpu(x, what):
        return resize_rows_plain(x, out_hw, h_total, oh_total, src_row0, out_row0)
    _check(x, what, out_hw, h_total, oh_total)
    b, h, w, c = x.shape
    oh, ow = out_hw
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    _build.launch(what, "maunet_resize_align_corners_rows",
                  [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12 + [ctypes.c_void_p],
                  x, x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, h, w, c, oh, ow,
                  _rows_for(x, out_hw), h_total, oh_total, src_row0, out_row0)
    resize_rows.launches += 1
    return y


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
resize_rows.launches = 0
_row_taps.host_constants = 0
resize_rows_backward.host_constants = 0
