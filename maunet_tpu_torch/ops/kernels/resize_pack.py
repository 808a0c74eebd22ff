"""Align-corners bilinear resize: CUDA kernel and its plain version.

Port of ``maunet_tpu/ops/pallas/resize_pack.py::resize_pack`` without the
lane-packed input and output forms (``s``, ``s_in``), which are a TPU layout
device.  The kernel is ``csrc/resize_pack.cu``; its header says what bounds it
on the H100.  Both versions take any (h, w) -> (oh, ow) on NHWC tensors and
round once from f32 to the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

from maunet_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resize_pack_plain(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The separable pair of interpolation products, in f32, rounded once."""
    from maunet_tpu_torch.ops.resize import _interp_matrix

    b, h, w, c = x.shape
    oh, ow = out_hw
    wh = torch.from_numpy(_interp_matrix(h, oh)).to(x.device)
    ww = torch.from_numpy(_interp_matrix(w, ow)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", wh, x.float())
    return torch.einsum("pw,bowc->bopc", ww, y).to(x.dtype)


def resize_pack(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, oh, ow, C) align-corners resize.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
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
    y = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    fn = _build.function("maunet_resize_align_corners",
                         [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, h, w, c,
                    oh, ow, _build.stream_of(x)), what)
    resize_pack.launches += 1
    return y


resize_pack.launches = 0
