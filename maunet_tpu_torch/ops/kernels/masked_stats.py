"""Per-Dynamic-World-class masked error sums: CUDA kernel and its plain
version.

Port of ``maunet_tpu/ops/pallas/masked_stats.py::masked_class_sums``.  For
each sample and channel: the sums of ``|err|`` and ``err**2`` over the pixels
of each of the 9 classes, and per sample the pixel count of each class, with
``err = (pred - target).float()`` (the subtraction in the inputs' dtype, as
masked_stats.py:65 has it).  The kernel is ``csrc/masked_stats.cu``; its
header says what bounds it on the H100.  The plain version is the one-hot
``einsum`` of ``maunet_tpu/evaluate/metrics.py::_class_sums_xla``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from maunet_tpu_torch.ops.kernels import _build

NUM_CLASSES = 9
MAX_CHANNELS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# maunet_masked_class_sums(pred, target, dw, out, B, hw, C, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]

Sums = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def masked_class_sums_plain(pred: torch.Tensor, target: torch.Tensor,
                            dw_map: torch.Tensor) -> Sums:
    """One-hot einsum; a class value outside 0..8 counts nowhere."""
    err = (pred - target).float()
    dw = dw_map.long()
    inside = (dw >= 0) & (dw < NUM_CLASSES)
    onehot = F.one_hot(dw.clamp(0, NUM_CLASSES - 1), NUM_CLASSES).float()
    onehot = onehot * inside[..., None]
    counts = onehot.sum(dim=(1, 2))
    sum_abs = torch.einsum("bhwc,bhwk->bck", err.abs(), onehot)
    sum_sq = torch.einsum("bhwc,bhwk->bck", err * err, onehot)
    return sum_abs, sum_sq, counts


def split_sums(out: torch.Tensor, c: int) -> Sums:
    """(sum_abs (B, C, 9), sum_sq (B, C, 9), counts (B, 9)) as views of one
    (B, 9 * (2C + 1)) row per sample: the |err| sums [c][k], then the err^2
    sums [c][k], then the counts [k], as the kernel writes them."""
    b, nv = out.shape
    k, at = NUM_CLASSES * c, out.storage_offset()
    # as_strided: three views in three calls, the fewest host operations
    return (out.as_strided((b, c, NUM_CLASSES), (nv, NUM_CLASSES, 1), at),
            out.as_strided((b, c, NUM_CLASSES), (nv, NUM_CLASSES, 1), at + k),
            out.as_strided((b, NUM_CLASSES), (nv, 1), at + 2 * k))


def masked_class_sums(pred: torch.Tensor, target: torch.Tensor,
                      dw_map: torch.Tensor) -> Sums:
    """(B, H, W, C) pred and target of one float dtype + (B, H, W) int32
    class map -> (sum_abs (B, C, 9), sum_sq (B, C, 9), counts (B, 9)), f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which takes f32, bf16 or f16 inputs of any H and W with 1-4 channels and
    writes one (B, 9 * (2C + 1)) tensor, of which the three are views
    (:func:`split_sums`).
    """
    what = "masked_class_sums"
    if _build.on_cpu(pred, what):
        return masked_class_sums_plain(pred, target, dw_map)
    _build.require_no_grad(what, pred, target)
    _build.require(pred.dim() == 4 and pred.shape == target.shape, what,
                   lambda: f"pred {tuple(pred.shape)} and target {tuple(target.shape)} "
                   "must be one (B, H, W, C) shape")
    b, h, w, c = pred.shape
    dev = pred.device
    _build.require(pred.dtype in _DTYPES and target.dtype == pred.dtype, what,
                   lambda: f"pred and target must share f32, bf16 or f16, got "
                   f"{pred.dtype} and {target.dtype}")
    _build.require(1 <= c <= MAX_CHANNELS, what,
                   lambda: f"takes 1-{MAX_CHANNELS} channels, got {c}")
    _build.require(dw_map.shape == (b, h, w) and dw_map.dtype == torch.int32,
                   what, lambda: f"dw_map must be int32 {(b, h, w)}, got {dw_map.dtype} "
                   f"{tuple(dw_map.shape)}")
    _build.require(target.device == dev and dw_map.device == dev, what,
                   lambda: f"every input must lie on {dev}")
    _build.require(pred.is_contiguous() and target.is_contiguous()
                   and dw_map.is_contiguous(), what, "inputs must be contiguous")
    _build.require(b <= 65535 and h * w > 0, what, lambda: f"batch {b} of {h}x{w} pixels")
    out = torch.empty((b, NUM_CLASSES * (2 * c + 1)), dtype=torch.float32, device=dev)
    _build.launch(what, "maunet_masked_class_sums", _ARGTYPES, pred,
                  pred.data_ptr(), target.data_ptr(), dw_map.data_ptr(), out.data_ptr(),
                  b, h * w, c, _DTYPES[pred.dtype])
    masked_class_sums.launches += 1
    return split_sums(out, c)


masked_class_sums.launches = 0
