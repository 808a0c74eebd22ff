"""Train-mode BatchNorm with ReLU after a conv: CUDA kernels and their plain
version.

:func:`bn_relu_train` computes ``relu(BN(y + bias)).to(y.dtype)`` with batch
statistics, the tail of ``models/blocks.py`` ``conv_bn_relu_train``, in the
same mathematics as that module's ``batch_norm_train``: ``y + bias`` in y's
dtype; per channel the mean and the biased variance ``E[y^2] - E[y]^2``
(clamped at 0) in f32 over every pixel of the batch; ``(y - mean) * (rsqrt(var
+ eps) * weight) + beta``; ReLU; a cast back to y's dtype; the running
statistics updated in place with flax's momentum update from the biased
variance, and ``num_batches_tracked`` counted, unless ``update_running`` is
false (``blocks.frozen_batch_statistics``).  ``bias`` is a constant (the conv
bias, detached as JAX ``stop_gradient``s it); the gradients are those of y,
``bn.weight`` and ``bn.bias``.

One autograd ``Function`` runs four passes: the statistics [sum y, sum y^2, n]
and the apply pass forward; the gradient statistics [sum g, sum g (y - mean)]
(g: the incoming gradient where the forward's ReLU passed it) and dy backward,
``weight * rstd * (g - G1 / n - (y - mean) * rstd^2 * G2 / n)``, the variance
term cut where the unclamped variance was negative, as ``clamp_min``'s
gradient cuts it.  It saves y (before the bias), the per-channel mean, rstd,
scale and clamp flag, and the sums; no f32 copy of the activation.  Under
data or spatial parallelism the caller passes ``all_reduce`` (in place, a
sum over the ranks): the forward sums are reduced between the two forward
passes and the gradient sums between the two backward ones, which is what
the differentiable all-reduce of ``batch_norm_train`` does; ``bn.weight``'s
and ``bn.bias``'s gradients stay this rank's, as there.

The passes are the kernels of ``csrc/batchnorm_train.cu`` (:class:`KernelPasses`,
its header says what bounds them on the H100), which :func:`bn_relu_train`
runs on a CUDA tensor and nothing else, or plain torch on any device
(:class:`PlainPasses`, through :func:`bn_relu_train_plain`), with the same
order of operations where the two share a rounding; so the CPU tests run
everything but the kernels.  ``models/blocks.py`` sends a CUDA tensor to the
kernels and a CPU one to its own ``batch_norm_train``.  y may be a view that
crops rows out of each batch (a spatial band's own rows); the kernels read it
in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn as nn
from torch.autograd.function import once_differentiable

from maunet_tpu_torch.ops.kernels import _build
from maunet_tpu_torch.utils.profiling import tally

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
# Pixels a thread loads before using any (the kernels' kUnroll).
UNROLL = 4
# Pixel blocks a slice of channels gets: about this many blocks an SM in all.
BLOCKS_PER_SM = 2
MAX_CHANNELS = 16384
MAX_PIXELS = 1 << 30

AllReduce = Callable[[torch.Tensor], object]


class Plan(NamedTuple):
    """How the kernels split a (pixels, C) tensor: ``lanes`` threads a pixel
    (16 bytes each) over a slice of ``lanes * 16 / itemsize`` channels,
    ``slices`` slices, ``blocks`` pixel blocks a slice of ``chunk`` pixels."""
    lanes: int
    slices: int
    blocks: int
    chunk: int


@functools.lru_cache(maxsize=256)
def plan(c: int, pixels: int, itemsize: int, sms: int) -> Plan:
    """The grid for C channels of ``pixels`` pixels of ``itemsize`` bytes on
    a card of ``sms`` SMs: the most lanes (up to 8) that divide C's 16-byte
    groups; about ``BLOCKS_PER_SM`` blocks an SM, but no block with less than
    one full unrolled step of pixels; chunks a whole number of the block's
    pixel rows."""
    groups = c // (16 // itemsize)
    lanes = next(n for n in (8, 4, 2, 1) if groups % n == 0)
    slices = groups // lanes
    rows = THREADS // lanes
    blocks = max(1, min(-(-BLOCKS_PER_SM * sms // slices), -(-pixels // (rows * UNROLL))))
    per_block = -(-pixels // blocks)
    chunk = -(-per_block // rows) * rows
    return Plan(lanes, slices, -(-pixels // chunk), chunk)


# --------------------------------------------------------------------------
# The plain passes.


def _biased(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y + bias in y's dtype, then in f32 (f64 for f64 input)."""
    return (y + bias).to(torch.promote_types(y.dtype, torch.float32))


def _channel_sums(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat([t.reshape(-1, t.shape[-1]).sum(0) for t in ts])


class PlainPasses:
    """The four passes in plain torch, on any device."""

    @staticmethod
    def grad_input(dout: torch.Tensor) -> torch.Tensor:
        return dout

    @staticmethod
    def stats(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        yb = _biased(y, bias)
        return torch.cat([_channel_sums(yb, yb * yb), yb.new_full((1,), yb[..., 0].numel())])

    @staticmethod
    def apply(y, bias, weight, beta, sums, bn: nn.BatchNorm2d, update: bool):
        c = y.shape[-1]
        n = sums[2 * c]
        mean = sums[:c] / n
        raw = sums[c:2 * c] / n - mean * mean
        var = raw.clamp_min(0.0)
        rstd = torch.rsqrt(var + bn.eps)
        scale = rstd * weight
        if update:
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
            bn.num_batches_tracked += 1
        z = (_biased(y, bias) - mean) * scale + beta
        saved = torch.cat([mean, rstd, scale, (~(raw < 0)).to(mean.dtype)])
        return torch.relu(z).to(y.dtype), saved

    @staticmethod
    def _masked(y, bias, dout, beta, saved):
        """(yb - mean, g): the centred input and the gradient the ReLU let through."""
        c = y.shape[-1]
        mean, scale = saved[:c], saved[2 * c:3 * c]
        yb = _biased(y, bias)
        g = torch.where((yb - mean) * scale + beta > 0, dout.to(yb.dtype), 0.0)
        return yb - mean, g

    @staticmethod
    def grad_stats(y, bias, dout, beta, saved):
        c = y.shape[-1]
        centred, g = PlainPasses._masked(y, bias, dout, beta, saved)
        gsums = _channel_sums(g, g * centred)
        return gsums, gsums[c:] * saved[c:2 * c], gsums[:c].clone()

    @staticmethod
    def dx(y, bias, dout, beta, saved, sums, gsums):
        c = y.shape[-1]
        n = sums[2 * c]
        rstd, scale, keep = saved[c:2 * c], saved[2 * c:3 * c], saved[3 * c:]
        centred, g = PlainPasses._masked(y, bias, dout, beta, saved)
        a = gsums[:c] / n
        k = rstd * rstd * gsums[c:] / n * keep
        return (scale * (g - a - centred * k)).to(y.dtype)


# --------------------------------------------------------------------------
# The kernels.

_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
# (pixels, hw, C, gap, lanes, chunk, blocks) after the pointers, then the
# entry's scalars and the dtype code
_LAYOUT = [_I, _I, _I, _LL, _I, _I, _I]
_STATS_ARGS = [_P] * 5 + _LAYOUT + [_I, _P]
_APPLY_ARGS = [_P] * 10 + _LAYOUT + [_F, _F, _F, _I, _I, _P]
_GRAD_STATS_ARGS = [_P] * 10 + _LAYOUT + [_I, _P]
_DX_ARGS = [_P] * 8 + _LAYOUT + [_I, _P]


class _Workspace:
    """A card's SM count, the statistics passes' tickets, one a slice (a
    slice has 4 channels or more): zero, and left zero by every launch (the
    last block of a slice resets its own), and the partial sums of those
    passes, shared by every launch: each launch is done with its rows before
    the next on the stream starts, as the tickets already assume."""

    def __init__(self, index: int):
        dev = torch.device("cuda", index)
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        with torch.inference_mode(False):
            self.tickets = torch.zeros(MAX_CHANNELS // 4, dtype=torch.int32, device=dev)
            self.partials = torch.empty(partial_floats(self.sms), dtype=torch.float32,
                                        device=dev)


def partial_floats(sms: int) -> int:
    """The most partial sums (blocks * 2C) a statistics pass writes under
    :func:`plan` on ``sms`` SMs: blocks <= 2 sms / slices + 1, and C =
    slices * lanes * 16 / itemsize with lanes * 16 / itemsize <= 64."""
    return 4 * sms * 64 + 2 * MAX_CHANNELS


@functools.lru_cache(maxsize=None)
def _workspace(index: int) -> _Workspace:
    return _Workspace(index)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _reads_in_place(y: torch.Tensor) -> bool:
    """Whether the kernels read y as it lies: every batch's (H, W, C) block
    contiguous and 16-byte aligned, at a batch stride of whole 16 bytes."""
    b, h, w, c = y.shape
    st = y.stride()
    vec = 16 // y.element_size()
    return (st[3] == 1 and (w == 1 or st[2] == c) and (h == 1 or st[1] == w * c)
            and (b == 1 or (st[0] >= h * w * c and st[0] % vec == 0)) and _aligned(y))


def _contiguous16(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if _aligned(t) else t.clone()


def _empty(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(n, dtype=torch.float32, device=like.device)


class KernelPasses:
    """The four passes as launches of ``csrc/batchnorm_train.cu`` on one y,
    whose layout (pixels, hw, C, gap, lanes, chunk, blocks), dtype code,
    device and stream are worked out once a call, for all four: autograd
    runs the backward on the forward's stream."""

    def __init__(self, y: torch.Tensor):
        b, h, w, c = y.shape
        self.device = y.get_device()
        self.stream = _build.stream_of(y)
        self.ws = _workspace(self.device)
        p = plan(c, b * h * w, y.element_size(), self.ws.sms)
        self.c = c
        self.layout = (b * h * w, h * w, c, y.stride(0) - h * w * c if b > 1 else 0,
                       p.lanes, p.chunk, p.blocks, _DTYPES[y.dtype])

    def _launch(self, entry: str, argtypes: list, *args) -> None:
        """As ``_build.launch``, on the call's device and stream."""
        with torch.cuda.device(self.device):
            _build.check(_build.function(entry, argtypes)(*args, self.stream), "bn_relu_train")
        bn_relu_train.launches += 1

    @staticmethod
    def grad_input(dout: torch.Tensor) -> torch.Tensor:
        return _contiguous16(dout)

    def stats(self, y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        sums = _empty(2 * self.c + 1, y)
        self._launch("maunet_bn_train_stats", _STATS_ARGS,
                     *_ptrs(y, bias, self.ws.partials, self.ws.tickets, sums), *self.layout)
        return sums

    def apply(self, y, bias, weight, beta, sums, bn: nn.BatchNorm2d, update: bool):
        out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
        saved = _empty(4 * self.c, y)
        m = bn.momentum
        self._launch("maunet_bn_train_apply", _APPLY_ARGS,
                     *_ptrs(y, bias, weight, beta, sums, saved, bn.running_mean,
                            bn.running_var, bn.num_batches_tracked, out),
                     *self.layout[:-1], m, 1.0 - m, bn.eps, int(update), self.layout[-1])
        return out, saved

    def grad_stats(self, y, bias, dout, beta, saved):
        c = self.c
        # [sum g, sum g (y - mean)], then weight's and beta's gradients
        grads = _empty(4 * c, y)
        self._launch("maunet_bn_train_grad_stats", _GRAD_STATS_ARGS,
                     *_ptrs(y, bias, dout, beta, saved, self.ws.partials, self.ws.tickets,
                            grads, grads[2 * c:], grads[3 * c:]), *self.layout)
        return grads[:2 * c], grads[2 * c:3 * c], grads[3 * c:]

    def dx(self, y, bias, dout, beta, saved, sums, gsums):
        out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
        self._launch("maunet_bn_train_dx", _DX_ARGS,
                     *_ptrs(y, bias, dout, beta, saved, sums, gsums, out), *self.layout)
        return out


def _ptrs(*ts: torch.Tensor) -> list[int]:
    return [t.data_ptr() for t in ts]


def _check(y: torch.Tensor, bias: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """What the kernels take, the cheap checks first; returns y, or a
    contiguous copy where its layout is not one the kernels read in place."""
    what = "bn_relu_train"
    _build.require(y.is_cuda, what, lambda: f"runs the kernels on a CUDA tensor, got "
                   f"{y.device} (bn_relu_train_plain is the plain version)")
    _build.require(y.dtype in _DTYPES, what, lambda: f"takes bf16 or f32, got {y.dtype}")
    _build.require(y.dim() == 4, what, lambda: f"expected NHWC, got {tuple(y.shape)}")
    b, h, w, c = y.shape
    vec = 16 // y.element_size()
    _build.require(c % vec == 0 and c <= MAX_CHANNELS and 0 < b * h * w <= MAX_PIXELS, what,
                   lambda: f"C = {c} must be a multiple of {vec}, at most {MAX_CHANNELS}; "
                   f"{b * h * w} pixels")
    _build.require(bias.dim() == 1 and bias.shape[0] == c and bias.dtype == y.dtype
                   and bias.is_contiguous() and bias.device == y.device, what,
                   lambda: f"bias must be a contiguous (C,) tensor of y's dtype on {y.device}")
    _build.require(bn.momentum is not None and bn.num_batches_tracked is not None
                   and bn.num_batches_tracked.dtype == torch.int64, what,
                   "bn must track running statistics with a momentum")
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        _build.require(t is not None and t.dim() == 1 and t.shape[0] == c
                       and t.dtype == torch.float32 and t.is_contiguous()
                       and t.device == y.device, what,
                       lambda: f"bn.{name} must be a contiguous f32 (C,) tensor on {y.device}")
    return y if _reads_in_place(y) else _contiguous16(y)


class _BNReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, weight, beta, bn, update, all_reduce, passes):
        sums = passes.stats(y, bias)
        if all_reduce is not None:
            all_reduce(sums)
        out, saved = passes.apply(y, bias, weight, beta, sums, bn, update)
        ctx.save_for_backward(y, bias, beta, sums, saved)
        ctx.all_reduce, ctx.passes = all_reduce, passes
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        y, bias, beta, sums, saved = ctx.saved_tensors
        passes = ctx.passes
        dout = passes.grad_input(dout)
        gsums, dweight, dbias = passes.grad_stats(y, bias, dout, beta, saved)
        dy = None
        if ctx.needs_input_grad[0]:
            if ctx.all_reduce is not None:
                ctx.all_reduce(gsums)
            dy = passes.dx(y, bias, dout, beta, saved, sums, gsums)
        return dy, None, dweight, dbias, None, None, None, None


def bn_relu_train(y: torch.Tensor, bias: torch.Tensor, bn: nn.BatchNorm2d, *,
                  update_running: bool = True,
                  all_reduce: AllReduce | None = None) -> torch.Tensor:
    """``relu(BN(y + bias)).to(y.dtype)`` in train mode (the module's
    docstring) through the kernels: y (B, H, W, C) NHWC on a CUDA device,
    each batch's block contiguous, bias (C,) of y's dtype.  Four launches
    (two here, two in the backward), counted in ``launches``; every call is
    tallied as ``kernel_calls``.  A tensor on any other device raises: the
    model runs ``blocks.batch_norm_train`` on the CPU, and
    :func:`bn_relu_train_plain` is the plain version."""
    y = _check(y, bias, bn)
    tally(bn_relu_train, "kernel_calls")
    return _BNReLUTrain.apply(y, bias, bn.weight, bn.bias, bn, update_running, all_reduce,
                              KernelPasses(y))


def bn_relu_train_plain(y: torch.Tensor, bias: torch.Tensor, bn: nn.BatchNorm2d, *,
                        update_running: bool = True,
                        all_reduce: AllReduce | None = None) -> torch.Tensor:
    """:func:`bn_relu_train`'s results through the plain passes, on any
    device; neither launched nor tallied."""
    return _BNReLUTrain.apply(y, bias, bn.weight, bn.bias, bn, update_running, all_reduce,
                              PlainPasses)


bn_relu_train.launches = 0
bn_relu_train.kernel_calls = 0
