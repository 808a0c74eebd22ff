"""The fused train-mode BatchNorm's plain version (``ops/kernels/
batchnorm_train.py``), on the CPU at small shapes.

Its passes, including the explicit backward formula, are held against
autograd through ``relu(blocks.batch_norm_train(y + b)).to(dtype)``, the
model's CPU path, and against the JAX package's train-mode BN, flax's
``nn.BatchNorm`` and ``jax.nn.relu`` under ``jax.vjp``: the output, the
running statistics, ``num_batches_tracked`` and the gradients of y,
``bn.weight`` and ``bn.bias``, in f64 (to rounding), f32 and bf16 (to their
rounding).  Also the clamp of a constant channel, frozen statistics under
checkpointing, a row-cropped view, the all-reduce between the passes, the
wrapper's refusal of a CPU tensor and its tally, and the kernels' grid plan.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from maunet_tpu_torch.models import blocks
from maunet_tpu_torch.ops.kernels import batchnorm_train as bnt

# (atol, rtol) of the comparisons, by dtype: f64 to its rounding; f32 to
# the two sides' sums in other orders; bf16 to one bf16 ulp of the shared
# f32 values (a cast can round either way).
TOL = {torch.float64: (1e-10, 1e-9), torch.float32: (2e-5, 2e-4),
       torch.bfloat16: (2e-2, 1.6e-2)}


def _inputs(seed: int, shape, dtype, constant: float | None = None):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    y = (torch.randn(shape, generator=g, dtype=torch.float64) * 1.5 + 0.3).to(dtype)
    if constant is not None:
        y[..., 0] = constant
    bias = (torch.randn(c, generator=g, dtype=torch.float64) * 0.2).to(dtype)
    dout = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    bn = nn.BatchNorm2d(c, eps=1e-5).to(torch.promote_types(dtype, torch.float32))
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g, dtype=torch.float64) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g, dtype=torch.float64) * 0.1)
        bn.running_mean.copy_(torch.randn(c, generator=g, dtype=torch.float64))
        bn.running_var.copy_(torch.rand(c, generator=g, dtype=torch.float64) + 0.5)
    return y, bias, dout, bn


def _reference(y, bias, dout, bn):
    """Autograd through the model's CPU path."""
    y = y.clone().requires_grad_(True)
    out = torch.relu(blocks.batch_norm_train(y + bias, bn)).to(y.dtype)
    out.backward(dout)
    return out.detach(), y.grad, bn.weight.grad, bn.bias.grad


def _plain(y, bias, dout, bn, **kw):
    y = y.clone().requires_grad_(True)
    out = bnt.bn_relu_train_plain(y, bias, bn, **kw)
    out.backward(dout)
    return out.detach(), y.grad, bn.weight.grad, bn.bias.grad


def _close(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    scale = want.double().abs().max().clamp_min(1.0)
    err = (got.double() - want.double()).abs()
    assert bool((err <= atol * scale + rtol * want.double().abs()).all()), \
        f"{what}: max error {float(err.max()):.3e}"


def _compare(got_bn, want_bn, got, want, dtype):
    for name, a, b in zip(("out", "dy", "dweight", "dbias"), got, want):
        _close(a, b, dtype, name)
    for name in ("running_mean", "running_var"):
        _close(getattr(got_bn, name), getattr(want_bn, name), dtype, name)
    assert int(got_bn.num_batches_tracked) == int(want_bn.num_batches_tracked) == 1


@pytest.mark.parametrize("dtype,shape", [
    (torch.float64, (2, 3, 5, 32)),
    (torch.float64, (1, 7, 3, 64)),
    (torch.float32, (2, 5, 3, 64)),
    (torch.float32, (2, 3, 3, 1024)),
    (torch.float32, (3, 5, 7, 32)),
    (torch.bfloat16, (3, 5, 7, 32)),
    (torch.bfloat16, (2, 3, 5, 64)),
    (torch.bfloat16, (1, 3, 5, 1024)),
])
def test_plain_matches_batch_norm_train(dtype, shape):
    y, bias, dout, bn = _inputs(0, shape, dtype)
    ref_bn = copy.deepcopy(bn)
    _compare(bn, ref_bn, _plain(y, bias, dout, bn), _reference(y, bias, dout, ref_bn), dtype)


@pytest.mark.parametrize("dtype,constant", [(torch.float64, 1.3), (torch.float32, 0.1)])
def test_constant_channel_takes_the_clamp(dtype, constant):
    """A constant channel whose E[y^2] - E[y]^2 rounds below 0 in both: the
    variance is clamped and its term of dy cut, as clamp_min's gradient is."""
    y, bias, dout, bn = _inputs(1, (2, 3, 5, 32), dtype, constant=constant)
    bias[0] = 0.0
    ref_bn = copy.deepcopy(bn)
    with torch.no_grad():
        sums = bnt.PlainPasses.stats(y, bias)
        _, saved = bnt.PlainPasses.apply(y, bias, bn.weight, bn.bias, sums, bn, False)
    assert float(saved[3 * 32]) == 0.0 and float(saved[3 * 32 + 1:].min()) == 1.0
    _compare(bn, ref_bn, _plain(y, bias, dout, bn), _reference(y, bias, dout, ref_bn), dtype)


def _flax(y, bias, dout, bn):
    """The JAX package's train-mode BN (``maunet_tpu/models/blocks.py``
    ``VGGBlock``): flax's ``nn.BatchNorm(use_running_average=False,
    momentum=0.9, epsilon=1e-5)`` in f32 and ``jax.nn.relu`` on y + bias,
    under ``jax.vjp`` with the batch statistics mutable.  Returns (out, dy,
    dweight, dbias) and the updated (mean, var), out and dy rounded to y's
    dtype as that block's casts round them."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    def f32(t):
        return jnp.asarray(t.detach().float().numpy())

    module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                           dtype=jnp.float32, param_dtype=jnp.float32)
    stats = {"mean": f32(bn.running_mean), "var": f32(bn.running_var)}

    def forward(x, params):
        out, updated = module.apply({"params": params, "batch_stats": stats}, x,
                                    mutable=["batch_stats"])
        return jax.nn.relu(out), updated["batch_stats"]

    @jax.jit
    def run(x, params, g):
        out, vjp, new_stats = jax.vjp(forward, x, params, has_aux=True)
        return (out, *vjp(g), new_stats)

    out, dx, dparams, new_stats = run(f32(y + bias), {"scale": f32(bn.weight),
                                                      "bias": f32(bn.bias)}, f32(dout))

    def back(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(dtype)

    return ((back(out, y.dtype), back(dx, y.dtype), back(dparams["scale"]),
             back(dparams["bias"])), back(new_stats["mean"]), back(new_stats["var"]))


@pytest.mark.parametrize("dtype,shape,constant", [
    (torch.float32, (2, 5, 3, 64), None),
    (torch.float32, (2, 3, 3, 1024), None),
    (torch.float32, (3, 5, 7, 32), None),
    (torch.bfloat16, (3, 5, 7, 32), None),
    (torch.bfloat16, (1, 3, 5, 1024), None),
    (torch.float32, (2, 3, 5, 32), 0.1),
])
def test_plain_matches_flax_batch_norm(dtype, shape, constant):
    """The plain passes against flax's BatchNorm and ReLU, the JAX package's
    train-mode BN: output, gradients and the momentum update of the running
    statistics from the biased variance; with ``constant``, channel 0 takes
    the clamp on the plain side, and its variance term is cut."""
    y, bias, dout, bn = _inputs(7, shape, dtype, constant=constant)
    if constant is not None:
        bias[0] = 0.0
    want, mean, var = _flax(y, bias, dout, bn)
    got = _plain(y, bias, dout, bn)
    for name, a, b in zip(("out", "dy", "dweight", "dbias"), got, want):
        _close(a, b, dtype, name)
    _close(bn.running_mean, mean, torch.float32, "running_mean")
    _close(bn.running_var, var, torch.float32, "running_var")
    assert int(bn.num_batches_tracked) == 1
    if constant is not None:
        with torch.no_grad():
            sums = bnt.PlainPasses.stats(y, bias)
            _, saved = bnt.PlainPasses.apply(y, bias, bn.weight, bn.bias, sums, bn, False)
        assert float(saved[3 * shape[-1]]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frozen_statistics_under_checkpoint(dtype):
    """Checkpointed as ``remat`` runs a block: the recompute runs under
    ``frozen_batch_statistics`` and leaves the running statistics alone, and
    the gradients equal the plain call's bit for bit."""
    y, bias, dout, bn = _inputs(2, (2, 4, 3, 64), dtype)
    frozen_bn = copy.deepcopy(bn)
    want = _plain(y, bias, dout, bn)

    def block(t):
        return bnt.bn_relu_train_plain(t, bias, frozen_bn,
                                 update_running=not getattr(blocks._frozen, "on", False))

    yr = y.clone().requires_grad_(True)
    out = checkpoint(block, yr, use_reentrant=False, context_fn=blocks._remat_contexts)
    out.backward(dout)
    for a, b in zip((out.detach(), yr.grad, frozen_bn.weight.grad, frozen_bn.bias.grad), want):
        assert torch.equal(a, b)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(frozen_bn, name), getattr(bn, name)), name

    still = copy.deepcopy(bn)
    with torch.no_grad():
        got = bnt.bn_relu_train_plain(y, bias, still, update_running=False)
    assert torch.equal(got, want[0])
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(still, name), getattr(bn, name)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_cropped_view(dtype):
    """A spatial band's own rows as a view of its halo-extended conv output:
    the same results as on a contiguous copy, the gradient only in those
    rows; the kernels read such a view in place."""
    full, bias, _, bn = _inputs(3, (2, 7, 3, 64), dtype)
    view = full[:, 2:6]
    assert not view.is_contiguous() and bnt._reads_in_place(view)
    dout = torch.randn(view.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
    copy_bn = copy.deepcopy(bn)
    want = _plain(view.contiguous(), bias, dout, copy_bn)
    leaf = full.clone().requires_grad_(True)
    out = bnt.bn_relu_train_plain(leaf[:, 2:6], bias, bn)
    out.backward(dout)
    assert torch.equal(out.detach(), want[0])
    assert torch.equal(leaf.grad[:, 2:6], want[1])
    assert not leaf.grad[:, :2].any() and not leaf.grad[:, 6:].any()
    assert torch.equal(bn.running_mean, copy_bn.running_mean)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_all_reduce_between_the_passes(dtype):
    """Two ranks holding the same half batch, the reduction mocked as a sum
    of two equal tensors: each rank's output, running statistics and dy are
    the single rank's on the whole batch (its first half), and bn's
    gradients that rank's half of the whole batch's."""
    y, bias, dout, bn = _inputs(5, (2, 3, 5, 32), dtype)
    whole_bn = copy.deepcopy(bn)
    whole = _plain(torch.cat([y, y]), bias, torch.cat([dout, dout]), whole_bn)
    reduced = []

    def all_reduce(t):
        reduced.append(t.numel())
        t.mul_(2)

    got = _plain(y, bias, dout, bn, all_reduce=all_reduce)
    assert reduced == [2 * 32 + 1, 2 * 32]
    _close(got[0], whole[0][:2], dtype, "out")
    _close(got[1], whole[1][:2], dtype, "dy")
    _close(got[2], whole[2] / 2, dtype, "dweight")
    _close(got[3], whole[3] / 2, dtype, "dbias")
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.allclose(getattr(bn, name), getattr(whole_bn, name)), name


def test_tally_counts_every_kernel_call(monkeypatch):
    """Every call through the kernels' route is tallied once, the plain
    version's none; here the kernels' passes are stood in for by the plain
    ones, which launch nothing."""
    monkeypatch.setattr(bnt, "_check", lambda y, bias, bn: y)
    monkeypatch.setattr(bnt, "KernelPasses", lambda y: bnt.PlainPasses)
    y, bias, _, bn = _inputs(6, (1, 2, 2, 32), torch.float32)
    calls, launches = bnt.bn_relu_train.kernel_calls, bnt.bn_relu_train.launches
    with torch.no_grad():
        for _ in range(3):
            bnt.bn_relu_train(y, bias, bn)
        bnt.bn_relu_train_plain(y, bias, bn)
    assert bnt.bn_relu_train.kernel_calls == calls + 3
    assert bnt.bn_relu_train.launches == launches


def test_cpu_tensor_is_refused():
    """The kernels' wrapper runs on a CUDA tensor only: a CPU one raises,
    untallied, and leaves bn alone."""
    y, bias, _, bn = _inputs(6, (1, 2, 2, 32), torch.float32)
    before = copy.deepcopy(bn)
    calls = bnt.bn_relu_train.kernel_calls
    with pytest.raises(ValueError, match="CUDA tensor"):
        bnt.bn_relu_train(y, bias, bn)
    assert bnt.bn_relu_train.kernel_calls == calls
    assert int(bn.num_batches_tracked) == 0
    assert torch.equal(bn.running_mean, before.running_mean)


def test_cpu_block_keeps_batch_norm_train(monkeypatch):
    """On a CPU tensor a train-mode block runs ``blocks.batch_norm_train``
    (the hook the train-step tests patch), not the fused wrapper."""
    seen = []
    real = blocks.batch_norm_train

    def recorded(y, bn):
        seen.append(tuple(y.shape))
        return real(y, bn)

    monkeypatch.setattr(blocks, "batch_norm_train", recorded)
    block = blocks.VGGBlock(3, 32, 32, compute_dtype=torch.float32).train()
    calls = bnt.bn_relu_train.kernel_calls
    block([torch.randn(2, 4, 4, 3)]).sum().backward()
    assert seen == [(2, 4, 4, 32)] * 2
    assert bnt.bn_relu_train.kernel_calls == calls


@pytest.mark.parametrize("c,pixels,itemsize,want", [
    (64, 16 * 256 * 256, 2, (8, 1, 263, 4000)),   # U-Net level 0, bf16
    (1024, 16 * 16 * 16, 2, (8, 16, 16, 256)),     # the bottleneck, bf16
    (32, 16 * 256 * 256, 2, (4, 1, 261, 4032)),   # U-Net++ level 0, bf16
    (1024, 16 * 16 * 16, 4, (8, 32, 9, 480)),      # the bottleneck, f32
    (96, 7, 2, (4, 3, 1, 64)),                     # 12 groups: 4 lanes; one block
])
def test_plan(c, pixels, itemsize, want):
    p = bnt.plan(c, pixels, itemsize, 132)
    assert tuple(p) == want
    assert p.blocks * 2 * c <= bnt.partial_floats(132)
    rows = bnt.THREADS // p.lanes
    assert p.slices * p.lanes * 16 // itemsize == c
    assert p.chunk % rows == 0 and (p.blocks - 1) * p.chunk < pixels <= p.blocks * p.chunk
