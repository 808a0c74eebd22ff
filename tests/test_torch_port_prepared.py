"""The fused conv's prepared weights and ``VGGBlock``'s kept constants.

``prepare_conv3x3`` folds a conv's weights and lays them out as the CUDA
kernel's main loop (``csrc/conv_tile.cuh``) copies them.  The kernel runs
only on the card; here the layout is read back by a numpy function that
repeats the kernel's index arithmetic, and everything around it (the
wrapper's prepared path, the block's cache and what invalidates it) runs on
the CPU through the plain version.
"""

import copy

import numpy as np
import pytest
import torch

from maunet_tpu_torch.models import blocks
from maunet_tpu_torch.ops.kernels import packed_vgg as pvgg

# The kernels' constants (csrc/conv_tile.cuh: BK; conv3x3_fused.cu: the 64- and
# 32-wide instantiations; conv3x3_f32.cu: BK), written out a second time on
# purpose.
BK = 32
BK_F32 = 8


def _read_like_the_kernel(packed: np.ndarray, cins, cout: int) -> list[np.ndarray]:
    """Each part's (cout, cin_p, 3, 3) weight as the kernel would multiply
    it.  For output-channel tile ``nbase`` (BN = 64 wide, or 32 for a last
    tile of at most 32 channels) and K step ``step`` (part by part, 32
    channels each) the kernel copies ``9 * BN * 32`` elements from ``slab +
    step * 9 * BN * 32`` and hands wgmma, for tap ``tap`` and k16 step ``ks``,
    the address ``(tap * 2 + ks) * BN * 16`` in it with a no-swizzle
    descriptor: 8 x 8 core matrices of 64 contiguous elements (8 weight rows
    of 8 channels), the second eight channels 64 elements (128 bytes) after
    the first, the next eight rows 128 elements (256 bytes) on.  Also checks
    that every element the kernel multiplies beyond the weights is zero."""
    steps = sum(-(-c // BK) for c in cins)
    out = [np.zeros((cout, c, 3, 3), packed.dtype) for c in cins]
    slab = 0
    for nbase in range(0, cout, 64):
        bn = 64 if cout - nbase > 32 else 32
        step = 0
        for wt, cin in zip(out, cins):
            for c0 in range(0, cin, BK):
                stage = slab + step * 9 * bn * BK
                for tap in range(9):
                    for ks in range(2):
                        operand = stage + (tap * 2 + ks) * bn * 16
                        for n in range(bn):
                            for k in range(16):
                                v = packed[operand + n // 8 * 128 + k // 8 * 64
                                           + n % 8 * 8 + k % 8]
                                ch = c0 + ks * 16 + k
                                if nbase + n < cout and ch < cin:
                                    wt[nbase + n, ch, tap // 3, tap % 3] = v
                                else:
                                    assert v == 0, (nbase, step, tap, ks, n, k)
                step += 1
        assert step == steps
        slab += steps * 9 * bn * BK
    assert slab == packed.size
    return out


def _read_like_the_f32_kernel(packed: np.ndarray, cins, cout: int) -> list[np.ndarray]:
    """As :func:`_read_like_the_kernel`, for the f32 kernel
    (``csrc/conv3x3_f32.cu``): for output-channel tile ``nbase`` (BN = 64,
    or 32 for a last tile of at most 32 channels) and K step ``step`` (part
    by part, BK_F32 = 8 channels each) it copies ``9 * 8 * BN`` elements from
    ``slab + step * 9 * 8 * BN`` and multiplies channel ``k`` of tap ``tap``
    into output ``n`` with element ``(tap * 8 + k) * BN + n`` of them."""
    steps = sum(-(-c // BK_F32) for c in cins)
    out = [np.zeros((cout, c, 3, 3), packed.dtype) for c in cins]
    slab = 0
    for nbase in range(0, cout, 64):
        bn = 64 if cout - nbase > 32 else 32
        step = 0
        for wt, cin in zip(out, cins):
            for c0 in range(0, cin, BK_F32):
                stage = slab + step * 9 * BK_F32 * bn
                for tap in range(9):
                    for k in range(BK_F32):
                        for n in range(bn):
                            v = packed[stage + (tap * BK_F32 + k) * bn + n]
                            if nbase + n < cout and c0 + k < cin:
                                wt[nbase + n, c0 + k, tap // 3, tap % 3] = v
                            else:
                                assert v == 0, (nbase, step, tap, k, n)
                step += 1
        assert step == steps
        slab += steps * 9 * BK_F32 * bn
    assert slab == packed.size
    return out


def _case(seed, b, h, w, cins, cout, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    parts = [torch.randn((b, h, w, c), generator=g).to(dtype) for c in cins]
    weights = [torch.randn((cout, c, 3, 3), generator=g) * 0.2 for c in cins]
    scale = 0.5 + torch.rand(cout, generator=g)
    bias = torch.randn(cout, generator=g) * 0.1
    add = torch.randn((b, 3, w, cout), generator=g)
    return parts, weights, scale, bias, add


SHAPES = [(2, 9, 11, (5, 8), 7), (1, 8, 8, (16,), 70)]


# A part of 23 channels (the U-Net's input) pads its last K step.
@pytest.mark.parametrize("b,h,w,cins,cout", SHAPES + [(1, 6, 5, (23, 9), 40)])
def test_prepared_layout_read_like_the_kernel_f32(b, h, w, cins, cout):
    parts, weights, scale, bias, add = _case(0, b, h, w, cins, cout)
    prepared = pvgg.prepare_conv3x3(weights, scale, bias, torch.float32)
    assert prepared.cins == cins and prepared.cout == cout
    assert prepared.layout == pvgg.FFMA and prepared.packed.dtype == torch.float32
    assert pvgg.output_tiles(cout) == [(n, 64 if cout - n > 32 else 32)
                                       for n in range(0, cout, 64)]
    read = _read_like_the_f32_kernel(prepared.packed.numpy(), cins, cout)
    want = pvgg.conv3x3_fused_plain(parts, weights, scale=scale, bias=bias, add=add, relu=True)
    # The weights read back, with the scale already in them: only add and bias remain.
    got = pvgg.conv3x3_fused_plain(parts, [torch.from_numpy(r) for r in read],
                                   bias=prepared.bias, add=add * prepared.scale, relu=True)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("b,h,w,cins,cout", SHAPES)
def test_prepared_layout_read_like_the_kernel_bf16(b, h, w, cins, cout):
    """In bf16 the layout holds exactly the weights that folding in bf16 gives."""
    _, weights, scale, bias, _ = _case(1, b, h, w, cins, cout)
    prepared = pvgg.prepare_conv3x3(weights, scale, bias)
    assert prepared.packed.dtype == torch.bfloat16
    assert prepared.packed.numel() == sum(
        pvgg.k_steps(cins) * 9 * width * pvgg.TILE_K
        for _, width in pvgg.output_tiles(cout))
    read = _read_like_the_kernel(prepared.packed.view(torch.int16).numpy(), cins, cout)
    for r, wt, unpacked in zip(read, weights, prepared.unpack()):
        folded = (wt * scale[:, None, None, None]).to(torch.bfloat16)
        assert np.array_equal(r, folded.view(torch.int16).numpy())
        assert torch.equal(unpacked, folded)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_call_equals_raw_call(with_scale, with_bias, with_add, dtype):
    parts, weights, scale, bias, add = _case(2, 2, 9, 11, (5, 8), 7, dtype)
    scale = scale if with_scale else None
    bias = bias if with_bias else None
    add = add if with_add else None
    raw = pvgg.conv3x3_fused(parts, weights, scale=scale, bias=bias, add=add, relu=True)
    prepared = pvgg.prepare_conv3x3(weights, scale, bias, dtype)
    got = pvgg.conv3x3_fused(parts, prepared, add=add, relu=True)
    assert got.dtype == dtype and torch.equal(got, raw)
    with pytest.raises(ValueError, match="carry their scale and bias"):
        pvgg.conv3x3_fused(parts, prepared, bias=torch.zeros(7))


def test_prepared_weights_reach_the_kernel_unchanged(monkeypatch):
    """The CUDA branch with prepared weights, against a recording stand-in
    for the C entry point: nothing is prepared again, and the pointers that go
    over are the prepared object's."""
    from maunet_tpu_torch.ops.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(_build, "function",
                        lambda name, argtypes: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    parts, weights, scale, bias, add = _case(3, 2, 5, 7, (8, 3), 12, torch.bfloat16)
    prepared = pvgg.prepare_conv3x3(weights, scale, bias)
    made, launched = pvgg.prepare_conv3x3.calls, pvgg.conv3x3_fused.launches
    out = pvgg.conv3x3_fused(parts, prepared, add=add, relu=True)
    assert out.shape == (2, 5, 7, 12) and out.dtype == torch.bfloat16
    assert pvgg.prepare_conv3x3.calls == made
    assert pvgg.conv3x3_fused.launches == launched + 1
    args = calls[-1]
    assert args[1] == prepared.packed.data_ptr() and args[5] == prepared.bias.data_ptr()
    assert args[12] == prepared.scale.data_ptr() and args[3] == 2
    pvgg.conv3x3_fused(parts, weights, scale=scale, bias=bias)
    assert pvgg.prepare_conv3x3.calls == made + 1
    with pytest.raises(ValueError, match="does not match"):
        pvgg.conv3x3_fused(parts[::-1], prepared)
    with pytest.raises(ValueError, match="not bf16"):
        pvgg.conv3x3_fused(parts, pvgg.prepare_conv3x3(weights, scale, bias, torch.float32))


def _block(seed=0, mid=6, out=5, dtype=torch.float32):
    """An eval-mode block with non-trivial BatchNorm statistics, and its
    input: two spatial parts and a broadcast embedding."""
    torch.manual_seed(seed)
    block = blocks.VGGBlock(4 + 3 + 2, mid, out, compute_dtype=dtype).eval()
    with torch.no_grad():
        for bn in (block.bn1, block.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0, 0.1)
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    g = torch.Generator().manual_seed(seed + 1)
    parts = [torch.randn((2, 6, 7, 4), generator=g), torch.randn((2, 6, 7, 3), generator=g),
             torch.randn((2, 1, 1, 2), generator=g)]
    return block, parts


def _fresh(block, parts):
    """The output of a newly built block with the same state."""
    other = blocks.VGGBlock(block.conv1.in_channels, block.conv1.out_channels,
                            block.conv2.out_channels, compute_dtype=block.compute_dtype).eval()
    other.load_state_dict(copy.deepcopy(block.state_dict()))
    with torch.no_grad():
        return other(parts)


def _load_other_state(block):
    other, _ = _block(seed=7)
    block.load_state_dict(other.state_dict())


def _edit_through_data(block):
    block.conv1.weight.data.mul_(2)


def _optimizer_step(block):
    block.train()
    opt = torch.optim.SGD(block.parameters(), lr=0.1)
    _, parts = _block(seed=3)
    block(parts).square().mean().backward()
    opt.step()
    block.eval()


def _edit_running_var(block):
    block.bn1.running_var.mul_(1.7)


def _edit_bias_under_no_grad(block):
    with torch.no_grad():
        block.conv2.bias.add_(0.3)


@pytest.mark.parametrize("change", [_load_other_state, _edit_through_data, _optimizer_step,
                                    _edit_running_var, _edit_bias_under_no_grad],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("path", ["fused", "wide", "pair"])
def test_block_constants_follow_their_sources(change, path, monkeypatch):
    """After each way of changing what the constants came from, the block
    answers as a newly built one does.  ``wide`` sends the convs down the
    path of the convs too wide for the fused kernel, ``pair`` through the
    pair kernel, which takes both convs' kept prepared weights."""
    if path == "wide":
        monkeypatch.setattr(blocks, "FUSED_KERNEL_MAX_COUT", 0)
    block, parts = _block()
    block.fuse_pair = path == "pair"
    assert block.takes_pair_kernel() == (path == "pair")
    with torch.no_grad():
        before = block(parts)
    assert torch.equal(before, _fresh(block, parts))
    change(block)
    with torch.no_grad():
        after = block(parts)
    assert not torch.equal(after, before)
    assert torch.equal(after, _fresh(block, parts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_second_forward_builds_nothing(dtype):
    _second_forward_builds_nothing(*_block(dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_block_second_forward_builds_nothing(dtype):
    """The pair path keeps the same two prepared convs as the two launches."""
    block, parts = _block(dtype=dtype)
    block.fuse_pair = True
    _second_forward_builds_nothing(block, parts, dtype)
    built = blocks.VGGBlock.constants_built
    with torch.no_grad():
        pair = block(parts)
        block.fuse_pair = False
        assert torch.equal(block(parts), pair)
    assert blocks.VGGBlock.constants_built == built


def _second_forward_builds_nothing(block, parts, dtype):
    built, prepared = blocks.VGGBlock.constants_built, pvgg.prepare_conv3x3.calls
    with torch.no_grad():
        first = block(parts)
    assert blocks.VGGBlock.constants_built == built + 2
    assert pvgg.prepare_conv3x3.calls == prepared + 2
    affine = []
    real = blocks.bn_affine
    blocks.bn_affine = lambda *a: affine.append(a) or real(*a)
    try:
        with torch.inference_mode():
            second = block(parts)
        with torch.no_grad():
            third = block(parts)
    finally:
        blocks.bn_affine = real
    assert torch.equal(first, second) and torch.equal(first, third)
    assert blocks.VGGBlock.constants_built == built + 2 and not affine
    assert pvgg.prepare_conv3x3.calls == prepared + 2
    # Another split of the same channels is another layout.
    with torch.no_grad():
        merged = block([torch.cat(parts[:2], -1), parts[2]])
    assert blocks.VGGBlock.constants_built == built + 3
    torch.testing.assert_close(merged.float(), first.float(),
                               atol=1e-5 if dtype == torch.float32 else 5e-2, rtol=0)
    block.forget_constants()
    with torch.no_grad():
        assert torch.equal(block(parts), first)
    assert blocks.VGGBlock.constants_built == built + 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_prepared_call_equals_raw_call(dtype):
    parts, weights1, scale1, bias1, add = _case(4, 2, 9, 11, (5, 8), 7, dtype)
    _, (weight2,), scale2, bias2, _ = _case(5, 2, 9, 11, (7,), 6)
    raw = pvgg.conv3x3_pair_fused(parts, weights1, weight2, scale1=scale1, bias1=bias1,
                                  scale2=scale2, bias2=bias2, add=add)
    prepared = (pvgg.prepare_conv3x3(weights1, scale1, bias1, dtype),
                pvgg.prepare_conv3x3([weight2], scale2, bias2, dtype))
    got = pvgg.conv3x3_pair_fused(parts, *prepared, add=add)
    assert got.dtype == dtype and got.shape == (2, 9, 11, 6) and torch.equal(got, raw)
    mixed = pvgg.conv3x3_pair_fused(parts, prepared[0], weight2, scale2=scale2, bias2=bias2,
                                    add=add)
    assert torch.equal(mixed, raw)
    with pytest.raises(ValueError, match="carry their scale and bias"):
        pvgg.conv3x3_pair_fused(parts, prepared[0], prepared[1], bias2=bias2)


def test_pair_prepared_weights_reach_the_kernel_unchanged(monkeypatch):
    """The pair kernel's CUDA branch with prepared weights, against a
    recording stand-in for the C entry point: nothing is prepared again, and
    the pointers that go over are the prepared objects'; raw weights are
    prepared at the call, both convs."""
    from maunet_tpu_torch.ops.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(_build, "function",
                        lambda name, argtypes: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    parts, weights1, scale1, bias1, add = _case(6, 2, 5, 7, (8, 3), 40, torch.bfloat16)
    _, (weight2,), scale2, bias2, _ = _case(7, 2, 5, 7, (40,), 24)
    p1 = pvgg.prepare_conv3x3(weights1, scale1, bias1)
    p2 = pvgg.prepare_conv3x3([weight2], scale2, bias2)
    made, launched = pvgg.prepare_conv3x3.calls, pvgg.conv3x3_pair_fused.launches
    out = pvgg.conv3x3_pair_fused(parts, p1, p2, add=add)
    assert out.shape == (2, 5, 7, 24) and out.dtype == torch.bfloat16
    assert pvgg.prepare_conv3x3.calls == made
    assert pvgg.conv3x3_pair_fused.launches == launched + 1
    name, args = calls[-1]
    assert name == "maunet_conv3x3_pair" and args[3] == 2 and args[9:14] == (2, 5, 7, 40, 24)
    assert args[1] == p1.packed.data_ptr() and args[4] == p2.packed.data_ptr()
    assert args[6] == p1.bias.data_ptr() and args[7] == p2.bias.data_ptr()
    assert args[14] == p1.scale.data_ptr()
    pvgg.conv3x3_pair_fused(parts, weights1, weight2, scale1=scale1, bias1=bias1,
                            scale2=scale2, bias2=bias2, add=add)
    assert pvgg.prepare_conv3x3.calls == made + 2
    with pytest.raises(ValueError, match="does not follow"):
        pvgg.conv3x3_pair_fused(parts, p1, pvgg.prepare_conv3x3([weight2[:, :39]]))
    with pytest.raises(ValueError, match="not bf16"):
        pvgg.conv3x3_pair_fused(parts, p1, pvgg.prepare_conv3x3([weight2], dtype=torch.float32))


def test_block_with_gradients_reaches_the_parameters():
    """With gradients on, eval mode derives everything from the parameters,
    keeps nothing, and equals the kept path's output."""
    block, parts = _block()
    built = blocks.VGGBlock.constants_built
    out = block(parts)
    assert blocks.VGGBlock.constants_built == built and not block._kept
    out.sum().backward()
    assert all(p.grad is not None for p in block.parameters())
    with torch.no_grad():
        assert torch.equal(block(parts), out)


def test_block_constants_survive_copy_and_bn_fused():
    block, parts = _block()
    with torch.no_grad():
        want = block(parts)
        clone = copy.deepcopy(block)
        assert torch.equal(clone(parts), want)
    fused = blocks.VGGBlock(9, 6, 5, compute_dtype=torch.float32, bn_fused=True).eval()
    with torch.no_grad():
        first = fused(parts)
        fused.conv1.weight.mul_(0.5)
        second = fused(parts)
    assert not torch.equal(first, second)
    reference = blocks.VGGBlock(9, 6, 5, compute_dtype=torch.float32, bn_fused=True).eval()
    reference.load_state_dict(fused.state_dict())
    with torch.no_grad():
        assert torch.equal(reference(parts), second)


def test_border_masks_made_in_inference_mode_serve_a_training_step():
    """``const_conv`` keeps its border masks per device.  One first made
    under ``inference_mode`` must still take part in a backward pass."""
    emb = torch.randn(2, 1, 1, 3)
    kernel = torch.randn(4, 3, 3, 3, requires_grad=True)
    with torch.inference_mode():
        want = blocks.const_conv(emb, kernel, 37, 41, compact_h=True)
    got = blocks.const_conv(emb, kernel, 37, 41, compact_h=True)
    assert torch.equal(got, want)
    got.sum().backward()
    assert kernel.grad is not None and bool(kernel.grad.abs().sum() > 0)
