"""Kernels A and G in f32: the f32 weight layout, the dispatch by dtype, and
the f32 path against the JAX package.

JAX's ``packed_conv3x3_fused`` and ``packed_pair_fused`` compute in the
parts' dtype, f32 included; the port's wrappers launch the bf16 entries
(``csrc/conv3x3_fused.cu``, ``conv3x3_pair.cu``) for bf16 parts and the f32
entries (``csrc/conv3x3_f32.cu``) for f32 parts, with weights prepared in
the f32 kernels' own layout.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them against their plain versions there); here the
CUDA branch runs against a recording stand-in for the C entry points, and
the f32 layout is read back through the plain version, against the Pallas
kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.ops.packed_conv import Packed, pack, pack_weights
from maunet_tpu.ops.pallas.packed_vgg import packed_conv3x3_fused, packed_pair_fused

from maunet_tpu_torch.models import blocks
from maunet_tpu_torch.ops import train_conv
from maunet_tpu_torch.ops.kernels import _build
from maunet_tpu_torch.ops.kernels import packed_vgg as pvgg


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _conv(seed, b, h, w, cins, cout, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    parts = [torch.randn((b, h, w, c), generator=g).to(dtype) for c in cins]
    weights = [torch.randn((cout, c, 3, 3), generator=g) * 0.2 for c in cins]
    scale = 0.5 + torch.rand(cout, generator=g)
    bias = torch.randn(cout, generator=g) * 0.1
    add = torch.randn((b, 3, w, cout), generator=g)
    return parts, weights, scale, bias, add


@pytest.mark.parametrize("cins,cout", [((5, 8), 7), ((23,), 64), ((16, 17, 40), 80),
                                       ((64, 128), 33), ((23, 9), 40)])
def test_f32_layout_round_trip(cins, cout):
    """prepare, then unpack: the folded f32 weights, exactly, in the f32
    kernels' layout (K steps of TILE_K_F32 channels); the plain version on them equals
    its raw-weight call bit for bit."""
    parts, weights, scale, bias, add = _conv(0, 2, 6, 5, cins, cout)
    prepared = pvgg.prepare_conv3x3(weights, scale, bias, torch.float32)
    assert prepared.layout == pvgg.FFMA and prepared.packed.dtype == torch.float32
    assert prepared.packed.numel() == sum(
        sum(-(-c // pvgg.TILE_K_F32) for c in cins) * 9 * width * pvgg.TILE_K_F32
        for _, width in pvgg.output_tiles(cout))
    for got, wt in zip(prepared.unpack(), weights):
        assert torch.equal(got, wt * scale[:, None, None, None])
    raw = pvgg.conv3x3_fused(parts, weights, scale=scale, bias=bias, add=add, relu=True)
    assert torch.equal(pvgg.conv3x3_fused(parts, prepared, add=add, relu=True), raw)
    # bf16 keeps wgmma's layout, and so does any dtype but f32.
    assert pvgg.prepare_conv3x3(weights, dtype=torch.bfloat16).layout == pvgg.WGMMA
    assert pvgg.prepare_conv3x3(weights, dtype=torch.float64).layout == pvgg.WGMMA


def test_f32_prepared_conv_matches_pallas(rng):
    """A on f32-prepared weights (read back from the f32 layout) against
    packed_conv3x3_fused in f32, interpret mode, lane-packed (s = 2)."""
    b, h, w, s, cins, cout = 2, 8, 16, 2, (16, 32), 16
    xs = [rng.normal(size=(b, h, w, c)).astype(np.float32) for c in cins]
    ks = [(rng.normal(size=(3, 3, c, cout)) * 0.1).astype(np.float32) for c in cins]
    scale, bias = (rng.normal(size=(cout,)).astype(np.float32) for _ in range(2))
    add = rng.normal(size=(b, 3, w, cout)).astype(np.float32)
    ref = packed_conv3x3_fused(
        tuple(pack(jnp.asarray(x), s).x for x in xs),
        tuple(pack_weights(jnp.asarray(k), s).reshape(3, (s + 2) * c, s * cout)
              for k, c in zip(ks, cins)), cins, s, cout,
        (jnp.tile(jnp.asarray(scale), s), jnp.tile(jnp.asarray(bias), s)),
        add=jnp.asarray(add).reshape(b, 3, w // s, s * cout), relu=True, interpret=True)
    prepared = pvgg.prepare_conv3x3([_t(k.transpose(3, 2, 0, 1)) for k in ks], _t(scale),
                                    _t(bias), torch.float32)
    got = pvgg.conv3x3_fused([_t(x) for x in xs], prepared, add=_t(add), relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, h, w, cout),
                               atol=1e-5, rtol=1e-5)


def test_f32_prepared_pair_matches_pallas(rng):
    """G on two f32-prepared convs against packed_pair_fused in f32,
    interpret mode: the U-Net++ decoder node's class, two 32-channel parts
    and the embedding term (f32 sums in other orders: atol 3e-5, as the
    raw-weight test in test_torch_port_unetpp.py)."""
    b, h, w, s, cmid, cins = 2, 16, 32, 4, 32, (32, 32)
    xs = [rng.normal(size=(b, h, w, c)).astype(np.float32) for c in cins]
    std1, std2 = np.sqrt(2 / (9 * sum(cins))), np.sqrt(2 / (9 * cmid))
    k1s = [(rng.normal(size=(3, 3, c, cmid)) * std1).astype(np.float32) for c in cins]
    k2 = (rng.normal(size=(3, 3, cmid, cmid)) * std2).astype(np.float32)
    a1, a2 = ((rng.normal(size=(cmid,)) * 0.3 + 1.0).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.normal(size=(cmid,)).astype(np.float32) for _ in range(2))
    add = rng.normal(size=(b, 3, w, cmid)).astype(np.float32)
    ref = packed_pair_fused(
        tuple(pack(jnp.asarray(x), s).x for x in xs),
        tuple(pack_weights(jnp.asarray(k), s).reshape(3, (s + 2) * c, s * cmid)
              for k, c in zip(k1s, cins)), cins, s, cmid,
        pack_weights(jnp.asarray(k2), s).reshape(3, (s + 2) * cmid, s * cmid), cmid,
        (jnp.tile(a1, s), jnp.tile(b1, s)), (jnp.tile(a2, s), jnp.tile(b2, s)),
        add=jnp.asarray(add).reshape(b, 3, w // s, s * cmid), interpret=True)
    ref = np.asarray(Packed(ref, cmid).unpack())
    p1 = pvgg.prepare_conv3x3([_t(k).permute(3, 2, 0, 1) for k in k1s], _t(a1), _t(b1),
                              torch.float32)
    p2 = pvgg.prepare_conv3x3([_t(k2).permute(3, 2, 0, 1)], _t(a2), _t(b2), torch.float32)
    got = pvgg.conv3x3_pair_fused([_t(x) for x in xs], p1, p2, add=_t(add))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-5)


@pytest.fixture
def cuda_branch(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, each C entry point a
    recording stand-in that checks its argument count."""
    calls = []

    def function(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, args)
            calls.append(name)
            return 0
        return fn

    monkeypatch.setattr(_build, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


DTYPES = [torch.bfloat16, torch.float32, torch.float16, torch.float64]
ENTRIES = {"conv": {torch.bfloat16: "maunet_conv3x3_fused",
                    torch.float32: "maunet_conv3x3_fused_f32"},
           "pair": {torch.bfloat16: "maunet_conv3x3_pair",
                    torch.float32: "maunet_conv3x3_pair_f32"}}


def _call(kernel, parts, weights, scale, bias, add):
    if kernel == "conv":
        return pvgg.conv3x3_fused(parts, weights, scale=scale, bias=bias, add=add, relu=True)
    return pvgg.conv3x3_pair_fused(parts, weights, torch.ones(6, 7, 3, 3),
                                   scale1=scale, bias1=bias, add=add)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kernel", ["conv", "pair"])
def test_dispatch_by_device_and_dtype(request, kernel, dtype, device):
    """A CPU tensor of any dtype takes the plain version.  On the card bf16
    and f32 launch their own entries, each wrapper counting its own
    launches, with weights prepared in the parts' dtype; any other dtype
    raises, naming it."""
    parts, weights, scale, bias, add = _conv(1, 2, 5, 7, (8, 3), 7, dtype)
    if device == "cpu":
        plain = (pvgg.conv3x3_fused_plain(parts, weights, scale=scale, bias=bias, add=add,
                                          relu=True) if kernel == "conv" else
                 pvgg.conv3x3_pair_fused_plain(parts, weights, torch.ones(6, 7, 3, 3),
                                               scale1=scale, bias1=bias, add=add))
        assert torch.equal(_call(kernel, parts, weights, scale, bias, add), plain)
        return
    calls = request.getfixturevalue("cuda_branch")
    counters = {"conv": (pvgg.conv3x3_fused, pvgg.conv3x3_fused_f32),
                "pair": (pvgg.conv3x3_pair_fused, pvgg.conv3x3_pair_fused_f32)}[kernel]
    before = [fn.launches for fn in counters]
    prepared = pvgg.prepare_conv3x3.calls
    if dtype not in ENTRIES[kernel]:
        with pytest.raises(ValueError, match=f"bf16 or f32 parts, got {dtype}"):
            _call(kernel, parts, weights, scale, bias, add)
        assert not calls and pvgg.prepare_conv3x3.calls == prepared
        return
    out = _call(kernel, parts, weights, scale, bias, add)
    assert out.dtype == dtype and calls == [ENTRIES[kernel][dtype]]
    assert pvgg.prepare_conv3x3.calls == prepared + (1 if kernel == "conv" else 2)
    f32 = dtype == torch.float32
    assert [fn.launches for fn in counters] == [before[0] + (not f32), before[1] + f32]
    # Weights prepared in the other dtype, or parts of two dtypes, raise.
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match=f"prepared in {other}"):
        pvgg.conv3x3_fused(parts, pvgg.prepare_conv3x3(weights, dtype=other))
    with pytest.raises(ValueError, match="parts must be"):
        pvgg.conv3x3_fused([parts[0], parts[1].to(other)], weights)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_takes_kernel_reads_jax_rule_alone(cuda_branch, dtype):
    """``takes_kernel`` is JAX's ``supported``, whatever the dtype and
    device; an f32 train conv then runs A's f32 entry under autograd."""
    shapes = [(2, 16, 32, 64)], [(2, 16, 32, 23)], [(2, 16, 32, 32)], [(2, 12, 30, 64)]
    for shape in shapes:
        for device in ("cpu", "meta"):
            parts = [torch.empty(s, dtype=dtype, device=device) for s in shape]
            assert train_conv.takes_kernel(parts, 64) == train_conv.supported(shape, 64)
    assert train_conv.takes_kernel([torch.empty(2, 16, 32, 64, dtype=dtype)], 64)
    if dtype != torch.float32:
        return
    parts = [torch.randn(2, 16, 32, 64, requires_grad=True)]
    weights = [torch.randn(64, 64, 3, 3, requires_grad=True)]
    n = pvgg.conv3x3_fused_f32.launches
    y = train_conv.train_conv3x3(parts, weights)
    assert y.dtype == torch.float32 and y.requires_grad and y.shape == (2, 16, 32, 64)
    assert cuda_branch == ["maunet_conv3x3_fused_f32"]
    assert pvgg.conv3x3_fused_f32.launches == n + 1


@pytest.mark.parametrize("fuse_pair", [False, True])
def test_f32_block_launches_f32_entries_and_prepares_once(cuda_branch, fuse_pair):
    """An f32 eval-mode VGGBlock on the CUDA branch: every conv launches an
    f32 entry (the pair's with ``fuse_pair``), from kept f32-layout weights
    that a second forward does not prepare again."""
    torch.manual_seed(0)
    block = blocks.VGGBlock(9, 6, 5, compute_dtype=torch.float32,
                            fuse_pair=fuse_pair).eval()
    g = torch.Generator().manual_seed(1)
    parts = [torch.randn((2, 6, 7, 4), generator=g), torch.randn((2, 6, 7, 3), generator=g),
             torch.randn((2, 1, 1, 2), generator=g)]
    with torch.no_grad():
        block(parts)
        built, prepared = blocks.VGGBlock.constants_built, pvgg.prepare_conv3x3.calls
        out = block(parts)
    assert out.dtype == torch.float32 and out.shape == (2, 6, 7, 5)
    entry = "maunet_conv3x3_pair_f32" if fuse_pair else "maunet_conv3x3_fused_f32"
    assert cuda_branch == [entry] * (2 if fuse_pair else 4)
    assert (blocks.VGGBlock.constants_built, pvgg.prepare_conv3x3.calls) == (built, prepared)
    kept = [made[2] for _, made in block._kept.values()]
    assert len(kept) == 2 and all(k.layout == pvgg.FFMA for k in kept)
