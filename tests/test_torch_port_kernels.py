"""The PyTorch port's kernel modules against the JAX Pallas kernels.

Each module of ``maunet_tpu_torch/ops/kernels`` is run here through its plain
PyTorch version (the CPU path of every wrapper) and compared with the JAX
kernel it replaces, run in Pallas interpret mode on the same numpy inputs.
Tolerances are f32: atol 1e-5 unless stated.  The CUDA kernels themselves run
only on the card, where ``chip_smoke.py`` compares them with these plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.ops.packed_conv import pack, pack_weights
from maunet_tpu.ops.pallas.lstm import _pallas_forward, lstm_last_hidden_scan
from maunet_tpu.ops.pallas.packed_vgg import packed_conv3x3_fused, supported
from maunet_tpu.ops.pallas.resize_pack import resize_pack
from maunet_tpu.ops.resize import resize_align_corners as jax_resize
from maunet_tpu.ops.resize import upsample_like as jax_upsample_like

from maunet_tpu_torch.ops import resize as port_resize
from maunet_tpu_torch.ops.kernels import lstm as port_lstm
from maunet_tpu_torch.ops.kernels import packed_vgg as port_vgg
from maunet_tpu_torch.ops.kernels import resize_pack as port_rp


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _conv_case(rng, b, h, w, cins, cout):
    xs = [rng.normal(size=(b, h, w, c)).astype(np.float32) for c in cins]
    ks = [(rng.normal(size=(3, 3, c, cout)) * 0.1).astype(np.float32) for c in cins]
    scale = rng.normal(size=(cout,)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    add = rng.normal(size=(b, 3, w, cout)).astype(np.float32)
    return xs, ks, scale, bias, add


def _port_conv(xs, ks, scale, bias, add, relu=True):
    # HWIO -> the port's OIHW weight slices
    return port_vgg.conv3x3_fused(
        [_t(x) for x in xs], [_t(k.transpose(3, 2, 0, 1)) for k in ks],
        scale=_t(scale), bias=_t(bias),
        add=None if add is None else _t(add), relu=relu).numpy()


@pytest.mark.parametrize("cins,cout,with_add", [
    ((24,), 16, False),          # the input conv's 24-channel form
    ((16, 32), 16, True),        # decoder [skip || upsampled] + embedding term
])
def test_conv3x3_fused_matches_pallas(rng, cins, cout, with_add):
    """The port's conv (NHWC, plain version) vs packed_conv3x3_fused in
    interpret mode on lane-packed inputs (s=2), unpacked afterwards."""
    b, h, w, s = 2, 8, 16, 2
    xs, ks, scale, bias, add = _conv_case(rng, b, h, w, cins, cout)
    add = add if with_add else None
    parts = tuple(pack(jnp.asarray(x), s).x for x in xs)
    wps = tuple(pack_weights(jnp.asarray(k), s).reshape(3, (s + 2) * c, s * cout)
                for k, c in zip(ks, cins))
    assert supported([p.shape for p in parts], cins, s, cout)
    add_packed = None
    if add is not None:
        add_packed = jnp.asarray(add).reshape(b, 3, w // s, s * cout)
    ref = packed_conv3x3_fused(
        parts, wps, cins, s, cout,
        (jnp.tile(jnp.asarray(scale), s), jnp.tile(jnp.asarray(bias), s)),
        add=add_packed, relu=True, interpret=True)
    ref = np.asarray(ref).reshape(b, h, w, cout)
    got = _port_conv(xs, ks, scale, bias, add)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_conv3x3_fused_odd_size_matches_lax_conv(rng):
    """Odd H, W and channel counts, which the Pallas kernel does not take:
    the port against a lax conv of the concat + full add + affine + ReLU."""
    import jax

    b, h, w, cins, cout = 2, 7, 9, (23, 5), 12
    xs, ks, scale, bias, add = _conv_case(rng, b, h, w, cins, cout)
    conv = jax.lax.conv_general_dilated(
        jnp.concatenate([jnp.asarray(x) for x in xs], -1),
        jnp.concatenate([jnp.asarray(k) for k in ks], 2), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    full_add = np.concatenate(
        [add[:, :1], np.repeat(add[:, 1:2], h - 2, axis=1), add[:, 2:]], axis=1)
    ref = np.maximum((np.asarray(conv) + full_add) * scale + bias, 0.0)
    got = _port_conv(xs, ks, scale, bias, add)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h", [1, 2])
def test_expand_add_short_maps(h):
    """Row 0 is y=0 and row 2 is y=H-1; a one-row map takes row 0."""
    add = torch.arange(3.0).reshape(1, 3, 1, 1)
    assert port_vgg.expand_add(add, h).flatten().tolist() == [0.0, 2.0][:h]


@pytest.mark.parametrize("lengths", [
    [40, 25, 0],                 # full, partial and empty sequences
    [40, 40, 13],
])
def test_lstm_matches_pallas(rng, lengths):
    # One shape for both cases: the interpret-mode kernel compiles once.
    b, t, hd = 3, 40, 8
    x_proj = rng.normal(size=(b, t, 4 * hd)).astype(np.float32)
    w_hh = (rng.normal(size=(hd, 4 * hd)) * 0.3).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ref = np.asarray(_pallas_forward(jnp.asarray(x_proj), jnp.asarray(w_hh),
                                     jnp.asarray(lens), interpret=True))
    scan = np.asarray(lstm_last_hidden_scan(jnp.asarray(x_proj), jnp.asarray(w_hh),
                                            jnp.asarray(lens)))
    got = port_lstm.lstm_last_hidden(_t(x_proj), _t(w_hh),
                                     torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, scan, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 16), (16, 32)), ((16, 8), (32, 16))])
def test_resize_matches_pallas(rng, in_hw, out_hw):
    x = rng.normal(size=(2, *in_hw, 8)).astype(np.float32)
    ref = np.asarray(resize_pack(jnp.asarray(x), out_hw, 1, interpret=True))
    got = port_rp.resize_pack(_t(x), out_hw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((15, 15), (31, 31)), ((30, 30), (31, 31)), ((1, 5), (3, 1)), ((25, 12), (50, 24)),
])
def test_resize_odd_matches_jax_einsum(rng, in_hw, out_hw):
    x = rng.normal(size=(2, *in_hw, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), out_hw))
    got = port_resize.resize_align_corners(_t(x), out_hw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("in_hw,target", [((15, 15), (31, 31)), ((12, 12), (25, 25)),
                                          ((8, 8), (16, 16))])
def test_upsample_like_double_interpolation(rng, in_hw, target):
    """The U-Net decoder's 2x upsample + fix-up (15 -> 30 -> 31), as JAX."""
    x = rng.normal(size=(1, *in_hw, 4)).astype(np.float32)
    ref = np.asarray(jax_upsample_like(jnp.asarray(x), target, pre_scale=2))
    got = port_resize.upsample_like(_t(x), target).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_resize_matches_torch_interpolate(rng):
    """The semantics the JAX code emulates: F.interpolate(align_corners=True)."""
    x = _t(rng.normal(size=(2, 7, 10, 3)))
    want = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(13, 4), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1)
    got = port_resize.resize_align_corners(x, (13, 4))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
