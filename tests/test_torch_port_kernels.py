"""The PyTorch port's kernel modules against the JAX Pallas kernels.

Each module of ``maunet_tpu_torch/ops/kernels`` is run here through its plain
PyTorch version (the CPU path of every wrapper) and compared with the JAX
kernel it replaces, run in Pallas interpret mode on the same numpy inputs.
Tolerances are f32: atol 1e-5 unless stated.  The CUDA kernels themselves run
only on the card, where ``chip_smoke.py`` compares them with these plain
versions.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.ops.packed_conv import pack, pack_weights
from maunet_tpu.ops.pallas.lstm import _pallas_forward, lstm_last_hidden_scan
from maunet_tpu.ops.pallas.masked_stats import masked_class_sums as jax_masked_class_sums
from maunet_tpu.ops.pallas.packed_vgg import packed_conv3x3_fused, supported
from maunet_tpu.ops.pallas.resize_pack import resize_pack
from maunet_tpu.ops.resize import resize_align_corners as jax_resize
from maunet_tpu.ops.resize import upsample_like as jax_upsample_like

from maunet_tpu_torch.ops import resize as port_resize
from maunet_tpu_torch.ops.kernels import lstm as port_lstm
from maunet_tpu_torch.ops.kernels import masked_stats as port_ms
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


@functools.cache
def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _walk_taps(n_in, n_out, oy0, rows):
    """The resize kernel's row walk, step by step as ``csrc/resize_pack.cu``
    takes it: (lo, hi, frac) of each output row of the strip from oy0, with
    the integer accumulator and one correctly rounded f32 division a row."""
    den = n_out - 1 if n_out > 1 else 1
    step = n_in - 1 if n_out > 1 and n_in > 1 else 0
    lo, rem = divmod(oy0 * step, den)
    taps = []
    for _ in range(oy0, min(oy0 + rows, n_out)):
        taps.append((lo, min(lo + 1, n_in - 1), np.float32(rem) / np.float32(den)))
        rem += step
        while rem >= den:
            rem -= den
            lo += 1
    return taps


@pytest.mark.parametrize("n_in,n_out", [
    (16, 32), (32, 64), (64, 128), (128, 256), (15, 30), (30, 31), (12, 25), (1, 7),
    (9, 1), (1, 1), (31, 12), (250, 7)])
@pytest.mark.parametrize("rows", [1, 3, 8, 32])
def test_resize_walk_taps_match_interp_matrix(n_in, n_out, rows):
    """The kernel's row walk, cut into strips of ``rows``, gives the weights
    of ``ops/resize._interp_matrix`` bit for bit: n -> 2n, the odd fix-ups,
    1 -> n, n -> 1 and downsamples whose walk jumps several rows."""
    w = np.zeros((n_out, n_in), np.float32)
    oy = 0
    for oy0 in range(0, n_out, rows):
        for lo, hi, frac in _walk_taps(n_in, n_out, oy0, rows):
            w[oy, lo] = np.float32(1.0) - frac
            w[oy, hi] += frac
            oy += 1
    assert oy == n_out
    np.testing.assert_array_equal(w, port_resize._interp_matrix(n_in, n_out))


@pytest.mark.parametrize("case", range(17))
def test_strip_rows_cover_every_output_row_once(case):
    """At each of ``chip_smoke.py``'s C shapes the strips of ``_strip_rows``
    rows cover every output row exactly once, with one thread per strip,
    column and channel group."""
    shape, out_hw, dtype, _ = _chip_smoke().RESIZE_CASES[case]
    b, _, _, c = shape
    oh, ow = out_hw
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    groups = c // vec if c % vec == 0 else c
    rows = port_rp._strip_rows(b, oh, ow, groups)
    assert rows == port_rp._rows_for(torch.empty(shape, dtype=dtype, device="meta"), out_hw)
    assert rows in port_rp._STRIP_ROWS
    strips = -(-oh // rows)
    covered = np.zeros(oh, np.int64)
    for s in range(strips):
        covered[s * rows:min((s + 1) * rows, oh)] += 1
    assert (covered == 1).all()
    threads = b * strips * ow * groups
    assert threads < 2 ** 31
    # A taller strip leaves fewer than _MIN_THREADS threads; every path
    # shape takes the tallest.
    assert rows == 8 or b * -(-oh // (2 * rows)) * ow * groups < port_rp._MIN_THREADS
    assert rows == 8 or case >= 12    # the twelve decoder shapes come first


def _masked_walk(b_total, hw, c, vec):
    """The pixels that ``csrc/masked_stats.cu``'s kernel reads, as the
    cluster of each sample walks it: per flat pixel the number of threads
    that read it.  With ``vec``, groups of 4 pixels (2 at 3 and 4 channels)
    from the first flat index divisible by the group at a stride of the
    cluster's 4,096 threads, then the pixels before the first boundary and
    after the last one a thread; else one pixel a thread."""
    cluster, threads, group = 8, 512, 4 if c <= 2 else 2
    span = cluster * threads
    stride = span * group
    seen = np.zeros(b_total * hw, np.int64)
    lane_c = np.arange(span)
    for b in range(b_total):
        first, last = b * hw, (b + 1) * hw
        if not vec:
            for p in range(first, last, span):
                idx = p + lane_c
                np.add.at(seen, idx[idx < last], 1)
            continue
        a0 = min(-(-first // group) * group, last)
        a1 = max(a0, last // group * group)
        p = a0 + lane_c * group
        while (p < a1).any():
            for px in range(group):
                np.add.at(seen, (p + px)[p < a1], 1)
            p = p + stride
        head, edges = a0 - first, (a0 - first) + (last - a1)
        edge = lane_c[lane_c < edges]
        np.add.at(seen, np.where(edge < head, first + edge, a1 + (edge - head)), 1)
    return seen


@pytest.mark.parametrize("case", range(10))
@pytest.mark.parametrize("vec", [True, False])
def test_masked_walk_reads_every_pixel_once(case, vec):
    """At each shape of ``chip_smoke.py``'s D list (and B = 8 and 3 of the
    evaluation batch) the clusters' walk reads every pixel of every sample
    exactly once, with 16-byte group loads where the bases allow and one
    pixel a thread where they do not."""
    shape, *_ = _chip_smoke().MASKED_CASES[case]
    b, h, w, c = shape
    assert (_masked_walk(b, h * w, c, vec) == 1).all()


@pytest.mark.parametrize("shape", [(2, 32, 32, 2), (3, 25, 19, 2), (2, 16, 8, 3), (1, 5, 3, 1)])
def test_masked_sums_as_views_match_plain_and_jax(shape):
    """The kernel writes one (B, 9 (2C + 1)) row per sample; ``split_sums``
    gives the three sums as views of it.  Rows packed from the plain
    version's sums come back as the plain version's sums and JAX's Pallas
    kernel's, in interpret mode."""
    rng = np.random.default_rng(3)
    pred = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    dw_map = rng.integers(-1, 10, size=shape[:3]).astype(np.int32)
    plain = port_ms.masked_class_sums_plain(_t(pred), _t(target), torch.from_numpy(dw_map))
    b, _, _, c = shape
    out = torch.cat([plain[0].reshape(b, -1), plain[1].reshape(b, -1), plain[2]], 1)
    assert out.shape == (b, 9 * (2 * c + 1))
    views = port_ms.split_sums(out, c)
    want = jax_masked_class_sums(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(dw_map),
                                 interpret=True)
    for v, p, j in zip(views, plain, want):
        assert v._base is out and v.shape == p.shape
        assert torch.equal(v, p)
        np.testing.assert_allclose(v.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
