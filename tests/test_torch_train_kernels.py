"""The PyTorch port's training kernels and their autograd wrappers against
the JAX package.

The LSTM's stash forward (E), backward (F) and dW reduction run here through
their plain versions (the CPU path of every wrapper) and are compared with
the Pallas kernels they replace, run in interpret mode, and with ``jax.vjp``
of the scan.  The resize's backward, the max pool's tie gradient and the
parameter order are held against the JAX package too.  f32 throughout:
atol 1e-5 unless stated.  The CUDA kernels themselves run only on the card,
where ``chip_smoke.py`` compares them with these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maunet_tpu.interop.torch_export import reference_param_order
from maunet_tpu.models.blocks import max_pool_2x2 as jax_max_pool
from maunet_tpu.ops.pallas.lstm import (_pallas_backward, _pallas_forward_stash,
                                        lstm_last_hidden_scan)
from maunet_tpu.ops.resize import resize_align_corners as jax_resize
from maunet_tpu.ops.resize import upsample_like as jax_upsample_like

from maunet_tpu_torch.models import UrbanPredictor
from maunet_tpu_torch.models.blocks import max_pool_2x2
from maunet_tpu_torch.ops import resize as port_resize
from maunet_tpu_torch.ops.kernels import _build, lstm, packed_vgg, resize_pack


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _lstm_case(rng, b, t, hd):
    x = rng.normal(size=(b, t, 4 * hd)).astype(np.float32)
    w = (rng.normal(size=(hd, 4 * hd)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, hd)).astype(np.float32)
    return x, w, g


# (B, T, H, lengths): a frozen row (length 0), full rows, a one-step row.
LSTM_CASES = [(3, 40, 8, [40, 0, 17]), (4, 64, 16, [64, 1, 33, 64])]


@pytest.mark.parametrize("b,t,hd,lengths", LSTM_CASES)
def test_stash_forward_and_backward_plain_match_pallas(rng, b, t, hd, lengths):
    """E's and F's plain versions, and the dW reduction's, against
    ``_pallas_forward_stash`` / ``_pallas_backward`` in interpret mode,
    including the frozen state E writes for t >= length."""
    x, w, g = _lstm_case(rng, b, t, hd)
    lens = np.asarray(lengths, np.int32)
    jh, jh_all, jc_all = _pallas_forward_stash(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(lens), interpret=True)
    ph, ph_all, pc_all = lstm.lstm_forward_stash_plain(_t(x), _t(w), torch.from_numpy(lens))
    for got, want in ((ph, jh), (ph_all, jh_all), (pc_all, jc_all)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    jdx, jdw = _pallas_backward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lens),
                                jh_all, jc_all, jnp.asarray(g), interpret=True)
    pdx, pdw = lstm.lstm_backward_plain(_t(x), _t(w), torch.from_numpy(lens),
                                        ph_all, pc_all, _t(g))
    np.testing.assert_allclose(pdx.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(pdw.numpy(), np.asarray(jdw), atol=1e-5)
    assert not pdx[1, lengths[1]:].any()        # zero adjoints past the length
    # The wrappers on CPU tensors: F alone, and dW from F's dx_proj.
    dx = lstm.lstm_backward(_t(x), _t(w), torch.from_numpy(lens), ph_all, pc_all, _t(g))
    np.testing.assert_array_equal(dx.numpy(), pdx.numpy())
    dw = lstm.lstm_dw(ph_all, dx, torch.from_numpy(lens))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-5)


@pytest.mark.parametrize("b,t,hd,lengths", LSTM_CASES)
def test_lstm_autograd_function_matches_jax_vjp(rng, b, t, hd, lengths):
    """With an input that needs a gradient, ``lstm_last_hidden`` is the
    autograd Function over E, F and dW; its gradients equal ``jax.vjp`` of
    ``lstm_last_hidden_scan`` and torch autograd through the plain scan."""
    x, w, g = _lstm_case(rng, b, t, hd)
    lens = np.asarray(lengths, np.int32)
    h_ref, vjp = jax.vjp(lambda a, m: lstm_last_hidden_scan(a, m, jnp.asarray(lens)),
                         jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))

    xt, wt = _t(x, grad=True), _t(w, grad=True)
    h = lstm.lstm_last_hidden(xt, wt, torch.from_numpy(lens))
    assert h.grad_fn is not None and type(h.grad_fn).__name__ == "_StashedLSTMBackward"
    h.backward(_t(g))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), atol=1e-5)

    xs, ws = _t(x, grad=True), _t(w, grad=True)
    lstm.lstm_last_hidden_scan(xs, ws, torch.from_numpy(lens)).backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), xs.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), ws.grad.numpy(), atol=1e-5)


def test_temporal_encoder_gradient_reaches_weight_hh(rng):
    """The encoder hands W_hh^T to the Function; the gradient flows back
    through the transpose to ``weight_hh_l0`` and through x_proj to
    ``weight_ih_l0`` and both biases."""
    from maunet_tpu_torch.models.encoders import TemporalEncoder

    enc = TemporalEncoder(8, 4, compute_dtype=torch.float32)
    series = _t(rng.normal(size=(3, 20)))
    lens = torch.tensor([20, 5, 0], dtype=torch.int32)
    enc(series, lens).square().sum().backward()
    grads = {n: p.grad.clone() for n, p in enc.lstm.named_parameters()}
    enc.zero_grad()
    p = enc.lstm
    x_proj = series[..., None] * p.weight_ih_l0[:, 0] + (p.bias_ih_l0 + p.bias_hh_l0)
    h = lstm.lstm_last_hidden_scan(x_proj, p.weight_hh_l0.t(), lens)
    enc.fc(h).square().sum().backward()
    for n, q in enc.lstm.named_parameters():
        assert grads[n].abs().sum() > 0, n
        np.testing.assert_allclose(grads[n].numpy(), q.grad.numpy(), atol=1e-5, err_msg=n)


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 4, 4, 3), (8, 8)),          # the decoder's scale-2 upsample
    ((1, 15, 15, 2), (30, 31)),      # the odd fix-up shape
    ((2, 5, 7, 3), (3, 9)),          # a downsample on one axis
])
def test_resize_backward_matches_jax_vjp_and_interpolate(rng, shape, out_hw):
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(shape[0], *out_hw, shape[3])).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_resize(a, out_hw), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))

    xt = _t(x, grad=True)
    y = resize_pack.resize_pack(xt, out_hw)
    assert type(y.grad_fn).__name__ == "_ResizePackBackward"
    y.backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), atol=1e-5)

    xi = _t(x.transpose(0, 3, 1, 2), grad=True)
    F.interpolate(xi, size=out_hw, mode="bilinear", align_corners=True).backward(
        _t(g.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(xt.grad.numpy(), xi.grad.numpy().transpose(0, 2, 3, 1),
                               atol=1e-5)


def test_upsample_like_gradient_matches_jax(rng):
    """The decoder's double interpolation (15 -> 30 -> 31) under autograd."""
    x = rng.normal(size=(2, 15, 15, 4)).astype(np.float32)
    g = rng.normal(size=(2, 31, 31, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_upsample_like(a, (31, 31)), jnp.asarray(x))
    xt = _t(x, grad=True)
    port_resize.upsample_like(xt, (31, 31)).backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5)


def test_max_pool_tie_gradient_matches_jax(rng):
    """Exact ties in every window, odd sizes: the gradient goes to one
    winner, rows first then columns, the first of tied values, as JAX's
    where-chain routes it (``amax`` would split it over the ties)."""
    x = rng.integers(0, 3, size=(2, 7, 9, 3)).astype(np.float32)
    x[0, :2, :2, 0] = 1.0                      # a window of four ties
    g = rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
    y_ref, vjp = jax.vjp(jax_max_pool, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = _t(x, grad=True)
    y = max_pool_2x2(xt)
    y.backward(_t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_ref))
    assert (xt.grad[0, :2, :2, 0] != 0).sum() == 1


@pytest.mark.parametrize("temporal,metadata", [(True, True), (False, True), (True, False)])
def test_parameter_order_is_the_reference_order(temporal, metadata):
    """Torch keys optimizer state by parameter index: the port registers its
    parameters in the reference's order, encoders first."""
    model = UrbanPredictor(base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8,
                           temporal_embeddings=temporal, metadata_embeddings=metadata)
    names = [n for n, _ in model.named_parameters()]
    want = [n for n in reference_param_order("unet")
            if (temporal or "temporal_encoder" not in n)
            and (metadata or "meta_encoder" not in n)]
    assert names == want


def test_kernel_branches_marshal_training_arguments(monkeypatch):
    """The CUDA branches of E, F and dW, run on CPU tensors against a
    recording stand-in for the C entry points; and the guard that keeps a
    tensor needing a gradient away from the conv kernel, which has no
    backward."""
    calls = []

    def fake_function(name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, args)
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    counters = (lstm.lstm_forward_stash, lstm.lstm_backward, lstm.lstm_dw,
                lstm.lstm_last_hidden)
    before = [f.launches for f in counters]
    b, t, hd = 3, 10, 8
    x, w = torch.zeros(b, t, 4 * hd), torch.zeros(hd, 4 * hd)
    lens = torch.full((b,), t, dtype=torch.int32)

    h, h_all, c_all = lstm.lstm_forward_stash(x, w, lens)
    assert h.shape == (b, hd) and h_all.shape == c_all.shape == (b, t, hd)
    assert calls[-1][0] == "maunet_lstm_forward_stash" and calls[-1][1][6:9] == (b, t, hd)
    dx = lstm.lstm_backward(x, w, lens, h_all, c_all, torch.zeros(b, hd))
    assert dx.shape == x.shape and calls[-1][0] == "maunet_lstm_backward"
    with pytest.raises(ValueError, match="g must be"):
        lstm.lstm_backward(x, w, lens, h_all, c_all, torch.zeros(b, hd + 1))
    dw = lstm.lstm_dw(h_all, dx, lens)
    name, args = calls[-1]
    # B*T = 30 rows: one 32-row slice.
    assert dw.shape == (hd, 4 * hd) and name == "maunet_lstm_dw" and args[5:10] == (b, t, hd, 1, 32)
    lstm.lstm_dw(torch.zeros(16, 828, 96), torch.zeros(16, 828, 384),
                 torch.zeros(16, dtype=torch.int32))
    assert calls[-1][1][8:10] == (8, 1664)    # 13,248 rows in 8 slices of 1,664
    with pytest.raises(ValueError, match="shared memory"):
        lstm.lstm_forward_stash(torch.zeros(1, 2, 4 * 120), torch.zeros(120, 480),
                                torch.ones(1, dtype=torch.int32))

    # Grad enabled and an input that needs a gradient: the Function (E);
    # under no_grad: the inference kernel (B).
    xg = x.clone().requires_grad_()
    lstm.lstm_last_hidden(xg, w, lens)
    with torch.no_grad():
        lstm.lstm_last_hidden(xg, w, lens)
    assert [f.launches for f in counters] == [before[0] + 2, before[1] + 1,
                                              before[2] + 2, before[3] + 1]

    bf = torch.bfloat16
    parts = [torch.zeros(1, 4, 4, 3, dtype=bf)]
    weight = torch.zeros(8, 3, 3, 3, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        packed_vgg.conv3x3_fused(parts, [weight], scale=torch.ones(8), bias=torch.zeros(8))
    with torch.no_grad():
        packed_vgg.conv3x3_fused(parts, [weight], scale=torch.ones(8), bias=torch.zeros(8))
    assert calls[-1][0] == "maunet_conv3x3_fused"
