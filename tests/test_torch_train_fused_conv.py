"""The port's ``train_fused_conv`` and its fresh-model initialisation against
the JAX package, on the CPU at a small size (32² tiles, T = 16, f32).

``ops/train_conv.TrainConv3x3`` runs kernel A's plain version forward and
the library's conv backward on CPU tensors; JAX runs its lane-packed Pallas
forward in interpret mode, as ``tests/test_pallas.py`` does, with
``pvgg.INTERPRET`` set inside a ``try``/``finally``.  Both packages get the
same weights (``model.init`` of the JAX model, carried over with
``interop.from_jax``) and the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maunet_tpu.ops.pallas.packed_vgg as jax_pvgg
import maunet_tpu.ops.train_conv as jax_train_conv
from maunet_tpu.interop.torch_export import _params_to_torch_arrays
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.ops.packed_conv import pack_factor

from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.models import UrbanPredictor
from maunet_tpu_torch.ops import train_conv

KW = dict(base_filters=8, temporal_dim=8, meta_dim=8, lstm_dim=16)
T = 16
# The fused path's configurations, those of JAX's own test of it
# (tests/test_pallas.py:424-470): JAX's model lane-packs every conv of 32 or
# fewer outputs in training instead, so at base 4-8 no conv takes the kernel.
FUSED = {"unet": dict(KW, base_filters=64), "unet++": dict(KW, base_filters=32)}
# Convs that take kernel A per forward there: the U-Net's four 64-channel
# level-0 convs at 32², U-Net++'s eight 64-channel level-1 convs at 16².
EXPECTED_CONVS = {"unet": 4, "unet++": 8}


def _inputs():
    rng = np.random.default_rng(12)
    return (rng.normal(size=(2, 32, 32, 23)).astype(np.float32),
            rng.normal(size=(2, T)).astype(np.float32),
            rng.normal(size=(2, 8)).astype(np.float32),
            np.array([T, 9], np.int32))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_init():
    """Jitted ``model.init`` per model type (op by op it takes most of a
    minute)."""
    cache = {}

    def get(model_type, kw=KW):
        key = (model_type, tuple(sorted(kw.items())))
        if key not in cache:
            model = JaxUrbanPredictor(model_type, compute_dtype=jnp.float32, **kw)
            cache[key] = _numpy(jax.jit(model.init)(jax.random.PRNGKey(0), *_inputs()))
        return cache[key]

    return get


# --- initialisation -------------------------------------------------------

@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_fresh_model_draws_from_the_jax_initializers(jax_init, model_type):
    """Every conv and linear weight from flax's lecun_normal (std ratio to
    JAX's draw within 10% where a tensor has >= 512 elements, every element
    within the truncation at 2 * sqrt(1 / fan_in) / 0.8796), every conv and
    linear bias zero, the LSTM uniform in +-1/sqrt(H), BatchNorm at ones and
    zeros: as the JAX package's ``model.init``."""
    want = state_dict_from_jax(jax_init(model_type))
    model = UrbanPredictor(model_type, compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0), **KW)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    modules = dict(model.named_modules())
    ratios = []
    for name, p in got.items():
        w = p.detach().numpy()
        ref = want[name].numpy()
        owner, leaf = modules[name.rsplit(".", 1)[0]], name.rsplit(".", 1)[1]
        if isinstance(owner, (torch.nn.Conv2d, torch.nn.Linear)):
            if leaf == "bias":
                assert not w.any() and not ref.any(), name
                continue
            bound = 2 * np.sqrt(1.0 / w[0].size) / 0.87962566
            assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound * (1 + 1e-6), name
        elif isinstance(owner, torch.nn.BatchNorm2d):
            np.testing.assert_array_equal(w, ref, err_msg=name)
            continue
        else:   # the LSTM
            bound = 1 / np.sqrt(KW["lstm_dim"])
            assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound, name
        if w.size >= 512:
            ratios.append(w.std() / ref.std())
            assert 0.9 <= ratios[-1] <= 1.1, (name, ratios[-1])
    assert len(ratios) >= 10


def test_init_draws_from_the_given_generator():
    """The same generator seed gives the same weights, another seed others;
    the global generator is not read."""
    make = lambda seed: UrbanPredictor(generator=torch.Generator().manual_seed(seed),
                                       compute_dtype=torch.float32, **KW).state_dict()
    torch.manual_seed(1)
    a = make(0)
    torch.manual_seed(2)
    b, c = make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.conv0_0.conv1.weight"], c["model.conv0_0.conv1.weight"])


# --- which convs take the kernel ------------------------------------------

def _conv_parts(model_type, b, hw, base):
    """(spatial part shapes, features, grouped) of every 3x3 conv of a
    forward, as the model's blocks call them."""
    nb = [base * 2 ** i for i in range(5)]
    size = lambda lvl: (b, hw >> lvl, hw >> lvl)
    convs = []

    def block(lvl, cins, grouped):
        convs.append(([size(lvl) + (c,) for c in cins], nb[lvl], grouped))
        convs.append(([size(lvl) + (nb[lvl],)], nb[lvl], False))

    grouped = model_type == "unet++"
    for lvl in range(5):
        block(lvl, [23 if lvl == 0 else nb[lvl - 1]], grouped)
    if model_type == "unet":
        for lvl in range(4):
            block(lvl, [nb[lvl], nb[lvl + 1]], False)
    else:
        for lvl, j in [(0, 1), (1, 1), (2, 1), (3, 1), (0, 2), (1, 2), (2, 2),
                       (0, 3), (1, 3), (0, 4)]:
            block(lvl, [nb[lvl]] * j + [nb[lvl + 1]], True)
    return convs


def _jax_supported(shapes, features, grouped):
    """Whether the JAX model's train-mode conv reaches its kernel: its
    factory's lane packing (``pack_min_s`` 4 in training) must not apply
    (``blocks.py:273, 373``), then ``train_conv.supported`` on the parts as
    its SplitConv hands them over (concatenated where ``group_spatial`` is
    on)."""
    if pack_factor(features, shapes[0][2], min_s=4) > 1:
        return False
    if grouped:
        shapes = [shapes[0][:3] + (sum(s[3] for s in shapes),)]
    parts = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax_train_conv.supported(parts, features, interpret=True) is not None


@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_supported_is_the_jax_rule(model_type):
    """Conv by conv, over tile sizes, widths and batches, the port takes a
    conv exactly where JAX does; at the full width, the U-Net's four
    level-0 convs (base 64, 256²) and U-Net++'s eight level-1 ones (base 32,
    128²: its 32-channel level-0 row is lane-packed in JAX)."""
    for b, hw, base in [(16, 256, 64), (16, 256, 32), (8, 512, 64), (2, 250, 16),
                        (2, 64, 8), (2, 32, 8), (3, 48, 4), (1, 96, 32), (2, 40, 4),
                        (2, 32, 64), (2, 32, 32), (2, 50, 48), (2, 24, 33)]:
        for shapes, features, grouped in _conv_parts(model_type, b, hw, base):
            want = _jax_supported(shapes, features, grouped)
            assert train_conv.supported(shapes, features, grouped) == want, (
                b, hw, base, shapes, features)
    full = {"unet": (16, 256, 64, 4), "unet++": (16, 256, 32, 8)}[model_type]
    assert sum(train_conv.supported(*c) for c in _conv_parts(model_type, *full[:3])) == full[3]
    small = _conv_parts(model_type, 2, 32, FUSED[model_type]["base_filters"])
    assert sum(train_conv.supported(*c) for c in small) == EXPECTED_CONVS[model_type]


# --- the train step against JAX --------------------------------------------

def _counting(monkeypatch, module, calls):
    fn = module.train_conv3x3

    def counted(*args, **kw):
        out = fn(*args, **kw)
        calls[0] += out is not None
        return out

    monkeypatch.setattr(module, "train_conv3x3", counted)


def _port_step(variables, model_type, fused, monkeypatch=None):
    """The port's loss mean(y^2), its gradients and running statistics after
    one train-mode forward and backward; with ``monkeypatch``, also how many
    convs took ``TrainConv3x3``."""
    model = UrbanPredictor(model_type, compute_dtype=torch.float32,
                           train_fused_conv=fused, **FUSED[model_type])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    calls = [0]
    if monkeypatch is not None:
        _counting(monkeypatch, train_conv, calls)
    y = model(*(torch.from_numpy(a) for a in _inputs()))
    loss = (y.float() ** 2).mean()
    loss.backward()
    loss = loss.detach()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in model.named_parameters()}
    stats = {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}
    return float(loss), grads, stats, calls[0]


@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_train_fused_conv_matches_jax_interpret(jax_init, monkeypatch, model_type):
    """JAX's ``train_fused_conv=True`` in interpret mode and the port's, in
    f32: the same convs take the kernel, the loss at rtol 2e-5, every
    gradient at JAX's own tolerance for its fused path (atol 5e-4, rtol
    5e-3, ``tests/test_pallas.py:424-470``), the running statistics at
    1e-4."""
    variables = jax_init(model_type, FUSED[model_type])
    model = JaxUrbanPredictor(model_type, compute_dtype=jnp.float32,
                              train_fused_conv=True, **FUSED[model_type])
    args = tuple(jnp.asarray(a) for a in _inputs())

    def objective(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               *args, train=True, mutable=["batch_stats"])
        return jnp.mean(out.astype(jnp.float32) ** 2), upd

    jax_calls = [0]
    _counting(monkeypatch, jax_train_conv, jax_calls)
    assert not jax_pvgg.INTERPRET
    jax_pvgg.INTERPRET = True
    try:
        (loss, upd), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            variables["params"])
    finally:
        jax_pvgg.INTERPRET = False
    assert jax_calls[0] == EXPECTED_CONVS[model_type]

    got_loss, got_grads, got_stats, calls = _port_step(variables, model_type, True, monkeypatch)
    assert calls == jax_calls[0]
    np.testing.assert_allclose(got_loss, float(loss), rtol=2e-5)
    want_grads = _params_to_torch_arrays(_numpy(grads))
    assert sorted(want_grads) == sorted(got_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(got_grads[k], g, atol=5e-4, rtol=5e-3, err_msg=k)
    want_stats = state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": _numpy(upd["batch_stats"])})
    for k, v in got_stats.items():
        np.testing.assert_allclose(v, want_stats[k].numpy(), atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_train_fused_conv_matches_the_port_without_it(jax_init, model_type):
    """On CPU tensors the fused path differs from the cuDNN path only by the
    order of f32 sums: loss, gradients and running statistics agree at
    1e-5 of the largest value."""
    variables = jax_init(model_type, FUSED[model_type])
    base_loss, base_grads, base_stats, _ = _port_step(variables, model_type, False)
    loss, grads, stats, _ = _port_step(variables, model_type, True)
    np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
    g_floor = 1e-5 * max(np.abs(g).max() for g in base_grads.values())
    for k, g in base_grads.items():
        np.testing.assert_allclose(grads[k], g, atol=g_floor, rtol=1e-5, err_msg=k)
    for k, v in base_stats.items():
        np.testing.assert_allclose(stats[k], v, atol=1e-6, rtol=1e-5, err_msg=k)


def test_train_conv_backward_gives_no_gradient_to_an_input_without_one():
    """Per part and per weight slice, and none for a part that needs none
    (the maps); the weight gradients equal autograd's through ``F.conv2d``
    over the concatenation."""
    g = torch.Generator().manual_seed(0)
    maps = torch.randn(2, 16, 16, 5, generator=g)
    act = torch.randn(2, 16, 16, 3, generator=g, requires_grad=True)
    w = torch.randn(4, 8, 3, 3, generator=g, requires_grad=True)
    y = train_conv.train_conv3x3([maps, act], [w[:, :5], w[:, 5:]])
    (y ** 2).sum().backward()
    assert maps.grad is None
    ref_act = act.detach().clone().requires_grad_()
    ref_w = w.detach().clone().requires_grad_()
    x = torch.cat([maps, ref_act], -1).permute(0, 3, 1, 2)
    ref = torch.nn.functional.conv2d(x, ref_w, padding=1).permute(0, 2, 3, 1)
    (ref ** 2).sum().backward()
    torch.testing.assert_close(y, ref)
    torch.testing.assert_close(act.grad, ref_act.grad)
    torch.testing.assert_close(w.grad, ref_w.grad)
