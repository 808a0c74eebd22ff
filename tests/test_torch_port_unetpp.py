"""The PyTorch port's U-Net++, BatchNorm folding and whole-block pair conv
against the JAX package, on the CPU at a small size (64² and 50² tiles,
base 8, T = 48).

Weights cross over through ``maunet_tpu_torch.interop.from_jax``; inputs are
numpy arrays from a seed.  On the CPU every kernel wrapper of the port takes
its plain version; the JAX pair kernel runs in Pallas interpret mode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.interop.torch_export import _params_to_torch_arrays, reference_param_order
from maunet_tpu.losses import get_loss_fn as jax_loss_fn
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.models.fuse import fold_batchnorm as jax_fold_batchnorm
from maunet_tpu.ops.packed_conv import Packed, pack, pack_weights
from maunet_tpu.ops.pallas.packed_vgg import packed_pair_fused, pair_supported
from maunet_tpu.train import make_optimizer as jax_optimizer
from maunet_tpu.train import make_train_step
from maunet_tpu.train.state import TrainState

from maunet_tpu_torch.interop.from_jax import state_dict_from_jax, variables_from_flat
from maunet_tpu_torch.interop.torch_import import infer_hyperparams
from maunet_tpu_torch.losses import get_loss_fn
from maunet_tpu_torch.models import UrbanPredictor, build_model
from maunet_tpu_torch.models.fuse import fold_batchnorm
from maunet_tpu_torch.ops.kernels import packed_vgg
from maunet_tpu_torch.train.config import TrainConfig, hyperparams_from_config
from maunet_tpu_torch.train.optimizers import make_optimizer
from maunet_tpu_torch.train.state import TrainState as PortState
from maunet_tpu_torch.train.steps import ds_loss, eval_step, last_head, train_step

from test_torch_port_model import _numpy_tree, random_jax_variables

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_unetpp.npz")
KW = dict(base_filters=8, temporal_dim=8, meta_dim=8, lstm_dim=8)
T = 48
# f32: the two frameworks sum convolutions and products in other orders.
F32_TOL = 1e-5
# bf16: both round activations to bf16 after every conv, at other points (JAX
# rounds a packed conv's output, the port rounds once after the fused f32
# epilogue), carried through 30 convs; the deep-supervised heads are raw (no
# tanh), of magnitude up to 3.
BF16_TOL = 6e-2


def _inputs(hw):
    rng = np.random.default_rng(hw)
    return rng, (rng.normal(size=(2, hw, hw, 23)).astype(np.float32),
                 rng.normal(size=(2, T)).astype(np.float32),
                 rng.normal(size=(2, 8)).astype(np.float32),
                 np.array([T, 30], np.int32))


class _JittedInit:
    """``random_jax_variables`` calls ``model.init``; op by op it takes most
    of a minute on the CPU, jitted a few seconds."""

    def __init__(self, model):
        self.init = jax.jit(model.init)


@pytest.fixture(scope="module")
def jax_case():
    """Random JAX U-Net++ weights and inputs per (tile size, deep supervision)."""
    cache = {}

    def make(hw, ds):
        if (hw, ds) not in cache:
            rng, inputs = _inputs(hw)
            model = JaxUrbanPredictor("unet++", deep_supervision=ds,
                                      compute_dtype=jnp.float32, **KW)
            cache[hw, ds] = (random_jax_variables(rng, _JittedInit(model), inputs), inputs)
        return cache[hw, ds]

    return make


def _jax_forward(variables, inputs, ds, dtype, **kw):
    model = JaxUrbanPredictor("unet++", deep_supervision=ds, compute_dtype=dtype,
                              **KW, **kw)
    out = jax.jit(model.apply)(variables, *(jnp.asarray(a) for a in inputs))
    return [np.asarray(o) for o in (out if ds else (out,))]


def _port(variables, ds, dtype, **kw):
    model = UrbanPredictor("unet++", deep_supervision=ds, compute_dtype=dtype,
                           **KW, **kw).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _run(model, inputs):
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in inputs))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def test_golden_fixture_strict_load_and_forward():
    with np.load(FIXTURE) as z:
        state_dict = state_dict_from_jax(variables_from_flat(z))
        inputs = [z[k] for k in ("maps", "series", "meta", "lengths")]
        expected = z["expected"]
    hp = infer_hyperparams(state_dict, {"model_type": "unet++"})
    assert hp["temporal_embeddings"] and hp["metadata_embeddings"]
    model = build_model(hp, compute_dtype=torch.float32)
    model.load_state_dict(state_dict, strict=True)
    (got,) = _run(model, inputs)
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("hw", [64, 50])
@pytest.mark.parametrize("ds", [False, True])
def test_unetpp_matches_jax_f32(jax_case, hw, ds):
    variables, inputs = jax_case(hw, ds)
    want = _jax_forward(variables, inputs, ds, jnp.float32)
    got = _run(_port(variables, ds, torch.float32), inputs)
    assert len(got) == len(want) == (4 if ds else 1)
    for g, w in zip(got, want):
        assert g.shape == (2, hw, hw, 2)
        np.testing.assert_allclose(g, w, atol=F32_TOL)
    if not ds:   # tanh on NDVI only
        assert np.abs(got[0][..., 0]).max() <= 1.0


@pytest.mark.parametrize("hw", [64, 50])
@pytest.mark.parametrize("ds", [False, True])
def test_unetpp_matches_jax_bf16(jax_case, hw, ds):
    variables, inputs = jax_case(hw, ds)
    want = _jax_forward(variables, inputs, ds, jnp.bfloat16)
    got = _run(_port(variables, ds, torch.bfloat16), inputs)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=BF16_TOL)


@pytest.mark.parametrize("model_type,ds", [("unet", False), ("unet++", False),
                                           ("unet++", True)])
def test_parameter_order_is_the_references(model_type, ds):
    model = UrbanPredictor(model_type, base_filters=4, deep_supervision=ds)
    assert [n for n, _ in model.named_parameters()] == reference_param_order(model_type, ds)


def test_ablation_flags_remove_encoders_and_channels():
    model = UrbanPredictor("unet++", base_filters=4, temporal_embeddings=False,
                           meta_dim=6)
    assert model.model.temporal_encoder is None
    assert model.model.conv0_1.conv1.in_channels == 4 + 8 + 6
    assert model.model.conv0_4.conv1.in_channels == 4 * 4 + 8 + 6
    with pytest.raises(ValueError, match="Unsupported model_type"):
        UrbanPredictor("unet3+")


@pytest.mark.parametrize("model_type", ["unet", "unet++"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fuse_pair_equals_the_default_forward(jax_case, monkeypatch, model_type, dtype):
    """On the CPU the pair wrapper's plain version is two chained plain
    convs, so the outputs are equal bit for bit; base 8 makes the blocks of
    width <= 64 (levels 0-3) eligible."""
    variables, inputs = jax_case(50, False)
    kw = dict(compute_dtype=dtype, **KW)
    if model_type == "unet":
        variables = random_jax_variables(
            np.random.default_rng(1),
            _JittedInit(JaxUrbanPredictor("unet", compute_dtype=jnp.float32, **KW)), inputs)
    base = UrbanPredictor(model_type, **kw).eval()
    base.load_state_dict(state_dict_from_jax(variables), strict=True)
    pair = UrbanPredictor(model_type, fuse_pair=True, **kw).eval()
    pair.load_state_dict(base.state_dict(), strict=True)
    plain, calls = packed_vgg.conv3x3_pair_fused_plain, []
    monkeypatch.setattr(packed_vgg, "conv3x3_pair_fused_plain",
                        lambda *a, **k: (calls.append(1), plain(*a, **k))[1])
    got = _run(pair, inputs)[0]
    # Blocks of width 8..64: 8 of the U-Net's 9, 14 of U-Net++'s 15.
    assert len(calls) == (8 if model_type == "unet" else 14)
    np.testing.assert_array_equal(got, _run(base, inputs)[0])
    # Train mode never takes the pair kernel.
    assert not pair.train().model.conv0_0.takes_pair_kernel()


@pytest.mark.parametrize("ds", [False, True])
def test_bn_fused_with_folded_weights_equals_the_default_forward(jax_case, ds):
    variables, inputs = jax_case(64, ds)
    base = _port(variables, ds, torch.float32)
    folded = fold_batchnorm(base.state_dict())
    assert not any(".bn" in k for k in folded)
    fused = UrbanPredictor("unet++", deep_supervision=ds, compute_dtype=torch.float32,
                           bn_fused=True, **KW).eval()
    fused.load_state_dict(folded, strict=True)
    for g, w in zip(_run(fused, inputs), _run(base, inputs)):
        np.testing.assert_allclose(g, w, atol=1e-5)
    # The same folding as the JAX package's, leaf by leaf.
    want = _params_to_torch_arrays(_numpy_tree(jax_fold_batchnorm(variables)["params"]))
    assert sorted(want) == sorted(folded)
    for k, v in want.items():
        np.testing.assert_allclose(folded[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(RuntimeError, match="inference-only"):
        fused.train()(*(torch.from_numpy(a) for a in inputs))


@pytest.mark.parametrize("h,w,s,cmid,cins,add_term", [
    # U-Net++ level-0 node class: two 32-channel parts + the embedding add
    (16, 32, 4, 32, (32, 32), True),
    # U-Net level-0 conv0_0 class: one part, no add
    (16, 32, 2, 64, (64,), False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_plain_matches_pallas_pair_kernel(h, w, s, cmid, cins, add_term, dtype):
    """The port's plain pair conv on NHWC tensors against
    ``packed_pair_fused(..., interpret=True)`` on the same tensors packed
    with ``pack``/``pack_weights``.  f32: other summation orders, atol 3e-5.
    bf16: both round mid and the output to bf16 once, from f32 sums taken in
    other orders, and JAX also rounds the scaled weights twice.  A mid value
    that lands one bf16 step apart (2^-8 relative, of mid values up to 8)
    moves every output it feeds by an amount that does not shrink with that
    output, so the bound has a floor set by the tensor's scale:
    1e-2 max|ref| + 2e-2 |ref| (measured: 0.039 at max|ref| = 10.7, where the
    JAX result is 0.037 from the f32 result and the port's 0.028)."""
    rng = np.random.default_rng(0)
    b, cout = 2, cmid
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xs = [rng.normal(size=(b, h, w, c)).astype(np.float32) for c in cins]
    # He-scaled weights keep mid and the output O(1), as in a trained block.
    std1, std2 = np.sqrt(2 / (9 * sum(cins))), np.sqrt(2 / (9 * cmid))
    k1s = [(rng.normal(size=(3, 3, c, cmid)) * std1).astype(np.float32) for c in cins]
    k2 = (rng.normal(size=(3, 3, cmid, cout)) * std2).astype(np.float32)
    a1, a2 = ((rng.normal(size=(n,)) * 0.3 + 1.0).astype(np.float32) for n in (cmid, cout))
    b1, b2 = (rng.normal(size=(n,)).astype(np.float32) for n in (cmid, cout))
    add = rng.normal(size=(b, 3, w, cmid)).astype(np.float32) if add_term else None

    parts = tuple(pack(jnp.asarray(x, jd), s).x for x in xs)
    wps1 = tuple(pack_weights(jnp.asarray(k), s).reshape(3, (s + 2) * c, s * cmid).astype(jd)
                 for k, c in zip(k1s, cins))
    wp2 = pack_weights(jnp.asarray(k2), s).reshape(3, (s + 2) * cmid, s * cout).astype(jd)
    assert pair_supported([p.shape for p in parts], cins, s, cmid, cout)
    add_packed = None if add is None else jnp.asarray(add).reshape(b, 3, w // s, s * cmid)
    ref = packed_pair_fused(parts, wps1, cins, s, cmid, wp2, cout,
                            (jnp.tile(a1, s), jnp.tile(b1, s)),
                            (jnp.tile(a2, s), jnp.tile(b2, s)),
                            add=add_packed, interpret=True)
    ref = np.asarray(Packed(ref, cout).unpack().astype(jnp.float32))

    t = torch.from_numpy
    got = packed_vgg.conv3x3_pair_fused(
        [t(x).to(td) for x in xs], [t(k).permute(3, 2, 0, 1) for k in k1s],
        t(k2).permute(3, 2, 0, 1), scale1=t(a1), bias1=t(b1), scale2=t(a2),
        bias2=t(b2), add=None if add is None else t(add)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-5)
    else:
        assert (np.abs(got - ref) <= 1e-2 * np.abs(ref).max() + 2e-2 * np.abs(ref)).all()


def _batch(seed, b=3, hw=32, t=16):
    rng = np.random.default_rng(seed)
    return {
        "maps": rng.normal(size=(b, hw, hw, 23)).astype(np.float32),
        "targets": np.concatenate([rng.uniform(-0.8, 0.8, (b, hw, hw, 1)),
                                   rng.uniform(-0.2, 1.2, (b, hw, hw, 1))],
                                  -1).astype(np.float32),
        "metadata": rng.normal(size=(b, 4)).astype(np.float32),
        "temp_series": rng.normal(size=(b, t)).astype(np.float32),
        "temp_lengths": np.array([t, 0, 9][:b], np.int32),
        "t1_dates": np.array([[2019, 3], [2020, 7], [2018, 12]][:b], np.float32),
        "t2_dates": np.array([[2023, 5], [2024, 1], [2022, 6]][:b], np.float32),
        "valid": np.array([True, True, False][:b]),
    }


DS_KW = dict(base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8)
DS_LOSS = "l1-gradient-ssim"


@pytest.fixture(scope="module")
def ds_jax():
    """The deep-supervised JAX U-Net++ with its jitted ``init``, its jitted
    train step, and the objective of that step (``maunet_tpu/train/steps.py``'s,
    written out) jitted as a forward and as ``jax.grad`` of its total, each
    compiled once."""
    from maunet_tpu.train.steps import _ds_loss

    model = JaxUrbanPredictor("unet++", deep_supervision=True,
                              compute_dtype=jnp.float32, **DS_KW)
    loss_fn = jax_loss_fn(DS_LOSS)
    tx = jax_optimizer("sgd", 1e-2, 0.0, 0.9, 0.0)

    def objective(params, batch_stats, b, meta):
        outputs, updates = model.apply(
            {"params": params, "batch_stats": batch_stats}, b["maps"], b["temp_series"],
            meta, b["temp_lengths"], train=True, mutable=["batch_stats"])
        losses = _ds_loss(loss_fn, outputs, b["targets"])
        return losses["total"], (losses, updates["batch_stats"])

    return (model, tx, jax.jit(model.init),
            make_train_step(model, loss_fn, tx, donate=False), jax.jit(objective),
            jax.jit(jax.grad(lambda *args: objective(*args)[0])))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deep_supervised_train_step_matches_jax(ds_jax, seed):
    """One f32 SGD step of a deep-supervised U-Net++ on three batches: loss
    components (each averaged over the four heads), the gradient norm, updated
    parameters and BatchNorm statistics; then validation reads the last head.

    The port is held at rtol 1e-4 to ``jax.jit(jax.grad(...))`` of the JAX
    package's objective followed by its optimizer.  It is also held to the
    package's jitted ``make_train_step``, at rtol 1e-4 plus what that step
    itself differs by from the gradient above: on the CPU, XLA compiles the
    step (``value_and_grad`` with the losses and the statistics as outputs)
    and the lone gradient to other programs, and on batches 0 and 1 their
    gradient norms differ by 3e-4 and 4e-4.  That difference is measured here
    on every batch and must stay below 1e-3."""
    import optax

    model, tx, init, jax_step, jax_forward, jax_grad = ds_jax
    b = _batch(seed)
    meta = np.concatenate([b["metadata"], b["t1_dates"], b["t2_dates"]], 1)
    variables = init(jax.random.PRNGKey(0), b["maps"], b["temp_series"], meta,
                     b["temp_lengths"])
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step_state, step_metrics = jax_step(state, b)
    _, (want, new_stats) = jax_forward(state.params, state.batch_stats, b, meta)
    grads = jax_grad(state.params, state.batch_stats, b, meta)
    want = {**want, "grad_norm": optax.global_norm(grads)}
    updates, _ = tx.update(grads, state.opt_state, state.params)
    new_variables = {"params": optax.apply_updates(state.params, updates),
                     "batch_stats": new_stats}

    port = UrbanPredictor("unet++", deep_supervision=True, compute_dtype=torch.float32,
                          **DS_KW)
    port.load_state_dict(state_dict_from_jax(_numpy_tree(variables)), strict=True)
    pstate = PortState(port, make_optimizer(port.parameters(), "sgd", 1e-2, 0.0, 0.9), 0)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    got = train_step(pstate, tb, get_loss_fn(DS_LOSS))
    assert sorted(got) == sorted(want) == sorted(step_metrics)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
        own = abs(float(step_metrics[k]) - float(v))
        assert own <= 1e-3 * abs(float(v)), (k, own)
        np.testing.assert_allclose(float(got[k]), float(step_metrics[k]), rtol=1e-4,
                                   atol=own, err_msg=f"{k} against make_train_step")

    before = state_dict_from_jax(_numpy_tree(variables))
    sd = port.state_dict()
    for label, after in [("jax.grad", new_variables), ("make_train_step", step_state.variables)]:
        new_sd = state_dict_from_jax(_numpy_tree(after))
        moved = max(float((new_sd[k] - before[k]).abs().max()) for k in new_sd
                    if not k.endswith("num_batches_tracked"))
        # Against the jitted step the floor also takes its own 1e-3.
        floor = (1e-4 if label == "jax.grad" else 1e-3) * moved
        for k, v in new_sd.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=floor,
                                           err_msg=f"{k} against {label}")
    sums = eval_step(port, tb)
    assert float(sums["num_samples"]) == 2.0 and np.isfinite(float(sums["total"]))


def test_ds_loss_averages_heads_and_last_head_picks_the_last():
    loss_fn = get_loss_fn("mse")
    rng = np.random.default_rng(0)
    heads = tuple(torch.from_numpy(rng.normal(size=(2, 8, 8, 2)).astype(np.float32))
                  for _ in range(4))
    target = torch.zeros(2, 8, 8, 2)
    want = sum(float(loss_fn(h, target)["total"]) for h in heads) / 4
    assert float(ds_loss(loss_fn, heads, target)["total"]) == pytest.approx(want, rel=1e-6)
    assert last_head(heads) is heads[-1] and last_head(heads[0]) is heads[0]
    assert ds_loss(loss_fn, heads[0], target)["total"] == loss_fn(heads[0], target)["total"]


def test_train_config_carries_unetpp():
    cfg = TrainConfig(model_type="unet++", deep_supervision=True, base_filters=32)
    hp = hyperparams_from_config(cfg)
    assert hp["model_type"] == "unet++" and hp["deep_supervision"] is True
    assert TrainConfig().deep_supervision is False
