"""One f32 train step of the PyTorch port against the JAX package's.

The same numpy batch (B = 3, 32² tiles, T = 16 with lengths 16, 0 and 9) and
the same weights (``model.init`` of the JAX model, carried over with
``interop.from_jax``) go through ``maunet_tpu.train.steps.make_train_step``
and the port's ``train_step``.  Loss components, gradients, updated
parameters and BatchNorm running statistics agree at rtol 1e-4; gradient
and update elements also get an absolute floor of 1e-4 of the largest
gradient (update) of any parameter, since sums that cancel to near zero,
such as a BN scale's gradient, carry no relative precision.  At B = 3 and a 2x2 bottleneck the unbiased-variance
factor n / (n - 1) would be 1.09, so the running variance shows that the
port updates it with the biased batch variance, as flax does.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.interop.torch_export import _params_to_torch_arrays, export_torch_checkpoint
from maunet_tpu.losses import get_loss_fn as jax_loss_fn
from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor
from maunet_tpu.train import make_eval_step, make_train_step
from maunet_tpu.train import make_optimizer as jax_optimizer
from maunet_tpu.train.state import TrainState

from maunet_tpu_torch.interop.from_jax import state_dict_from_jax
from maunet_tpu_torch.losses import get_loss_fn
from maunet_tpu_torch.models import UrbanPredictor, blocks
from maunet_tpu_torch.train.checkpoint import restore_checkpoint
from maunet_tpu_torch.train.optimizers import make_optimizer
from maunet_tpu_torch.train.state import TrainState as PortState
from maunet_tpu_torch.train.steps import eval_step, metadata_full, train_step

KW = dict(base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=8)
LOSS = "l1-gradient-ssim"
T = 16
# (optimizer, learning rate, weight decay, clip): the clip of 0.5 sits
# below the first step's gradient norm, so it scales.
OPTIMIZERS = {"sgd": ("sgd", 1e-2, 0.0, 0.0),
              "adam": ("adam", 1e-3, 1e-3, 0.0),
              "adamw": ("adamw", 1e-3, 1e-2, 0.5)}


def _batch(seed, b=3, hw=32, valid=None):
    rng = np.random.default_rng(seed)
    return {
        "maps": rng.normal(size=(b, hw, hw, 23)).astype(np.float32),
        "targets": np.concatenate([rng.uniform(-0.8, 0.8, (b, hw, hw, 1)),
                                   rng.uniform(-0.2, 1.2, (b, hw, hw, 1))],
                                  -1).astype(np.float32),
        "metadata": rng.normal(size=(b, 4)).astype(np.float32),
        "temp_series": rng.normal(size=(b, T)).astype(np.float32),
        "temp_lengths": np.array([T, 0, 9][:b], np.int32),
        "t1_dates": np.array([[2019, 3], [2020, 7], [2018, 12]][:b], np.float32),
        "t2_dates": np.array([[2023, 5], [2024, 1], [2022, 6]][:b], np.float32),
        "valid": np.ones(b, bool) if valid is None else np.asarray(valid),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX model, its initial state per optimizer and the compiled steps,
    built once for the module.  The state is ``create_train_state``'s, with
    ``model.init`` jitted (run op by op it takes most of a minute)."""
    model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, **KW)
    b = _batch(0)
    meta = np.concatenate([b["metadata"], b["t1_dates"], b["t2_dates"]], 1)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), b["maps"], b["temp_series"],
                                    meta, b["temp_lengths"])
    cache = {}

    def get(name):
        if name not in cache:
            opt_name, lr, wd, clip = OPTIMIZERS[name]
            tx = jax_optimizer(opt_name, lr, wd, 0.9, clip)
            state = TrainState(params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]),
                               step=jnp.zeros((), jnp.int32))
            step = make_train_step(model, jax_loss_fn(LOSS), tx, donate=False)
            cache[name] = (state, step)
        return cache[name]

    return model, get


def _port_state(variables, name):
    opt_name, lr, wd, _ = OPTIMIZERS[name]
    model = UrbanPredictor(compute_dtype=torch.float32, **KW)
    model.load_state_dict(state_dict_from_jax(_numpy(variables)), strict=True)
    opt = make_optimizer(model.parameters(), opt_name, lr, wd, 0.9)
    return PortState(model, opt, 0)


def _check_params(model, variables, what, skip=None):
    """Parameters and BN statistics at rtol 1e-4, atol 1e-6; ``skip`` maps a
    parameter name to a mask of elements not compared here."""
    want = state_dict_from_jax(_numpy(variables))
    got = model.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = got[k].numpy(), v.numpy()
        if skip is not None and k in skip:
            a, b = a[~skip[k]], b[~skip[k]]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f"{what}: {k}")


def _jax_grads(model, state, batch):
    """The gradients ``make_train_step`` differentiates, by the same
    objective (maunet_tpu/train/steps.py:61-68)."""
    meta = jnp.concatenate([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], 1)

    def objective(params):
        out, _ = model.apply({"params": params, "batch_stats": state.batch_stats},
                             batch["maps"], batch["temp_series"], meta,
                             batch["temp_lengths"], train=True, mutable=["batch_stats"])
        return jax_loss_fn(LOSS)(out, batch["targets"])["total"]

    return jax.jit(jax.grad(objective))(state.params)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_step_matches_jax(jax_setup, name):
    model, get = jax_setup
    state, step = get(name)
    batch = _batch(0)
    new_state, metrics = step(state, batch)
    pstate = _port_state(state.variables, name)
    before = {n: p.detach().clone() for n, p in pstate.model.named_parameters()}
    _, _, _, clip = OPTIMIZERS[name]
    got = train_step(pstate, _torch_batch(batch), get_loss_fn(LOSS), gradient_clipping=clip)
    assert pstate.step == 1 and sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
    if clip:
        assert float(got["grad_norm"]) > clip      # the clip was active

    grads = _params_to_torch_arrays(_numpy(_jax_grads(model, state, batch)))
    new_params = _params_to_torch_arrays(_numpy(new_state.params))
    params = dict(pstate.model.named_parameters())
    assert sorted(grads) == sorted(params)
    if clip:
        grads = {k: g / float(metrics["grad_norm"]) * clip for k, g in grads.items()}
    deltas = {k: new_params[k] - before[k].numpy() for k in grads}
    g_floor = 1e-4 * max(float(np.abs(g).max()) for g in grads.values())
    d_floor = 1e-4 * max(float(np.abs(d).max()) for d in deltas.values())
    opt_name, lr, wd, _ = OPTIMIZERS[name]
    unstable = {}
    for k, g in grads.items():
        p, p0 = params[k], before[k]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4, atol=g_floor, err_msg=k)
        delta = (p.detach() - p0).numpy()
        if opt_name == "sgd":
            np.testing.assert_allclose(delta, deltas[k], rtol=1e-4, atol=d_floor, err_msg=k)
            continue
        # Adam's first update is -lr g' / (|g'| + eps) (g' with Adam's L2
        # term), as optax forms it: held at rtol 1e-4 against the formula on
        # the port's own gradient.  Against JAX it is compared where
        # |g'| > 1e-5: there it lies within 1e-9 of -lr sign(g').  Below, a
        # gradient's rounding moves it by up to lr eps |dg| / (|g'| + eps)^2,
        # and where g cancels wd p to 1e-8 rounding picks its sign.
        gk = p.grad + (wd * p0 if opt_name == "adam" else 0.0)
        want = -lr * gk / (gk.abs() + 1e-8) - (lr * wd * p0 if opt_name == "adamw" else 0.0)
        # atol: two roundings of the parameter (AdamW decays, then steps),
        # plus the rounding of g' in f32, ulp(|g|) + ulp(|wd p|), carried
        # through the formula's slope lr eps / (|g'| + eps)^2: where g and
        # wd p cancel to |g'| ~ 1e-9, that rounding moves the update by 1e-4
        # of itself (in f64 the port's update meets the formula there).
        ulp2 = 2 * float(np.spacing(np.float32(p0.abs().max())))
        wd_p = ((wd if opt_name == "adam" else 0.0) * p0).numpy()
        g_err = np.spacing(np.abs(p.grad.numpy())) + np.spacing(np.abs(wd_p))
        slope = lr * 1e-8 / (np.abs(gk.numpy().astype(np.float64)) + 1e-8) ** 2
        bound = ulp2 + g_err * slope + 1e-4 * np.abs(want.numpy())
        assert (np.abs(delta - want.numpy()) <= bound).all(), (
            k, float(np.abs(delta - want.numpy())[np.abs(delta - want.numpy()) > bound].max()))
        g_jax = g + (wd * p0.numpy() if opt_name == "adam" else 0.0)
        unstable[k] = np.abs(g_jax) <= 1e-5
        assert np.abs(delta - deltas[k]).max() <= 2 * lr * (1 + wd), k
    assert sum(int(m.sum()) for m in unstable.values()) < 0.5 * sum(
        g.size for g in grads.values())
    _check_params(pstate.model, new_state.variables, name, skip=unstable)
    # The detached conv biases got a zero gradient and still took the update:
    # under AdamW, the decoupled decay alone.
    key = "model.conv0_0.conv1.bias"
    assert not params[key].grad.any() and params[key].requires_grad
    if name == "adamw":
        _, lr, wd, _ = OPTIMIZERS[name]
        np.testing.assert_allclose((params[key].detach() - before[key]).numpy(),
                                   -lr * wd * before[key].numpy(), rtol=1e-4)


def test_eval_step_matches_jax_with_padded_tail(jax_setup):
    """Masked sums after one train step (BN running statistics updated),
    over a batch whose last sample is padding."""
    model, get = jax_setup
    state, step = get("adamw")
    new_state, _ = step(state, _batch(0))
    batch = _batch(1, valid=[True, True, False])
    want = make_eval_step(model)(new_state, batch)
    port = UrbanPredictor(compute_dtype=torch.float32, **KW)
    port.load_state_dict(state_dict_from_jax(_numpy(new_state.variables)), strict=True)
    got = eval_step(port, _torch_batch(batch))
    assert sorted(got) == sorted(want) and float(got["num_samples"]) == 2.0
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
    assert not port.training


def test_metadata_full_concatenates_dates():
    b = _torch_batch(_batch(0))
    assert tuple(metadata_full(b, 8).shape) == (3, 8)
    assert metadata_full(b, 4) is b["metadata"]


# A BatchNorm output that the two packages round to opposite sides of the
# ReLU's kink: its |value| lies within f32 rounding of 0 in both.
RELU_EDGE = 1e-5


def _jax_relu_inputs(model, state, batch):
    """Every BatchNorm output (the ReLU's input) of ``model``'s train-mode
    forward, by the port's module name (``model.conv0_1.bn1``)."""
    meta = jnp.concatenate([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], 1)

    def run(params, stats):
        _, upd = model.apply({"params": params, "batch_stats": stats}, batch["maps"],
                             batch["temp_series"], meta, batch["temp_lengths"], train=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=lambda m, _: isinstance(m, flax.linen.BatchNorm))
        return upd["intermediates"]

    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                out["model." + ".".join(path)] = np.array(v[0])
            else:
                walk(v, path + [k])

    walk(jax.jit(run)(state.params, state.batch_stats), [])
    return out


def _take_jax_relu_edges(monkeypatch, port_model, jax_inputs):
    """Make the port's train-mode forward take JAX's side of the ReLU at the
    elements where the two packages' BatchNorm outputs straddle 0, each
    within RELU_EDGE of it; any other disagreement of signs fails.  At such
    an element the gradient is cut in one package and not in the other,
    and that one element's difference reaches every parameter upstream.
    Returns the number of elements taken over."""
    names = {id(m): n for n, m in port_model.named_modules()}
    taken = [0]
    bn_train = blocks.batch_norm_train

    def batch_norm_train(y, bn):
        out = bn_train(y, bn)
        want = torch.from_numpy(jax_inputs[names[id(bn)]])
        flip = (out > 0) != (want > 0)
        if flip.any():
            assert out.detach()[flip].abs().max() <= RELU_EDGE, names[id(bn)]
            assert want[flip].abs().max() <= RELU_EDGE, names[id(bn)]
            taken[0] += int(flip.sum())
            out = torch.where(flip, out + (want - out).detach(), out)
        return out

    monkeypatch.setattr(blocks, "batch_norm_train", batch_norm_train)
    return taken


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_resume_from_jax_exported_optimizer_state(jax_setup, name, tmp_path, monkeypatch):
    """JAX takes two steps and exports params, BN statistics and optimizer
    state to a reference ``.pth``; the port loads it and both take step 3.

    At step 3 under SGD one ReLU input of ``conv0_1.bn1`` is +2.2e-6 in f64
    (both packages agree there to 1e-14 on every gradient) and JAX's f32,
    -1.5e-6 in the port's f32: the port's gradient loses that element, and
    every parameter upstream moves by up to lr * 1.6e-3.  So the port takes
    JAX's side of the ReLU at such knife edges (``_take_jax_relu_edges``,
    none under AdamW) and the comparison keeps its tolerance."""
    model, get = jax_setup
    state, step = get(name)
    for seed in (0, 1):
        state, _ = step(state, _batch(seed))
    opt_name, lr, wd, clip = OPTIMIZERS[name]
    path = str(tmp_path / "jax.pth")
    export_torch_checkpoint(path, _numpy(state.variables),
                            {"model_type": "unet", "optimizer": opt_name,
                             "learning_rate": lr, "weight_decay": wd, "momentum": 0.9},
                            opt_state=state.opt_state, step=2, epoch=0)
    pstate = _port_state(state.variables, name)
    restore_checkpoint(path, pstate)
    assert pstate.step == 2
    batch = _batch(2)
    state3, _ = step(state, batch)
    taken = _take_jax_relu_edges(monkeypatch, pstate.model, _jax_relu_inputs(model, state, batch))
    train_step(pstate, _torch_batch(batch), get_loss_fn(LOSS), gradient_clipping=clip)
    assert taken[0] <= 4     # knife edges are rare: one here under SGD, none under AdamW
    _check_params(pstate.model, state3.variables, name)
