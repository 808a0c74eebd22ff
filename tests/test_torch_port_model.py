"""The PyTorch port's U-Net against the JAX package.

Weights cross over through ``maunet_tpu_torch.interop.from_jax``; inputs are
numpy arrays from a seed.  Both models run on the CPU, where every kernel
wrapper of the port takes its plain version.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu.models import UrbanPredictor as JaxUrbanPredictor

from maunet_tpu_torch.interop.from_jax import state_dict_from_jax, variables_from_flat
from maunet_tpu_torch.models import UrbanPredictor

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_unet.npz")
KW = dict(base_filters=8, temporal_dim=8, meta_dim=8, lstm_dim=8)
T = 48
# f32: the two frameworks sum convolutions and products in other orders
# (measured: at most 4.5e-7 on outputs of magnitude 0.64).
F32_TOL = 1e-5
# bf16: both round activations to bf16 after every conv, but at other points
# (JAX rounds each part's conv and the cross-part sum, the port rounds once
# after the fused f32 epilogue), 2^-9 relative on average per rounding,
# carried through 18 convs (measured: at most 8.1e-3 on outputs of magnitude
# 0.64).
BF16_TOL = 3e-2


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port(variables, maps, meta, **kw):
    model = UrbanPredictor(in_channels=maps.shape[-1], meta_features=meta.shape[-1],
                           **kw).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _run_port(model, maps, series, meta, lengths):
    with torch.inference_mode():
        return model(*(torch.from_numpy(a) for a in (maps, series, meta, lengths))).numpy()


def test_golden_fixture_strict_load_and_forward():
    with np.load(FIXTURE) as z:
        variables = variables_from_flat(z)
        inputs = [z[k] for k in ("maps", "series", "meta", "lengths")]
        expected = z["expected"]
    model = _port(variables, inputs[0], inputs[2], base_filters=4, temporal_dim=4,
                  meta_dim=6, lstm_dim=8, compute_dtype=torch.float32)
    np.testing.assert_allclose(_run_port(model, *inputs), expected, atol=1e-5)


def random_jax_variables(rng, model, inputs):
    """``model.init`` weights as numpy, with BatchNorm statistics and affine
    parameters drawn from ``rng`` so the folded affine is non-trivial."""
    v = _numpy_tree(model.init(jax.random.PRNGKey(0), *inputs))
    for block in v["batch_stats"].values():
        for bn in block.values():
            bn["mean"] = (rng.normal(size=bn["mean"].shape) * 0.1).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    for block in v["params"].values():
        for sub, leaf in block.items():
            if sub.startswith("bn"):
                leaf["scale"] = rng.uniform(0.5, 1.5, leaf["scale"].shape).astype(np.float32)
                leaf["bias"] = (rng.normal(size=leaf["bias"].shape) * 0.1).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def jax_case():
    """Random JAX weights and inputs, per tile size."""
    cache = {}

    def make(hw):
        if hw not in cache:
            rng = np.random.default_rng(hw)
            inputs = (rng.normal(size=(2, hw, hw, 23)).astype(np.float32),
                      rng.normal(size=(2, T)).astype(np.float32),
                      rng.normal(size=(2, 8)).astype(np.float32),
                      np.array([T, 30], np.int32))
            model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, **KW)
            cache[hw] = (random_jax_variables(rng, model, inputs), inputs)
        return cache[hw]

    return make


def _jax_forward(variables, inputs, mode, dtype):
    model = JaxUrbanPredictor("unet", lstm_mask_mode=mode, compute_dtype=dtype, **KW)
    return np.asarray(model.apply(variables, *(jnp.asarray(a) for a in inputs)))


@pytest.mark.parametrize("hw", [64, 50])
@pytest.mark.parametrize("mode", ["per_sample", "batch_max", "none"])
def test_unet_matches_jax_f32(jax_case, hw, mode):
    variables, inputs = jax_case(hw)
    ref = _jax_forward(variables, inputs, mode, jnp.float32)
    model = _port(variables, inputs[0], inputs[2], lstm_mask_mode=mode,
                  compute_dtype=torch.float32, **KW)
    got = _run_port(model, *inputs)
    assert got.shape == (2, hw, hw, 2)
    np.testing.assert_allclose(got, ref, atol=F32_TOL)


@pytest.mark.parametrize("hw", [64, 50])
def test_unet_matches_jax_bf16(jax_case, hw):
    variables, inputs = jax_case(hw)
    ref = _jax_forward(variables, inputs, "per_sample", jnp.bfloat16)
    model = _port(variables, inputs[0], inputs[2], compute_dtype=torch.bfloat16, **KW)
    got = _run_port(model, *inputs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=BF16_TOL)


def test_unet_250_chain_matches_jax_f32():
    """The reference data's tile size: 250 -> 125 -> 62 -> 31 -> 15 going
    down (the floor max-pool drops a row and a column twice) and 15 -> 30 ->
    31, 31 -> 62, 62 -> 124 -> 125, 125 -> 250 going up (a fix-up resize after
    the 2x upsample wherever the skip is odd)."""
    hw, t = 250, 16
    kw = dict(base_filters=4, temporal_dim=4, meta_dim=4, lstm_dim=4)
    rng = np.random.default_rng(250)
    inputs = (rng.normal(size=(1, hw, hw, 23)).astype(np.float32),
              rng.normal(size=(1, t)).astype(np.float32),
              rng.normal(size=(1, 8)).astype(np.float32),
              np.array([11], np.int32))
    jax_model = JaxUrbanPredictor("unet", compute_dtype=jnp.float32, **kw)
    variables = random_jax_variables(rng, jax_model, inputs)
    ref = np.asarray(jax.jit(jax_model.apply)(variables, *(jnp.asarray(a) for a in inputs)))
    model = _port(variables, inputs[0], inputs[2], compute_dtype=torch.float32, **kw)
    got = _run_port(model, *inputs)
    assert got.shape == ref.shape == (1, hw, hw, 2)
    np.testing.assert_allclose(got, ref, atol=F32_TOL)


def test_unetpp_builds_through_the_facade():
    """Both model families build (U-Net++ is compared with JAX in
    tests/test_torch_port_unetpp.py); an unknown one is refused."""
    model = UrbanPredictor("unet++", base_filters=4, deep_supervision=True)
    assert model.model_type == "unet++" and hasattr(model.model, "final4")
    with pytest.raises(ValueError, match="Unsupported model_type"):
        UrbanPredictor("unet+")
