"""The PyTorch port's losses against ``maunet_tpu.losses``.

The same numpy inputs (NHWC, f32) go through both; values and gradients
agree within atol 1e-5.  The SSIM cases include flat windows (a constant
image, where the moments cancel exactly) and LST values clipped to [0, 1]
by the rescaling before SSIM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maunet_tpu import losses as jl
from maunet_tpu.losses.combined import per_sample_losses as jax_per_sample

from maunet_tpu_torch import losses as pl
from maunet_tpu_torch.losses.combined import per_sample_losses


def _pair(rng, shape=(2, 32, 32, 2), flat=False, clipped=False):
    o = rng.uniform(-0.9, 0.9, size=shape).astype(np.float32)
    t = rng.uniform(-0.9, 0.9, size=shape).astype(np.float32)
    if flat:
        o[0] = 0.25                      # one sample entirely constant
        t[1, :16, :16] = -0.5            # a flat quadrant
    if clipped:
        o[..., 1] *= 3.0                 # LST outside [0, 1] before SSIM
        t[..., 1] -= 0.8
    return o, t


CASES = [dict(), dict(flat=True), dict(clipped=True), dict(shape=(1, 50, 50, 2))]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "gradient_loss"])
def test_basic_losses_match_jax(rng, case, name):
    o, t = _pair(rng, **case)
    got = getattr(pl, name)(torch.from_numpy(o), torch.from_numpy(t))
    want = getattr(jl, name)(jnp.asarray(o), jnp.asarray(t))
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_ssim_matches_jax(rng, case):
    o, t = _pair(rng, **case)
    o01, t01 = (o + 1) / 2, (t + 1) / 2
    got = pl.ssim(torch.from_numpy(o01), torch.from_numpy(t01)).numpy()
    want = np.asarray(jl.ssim(jnp.asarray(o01), jnp.asarray(t01)))
    assert got.shape == (o.shape[0],)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if case.get("flat"):
        # A constant image against itself, the one ill-conditioned case:
        # sigma_xx is clamped at 0 and sigma_xy is not, so the sign of the
        # rounding residue of E[x^2] - mu^2 (about 1e-8; the two blurs sum
        # in other orders) moves SSIM by 2|residue| / C2, 7e-5 here.
        same = pl.ssim(torch.from_numpy(o01[:1]), torch.from_numpy(o01[:1]))
        want = jl.ssim(jnp.asarray(o01[:1]), jnp.asarray(o01[:1]))
        np.testing.assert_allclose(same.numpy(), np.asarray(want), atol=1e-4)


def test_ssim_downsamples_large_tiles(rng):
    """min(H, W) / 256 rounds to 2 at 512: the average-pool downsampling."""
    o, t = _pair(rng, shape=(1, 512, 384, 1))
    got = pl.ssim(torch.from_numpy(o), torch.from_numpy(t), data_range=2.0)
    want = jl.ssim(jnp.asarray(o), jnp.asarray(t), data_range=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["mse", "mse-gradient", "l1-gradient-ssim"])
def test_combined_losses_and_gradients_match_jax(rng, case, name):
    o, t = _pair(rng, **case)
    want, vjp = jax.vjp(lambda a: jl.get_loss_fn(name)(a, jnp.asarray(t)), jnp.asarray(o))
    ot = torch.tensor(o, requires_grad=True)
    got = pl.get_loss_fn(name)(ot, torch.from_numpy(t))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), atol=1e-5, err_msg=k)
    got["total"].backward()
    cot = {k: jnp.asarray(1.0 if k == "total" else 0.0) for k in want}
    (dref,) = vjp(cot)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(dref), atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_all_and_per_sample_losses_match_jax(rng, case):
    o, t = _pair(rng, **case)
    got = pl.compute_all_loss(torch.from_numpy(o), torch.from_numpy(t))
    want = jl.compute_all_loss(jnp.asarray(o), jnp.asarray(t))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, err_msg=k)
    got = per_sample_losses(torch.from_numpy(o), torch.from_numpy(t))
    want = jax_per_sample(jnp.asarray(o), jnp.asarray(t))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_bf16_outputs_reduce_in_f32(rng):
    o, t = _pair(rng)
    ob = torch.from_numpy(o).bfloat16()
    for name in ("mse", "mse-gradient", "l1-gradient-ssim"):
        out = pl.get_loss_fn(name)(ob, torch.from_numpy(t))
        assert all(v.dtype == torch.float32 for v in out.values()), name


def test_unknown_loss_raises():
    with pytest.raises(NotImplementedError, match="available"):
        pl.get_loss_fn("huber")
