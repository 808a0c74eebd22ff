"""The PyTorch port's evaluation metrics against the JAX package, scipy and
numpy, on the CPU, where the per-class sums take their plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from maunet_tpu.data.schema import NormalizationStats as JaxStats
from maunet_tpu.evaluate import metrics as jax_metrics
from maunet_tpu.ops.pallas.masked_stats import masked_class_sums as jax_masked_class_sums
from maunet_tpu.utils import dw as jax_dw
from maunet_tpu.utils.tracking import make_emb_tag as jax_make_emb_tag

from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.evaluate import metrics
from maunet_tpu_torch.evaluate.evaluator import make_emb_tag
from maunet_tpu_torch.ops.kernels import masked_stats
from maunet_tpu_torch.utils import dw

# (B, H, W, C): the evaluator's two channels on an even and an odd size, and
# the kernel's other channel counts.
SHAPES = [(2, 32, 32, 2), (3, 25, 19, 2), (1, 50, 50, 1), (2, 16, 8, 3)]


def _case(shape, seed=0, absent=(4,)):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    dw_map = rng.integers(0, 9, size=shape[:3]).astype(np.int32)
    for k in absent:                       # a class no pixel has
        dw_map[dw_map == k] = (k + 1) % 9
    dw_map[0, :2, :2] = 7                  # and one that sample 0 surely has
    return pred, target, dw_map


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference", ["pallas-interpret", "xla"])
def test_masked_class_sums_plain_matches_jax(shape, reference):
    pred, target, dw_map = _case(shape)
    if reference == "xla":
        err = jnp.asarray(pred - target)
        want = jax_metrics._class_sums_xla(jnp.abs(err), err * err, jnp.asarray(dw_map))
    else:
        want = jax_masked_class_sums(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(dw_map), interpret=True)
    got = masked_stats.masked_class_sums(*(torch.from_numpy(a) for a in (pred, target, dw_map)))
    b, _, _, c = shape
    assert [tuple(g.shape) for g in got] == [(b, c, 9), (b, c, 9), (b, 9)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert not got[2][:, 4].any() and got[2][0, 7] >= 4     # absent and present


def test_masked_class_sums_ignores_out_of_range_classes_and_subtracts_in_dtype():
    pred, target, dw_map = _case((2, 16, 16, 2), seed=1)
    inside = [torch.from_numpy(a) for a in (pred, target, dw_map)]
    want = masked_stats.masked_class_sums_plain(*inside)
    dw_out = dw_map.copy()
    dw_out[0, :4] = 11
    dw_out[1, 5:7] = -2
    got = masked_stats.masked_class_sums(inside[0], inside[1], torch.from_numpy(dw_out))
    # The relabelled pixels count nowhere: every sum can only shrink.
    assert float(got[2].sum()) == 2 * 16 * 16 - 4 * 16 - 2 * 16
    for g, w in zip(got, want):
        assert (g <= w + 1e-6).all()
    # bf16 inputs: the error is rounded to bf16 before it is widened
    # (masked_stats.py:65), so it differs from the f32 error.
    pb, tb = inside[0].bfloat16(), inside[1].bfloat16()
    sum_abs = masked_stats.masked_class_sums(pb, tb, inside[2])[0]
    err = (pb - tb).float().abs()
    np.testing.assert_allclose(float(sum_abs.sum()), float(err.sum()), rtol=1e-5)
    assert float(err.sum()) != float((pb.float() - tb.float()).abs().sum())


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_eval_metrics_match_jax(shape):
    pred, target, dw_map = _case(shape, seed=2)
    want = jax_metrics.eval_metrics(jnp.asarray(pred), jnp.asarray(target),
                                    jnp.asarray(dw_map), backend="xla")
    got = metrics.eval_metrics(*(torch.from_numpy(a) for a in (pred, target, dw_map)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert np.isnan(got["class_mae"].numpy()[:, :, 4]).all()
    assert not got["class_present"][:, 4].any()


def test_laplacian_matches_scipy():
    x = np.random.default_rng(3).normal(size=(2, 3, 17, 23)).astype(np.float32)
    lap = metrics.laplacian(torch.from_numpy(x)).numpy()
    var = metrics.laplacian_variance(torch.from_numpy(x)).numpy()
    for b in range(2):
        for c in range(3):
            want = ndimage.laplace(x[b, c])      # mode='reflect'
            np.testing.assert_allclose(lap[b, c], want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(var[b, c], np.var(want), rtol=1e-4)
    np.testing.assert_allclose(
        lap, np.asarray(jax_metrics.laplacian(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_dw_map_keeps_the_argmax_quirk():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 9, size=(2, 8, 8))
    maps = np.concatenate([np.eye(9, dtype=np.float32)[labels],
                           rng.normal(size=(2, 8, 8, 14)).astype(np.float32)], axis=-1)
    got = metrics.dw_map_from_input(torch.from_numpy(maps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), labels)
    # Not one-hot: argmax(input[c] * c), so class 0 can never win over a
    # positive later channel, whatever its own value.
    soft = rng.uniform(0.05, 1.0, size=(2, 8, 8, 23)).astype(np.float32)
    want = np.asarray(jax_metrics.dw_map_from_input(jnp.asarray(soft)))
    np.testing.assert_array_equal(metrics.dw_map_from_input(torch.from_numpy(soft)).numpy(), want)
    assert (want != soft[..., :9].argmax(-1)).any() and (want > 0).all()


def test_unnormalize_targets_matches_jax():
    fields = ((0.1,) * 3, (1.0,) * 3, 30.0, 5.0, (0.0,) * 4, (1.0,) * 4, 0.0, 1.0)
    arr = np.random.default_rng(5).normal(size=(1, 4, 4, 2)).astype(np.float32)
    got = metrics.unnormalize_targets(torch.from_numpy(arr), NormalizationStats(*fields))
    want = jax_metrics.unnormalize_targets(jnp.asarray(arr), JaxStats(*fields))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy()[..., 0], arr[..., 0])     # NDVI untouched
    assert metrics.unnormalize_targets(torch.from_numpy(arr), None) is not None


def test_copied_constants_equal_their_originals():
    assert dw.DW_CLASSES == jax_dw.DW_CLASSES and dw.HEX_COLORS == jax_dw.HEX_COLORS
    labels = np.arange(-1, 11).reshape(3, 4)
    np.testing.assert_array_equal(dw.dw_to_rgb(labels), jax_dw.dw_to_rgb(labels))
    for flags in [(True, True), (True, False), (False, True), (False, False)]:
        assert make_emb_tag(*flags) == jax_make_emb_tag(*flags)
    assert metrics.NUM_CLASSES == jax_metrics.NUM_CLASSES == len(dw.DW_CLASSES)
