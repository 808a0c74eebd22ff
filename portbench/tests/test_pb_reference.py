"""The plain reference against the program at a tiny size on the CPU, in f32.

The reference must compute what the program computes, so that a gap between
them on the card is the program's precision or a fault: the forward of both
families under both LSTM maskings, one training step (loss, the gradient as
AdamW's first moment holds it, the update), the planner's input assembly and
the evaluation metrics.
"""

import numpy as np
import pytest
import torch

from portbench import inputs, weights
from portbench.entries import common
from portbench.reference import metrics as ref_metrics
from portbench.reference import planner as ref_planner
from portbench.reference import train as ref_train
from portbench.reference.model import Reference
from portbench.tests import tiny

CFG = {**tiny.harness_cfg("unet64"), **tiny.CFG}
CFG_PP = {**tiny.harness_cfg("unetpp32"), **tiny.CFG}


def port_model(cfg, mask_mode, seed=3):
    from maunet_tpu_torch.models.factory import UrbanPredictor

    m = UrbanPredictor(model_type=cfg["model_type"], temporal_dim=cfg["temporal_dim"],
                       meta_dim=cfg["meta_dim"], lstm_dim=cfg["lstm_hidden"],
                       base_filters=cfg["base_filters"], lstm_mask_mode=mask_mode,
                       compute_dtype=torch.float32)
    m.load_state_dict(weights.make(cfg, seed, "cpu"))
    return m


def batch(side=32, b=3, t=32, seed=5):
    return inputs.tile_batch(torch.Generator().manual_seed(seed), b, side, t, (7, 32), "cpu")


def meta(bt):
    return torch.cat([bt["metadata"], bt["t1_dates"], bt["t2_dates"]], 1)


def test_state_dict_keys_are_the_programs():
    for cfg in (CFG, CFG_PP):
        assert set(Reference(cfg).state_dict()) == set(port_model(cfg, "per_sample").state_dict())


@pytest.mark.parametrize("family", ["unet", "unet++"])
@pytest.mark.parametrize("mask_mode", ["per_sample", "batch_max"])
def test_forward_matches_program(family, mask_mode):
    cfg = CFG if family == "unet" else CFG_PP
    bt = batch()
    ref = common.reference(cfg, 3, "cpu")
    port = port_model(cfg, mask_mode).eval()
    with torch.no_grad():
        want = ref(bt["maps"], bt["temp_series"], meta(bt), bt["temp_lengths"],
                   mask_mode=mask_mode)
        got = port(bt["maps"], bt["temp_series"], meta(bt), bt["temp_lengths"])
    assert common.rel_err(got.numpy(), want.numpy()) < 1e-5


def test_masking_modes_differ():
    """The lengths reach the output: the two maskings give different answers."""
    bt = batch()
    ref = common.reference(CFG, 3, "cpu")
    with torch.no_grad():
        a = ref(bt["maps"], bt["temp_series"], meta(bt), bt["temp_lengths"], mask_mode="per_sample")
        b = ref(bt["maps"], bt["temp_series"], meta(bt), bt["temp_lengths"], mask_mode="batch_max")
    assert common.rel_err(a.numpy(), b.numpy()) > 1e-4


def test_train_step_matches_program():
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import train_step

    bt = batch(b=4)
    port = port_model(CFG, "per_sample").train()
    opt = make_optimizer(port.parameters(), "adamw", 1e-4, 1e-3)
    out = train_step(TrainState(port, opt, 0), bt, get_loss_fn("l1-gradient-ssim"))
    ref = common.reference(CFG, 3, "cpu")
    params = dict(ref.named_parameters())
    y = ref(bt["maps"], bt["temp_series"], meta(bt), bt["temp_lengths"], train=True)
    loss = ref_train.loss(y, bt["targets"])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(float(out["total"]) - float(loss.detach())) < 1e-5 * float(loss.detach())
    before = {n: p.detach().clone() for n, p in params.items()}
    ref_train.AdamW(params, 1e-4, 1e-3).step(grads)
    norms = {n: float(g.norm()) for n, g in grads.items()}
    median = float(np.median(list(norms.values())))
    for n, p in port.named_parameters():
        g = opt.state[p]["exp_avg"] / 0.1
        if norms[n] < 1e-3 * median:  # a conv bias before train-mode BatchNorm
            assert float(g.norm()) == 0.0
            continue
        assert float((g - grads[n]).norm()) <= 1e-4 * max(norms[n], median), n
        # Adam's first step is g / |g|: compare the step's norm, which an
        # element whose gradient is of the order of eps cannot move.
        got, want = (p.detach() - before[n]).norm(), (params[n].detach() - before[n]).norm()
        assert abs(float(got - want)) <= 1e-4 * float(want), n


def test_planner_assembly_matches_program():
    from maunet_tpu_torch.apps.engine import PlannerEngine

    rng = np.random.default_rng(4)
    layers = inputs.planner_layers(rng, 64)
    place = inputs.planner_place(rng)
    canvas = inputs.canvas(rng, 64, 24)
    canvas[::7, ::5, 3] = 128  # antialiased edges: partly transparent, off-palette
    canvas[::7, ::5, :3] = rng.integers(0, 256, canvas[::7, ::5, :3].shape)
    src = inputs.SeriesSource()
    src.add(rng, place["lat"], place["lon"], 20)
    engine = PlannerEngine.__new__(PlannerEngine)
    engine.stats, engine.temp_query, engine.temporal_length = common.stats(CFG), src, 32
    engine.metadata_features = 8
    args = [place[k] for k in ("lat", "lon", "population", "year_t1", "month_t1",
                               "year_t2", "month_t2")]
    for c in (None, canvas):
        got = engine.prepare_input(layers, c, *args)
        want = ref_planner.assemble(layers, c, *args, CFG["serving_stats"],
                                    src.query(place["lat"], place["lon"], 0, 0), 32)
        for g, w in zip((got.maps, got.metadata, got.temp_series, got.temp_lengths), want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g.astype(np.float64) - w).max() <= 1e-6


def test_metrics_match_program():
    from maunet_tpu_torch.evaluate.metrics import dw_map_from_input, eval_metrics

    bt = batch(b=2)
    pred = ref_metrics.unnormalise(torch.tanh(bt["targets"] + 0.3 * torch.randn(
        bt["targets"].shape, generator=torch.Generator().manual_seed(1))), CFG["serving_stats"])
    target = ref_metrics.unnormalise(bt["targets"], CFG["serving_stats"])
    got = eval_metrics(pred, target, dw_map_from_input(bt["maps"]))
    want = ref_metrics.metrics(pred, target, bt["maps"])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
