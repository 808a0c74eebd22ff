#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``maunet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each (or a few for the kernel table):

1. device: exits non-zero without CUDA; prints ``nvidia-smi``'s card name
   and power limit;
2. build: compiles ``maunet_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes its path gives it, with the tolerance stated
   below, and both times from CUDA events (median of 10 after 3 warm-up
   runs);
4. golden: the small U-Net of ``tests/fixtures/golden_unet.npz`` runs on
   the card in bf16 and is held against the JAX package's recorded f32
   output;
5. serving path: a full-width serving U-Net (base 64, LSTM 96, T = 828,
   bf16) with seeded random weights and BatchNorm statistics is saved as a
   reference-layout ``.pth`` and served through ``PlannerEngine`` on the
   card: three ``predict`` requests (256², 256² with a painted canvas, 250²)
   and one ``predict_many`` over 8 requests at 256².  The launch counters of
   A, B and C must rise in this phase.  The same batch is then run with the
   plain versions patched in, and the two outputs are compared;
6. training path: ``TrainConfig``'s defaults (the JAX package's: U-Net base
   64, LSTM 96, bf16, batch 16, AdamW lr 1e-4 wd 1e-3, l1-gradient-ssim) on
   a synthetic dataset of 256² tiles with T = 828 (48 train and 16 val
   samples, seeded): ``Trainer.train(epochs=1)``, then a second ``Trainer``
   resumes for epoch 2.  Losses and val losses must be finite, the step
   count must carry across the resume, and the best and last ``.pth`` must
   exist.  The counters of E, F, dW and C must rise in the train steps, and
   those of A and B in validation.  From one saved state, one train step
   with the kernels and one with the plain versions patched in are compared;
   the best checkpoint then serves a ``predict`` through ``PlannerEngine``;
   and the train step is timed (host clock around synchronised steps).

The line before the last is the kernel summary JSON: per kernel the launch
count of its path (A, B, C: serving; E, F, dW: training), and over that
path's shapes in phase 3 (B = 8 at 256² for A and C, B = 8 for B, B = 16
for E, F and dW; one launch per distinct shape) the largest error against
the plain version and the summed kernel and plain times.  The other shapes
of phase 3 are pass/fail checks printed on their own lines.  The last line
is ``{"ok": true, "device": {...}}``.  Any failure raises, and the script
then exits non-zero without printing either line.

Tolerances (the plain versions compute in f32 from the same bf16 operands):
  conv3x3_fused, resize (bf16): |kernel - plain| <= 1e-2 + 1e-2 |plain|,
    one bf16 ulp of the shared f32 result, since the two sum in other orders;
  resize (f32) <= 1e-5 + 1e-5 |plain|;
  lstm, lstm stash forward (f32, 828 steps): h_last, h_all, c_all <= 1e-4;
  lstm backward (f32): dx_proj <= 1e-4 + 1e-4 |plain|;
  lstm dW (f32, a sum of B * T terms, 13,248 at B = 16):
    <= 1e-4 + 1e-3 max|plain|;
  golden fixture, bf16 against f32: <= 3e-2 (the port's bf16 forward on
    the CPU is 6.4e-3 from it, on outputs up to 0.85);
  serving path, kernels vs plain versions, bf16 end to end: the output's max
    difference <= 5% of its largest magnitude (rounding flips of one bf16
    ulp in the conv and resize outputs, carried through 18 convs);
  training step, kernels vs plain versions, bf16: loss within 1% and
    gradient global norm within 5% (the same one-ulp flips in the resize
    outputs, carried through the decoder forward and back; the resize's
    backward runs in bf16 with bf16 interpolation weights, as JAX's does,
    where autograd through the plain version runs in f32; and cuDNN's
    backward sums in no fixed order).
TF32 is off for cuDNN and matmuls, so the plain versions run in full f32.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
T_SERIES = 828
# The LSTM lengths of phase 3's training-batch checks of E, F and dW.
TRAIN_LENGTHS = [828, 828, 700, 600, 414, 300, 100, 1, 0, 827, 828, 500, 828, 64, 828, 2]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "tests", "fixtures", "golden_unet.npz")
GOLDEN_TOL = 3e-2


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median device time of ``fn`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class KernelTable:
    """Per-kernel results of phase 3."""

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def check(self, name: str, label: str, kernel, plain, atol: float,
              rtol: float, on_path: bool = False) -> None:
        """Compare ``kernel()`` with ``plain()`` (a tensor, or a tuple of
        tensors compared one by one); a shape of the kernel's own path
        (``on_path``) also enters the kernel's summary row."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = rel = 0.0
        ok = True
        for a, b in pairs:
            diff = (a.float() - b.float()).abs()
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / b.float().abs().clamp_min(1e-6)).max()))
            ok &= bool(torch.isfinite(a).all()) and bool(
                (diff <= atol + rtol * b.float().abs()).all())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        print(f"kernel {name} {label}{' [path]' if on_path else ''}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=({atol:g} + {rtol:g}|plain|) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        if not on_path:
            return
        row = self.rows.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms


def check_kernels(table: KernelTable, dev) -> None:
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    # A: the level-0 convs (conv0_0.conv1 reads the 23 input channels as they
    # are; conv0_1.conv1 reads the [64 skip | 128 upsampled] concat) at the
    # predict_many batch (B=8), at B=2, and at B=1 on a 250² tile as predict
    # serves it; then the compact embedding term, and two odd sizes (the
    # second with two output-channel tiles).
    bf = torch.bfloat16
    level0 = [(23,), (64,), (64, 128)]
    # (batch, (H, W), input parts' channels, cout, with add, on the path)
    a_cases = ([(8, (256, 256), cins, 64, False, True) for cins in level0]
               + [(2, (256, 256), cins, 64, False, False) for cins in level0]
               + [(1, (250, 250), cins, 64, False, False) for cins in level0]
               + [(2, (256, 256), (64,), 64, True, False),
                  (2, (125, 125), (23, 40), 48, True, False),
                  (2, (33, 47), (16,), 80, True, False)])
    for b, hw, cins, cout, with_add, on_path in a_cases:
        parts = [randn(b, *hw, c, dtype=bf) for c in cins]
        fan_in = 9 * sum(cins)
        weights = [randn(cout, c, 3, 3, std=math.sqrt(2 / fan_in)) for c in cins]
        scale = 0.5 + torch.rand(cout, generator=g, device=dev)
        bias = randn(cout, std=0.1)
        add = randn(b, 3, hw[1], cout, std=0.5) if with_add else None
        kw = dict(scale=scale, bias=bias, add=add, relu=True)
        table.check("conv3x3_fused", f"{[(b, *hw, c) for c in cins]}->{cout}"
                    f"{' +add' if with_add else ''}",
                    lambda: packed_vgg.conv3x3_fused(parts, weights, **kw),
                    lambda: packed_vgg.conv3x3_fused_plain(parts, weights, **kw),
                    1e-2, 1e-2, on_path)

    # B: the temporal encoder's recurrence at the predict_many batch with
    # mixed lengths, and at B=1 (predict).
    hidden = 96

    def lstm_case(lens):
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        x_proj = randn(len(lens), T_SERIES, 4 * hidden, std=0.5)
        w_hh = (torch.rand((hidden, 4 * hidden), generator=g, device=dev) * 2 - 1) / math.sqrt(hidden)
        return lens, x_proj, w_hh, f"({len(lens)}, {T_SERIES}, {4 * hidden}) lengths={lens.tolist()}"

    for lens, on_path in [([828, 828, 600, 414, 100, 1, 0, 827], True), ([828], False)]:
        lens, x_proj, w_hh, label = lstm_case(lens)
        table.check("lstm_last_hidden", label,
                    lambda: lstm.lstm_last_hidden(x_proj, w_hh, lens),
                    lambda: lstm.lstm_last_hidden_scan(x_proj, w_hh, lens), 1e-4, 0.0,
                    on_path)

    # E, F and dW: the training batch (B=16, the trainer's default) with
    # mixed lengths, and B=1.  F and dW read the plain version's stash, so
    # both sides see the same inputs; the plain F also forms dW.
    for lens, on_path in [(TRAIN_LENGTHS, True), ([828], False)]:
        lens, x_proj, w_hh, label = lstm_case(lens)
        grad = randn(len(lens), hidden)
        table.check("lstm_forward_stash", label,
                    lambda: lstm.lstm_forward_stash(x_proj, w_hh, lens),
                    lambda: lstm.lstm_forward_stash_plain(x_proj, w_hh, lens), 1e-4, 0.0,
                    on_path)
        _, h_all, c_all = lstm.lstm_forward_stash_plain(x_proj, w_hh, lens)
        table.check("lstm_backward", label,
                    lambda: lstm.lstm_backward(x_proj, w_hh, lens, h_all, c_all, grad),
                    lambda: lstm.lstm_backward_plain(x_proj, w_hh, lens, h_all, c_all, grad)[0],
                    1e-4, 1e-4, on_path)
        dx = lstm.lstm_backward(x_proj, w_hh, lens, h_all, c_all, grad)
        want = lstm.lstm_dw_plain(h_all, dx, lens)
        table.check("lstm_dw", label, lambda: lstm.lstm_dw(h_all, dx, lens),
                    lambda: lstm.lstm_dw_plain(h_all, dx, lens),
                    1e-4 + 1e-3 * float(want.abs().max()), 0.0, on_path)
        if not torch.equal(lstm.lstm_dw(h_all, dx, lens), lstm.lstm_dw(h_all, dx, lens)):
            raise AssertionError("lstm_dw: two launches on the same inputs differ")

    # C: the four decoder upsamples at B=8, two of them at the training
    # batch (B=16); the bottleneck's double
    # interpolation of a 250² tile at B=1 (15 -> 30, then the odd fix-up
    # 30 -> 31); one f32 case and one channel count that takes the kernel's
    # one-channel-per-thread path.
    for shape, out_hw, dtype, tol, on_path in [
            ((8, 16, 16, 1024), (32, 32), bf, 1e-2, True),
            ((8, 32, 32, 512), (64, 64), bf, 1e-2, True),
            ((8, 64, 64, 256), (128, 128), bf, 1e-2, True),
            ((8, 128, 128, 128), (256, 256), bf, 1e-2, True),
            ((16, 16, 16, 1024), (32, 32), bf, 1e-2, False),   # the training batch
            ((16, 128, 128, 128), (256, 256), bf, 1e-2, False),
            ((1, 15, 15, 1024), (30, 30), bf, 1e-2, False),
            ((1, 30, 30, 1024), (31, 31), bf, 1e-2, False),
            ((2, 15, 15, 64), (30, 30), torch.float32, 1e-5, False),
            ((2, 15, 15, 3), (30, 31), bf, 1e-2, False)]:
        x = randn(*shape, dtype=dtype)
        table.check("resize_pack", f"{shape}->{out_hw} {str(dtype).split('.')[-1]}",
                    lambda: resize_pack.resize_pack(x, out_hw),
                    lambda: resize_pack.resize_pack_plain(x, out_hw), tol, tol, on_path)


def check_golden(dev) -> None:
    """The port's U-Net on the card against the JAX package's recorded
    output (``tests/fixtures/golden_unet.npz``: 50² tiles, base 4, lengths
    40 and 25).  At base 4 every conv runs kernel A, the bottleneck's with
    the embedding term, and the odd 50 -> 25 -> 12 chain runs C's fix-ups."""
    from maunet_tpu_torch.interop.from_jax import state_dict_from_jax, variables_from_flat
    from maunet_tpu_torch.interop.torch_import import infer_hyperparams
    from maunet_tpu_torch.models.factory import build_model

    with np.load(GOLDEN) as z:
        state_dict = state_dict_from_jax(variables_from_flat(z))
        inputs = [torch.from_numpy(z[k]).to(dev) for k in ("maps", "series", "meta", "lengths")]
        expected = z["expected"]
    model = build_model(infer_hyperparams(state_dict))
    model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        got = model.to(dev)(*inputs).cpu().numpy()
    err = float(np.abs(got - expected).max())
    print(f"golden fixture (bf16 on the card vs the f32 JAX output): "
          f"max_abs_err={err:.4e} tol={GOLDEN_TOL:g}")
    if got.shape != expected.shape or not err <= GOLDEN_TOL:
        raise AssertionError("the port disagrees with golden_unet.npz")


def randomize_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights that keep activations O(1) through the ReLU stack (He
    normal convs) and non-trivial BatchNorm statistics."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() == 4:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2 / fan_in))
            elif p.dim() == 2 and "lstm" not in name:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
            elif ".bn" in name and leaf == "weight":
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=gen))
            elif "lstm" in name:
                bound = 1 / math.sqrt(p.shape[0] // 4)
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        # Metadata features 4..7 are raw years and months (about 2000 and
        # 6); scale their weights so the MLP sees O(1) pre-activations.
        model.model.meta_encoder.fc[0].weight[:, 4:] *= 1e-3
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.8 + 0.4 * torch.rand(buf.shape, generator=gen))


class StubTempQuery:
    """Seeded stand-in for the CRU temperature query: full 828-month series
    north of the equator, shorter ones south of it."""

    def query(self, lat, lon, year, month):
        rng = np.random.default_rng([SEED, int(abs(lat) * 1000), int(abs(lon) * 1000)])
        n = T_SERIES if lat >= 0 else 500 + int(rng.integers(0, 300))
        return 20.0 + 5.0 * rng.standard_normal(n)


def make_layers(rng: np.random.Generator, hw: int) -> dict[str, np.ndarray]:
    return {
        "dw": rng.integers(0, 9, size=(hw, hw)).astype(np.float32),
        "rgb": rng.uniform(0, 255, size=(3, hw, hw)).astype(np.float32),
        "ndvi": rng.uniform(-1, 1, size=(hw, hw)).astype(np.float32),
        "temp": rng.uniform(10, 45, size=(hw, hw)).astype(np.float32),
    }


def check_outputs(label: str, ndvi: np.ndarray, lst: np.ndarray, hw: int) -> None:
    if ndvi.shape != (hw, hw) or lst.shape != (hw, hw):
        raise AssertionError(f"{label}: shapes {ndvi.shape}, {lst.shape} != {(hw, hw)}")
    if not (np.isfinite(ndvi).all() and np.isfinite(lst).all()):
        raise AssertionError(f"{label}: non-finite output")
    if np.abs(ndvi).max() > 1.0:
        raise AssertionError(f"{label}: NDVI outside [-1, 1]")


def serving_path(dev, tmpdir: str) -> dict[str, int]:
    from maunet_tpu_torch.apps.engine import CANVAS_RGB, PlannerEngine
    from maunet_tpu_torch.models.factory import build_model
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack

    hp = {"model_type": "unet", "base_filters": 64, "temporal_dim": 64,
          "meta_dim": 64, "lstm_hidden": 96, "temporal_embeddings": True,
          "metadata_embeddings": True, "metadata_input_length": 8}
    model = build_model(hp, lstm_mask_mode="batch_max")
    randomize_(model, torch.Generator().manual_seed(SEED))
    path = os.path.join(tmpdir, "unet64.pth")
    torch.save({"model_state_dict": model.state_dict(), "hyperparameters": hp,
                "model_type": "unet", "metadata_input_length": 8}, path)
    del model
    engine = PlannerEngine(path, device=dev, temp_query=StubTempQuery(),
                           temporal_length=T_SERIES)
    rng = np.random.default_rng(SEED)
    served = (packed_vgg.conv3x3_fused, lstm.lstm_last_hidden, resize_pack.resize_pack)
    for fn in served:
        fn.launches = 0

    layers = make_layers(rng, 256)
    args = (2_800_000, 2023, 7, 2025, 7)
    base = engine.prepare_input(layers, None, 41.9, 12.5, *args)
    canvas = np.zeros((256, 256, 4), np.uint8)
    canvas[64:192, 64:192, :3] = CANVAS_RGB[1]   # paint trees
    canvas[64:192, 64:192, 3] = 255
    painted = engine.prepare_input(layers, canvas, 41.9, 12.5, *args)
    odd = engine.prepare_input(make_layers(rng, 250), None, -23.5, -46.6, *args)
    ndvi0, lst0 = engine.predict(base)
    check_outputs("predict 256²", ndvi0, lst0, 256)
    ndvi1, lst1 = engine.predict(painted)
    check_outputs("predict 256² painted", ndvi1, lst1, 256)
    cooling = engine.cooling_metric(lst0, lst1)
    if not math.isfinite(cooling):
        raise AssertionError("cooling metric is not finite")
    ndvi2, lst2 = engine.predict(odd)
    check_outputs("predict 250²", ndvi2, lst2, 250)

    batch = [engine.prepare_input(make_layers(rng, 256), None,
                                  float(rng.uniform(-60, 60)),
                                  float(rng.uniform(-180, 180)), *args)
             for _ in range(8)]
    many = engine.predict_many(batch)
    for i, (nd, ls) in enumerate(many):
        check_outputs(f"predict_many[{i}]", nd, ls, 256)
    launches = {fn.__name__: fn.launches for fn in served}
    print(f"serving path: predict x3 + predict_many x8 ok, cooling={cooling:.4f} °C, "
          f"launches={launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

    # The same batch through the plain versions, on the card.
    with mock.patch.object(packed_vgg, "conv3x3_fused", packed_vgg.conv3x3_fused_plain), \
            mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
            mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain):
        plain = engine.predict_many(batch)
    got = np.stack([np.stack([nd, (ls - engine.stats.temp_mean) / engine.stats.temp_std])
                    for nd, ls in many])
    want = np.stack([np.stack([nd, (ls - engine.stats.temp_mean) / engine.stats.temp_std])
                     for nd, ls in plain])
    diff = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"serving path vs plain versions: max_abs_diff={diff:.4e} "
          f"(output max |x| {scale:.4f}, tol {0.05 * max(scale, 1.0):.4f})")
    if diff > 0.05 * max(scale, 1.0):
        raise AssertionError("serving path disagrees with its plain versions")

    host_ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict_many(batch)
        torch.cuda.synchronize()
        if i >= 1:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"predict_many (8 x 256², bf16): {statistics.median(host_ms):.3f} ms per batch "
          f"(host clock, median of {len(host_ms)}, inputs and outputs copied)")
    return launches


def wrappers() -> dict:
    """Every kernel wrapper, by name; each counts its launches."""
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack

    return {fn.__name__: fn for fn in (
        packed_vgg.conv3x3_fused, lstm.lstm_last_hidden, resize_pack.resize_pack,
        lstm.lstm_forward_stash, lstm.lstm_backward, lstm.lstm_dw)}


TRAIN_SAMPLES = {"train": 48, "val": 16}


def train_path(dev, tmpdir: str) -> dict[str, int]:
    """Phase 6: ``Trainer`` at the default full-width config, one epoch and
    a resumed second, then the kernels-vs-plain step, serving the result and
    the step time."""
    from maunet_tpu_torch.apps.engine import PlannerEngine
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.data.synthetic import generate_dataset
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.ops.kernels import lstm, resize_pack
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.train.steps import train_step

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(tmpdir, "data"), TRAIN_SAMPLES, hw=256,
                            temporal_len=T_SERIES, seed=SEED)
    print(f"training data: {TRAIN_SAMPLES} samples of 256², T = {T_SERIES}, "
          f"in {time.perf_counter() - t0:.1f} s")
    cfg = TrainConfig(frequency_log=1)
    work = os.path.join(tmpdir, "train")
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    r1 = Trainer(cfg, data, work_dir=work, study_name="smoke", device=dev).train(epochs=1)
    trainer = Trainer(cfg, data, work_dir=work, study_name="smoke", device=dev)
    r2 = trainer.train(epochs=2, resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    steps_per_epoch = TRAIN_SAMPLES["train"] // cfg.batch_size
    with open(os.path.join(work, "smoke_trial0_train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(v) for r in rows for k, v in r.items() if "loss" in k]
    val = [r1.history[0]["val_loss"], r2.history[0]["val_loss"]]
    print(f"training path: 2 epochs x {steps_per_epoch} steps across a resume in "
          f"{wall:.1f} s, train loss {[round(h['train_loss'], 5) for h in r1.history + r2.history]}, "
          f"val loss {[round(v, 5) for v in val]}, step {trainer.state.step}, "
          f"launches={launches}")
    if not (all(map(math.isfinite, losses + val)) and len(rows) == 2 * steps_per_epoch):
        raise AssertionError("training path: a loss is not finite, or a step was not logged")
    if [int(r["step"]) for r in rows] != list(range(2 * steps_per_epoch)) \
            or trainer.state.step != 2 * steps_per_epoch or r2.epochs_run != 2:
        raise AssertionError("training path: the step count did not carry across the resume")
    best = os.path.join(work, "smoke_trial_0_best.pth")
    for path in (best, os.path.join(work, "smoke_trial_0_last.pth")):
        if not os.path.exists(path):
            raise AssertionError(f"training path: {path} was not written")
    steps = 2 * steps_per_epoch
    if not (launches["lstm_forward_stash"] == launches["lstm_backward"]
            == launches["lstm_dw"] == steps):
        raise AssertionError(f"training path: E, F and dW must launch once per step ({steps})")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: {missing}")

    # One step with the kernels and one with the plain versions, from one state.
    state = trainer.state
    model_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    ds = NpzDataset(os.path.join(data, "train"), T_SERIES)
    batch = to_device(host_tensors(next(make_batches(ds, cfg.batch_size)),
                                   pin=dev.type == "cuda"), dev)
    loss_fn = get_loss_fn(cfg.loss)
    got = {k: float(v) for k, v in train_step(state, batch, loss_fn).items()}
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)
    with mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
            mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain):
        want = {k: float(v) for k, v in train_step(state, batch, loss_fn).items()}
    loss_rel = abs(got["total"] - want["total"]) / abs(want["total"])
    norm_rel = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    print(f"train step, kernels vs plain versions: loss {got['total']:.6f} vs "
          f"{want['total']:.6f} (rel {loss_rel:.3e}, tol 1e-2), grad_norm "
          f"{got['grad_norm']:.6f} vs {want['grad_norm']:.6f} (rel {norm_rel:.3e}, tol 5e-2)")
    if not (loss_rel <= 1e-2 and norm_rel <= 5e-2):
        raise AssertionError("training step disagrees with its plain versions")

    engine = PlannerEngine(best, device=dev, temp_query=StubTempQuery(),
                           temporal_length=T_SERIES)
    rng = np.random.default_rng(SEED + 1)
    ndvi, lst = engine.predict(engine.prepare_input(
        make_layers(rng, 256), None, 45.76, 4.84, 520_000, 2023, 7, 2025, 7))
    check_outputs("predict 256² from the trained checkpoint", ndvi, lst, 256)
    print(f"serving the trained checkpoint: predict 256² ok, mean LST {float(lst.mean()):.3f}")

    host_ms = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, loss_fn)
        torch.cuda.synchronize()
        if i >= 2:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(host_ms)
    print(f"train step ({cfg.batch_size} x 256², T = {T_SERIES}, bf16, {cfg.optimizer}, "
          f"{cfg.loss}): {ms:.3f} ms/step, {cfg.batch_size / ms * 1e3:.1f} tiles/s "
          f"(host clock around synchronised steps, median of {len(host_ms)} after 2 warm-up)")
    return launches


LSTM_CU = "maunet_tpu_torch/csrc/lstm.cu"
# name: (source, TPU kernel replaced, the path whose launches the summary gives)
KERNEL_INFO = {
    "conv3x3_fused": ("maunet_tpu_torch/csrc/conv3x3_fused.cu",
                      "maunet_tpu/ops/pallas/packed_vgg.py:451", "serving"),
    "lstm_last_hidden": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:402", "serving"),
    "resize_pack": ("maunet_tpu_torch/csrc/resize_pack.cu",
                    "maunet_tpu/ops/pallas/resize_pack.py:216", "serving"),
    "lstm_forward_stash": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:290", "training"),
    "lstm_backward": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:334", "training"),
    # the dW sum that the TPU backward keeps in its body (lstm.py:266)
    "lstm_dw": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:334", "training"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from maunet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    table = KernelTable()
    check_kernels(table, dev)
    check_golden(dev)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches = {"serving": serving_path(dev, tmpdir), "training": train_path(dev, tmpdir)}

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[path][name], **table.rows[name]}
               for name, (src, replaces, path) in KERNEL_INFO.items()]
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
