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
   runs).  At its path's shapes each kernel is also timed beside the one
   PyTorch call that computes the same function, where there is one (cuDNN's
   bf16 conv with its epilogue for the convs, ``nn.LSTM`` for the LSTM
   forward, ``F.interpolate`` for the resize, ``einsum`` for dW), and its
   bound is reckoned: the larger of the bytes it must move over 3.35 TB/s
   and the operations it does over the card's peak for their type (989
   TFLOP/s bf16, 67 TFLOP/s f32).  The single-conv kernel is timed with its
   weights prepared once, as a model's blocks keep them; the call with raw
   weights, which prepares them on the fly, must give the same bits and is
   timed beside it (``unprepared_ms``); so is the pair kernel, whose two
   convs' weights are prepared the same way.  The pair kernel is also held
   against the two launches of the single-conv kernel that it replaces.  The shapes that
   an evaluation batch (B = 16) gives A, B and C are checked here as well:
   the U-Net's three convs and four upsamples, U-Net++'s eleven distinct
   base-32 convs (up to five parts plus the embedding term) and its four
   upsamples, and the LSTM at 16 lengths between T/2 and T; B also at the
   sensitivity sweeps' batches (B = 50 and 41, one length each).  A and C
   also run at the planner app's shapes (B = 1, 512²: A's four convs, three
   distinct shapes, and C's four upsamples, the last writing 64 MiB), with
   their bounds and library calls beside them; A also as
   ``train_fused_conv``'s forward (B = 16, 256², no epilogue, weights
   prepared at every call) beside cuDNN's forward conv.  B, E and F
   are also held against their plain versions at the edges of what the
   kernels take (``LSTM_EDGE_CASES``: lengths 0, 1 and T in one batch,
   B = 1, H = 50, 64 and 96, T = 64 and 828).  F is two launches, the gate
   terms of every step and then the recurrence: the first has a row of its
   own (``lstm_gate_terms``) against its plain version, at the training
   batch and at ``LSTM_EDGE_CASES``, compared on the steps t < length that
   it writes.  C runs at every shape of ``RESIZE_CASES``, D at every shape
   of ``MASKED_CASES`` (the evaluation batch, B = 8 and 3 of it, a 250²
   tile, bf16, f16, absent classes, classes outside 0..8, C = 1, 3, 4).
   Two launches of C, D and dW on the same inputs must give the same bits;
4. golden: the small U-Net and U-Net++ of ``tests/fixtures/golden_unet.npz``
   and ``golden_unetpp.npz`` run on the card in bf16 and are held against the
   JAX package's recorded f32 outputs;
5. serving path: a full-width serving U-Net (base 64, LSTM 96, T = 828,
   bf16) with seeded random weights and BatchNorm statistics is saved as a
   reference-layout ``.pth`` and served through ``PlannerEngine`` on the
   card: three ``predict`` requests (256², 256² with a painted canvas, 250²)
   and one ``predict_many`` over 8 requests at 256².  The launch counters of
   A, B and C must rise in this phase, and after the first batch no block
   may fold, lay out or prepare a weight again (this is checked in the
   evaluation and pair phases too).  The same batch is then run with the
   plain versions patched in, and the two outputs are compared;
6. training path: ``TrainConfig``'s defaults (the JAX package's: U-Net base
   64, LSTM 96, bf16, batch 16, AdamW lr 1e-4 wd 1e-3, l1-gradient-ssim) on
   a synthetic dataset of 256² tiles with T = 828 (48 train and 16 val
   samples, seeded): ``Trainer.train(epochs=1)``, then a second ``Trainer``
   resumes for epoch 2.  Losses and val losses must be finite, the step
   count must carry across the resume, and the best and last ``.pth`` must
   exist.  The counters of E, F (both of its launches), dW and C must rise
   in the train steps (E, F and dW once a step), and
   those of A and B in validation.  From one saved state, one train step
   with the kernels and one with the plain versions patched in are compared;
   the best checkpoint then serves a ``predict`` through ``PlannerEngine``;
   and the train step is timed (host clock around synchronised steps).  A
   deep-supervised U-Net++ (base 32) then trains one epoch on the same data.
   The Trainers draw no prediction plot where matplotlib is missing (one
   logged line each, no warning) and one PNG at step 0 where it exists;
6b. training variants: from one seeded state and one batch of the same
   data, one train step at ``TrainConfig``'s defaults three ways: plain,
   with ``train_fused_conv`` (A must launch exactly 4 times, the U-Net's
   level-0 convs, forward only) and with ``remat`` (the same loss bits, the
   running statistics updated once); each step's time (median of 5
   synchronised steps) and peak memory are printed.  A's wrapper must still
   refuse an input that needs a gradient outside the autograd ``Function``.
   Then one U-Net++ (base 32) step with ``train_fused_conv``: A exactly 8
   times (the 64-channel level-1 convs);
7. evaluation path: the split's 40 test samples (256², T = 828; batches of
   16, so the last is padded) go through ``evaluate_checkpoint`` on the card
   for two seeded ``.pth`` checkpoints in the reference layout: the serving
   U-Net (base 64) and U-Net++ at its reference width (base 32, LSTM 96,
   temporal 64, meta 64).  The CSV must exist under its exact name and hold
   40 distinct samples, two finite ``overall`` rows each, and class rows for
   exactly the classes each sample has.  The counters of A, B, C and D must
   rise.  The same call then reads a packed copy of the test split
   (``data/shards.py``) and must give the same rows; both loops' tiles per
   second are printed.  One batch's metrics are then computed with the plain
   versions patched in and compared;
8. pair configuration: the same two models built with ``fuse_pair=True`` run
   one forward at B = 8, 256².  G's counter must rise by the number of
   eligible blocks (2 in the U-Net: ``conv0_0``, ``conv0_1``; 9 in U-Net++:
   ``conv0_0``-``conv0_4``, ``conv1_0``-``conv1_3``), the output must agree
   with the ``fuse_pair=False`` forward, and both forwards are timed in
   turns (off, on, on, off);
9. research command line: on the serving U-Net's checkpoint and phase 7's
   evaluation CSV, ``run_sensitivity`` sweeps the 40 test samples (50
   latitude and 50 longitude variants each, a 20×20 heatmap for each
   highlighted sample) in chunks of 50 variants, one forward a chunk:
   A, B and C must launch exactly 4, 1 and 4 times a chunk and no weight
   may be prepared after the first chunk; the JSON's schema is checked (50
   points a sweep, 20×20 heatmaps, every number finite).  One sample's
   latitude chunk is run again with the plain versions patched in (per
   channel within 1e-2 of the channel's largest mean), and one chunk is
   timed with CUDA events.  ``run_temporal_sensitivity`` then runs 24 of
   the samples at 41 offsets (A, B and C at B = 41).  The command line's
   ``bench`` runs the inference, lstm (the plain recurrence at 5
   iterations, best of 2) and eval suites on the card, each row printed on
   a line of its own (the train suite is left out to keep the script's
   time: the study below trains), and its ``train`` runs a one-trial study
   of one epoch on phase 6's data, which must end ``COMPLETE``;
10. planner: the Urban Greening Planner app (``apps/planner.py``) runs
   headless (``apps/headless.run_planner``) with ``--device cuda``, its
   default ``--img-size 512``, ``--temporal-length 828``, an empty cache
   directory (so the bundled demo tiles are resized 256 -> 512), a
   ``models/`` directory holding phase 5's checkpoint, the scripted answer
   ``Run Prediction`` and a canvas with a 256² block of trees painted over
   the tile's centre.  It must run in cache-only mode, render 7 images and
   call the canvas, give a finite mean-ΔT metric, launch A, B and C exactly
   8, 2 and 8 times (two predicts), and prepare nothing after the first
   predict.  The same two requests through the plain versions must agree
   within 5% of the output's largest magnitude, as in phase 5; one
   ``predict`` at 512² is timed (CUDA events around the forward on inputs on
   the card, the host clock around the call);
11. science loop: ``analysis.science.run_science_loop`` on the card at the
   JAX defaults cut to 48/16/24 samples and 2 epochs (64², T = 828, base 16,
   batch 8): the four ablation variants train, evaluate, sweep and go
   through the statistics.  The four evaluation CSVs, the t-tests, the
   nonparametric tests, ``summary.json`` (with the keys of the committed
   ``reports/science/summary.json``) and ``REPORT.md`` must be written, every
   slope finite, E, F's two launches and dW launched in training and D in
   evaluation; ``cli stats`` over the four CSVs must exit 0.

The line before the last is the kernel summary JSON: per kernel the launch
count of its path (A, B, C: serving; E, F's gate terms, F, dW: training; D:
evaluation; G: the pair configuration), and over that path's shapes in phase
3 (B = 8 at 256² for A and C, B = 8 for B, B = 16 for E, F's two launches
(the ``lstm_backward`` row times both), dW and D, the eleven
eligible blocks at B = 8 for G; one launch per distinct shape) the largest
error against the plain version and the summed kernel, plain, bound and
library times.  The other shapes of phase 3 are pass/fail checks printed on
their own lines.  The last line
is ``{"ok": true, "device": {...}}``.  Any failure raises, and the script
then exits non-zero without printing either line.

Tolerances (the plain versions compute in f32 from the same bf16 operands):
  conv3x3_fused, resize (bf16): |kernel - plain| <= 1e-2 + 1e-2 |plain|,
    one bf16 ulp of the shared f32 result, since the two sum in other orders;
  conv3x3_pair_fused (bf16): <= 2e-2 + 2e-2 |plain|, two bf16 roundings (mid
    and output); against two chained conv3x3_fused launches the same bound
    (the two kernels sum in other orders);
  masked_class_sums (f32 sums of about 7,000 terms per class, taken in other
    orders on the two sides): <= 5e-5 + 5e-5 |plain| for f32 inputs, 1e-4 for
    bf16 and f16 ones; two launches give the same bits;
  resize (f32) <= 1e-5 + 1e-5 |plain|;
  lstm, lstm stash forward (f32, 828 steps): h_last, h_all, c_all <= 1e-4;
  lstm backward (f32): dx_proj <= 1e-4 + 1e-4 |plain|;
  lstm gate terms (f32, a 96-term product per gate, then the activations):
    <= 1e-5 + 1e-5 |plain|;
  lstm dW (f32, a sum of B * T terms, 13,248 at B = 16):
    <= 1e-4 + 1e-3 max|plain|;
  golden fixtures, bf16 against f32: <= 3e-2 (the port's bf16 forward on
    the CPU is 6.4e-3 from the U-Net's, on outputs up to 0.85);
  serving path, kernels vs plain versions, bf16 end to end: the output's max
    difference <= 5% of its largest magnitude (rounding flips of one bf16
    ulp in the conv and resize outputs, carried through 18 convs);
  training step, kernels vs plain versions, bf16: loss within 1% and
    gradient global norm within 5% (the same one-ulp flips in the resize
    outputs, carried through the decoder forward and back; the resize's
    backward runs in bf16 with bf16 interpolation weights, as JAX's does,
    where autograd through the plain version runs in f32; and cuDNN's
    backward sums in no fixed order).
  evaluation batch, kernels vs plain versions, bf16 forward: MAE, RMSE and
    the per-class ones within 1e-2 relative (means over thousands of pixels
    of one-ulp flips), the Laplacian variances within 5e-2 (a second
    difference amplifies the flips), NaN and ``class_present`` in the same
    places;
  pair configuration vs two launches per block: as the serving path, 5%;
  train step with train_fused_conv vs plain: as the kernels-vs-plain step,
    loss within 1% and gradient global norm within 5%;
  train step with remat vs plain: the same loss bits and running
    statistics; each gradient within 1e-2 of its tensor's largest magnitude
    (cuDNN's dgrad and wgrad may sum in another order when run again).
TF32 is off for cuDNN and matmuls, so the plain versions run in full f32.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import functools
import glob
import io
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
import torch.nn.functional as F

SEED = 0
T_SERIES = 828
# The LSTM lengths of phase 3's training-batch checks of E, F and dW.
TRAIN_LENGTHS = [828, 828, 700, 600, 414, 300, 100, 1, 0, 827, 828, 500, 828, 64, 828, 2]
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
GOLDEN_TOL = 3e-2
# The H100's published peaks (SXM, dense): device memory and tensor-core or
# plain f32 rates, by the type a kernel computes in.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


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
              rtol: float, on_path: bool, work, library=None, view=None) -> float:
        """Compare ``kernel()`` with ``plain()`` (a tensor, or a tuple of
        tensors compared one by one) and return the kernel's time.  ``work``
        = (bytes moved, operations, their type) gives the bound, and
        ``library`` is the one PyTorch call that computes the same function,
        or None where there is none.  ``view``, if given, picks what is
        compared from each side (the part a kernel writes).  A shape of the
        path that the summary line reads for this kernel (``on_path``) also
        enters its summary row."""
        got, want = kernel(), plain()
        if view is not None:
            got, want = view(got), view(want)
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
        nbytes, flops, kind = work
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[kind] * 1e3
        library_ms = None if library is None else cuda_ms(library)
        print(f"kernel {name} {label}{' [path]' if on_path else ''}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=({atol:g} + {rtol:g}|plain|) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={max(bytes_ms, ops_ms):.4f} "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}) library_ms="
              + ("none" if library_ms is None else f"{library_ms:.4f}")
              + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        if not on_path:
            return ms
        row = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0,
            "library_ms": None if library is None else 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += max(bytes_ms, ops_ms)
        row["bytes_ms"] += bytes_ms
        row["ops_ms"] += ops_ms
        if library is not None:
            row["library_ms"] += library_ms
        return ms

    def summary(self, name: str) -> dict:
        """The kernel's row of the summary line; ``bound_by`` says which of
        the two summed times is the larger."""
        row = dict(self.rows[name])
        row["bound_by"] = "bytes" if row.pop("bytes_ms") >= row.pop("ops_ms") else "operations"
        return row


def conv_work(b: int, hw, cins, cout: int, with_add: bool):
    """One fused conv's bytes (bf16 parts and output, f32 weights, scale,
    bias and add, each once) and operations (bf16 multiply-adds)."""
    h, w = hw
    cin = sum(cins)
    nbytes = (b * h * w * (cin + cout) * 2 + 9 * cin * cout * 4 + 2 * cout * 4
              + (b * 3 * w * cout * 4 if with_add else 0))
    return nbytes, 2 * b * h * w * 9 * cin * cout, "bf16"


def train_conv_work(b: int, cins, cout: int):
    """A train_fused_conv forward at 256²: bf16 parts and output and the f32
    weight slices, each once, and its bf16 multiply-adds (no epilogue)."""
    cin = sum(cins)
    nbytes = b * 256 * 256 * (cin + cout) * 2 + 9 * cin * cout * 4
    return nbytes, 2 * b * 256 * 256 * 9 * cin * cout, "bf16"


def cudnn_block(parts, convs, add):
    """The library yardstick of the conv kernels: for each (weights, scale,
    bias) of ``convs`` a cuDNN bf16 conv over the concatenated parts with its
    epilogue (bias, the first conv's ``add``, ReLU).  The weights are folded
    and laid out once, outside the timed call, as a deployed model would."""
    from maunet_tpu_torch.ops.kernels import packed_vgg

    folded = []
    for weights, scale, bias in convs:
        wt = (torch.cat(list(weights), 1) * scale[:, None, None, None]).to(torch.bfloat16)
        folded.append((wt.contiguous(memory_format=torch.channels_last),
                       bias.to(torch.bfloat16)))
    if add is not None:
        add = (add * convs[0][1]).to(torch.bfloat16)

    def run():
        x = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        for i, (wt, bias) in enumerate(folded):
            y = F.conv2d(x.permute(0, 3, 1, 2), wt, bias, padding=1).permute(0, 2, 3, 1)
            if i == 0 and add is not None:
                y = y + packed_vgg.expand_add(add, y.shape[1])
            x = torch.relu(y)
        return x

    return run


# The VGGBlocks that take the pair kernel at B = 8, 256²: ((H, W), conv1's
# spatial parts, width, with the embedding term).  U-Net (base 64): conv0_0,
# conv0_1.  U-Net++ (base 32): conv0_0-conv0_4 at 256², conv1_0-conv1_3 at 128².
PAIR_BLOCKS = (
    [((256, 256), (23,), 64, False), ((256, 256), (64, 128), 64, False)]
    + [((256, 256), (23,), 32, False)]
    + [((256, 256), (32,) * j + (64,), 32, True) for j in (1, 2, 3, 4)]
    + [((128, 128), (32,), 64, False)]
    + [((128, 128), (64,) * j + (128,), 64, True) for j in (1, 2, 3)])


# Every distinct fused conv of a U-Net++ (base 32) forward, 18 launches in
# all: conv1 of each PAIR_BLOCKS block, and the conv2 of each level.
UNETPP_CONVS = ([(hw, cins, width, with_add)
                 for hw, cins, width, with_add in PAIR_BLOCKS[2:]]
                + [((256, 256), (32,), 32, False), ((128, 128), (64,), 64, False)])
EVAL_BATCH = 16
# TrainConfig's batch, and the input channels of the convs that take A in
# one of its train steps with train_fused_conv (the U-Net's conv0_0 and
# conv0_1, base 64; conv0_1.conv1 reads [64 skip | 128 upsampled]).
TRAIN_BATCH = 16
TRAIN_FUSED_CONVS = ((23,), (64,), (64, 128))
# A's launches in one such step (forward only: the backward is cuDNN's):
# the U-Net's four level-0 convs at base 64; U-Net++'s eight level-1 ones at
# base 32 (its 32-channel row is lane-packed in JAX, which sends it to XLA).
TRAIN_FUSED_LAUNCHES = {"unet": 4, "unet++": 8}
# The planner app's default --img-size (maunet_tpu_torch/apps/planner.py).
PLANNER_HW = 512
# LSTM lengths of phase 3's evaluation-batch check of B: the synthetic split
# draws each sample's from T/2..T.
EVAL_LENGTHS = [828, 414, 700, 512, 621, 799, 450, 828, 733, 580, 666, 415, 777, 502, 640, 811]
# The LSTM lengths of phase 3's predict_many batch (B=8) for B.
SERVING_LENGTHS = [828, 828, 600, 414, 100, 1, 0, 827]
# The sensitivity sweeps' batches for B: a chunk of 50 metadata variants and
# the 41 series offsets of one tile, so one length each.
SWEEP_LENGTHS = ([T_SERIES] * 50, [612] * 41)
# (hidden, T, lengths) of phase 3's edge-case checks of B, E and F.
LSTM_EDGE_CASES = [
    (96, T_SERIES, [0, 1, T_SERIES]), (96, 64, [64]), (64, 64, [64, 0, 1, 33]),
    (50, 64, [64, 1, 0, 17, 63]), (50, T_SERIES, [T_SERIES, 0, 1, 400]),
    (64, T_SERIES, [T_SERIES])]


# C's cases in phase 3, as (input shape, output size, dtype, on the serving
# path): the four decoder upsamples at B=8 (the serving path), at the
# evaluation batch (B=16; the training batch has the same shapes) and
# U-Net++'s (base 32) four at the evaluation batch; the bottleneck's double
# interpolation of a 250² tile at B=1 (15 -> 30, then the odd fix-up 30 ->
# 31); U-Net++'s single odd resize (12 -> 25); one f32 case and one channel
# count that takes the kernel's one-channel-per-thread path; the planner's
# four upsamples at B=1, 512² (the last writes 64 MiB).
RESIZE_CASES = (
    ((8, 16, 16, 1024), (32, 32), torch.bfloat16, True),
    ((8, 32, 32, 512), (64, 64), torch.bfloat16, True),
    ((8, 64, 64, 256), (128, 128), torch.bfloat16, True),
    ((8, 128, 128, 128), (256, 256), torch.bfloat16, True),
    ((16, 16, 16, 1024), (32, 32), torch.bfloat16, False),
    ((16, 32, 32, 512), (64, 64), torch.bfloat16, False),
    ((16, 64, 64, 256), (128, 128), torch.bfloat16, False),
    ((16, 128, 128, 128), (256, 256), torch.bfloat16, False),
    ((16, 16, 16, 512), (32, 32), torch.bfloat16, False),    # U-Net++
    ((16, 32, 32, 256), (64, 64), torch.bfloat16, False),
    ((16, 64, 64, 128), (128, 128), torch.bfloat16, False),
    ((16, 128, 128, 64), (256, 256), torch.bfloat16, False),
    ((1, 15, 15, 1024), (30, 30), torch.bfloat16, False),
    ((1, 30, 30, 1024), (31, 31), torch.bfloat16, False),
    ((2, 12, 12, 64), (25, 25), torch.bfloat16, False),
    ((2, 15, 15, 64), (30, 30), torch.float32, False),
    ((2, 15, 15, 3), (30, 31), torch.bfloat16, False),
    ((1, 32, 32, 1024), (64, 64), torch.bfloat16, False),    # the planner, 512²
    ((1, 64, 64, 512), (128, 128), torch.bfloat16, False),
    ((1, 128, 128, 256), (256, 256), torch.bfloat16, False),
    ((1, 256, 256, 128), (512, 512), torch.bfloat16, False))


# D's cases in phase 3, as (shape, dtype, tolerance, classes made absent,
# with class values outside 0..8, on the evaluation path): the evaluation
# batch, and B = 8 and 3 of it; one 250² tile; bf16 inputs; a map with absent
# classes; one with class values outside 0..8, which count nowhere; then the
# other channel counts and f16, which the evaluator does not send.
MASKED_CASES = (
    ((16, 256, 256, 2), torch.float32, 5e-5, (), False, True),
    ((8, 256, 256, 2), torch.float32, 5e-5, (), False, False),
    ((3, 256, 256, 2), torch.float32, 5e-5, (), False, False),
    ((1, 250, 250, 2), torch.float32, 5e-5, (), False, False),
    ((16, 256, 256, 2), torch.bfloat16, 1e-4, (), False, False),
    ((4, 50, 50, 2), torch.float32, 5e-5, (3, 8), False, False),
    ((4, 50, 50, 2), torch.float32, 5e-5, (), True, False),
    ((2, 50, 50, 3), torch.float16, 1e-4, (), False, False),
    ((2, 33, 47, 4), torch.float32, 5e-5, (5,), False, False),
    ((2, 125, 125, 1), torch.bfloat16, 1e-4, (), False, False))


def masked_inputs(g: torch.Generator, dev, shape, dtype, absent=(), outside=False):
    """Seeded (pred, target (B, H, W, C) of ``dtype``, class map (B, H, W)
    int32) on ``dev``: classes 0..8, those of ``absent`` relabelled, and with
    ``outside`` a few pixels of the first and last sample at 11 and -3."""
    pred = torch.randn(shape, generator=g, device=dev).to(dtype)
    target = torch.randn(shape, generator=g, device=dev).to(dtype)
    dw = torch.randint(0, 9, shape[:3], generator=g, device=dev, dtype=torch.int32)
    for k in absent:
        dw[dw == k] = (k + 1) % 9
    if outside:
        dw[0, :5] = 11
        dw[-1, 5:7] = -3
    return pred, target, dw


def masked_work(shape, itemsize: int):
    """D's bytes (pred, target and the class map read once, the sums written
    once) and operations (a subtraction, |err|, err^2 and two adds per value,
    one add per pixel)."""
    b, h, w, c = shape
    pixels = b * h * w
    return (pixels * (2 * c * itemsize + 4) + b * (2 * c + 1) * 9 * 4,
            pixels * (5 * c + 1), "f32")


def lstm_inputs(g: torch.Generator, dev, hidden: int, t: int, lens):
    """Seeded (x_proj (B, t, 4H), W_hh (H, 4H), lengths (B,) int32) on
    ``dev``, W_hh drawn as torch's LSTM initialises it."""
    x_proj = torch.randn((len(lens), t, 4 * hidden), generator=g, device=dev) * 0.5
    w_hh = (torch.rand((hidden, 4 * hidden), generator=g, device=dev) * 2 - 1) / math.sqrt(hidden)
    return x_proj, w_hh, torch.tensor(lens, dtype=torch.int32, device=dev)


def check_kernels(table: KernelTable, dev) -> None:
    from maunet_tpu_torch.ops.kernels import lstm, masked_stats, packed_vgg, resize_pack

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def conv_params(cins, cout):
        fan_in = 9 * sum(cins)
        return ([randn(cout, c, 3, 3, std=math.sqrt(2 / fan_in)) for c in cins],
                0.5 + torch.rand(cout, generator=g, device=dev), randn(cout, std=0.1))

    # A: the level-0 convs (conv0_0.conv1 reads the 23 input channels as they
    # are; conv0_1.conv1 reads the [64 skip | 128 upsampled] concat) at the
    # predict_many batch (B=8), at B=2, and at B=1 on a 250² tile as predict
    # serves it; then the compact embedding term, and two odd sizes (the
    # second with two output-channel tiles); then every distinct conv of one
    # evaluation batch (B=16): the U-Net's three, and U-Net++'s eleven (each
    # block's conv1, with the embedding term at the decoder nodes, and the
    # conv2 of each level); then the planner's four convs at B=1, 512² (three
    # distinct shapes: both conv2s are 64 -> 64).
    bf = torch.bfloat16
    level0 = [(23,), (64,), (64, 128)]
    # (batch, (H, W), input parts' channels, cout, with add, on the path, note)
    a_cases = ([(8, (256, 256), cins, 64, False, True, "") for cins in level0]
               + [(2, (256, 256), cins, 64, False, False, "") for cins in level0]
               + [(1, (250, 250), cins, 64, False, False, "") for cins in level0]
               + [(2, (256, 256), (64,), 64, True, False, ""),
                  (2, (125, 125), (23, 40), 48, True, False, ""),
                  (2, (33, 47), (16,), 80, True, False, "")]
               + [(EVAL_BATCH, (256, 256), cins, 64, False, False, " evaluation U-Net")
                  for cins in level0]
               + [(EVAL_BATCH, hw, cins, width, with_add, False, " evaluation U-Net++")
                  for hw, cins, width, with_add in UNETPP_CONVS]
               + [(1, (PLANNER_HW, PLANNER_HW), cins, 64, False, False, " planner")
                  for cins in level0])
    for b, hw, cins, cout, with_add, on_path, note in a_cases:
        parts = [randn(b, *hw, c, dtype=bf) for c in cins]
        weights, scale, bias = conv_params(cins, cout)
        add = randn(b, 3, hw[1], cout, std=0.5) if with_add else None
        kw = dict(scale=scale, bias=bias, add=add, relu=True)
        prepared = packed_vgg.prepare_conv3x3(weights, scale, bias)
        label = f"{[(b, *hw, c) for c in cins]}->{cout}{' +add' if with_add else ''}{note}"
        table.check("conv3x3_fused", label,
                    lambda: packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True),
                    lambda: packed_vgg.conv3x3_fused_plain(parts, weights, **kw),
                    1e-2, 1e-2, on_path, conv_work(b, hw, cins, cout, with_add),
                    cudnn_block(parts, [(weights, scale, bias)], add))
        if not torch.equal(packed_vgg.conv3x3_fused(parts, weights, **kw),
                           packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True)):
            raise AssertionError(f"conv3x3_fused {label}: prepared and raw weights differ")
        unprepared_ms = cuda_ms(lambda: packed_vgg.conv3x3_fused(parts, weights, **kw))
        print(f"kernel conv3x3_fused {label}: unprepared_ms={unprepared_ms:.4f}, "
              f"same bits as the prepared call")
        if on_path:
            row = table.rows["conv3x3_fused"]
            row["unprepared_ms"] = row.get("unprepared_ms", 0.0) + unprepared_ms

    # A as train_fused_conv's forward (ops/train_conv.py): the four level-0
    # convs of a train step at TrainConfig's defaults (B = 16, 256²; conv0_0's
    # and conv0_1's 64 -> 64 share a shape), no epilogue, weights prepared at
    # every call as the autograd Function does; beside cuDNN's forward conv.
    for cins in TRAIN_FUSED_CONVS:
        parts = [randn(TRAIN_BATCH, 256, 256, c, dtype=bf) for c in cins]
        weights = conv_params(cins, 64)[0]
        cat_w = torch.cat(weights, 1).to(bf).contiguous(memory_format=torch.channels_last)

        def cudnn_forward():
            x = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
            return F.conv2d(x.permute(0, 3, 1, 2), cat_w, padding=1).permute(0, 2, 3, 1)

        label = f"{[(TRAIN_BATCH, 256, 256, c) for c in cins]}->64 training, no epilogue"
        table.check("conv3x3_fused", label,
                    lambda: packed_vgg.conv3x3_fused(parts, weights),
                    lambda: packed_vgg.conv3x3_fused_plain(parts, weights),
                    1e-2, 1e-2, False, train_conv_work(TRAIN_BATCH, cins, 64), cudnn_forward)
        # How much of that is the preparation of the weights.
        prepared = packed_vgg.prepare_conv3x3(weights)
        if not torch.equal(packed_vgg.conv3x3_fused(parts, prepared),
                           packed_vgg.conv3x3_fused(parts, weights)):
            raise AssertionError(f"conv3x3_fused {label}: prepared and raw weights differ")
        prepared_ms = cuda_ms(lambda: packed_vgg.conv3x3_fused(parts, prepared))
        print(f"kernel conv3x3_fused {label}: prepared_ms={prepared_ms:.4f} (weights prepared "
              f"once), same bits as the call above")

    # G: every eligible block of the pair configuration at B=8, against its
    # plain version, against the two A launches it replaces, and beside
    # cuDNN's two convs; then two odd sizes with narrow, unequal widths.
    g_cases = ([(8, hw, cins, width, width, with_add, True)
                for hw, cins, width, with_add in PAIR_BLOCKS]
               + [(2, (125, 125), (23, 40), 48, 40, True, False),
                  (2, (33, 47), (16,), 20, 7, True, False)])
    for b, hw, cins, cmid, cout, with_add, on_path in g_cases:
        parts = [randn(b, *hw, c, dtype=bf) for c in cins]
        w1, scale1, bias1 = conv_params(cins, cmid)
        (w2,), scale2, bias2 = conv_params((cmid,), cout)
        add = randn(b, 3, hw[1], cmid, std=0.5) if with_add else None
        kw = dict(scale1=scale1, bias1=bias1, scale2=scale2, bias2=bias2, add=add)

        prepared1 = packed_vgg.prepare_conv3x3(w1, scale1, bias1)
        prepared2 = packed_vgg.prepare_conv3x3([w2], scale2, bias2)

        def two_launches():
            mid = packed_vgg.conv3x3_fused(parts, prepared1, add=add, relu=True)
            return packed_vgg.conv3x3_fused([mid], prepared2, relu=True)

        def pair():
            return packed_vgg.conv3x3_pair_fused(parts, prepared1, prepared2, add=add)

        n1, f1, _ = conv_work(b, hw, cins, cmid, with_add)
        n2, f2, _ = conv_work(b, hw, (cmid,), cout, False)
        mid_bytes = 2 * b * hw[0] * hw[1] * cmid * 2     # never written, never read
        label = (f"{[(b, *hw, c) for c in cins]}->{cmid}->{cout}"
                 f"{' +add' if with_add else ''}")
        ms = table.check("conv3x3_pair_fused", label, pair,
                         lambda: packed_vgg.conv3x3_pair_fused_plain(parts, w1, w2, **kw),
                         2e-2, 2e-2, on_path, (n1 + n2 - mid_bytes, f1 + f2, "bf16"),
                         cudnn_block(parts, [(w1, scale1, bias1), ([w2], scale2, bias2)], add))
        got, chained = pair(), two_launches()
        if not torch.equal(packed_vgg.conv3x3_pair_fused(parts, w1, w2, **kw), got):
            raise AssertionError(f"conv3x3_pair_fused {label}: prepared and raw weights differ")
        unprepared_ms = cuda_ms(lambda: packed_vgg.conv3x3_pair_fused(parts, w1, w2, **kw))
        two_ms = cuda_ms(two_launches)
        diff = (got.float() - chained.float()).abs()
        ok = bool((diff <= 2e-2 + 2e-2 * chained.float().abs()).all())
        print(f"kernel conv3x3_pair_fused {label} vs two conv3x3_fused launches: "
              f"max_abs_diff={float(diff.max()):.3e} ms={ms:.4f} "
              f"two_launches_ms={two_ms:.4f} unprepared_ms={unprepared_ms:.4f} "
              f"(raw weights, same bits) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"conv3x3_pair_fused {label} disagrees with two launches")
        if on_path:
            row = table.rows["conv3x3_pair_fused"]
            row["unprepared_ms"] = row.get("unprepared_ms", 0.0) + unprepared_ms
            row["two_launches_ms"] = row.get("two_launches_ms", 0.0) + two_ms

    # D at every shape of MASKED_CASES.
    for shape, dtype, tol, absent, outside, on_path in MASKED_CASES:
        pred, target, dw = masked_inputs(g, dev, shape, dtype, absent, outside)
        table.check("masked_class_sums",
                    f"{shape} {str(dtype).split('.')[-1]}"
                    f"{' absent ' + str(absent) if absent else ''}"
                    f"{' with classes outside 0..8' if outside else ''}",
                    lambda: masked_stats.masked_class_sums(pred, target, dw),
                    lambda: masked_stats.masked_class_sums_plain(pred, target, dw),
                    tol, tol, on_path, masked_work(shape, pred.element_size()), None)
        first, second = (masked_stats.masked_class_sums(pred, target, dw) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError("masked_class_sums: two launches on the same inputs differ")
        counted = float(first[2].sum())
        inside = float(((dw >= 0) & (dw < 9)).sum())
        if counted != inside or any(float(first[2][:, k].sum()) for k in absent):
            raise AssertionError(f"masked_class_sums: counted {counted} of {inside} pixels")

    # B: the temporal encoder's recurrence at the predict_many batch with
    # mixed lengths, at B=1 (predict), at the evaluation batch and at the
    # sensitivity sweeps' batches.  Its bound counts the steps this
    # batch's lengths need; the library call is cuDNN's LSTM over the raw
    # series at full length (what batch_max masking runs).
    hidden = 96
    gates = 4 * hidden

    def lstm_case(lens, hidden=hidden, t=T_SERIES):
        x_proj, w_hh, lengths = lstm_inputs(g, dev, hidden, t, lens)
        shown = f"{lens[0]} x {len(lens)}" if len(set(lens)) == 1 < len(lens) else lens
        return lengths, x_proj, w_hh, f"({len(lens)}, {t}, {4 * hidden}) lengths={shown}"

    cudnn_lstm = torch.nn.LSTM(1, hidden, batch_first=True).to(dev)
    for lens, on_path in [(SERVING_LENGTHS, True), ([828], False), (EVAL_LENGTHS, False)] + [
            (lens, False) for lens in SWEEP_LENGTHS]:
        steps = sum(lens)
        lens, x_proj, w_hh, label = lstm_case(lens)
        series = randn(len(lens), T_SERIES, 1)
        with torch.no_grad():
            table.check("lstm_last_hidden", label,
                        lambda: lstm.lstm_last_hidden(x_proj, w_hh, lens),
                        lambda: lstm.lstm_last_hidden_scan(x_proj, w_hh, lens), 1e-4, 0.0,
                        on_path,
                        (steps * gates * 4 + hidden * gates * 4 + len(lens) * hidden * 4,
                         steps * (2 * hidden * gates + 10 * gates), "f32"),
                        lambda: cudnn_lstm(series)[1][0])

    # B, E and F at the edges of what the kernels take: lengths 0, 1 and T
    # in one batch, B = 1, hidden sizes that do not fill a lane's weights
    # (50), fill them (64) or are the model's (96), T = 64 and 828.
    def backward_work(steps, rows, h, b):
        """F's bytes (x_proj's active rows, the stash, W_hh, g and dx_proj)
        and operations (the gate recompute and dh, two H x 4H products a
        step, and the cell's terms)."""
        return ((steps * 6 * h + h * 4 * h + b * h + rows * 4 * h) * 4,
                steps * (16 * h * h + 80 * h), "f32")

    def gate_terms_work(steps, h):
        """The gate terms' bytes (x_proj, h_{t-1}, c_t and the terms of the
        steps t < length, W_hh) and operations (the H x 4H product and the
        epilogue)."""
        return (steps * 12 * h * 4 + 4 * h * h * 4, steps * (8 * h * h + 80 * h), "f32")

    for edge_hidden, t, lens in LSTM_EDGE_CASES:
        steps, g4 = sum(lens), 4 * edge_hidden
        lens, x_proj, w_hh, label = lstm_case(lens, edge_hidden, t)
        grad = randn(len(lens), edge_hidden)
        flops = steps * (2 * edge_hidden * g4 + 10 * g4)
        with torch.no_grad():
            table.check("lstm_last_hidden", label,
                        lambda: lstm.lstm_last_hidden(x_proj, w_hh, lens),
                        lambda: lstm.lstm_last_hidden_scan(x_proj, w_hh, lens), 1e-4, 0.0,
                        False, (steps * g4 * 4 + edge_hidden * g4 * 4 + len(lens) * edge_hidden * 4,
                                flops, "f32"))
        table.check("lstm_forward_stash", label,
                    lambda: lstm.lstm_forward_stash(x_proj, w_hh, lens),
                    lambda: lstm.lstm_forward_stash_plain(x_proj, w_hh, lens), 1e-4, 0.0,
                    False, (steps * g4 * 4 + edge_hidden * g4 * 4
                            + 2 * len(lens) * t * edge_hidden * 4, flops, "f32"))
        _, h_all, c_all = lstm.lstm_forward_stash_plain(x_proj, w_hh, lens)
        active = (torch.arange(t, device=dev)[None, :] < lens[:, None])[..., None]
        table.check("lstm_gate_terms", label,
                    lambda: lstm.lstm_gate_terms(x_proj, w_hh, lens, h_all, c_all),
                    lambda: lstm.lstm_gate_terms_plain(x_proj, w_hh, lens, h_all, c_all),
                    1e-5, 1e-5, False, gate_terms_work(steps, edge_hidden), None,
                    view=lambda terms: torch.where(active, terms, 0.0))
        table.check("lstm_backward", label,
                    lambda: lstm.lstm_backward(x_proj, w_hh, lens, h_all, c_all, grad),
                    lambda: lstm.lstm_backward_plain(x_proj, w_hh, lens, h_all, c_all, grad)[0],
                    1e-4, 1e-4, False,
                    backward_work(steps, len(lens) * t, edge_hidden, len(lens)))

    # E, F (both launches, and the gate terms alone) and dW: the training
    # batch (B=16, the trainer's default) with mixed lengths, and B=1.  F and
    # dW read the plain version's stash, so both sides see the same inputs;
    # the plain F also forms dW.  E, F and the gate terms have no single
    # library call; dW's is the plain version's einsum.  The gate terms are
    # compared where the kernel writes them, at t < length.
    for lens, on_path in [(TRAIN_LENGTHS, True), ([828], False)]:
        steps, rows = sum(lens), len(lens) * T_SERIES
        lens, x_proj, w_hh, label = lstm_case(lens)
        grad = randn(len(lens), hidden)
        weight_bytes = hidden * gates * 4
        table.check("lstm_forward_stash", label,
                    lambda: lstm.lstm_forward_stash(x_proj, w_hh, lens),
                    lambda: lstm.lstm_forward_stash_plain(x_proj, w_hh, lens), 1e-4, 0.0,
                    on_path,
                    (steps * gates * 4 + weight_bytes + 2 * rows * hidden * 4,
                     steps * (2 * hidden * gates + 10 * gates), "f32"), None)
        _, h_all, c_all = lstm.lstm_forward_stash_plain(x_proj, w_hh, lens)
        active = (torch.arange(T_SERIES, device=dev)[None, :] < lens[:, None])[..., None]
        table.check("lstm_gate_terms", label,
                    lambda: lstm.lstm_gate_terms(x_proj, w_hh, lens, h_all, c_all),
                    lambda: lstm.lstm_gate_terms_plain(x_proj, w_hh, lens, h_all, c_all),
                    1e-5, 1e-5, on_path, gate_terms_work(steps, hidden), None,
                    view=lambda terms: torch.where(active, terms, 0.0))
        table.check("lstm_backward", label,
                    lambda: lstm.lstm_backward(x_proj, w_hh, lens, h_all, c_all, grad),
                    lambda: lstm.lstm_backward_plain(x_proj, w_hh, lens, h_all, c_all, grad)[0],
                    1e-4, 1e-4, on_path, backward_work(steps, rows, hidden, len(lens)), None)
        dx = lstm.lstm_backward(x_proj, w_hh, lens, h_all, c_all, grad)
        want = lstm.lstm_dw_plain(h_all, dx, lens)
        table.check("lstm_dw", label, lambda: lstm.lstm_dw(h_all, dx, lens),
                    lambda: lstm.lstm_dw_plain(h_all, dx, lens),
                    1e-4 + 1e-3 * float(want.abs().max()), 0.0, on_path,
                    (steps * (gates + hidden) * 4 + weight_bytes,
                     steps * 2 * hidden * gates, "f32"),
                    lambda: lstm.lstm_dw_plain(h_all, dx, lens))
        if not torch.equal(lstm.lstm_dw(h_all, dx, lens), lstm.lstm_dw(h_all, dx, lens)):
            raise AssertionError("lstm_dw: two launches on the same inputs differ")

    # C at every shape of RESIZE_CASES; two launches on the same input must
    # give the same bits.
    for shape, out_hw, dtype, on_path in RESIZE_CASES:
        x = randn(*shape, dtype=dtype)
        tol = 1e-2 if dtype == bf else 1e-5
        n_out = shape[0] * out_hw[0] * out_hw[1] * shape[3]
        label = f"{shape}->{out_hw} {str(dtype).split('.')[-1]}"
        table.check("resize_pack", label,
                    lambda: resize_pack.resize_pack(x, out_hw),
                    lambda: resize_pack.resize_pack_plain(x, out_hw), tol, tol, on_path,
                    ((x.numel() + n_out) * x.element_size(), 8 * n_out, "f32"),
                    lambda: F.interpolate(x.permute(0, 3, 1, 2), size=out_hw,
                                          mode="bilinear", align_corners=True))
        if not torch.equal(resize_pack.resize_pack(x, out_hw),
                           resize_pack.resize_pack(x, out_hw)):
            raise AssertionError(f"resize_pack {label}: two launches on the same input differ")


def check_golden(dev) -> None:
    """The port's U-Net and U-Net++ on the card against the JAX package's
    recorded outputs (``tests/fixtures/golden_unet.npz`` and
    ``golden_unetpp.npz``: 50² tiles, base 4).  At base 4 every conv runs
    kernel A, with the embedding term at the U-Net's bottleneck and at every
    U-Net++ decoder node, and the odd 50 -> 25 -> 12 chain runs C's fix-ups
    (U-Net) and single odd resizes (U-Net++)."""
    from maunet_tpu_torch.interop.from_jax import state_dict_from_jax, variables_from_flat
    from maunet_tpu_torch.interop.torch_import import infer_hyperparams
    from maunet_tpu_torch.models.factory import build_model

    for model_type, name in [("unet", "golden_unet.npz"), ("unet++", "golden_unetpp.npz")]:
        with np.load(os.path.join(FIXTURES, name)) as z:
            state_dict = state_dict_from_jax(variables_from_flat(z))
            inputs = [torch.from_numpy(z[k]).to(dev)
                      for k in ("maps", "series", "meta", "lengths")]
            expected = z["expected"]
        model = build_model(infer_hyperparams(state_dict, {"model_type": model_type}))
        model.load_state_dict(state_dict, strict=True)
        with torch.inference_mode():
            got = model.to(dev)(*inputs).cpu().numpy()
        err = float(np.abs(got - expected).max())
        print(f"golden fixture {name} (bf16 on the card vs the f32 JAX output): "
              f"max_abs_err={err:.4e} tol={GOLDEN_TOL:g}")
        if got.shape != expected.shape or not err <= GOLDEN_TOL:
            raise AssertionError(f"the port disagrees with {name}")


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


# The two full-width models: the serving U-Net (bench.py:80-82) and U-Net++
# at its reference width (maunet_tpu/benchmarks.py:86-88).
FULL_WIDTH = {
    "unet": {"model_type": "unet", "base_filters": 64},
    "unet++": {"model_type": "unet++", "base_filters": 32},
}


def write_checkpoint(tmpdir: str, model_type: str) -> str:
    """A reference-layout ``.pth`` of the full-width model with seeded random
    weights and BatchNorm statistics."""
    from maunet_tpu_torch.models.factory import build_model

    hp = {**FULL_WIDTH[model_type], "temporal_dim": 64, "meta_dim": 64,
          "lstm_hidden": 96, "temporal_embeddings": True,
          "metadata_embeddings": True, "metadata_input_length": 8}
    model = build_model(hp, lstm_mask_mode="batch_max")
    randomize_(model, torch.Generator().manual_seed(SEED))
    path = os.path.join(tmpdir, f"{model_type}_full_width.pth")
    torch.save({"model_state_dict": model.state_dict(), "hyperparameters": hp,
                "model_type": model_type, "metadata_input_length": 8,
                "trial_id": 0}, path)
    return path


def weights_prepared() -> tuple[int, int]:
    """How often a block made its constants and a conv's weights were
    prepared, so far."""
    from maunet_tpu_torch.models.blocks import VGGBlock
    from maunet_tpu_torch.ops.kernels import packed_vgg

    return VGGBlock.constants_built, packed_vgg.prepare_conv3x3.calls


def require_nothing_prepared(before: tuple[int, int], what: str) -> None:
    if weights_prepared() != before:
        raise AssertionError(f"{what}: a later forward prepared weights again "
                             f"({before} -> {weights_prepared()})")


def serving_path(dev, path: str) -> dict[str, int]:
    from maunet_tpu_torch.apps.engine import CANVAS_RGB, PlannerEngine
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack

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
    prepared = weights_prepared()
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
    require_nothing_prepared(prepared, "serving path")
    return launches


def wrappers() -> dict:
    """Every kernel wrapper, by name; each counts its launches."""
    from maunet_tpu_torch.ops.kernels import lstm, masked_stats, packed_vgg, resize_pack

    return {fn.__name__: fn for fn in (
        packed_vgg.conv3x3_fused, lstm.lstm_last_hidden, resize_pack.resize_pack,
        lstm.lstm_forward_stash, lstm.lstm_gate_terms, lstm.lstm_backward, lstm.lstm_dw,
        masked_stats.masked_class_sums, packed_vgg.conv3x3_pair_fused)}


def reset_launches() -> dict:
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    return fns


# The synthetic split every path reads: training takes train and val,
# evaluation test (40 samples in batches of 16: the last batch is padded).
SAMPLES = {"train": 48, "val": 16, "test": 40}


def make_data(tmpdir: str) -> str:
    from maunet_tpu_torch.data.synthetic import generate_dataset

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(tmpdir, "data"), SAMPLES, hw=256,
                            temporal_len=T_SERIES, seed=SEED)
    print(f"synthetic data: {SAMPLES} samples of 256², T = {T_SERIES}, "
          f"in {time.perf_counter() - t0:.1f} s")
    return data


def train_path(dev, tmpdir: str, data: str) -> dict[str, int]:
    """Phase 6: ``Trainer`` at the default full-width config, one epoch and
    a resumed second, then the kernels-vs-plain step, serving the result and
    the step time."""
    from maunet_tpu_torch.apps.engine import PlannerEngine
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.ops.kernels import lstm, resize_pack
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.train.steps import train_step

    cfg = TrainConfig(frequency_log=1)
    work = os.path.join(tmpdir, "train")
    fns = reset_launches()
    t0 = time.perf_counter()
    with captured_log("maunet_tpu_torch.train.loop") as records:
        r1 = Trainer(cfg, data, work_dir=work, study_name="smoke", device=dev).train(epochs=1)
        trainer = Trainer(cfg, data, work_dir=work, study_name="smoke", device=dev)
        r2 = trainer.train(epochs=2, resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_plot_lines(records, trainers=2, plot_steps=1, work=work)
    launches = {name: fn.launches for name, fn in fns.items()}
    steps_per_epoch = SAMPLES["train"] // cfg.batch_size
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
    if not (launches["lstm_forward_stash"] == launches["lstm_gate_terms"]
            == launches["lstm_backward"] == launches["lstm_dw"] == steps):
        raise AssertionError(f"training path: E, F's two launches and dW must launch "
                             f"once per step ({steps})")
    missing = [name for name in ("lstm_forward_stash", "lstm_gate_terms", "lstm_backward",
                                 "lstm_dw", "resize_pack", "conv3x3_fused", "lstm_last_hidden")
               if launches[name] == 0]
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


@contextlib.contextmanager
def captured_log(name: str):
    """The records that logger ``name`` emits at INFO and above within."""
    import logging

    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger(name)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def check_plot_lines(records, trainers: int, plot_steps: int, work: str) -> None:
    """Prediction plots at their default frequency (step 0 of each run):
    where matplotlib is missing, one logged line per Trainer, no figure and
    no warning; where it is installed, one PNG per plot step."""
    from importlib.util import find_spec

    lines = [r.getMessage() for r in records if "matplotlib" in r.getMessage()]
    warnings = [r.getMessage() for r in records if r.levelno >= 30]
    pngs = glob.glob(os.path.join(work, "visualizations", "*.png"))
    if find_spec("matplotlib") is None:
        ok = len(lines) == trainers and not warnings and not pngs
        print(f"prediction plots: {lines[0] if lines else 'no line'} "
              f"({len(lines)} lines for {trainers} Trainers, {len(warnings)} warnings)")
    else:
        ok = not lines and not warnings and len(pngs) == plot_steps
        print(f"prediction plots: {len(pngs)} PNGs for {plot_steps} plot steps")
    if not ok:
        raise AssertionError(f"prediction plots: lines {lines}, warnings {warnings}, "
                             f"PNGs {pngs}")


def train_variants_path(dev, data: str) -> None:
    """Phase 6b: from one seeded state and one batch at TrainConfig's
    defaults, one train step three ways, plain, with ``train_fused_conv``
    and with ``remat``; then a U-Net++ step with ``train_fused_conv``."""
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.models import UrbanPredictor
    from maunet_tpu_torch.ops.kernels import packed_vgg
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import train_step

    t_phase = time.perf_counter()
    ds = NpzDataset(os.path.join(data, "train"), T_SERIES)
    batch = to_device(host_tensors(next(make_batches(ds, TRAIN_BATCH)), pin=True), dev)

    def step_three_ways(cfg: TrainConfig, variants: dict) -> dict:
        """For each variant (UrbanPredictor flags): the metrics, gradients,
        buffers and A's launches of one step from the same weights, then the
        median of 5 synchronised steps and the peak memory over them."""
        loss_fn = get_loss_fn(cfg.loss)
        kw = dict(model_type=cfg.model_type, out_channels=len(cfg.target_channels),
                  temporal_dim=cfg.temporal_dim, meta_dim=cfg.meta_dim,
                  lstm_dim=cfg.lstm_hidden, base_filters=cfg.base_filters,
                  meta_features=cfg.nb_metadata_features,
                  deep_supervision=cfg.deep_supervision)
        weights = UrbanPredictor(**kw, generator=torch.Generator().manual_seed(SEED)).state_dict()
        out = {}
        for name, flags in variants.items():
            model = UrbanPredictor(**kw, **flags)
            model.load_state_dict(weights)
            model.to(dev)
            state = TrainState(model, make_optimizer(model.parameters(), cfg.optimizer,
                                                     cfg.learning_rate, cfg.weight_decay,
                                                     cfg.momentum), 0)
            reset_launches()
            metrics = train_step(state, batch, loss_fn)
            torch.cuda.synchronize()
            a_launches = packed_vgg.conv3x3_fused.launches
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
            buffers = {k: v.clone() for k, v in model.named_buffers()}
            torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(state, batch, loss_fn)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = dict(metrics=metrics, grads=grads, buffers=buffers,
                             a_launches=a_launches, ms=statistics.median(times),
                             peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            del state, model
            torch.cuda.empty_cache()
        return out

    cfg = TrainConfig()
    runs = step_three_ways(cfg, {"plain": {}, "train_fused_conv": {"train_fused_conv": True},
                                 "remat": {"remat": True}})
    plain = runs["plain"]
    for name, run in runs.items():
        loss, want = float(run["metrics"]["total"]), float(plain["metrics"]["total"])
        norm, want_norm = float(run["metrics"]["grad_norm"]), float(plain["metrics"]["grad_norm"])
        print(f"train step {name}: loss {loss:.6f} (plain {want:.6f}, rel "
              f"{abs(loss - want) / abs(want):.3e}), grad_norm {norm:.6f} (plain "
              f"{want_norm:.6f}), A launches {run['a_launches']}, {run['ms']:.3f} ms/step "
              f"(median of 5 synchronised steps), peak {run['peak_gib']:.3f} GiB allocated")
    if plain["a_launches"] or runs["remat"]["a_launches"]:
        raise AssertionError("train step: A launched without train_fused_conv")

    # train_fused_conv: A's forward in the four level-0 convs; losses within
    # 1e-2 and gradient norms within 5e-2 (as the kernels-vs-plain step of
    # phase 6: one-ulp bf16 flips of the convs' outputs, cuDNN's backward in
    # no fixed order).
    fused = runs["train_fused_conv"]
    loss_rel = abs(float(fused["metrics"]["total"]) / float(plain["metrics"]["total"]) - 1)
    norm_rel = abs(float(fused["metrics"]["grad_norm"]) / float(plain["metrics"]["grad_norm"]) - 1)
    if fused["a_launches"] != TRAIN_FUSED_LAUNCHES["unet"] or loss_rel > 1e-2 or norm_rel > 5e-2:
        raise AssertionError(f"train_fused_conv step: {fused['a_launches']} A launches "
                             f"(want {TRAIN_FUSED_LAUNCHES['unet']}), loss rel {loss_rel:.3e} "
                             f"(tol 1e-2), grad_norm rel {norm_rel:.3e} (tol 5e-2)")
    # remat: the same forward, so the same loss bits and running statistics
    # updated once (the recompute leaves them alone); gradients within 1e-2
    # of each tensor's largest (cuDNN's dgrad and wgrad sum in no fixed order).
    remat = runs["remat"]
    same_loss = torch.equal(remat["metrics"]["total"], plain["metrics"]["total"])
    same_stats = all(torch.equal(v, plain["buffers"][k]) for k, v in remat["buffers"].items())
    tracked = {int(v) for k, v in remat["buffers"].items() if k.endswith("num_batches_tracked")}
    grad_err = max(float((g - plain["grads"][k]).abs().max())
                   / max(float(plain["grads"][k].abs().max()), 1e-30)
                   for k, g in remat["grads"].items())
    bits = all(torch.equal(g, plain["grads"][k]) for k, g in remat["grads"].items())
    print(f"remat: loss bits {'equal' if same_loss else 'DIFFER'}, running statistics "
          f"{'equal' if same_stats else 'DIFFER'}, num_batches_tracked {sorted(tracked)}, "
          f"gradients {'bit-equal' if bits else 'differ'} (largest difference {grad_err:.3e} "
          f"of its tensor's largest, tol 1e-2); peak memory {remat['peak_gib']:.3f} GiB "
          f"against {plain['peak_gib']:.3f}")
    if not (same_loss and same_stats and tracked == {1} and grad_err <= 1e-2):
        raise AssertionError("remat step disagrees with the plain step")

    # A's wrapper still refuses an input that needs a gradient outside the
    # autograd Function.
    x = torch.randn(1, 8, 8, 16, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(16, 16, 3, 3, device=dev)
    try:
        packed_vgg.conv3x3_fused([x], [w])
    except ValueError:
        print("conv3x3_fused refuses an input that needs a gradient outside TrainConv3x3: ok")
    else:
        raise AssertionError("conv3x3_fused launched on an input that needs a gradient")

    pp = TrainConfig(model_type="unet++", base_filters=32)
    runs = step_three_ways(pp, {"plain": {}, "train_fused_conv": {"train_fused_conv": True}})
    fused, plain = runs["train_fused_conv"], runs["plain"]
    loss_rel = abs(float(fused["metrics"]["total"]) / float(plain["metrics"]["total"]) - 1)
    print(f"U-Net++ (base 32) train step with train_fused_conv: A launches "
          f"{fused['a_launches']} (want {TRAIN_FUSED_LAUNCHES['unet++']}), loss "
          f"{float(fused['metrics']['total']):.6f} (plain {float(plain['metrics']['total']):.6f}, "
          f"rel {loss_rel:.3e}, tol 1e-2), {fused['ms']:.3f} ms/step against {plain['ms']:.3f}, "
          f"peak {fused['peak_gib']:.3f} GiB against {plain['peak_gib']:.3f}")
    if fused["a_launches"] != TRAIN_FUSED_LAUNCHES["unet++"] or loss_rel > 1e-2:
        raise AssertionError("U-Net++ train_fused_conv step disagrees")
    print(f"training variants phase: {time.perf_counter() - t_phase:.1f} s")


def unetpp_train(dev, tmpdir: str, data: str) -> None:
    """One epoch of a deep-supervised U-Net++ at its reference width through
    ``Trainer``: the train-mode blocks and the four heads' averaged loss."""
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(model_type="unet++", base_filters=32, deep_supervision=True,
                      frequency_log=1)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data, work_dir=os.path.join(tmpdir, "train_unetpp"),
                      study_name="smoke-pp", device=dev)
    result = trainer.train(epochs=1)
    torch.cuda.synchronize()
    h = result.history[0]
    print(f"training U-Net++ (base 32, deep supervision): {trainer.state.step} steps in "
          f"{time.perf_counter() - t0:.1f} s, train loss {h['train_loss']:.5f}, "
          f"val loss {h['val_loss']:.5f}")
    if not (math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])
            and trainer.state.step == SAMPLES["train"] // cfg.batch_size
            and result.best_checkpoint and os.path.exists(result.best_checkpoint)):
        raise AssertionError("U-Net++ training: a loss is not finite or a step is missing")


def eval_path(dev, tmpdir: str, data: str, checkpoints: dict[str, str]) -> dict[str, int]:
    """Phase 7: ``evaluate_checkpoint`` on the card for both model families."""
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.data.schema import NormalizationStats
    from maunet_tpu_torch.data.shards import pack_dataset
    from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
    from maunet_tpu_torch.evaluate.evaluator import batch_metrics, evaluate_checkpoint
    from maunet_tpu_torch.evaluate.metrics import dw_map_from_input
    from maunet_tpu_torch.ops.kernels import lstm, masked_stats, packed_vgg, resize_pack
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.utils.dw import DW_CLASSES

    n_test = SAMPLES["test"]
    ds = NpzDataset(os.path.join(data, "test"), T_SERIES)
    present = [{DW_CLASSES[int(k)] for k in dw_map_from_input(
        torch.from_numpy(ds[i]["maps"][None])).unique()} for i in range(n_test)]
    out_dir = os.path.join(tmpdir, "reports")
    # A packed copy of the test split (the train split, which gives the known
    # cities, and the statistics are linked), read through the same call.
    t0 = time.perf_counter()
    packed = os.path.join(tmpdir, "packed")
    pack_dataset(os.path.join(data, "test"), os.path.join(packed, "test"),
                 temporal_length=T_SERIES)
    os.symlink(os.path.join(data, "train"), os.path.join(packed, "train"))
    os.symlink(os.path.join(data, "normalization_metrics.json"),
               os.path.join(packed, "normalization_metrics.json"))
    print(f"packed the test split ({n_test} samples) in {time.perf_counter() - t0:.1f} s")

    def evaluate(path, root, jobid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = evaluate_checkpoint(path, TrainConfig(), data_dir=root, study_name="smoke",
                                   jobid=jobid, n_visualize=0, output_dir=out_dir,
                                   batch_size=EVAL_BATCH, device=dev)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    total: dict[str, int] = {}
    for model_type, path in checkpoints.items():
        fns = reset_launches()
        rows, wall = evaluate(path, data, "1")
        launches = {name: fn.launches for name, fn in fns.items()}
        report = os.path.join(out_dir, f"smoke_{model_type}_emb_0_job1_evaluation.csv")
        if not (os.path.exists(report)
                and os.path.exists(report.replace("_evaluation.csv", "_info.csv"))):
            raise AssertionError(f"evaluation path: {report} was not written")
        with open(report, newline="") as f:
            written = list(csv.DictReader(f))
        if len(written) != len(rows):
            raise AssertionError("evaluation path: the CSV and the returned rows differ")
        if sorted({int(r["sample_idx"]) for r in written}) != list(range(n_test)):
            raise AssertionError("evaluation path: not every test sample has rows")
        for i in range(n_test):
            mine = [r for r in written if int(r["sample_idx"]) == i]
            overall = [r for r in mine if r["dw_class"] == "overall"]
            finite = all(math.isfinite(float(r[k])) for r in mine for k in ("mae", "rmse"))
            for channel in ("after_ndvi", "after_temp"):
                classes = {r["dw_class"] for r in mine
                           if r["channel"] == channel and r["dw_class"] != "overall"}
                if classes != present[i]:
                    raise AssertionError(f"evaluation path: sample {i} has class rows "
                                         f"{sorted(classes)}, its map has {sorted(present[i])}")
            if len(overall) != 2 or not finite:
                raise AssertionError(f"evaluation path: sample {i} lacks two finite overall rows")
        print(f"evaluation path {model_type}: {n_test} samples, {len(rows)} rows in "
              f"{wall:.2f} s, {n_test / wall:.1f} tiles/s on {torch.cuda.get_device_name(0)} "
              f"(host clock; checkpoint load, data decode and the CSV included), "
              f"launches={launches}")
        packed_rows, packed_wall = evaluate(path, packed, "1packed")
        same = [(r["sample_idx"], r["channel"], r["dw_class"]) for r in packed_rows] == [
            (r["sample_idx"], r["channel"], r["dw_class"]) for r in rows]
        worst = max(abs(a["mae"] - b["mae"]) / max(abs(b["mae"]), 1e-12)
                    for a, b in zip(packed_rows, rows))
        print(f"evaluation path {model_type} from the packed split: {n_test / packed_wall:.1f} "
              f"tiles/s against {n_test / wall:.1f} from per-sample files (host clock, as "
              f"above); rows {'equal' if same else 'DIFFER'}, MAE max relative difference "
              f"{worst:.2e} (tol 1e-3)")
        if not (same and worst <= 1e-3):
            raise AssertionError(f"evaluation path {model_type}: the packed split's rows differ")
        missing = [name for name in ("conv3x3_fused", "lstm_last_hidden", "resize_pack",
                                     "masked_class_sums") if launches[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the evaluation path: {missing}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

        # One batch's metrics with the kernels and with the plain versions.
        loaded = load_any_checkpoint(path, device=dev)
        stats = NormalizationStats.from_json(os.path.join(data, "normalization_metrics.json"))
        batch = to_device(host_tensors(next(make_batches(ds, EVAL_BATCH)),
                                       pin=dev.type == "cuda"), dev)
        got, _, _ = batch_metrics(loaded.model, batch, stats, 8)
        prepared = weights_prepared()
        with mock.patch.object(packed_vgg, "conv3x3_fused", packed_vgg.conv3x3_fused_plain), \
                mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
                mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain), \
                mock.patch.object(masked_stats, "masked_class_sums",
                                  masked_stats.masked_class_sums_plain):
            want, _, _ = batch_metrics(loaded.model, batch, stats, 8)
        require_nothing_prepared(prepared, f"evaluation batch {model_type}")
        worst = {}
        for k, tol in [("mae", 1e-2), ("rmse", 1e-2), ("class_mae", 1e-2),
                       ("class_rmse", 1e-2), ("lap_var_pred", 5e-2), ("lap_var_gt", 5e-2)]:
            a, b = got[k].double(), want[k].double()
            if not torch.equal(a.isnan(), b.isnan()):
                raise AssertionError(f"evaluation batch: {k} has NaN in other places")
            rel = ((a - b).abs() / b.abs().clamp_min(1e-12))[~b.isnan()]
            worst[k] = float(rel.max())
            if not worst[k] <= tol:
                raise AssertionError(f"evaluation batch: {k} differs by {worst[k]:.3e} "
                                     f"(tol {tol:g}) from the plain versions")
        if not torch.equal(got["class_present"], want["class_present"]):
            raise AssertionError("evaluation batch: class_present differs")
        print(f"evaluation batch {model_type}, kernels vs plain versions, max relative "
              f"difference: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
              + " (tol 1e-2; Laplacian variances 5e-2)")
    return total


# Blocks whose two convs both take the fused kernel (width <= 64) at full
# width: conv0_0 and conv0_1; conv0_0-conv0_4 and conv1_0-conv1_3.
PAIR_ELIGIBLE = {"unet": 2, "unet++": 9}


def pair_path(dev, checkpoints: dict[str, str]) -> dict[str, int]:
    """Phase 8: both models with ``fuse_pair=True`` against ``fuse_pair=False``."""
    from maunet_tpu_torch.interop.torch_import import load_torch_checkpoint
    from maunet_tpu_torch.models.factory import build_model

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    inputs = [torch.randn((8, 256, 256, 23), generator=g, device=dev),
              torch.randn((8, T_SERIES), generator=g, device=dev),
              torch.randn((8, 8), generator=g, device=dev),
              torch.tensor([828, 828, 600, 414, 100, 1, 0, 827], dtype=torch.int32, device=dev)]
    total: dict[str, int] = {}
    for model_type, path in checkpoints.items():
        state_dict, hp, _ = load_torch_checkpoint(path)
        models = {}
        for fuse_pair in (False, True):
            model = build_model(hp, lstm_mask_mode="batch_max", fuse_pair=fuse_pair)
            model.load_state_dict(state_dict, strict=True)
            models[fuse_pair] = model.to(dev)

        def forward(fuse_pair):
            with torch.inference_mode():
                return models[fuse_pair](*inputs)

        want = forward(False)
        fns = reset_launches()
        got = forward(True)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in fns.items()}
        prepared = weights_prepared()
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or diff > 0.05 * max(scale, 1.0):
            raise AssertionError(f"pair configuration {model_type}: the output differs by "
                                 f"{diff:.3e} from the fuse_pair=False forward")
        if launches["conv3x3_pair_fused"] != PAIR_ELIGIBLE[model_type]:
            raise AssertionError(
                f"pair configuration {model_type}: {launches['conv3x3_pair_fused']} pair "
                f"launches, {PAIR_ELIGIBLE[model_type]} blocks are eligible")
        # In turns (off, on, on, off): the forward is bound by the host's
        # dispatch, whose speed drifts within a run.
        ms = {False: [], True: []}
        for fuse_pair in (False, True, True, False):
            ms[fuse_pair].append(cuda_ms(lambda: forward(fuse_pair)))
        require_nothing_prepared(prepared, f"pair configuration {model_type}")
        print(f"pair configuration {model_type} (8 x 256², bf16): fuse_pair=True "
              f"{ms[True][0]:.3f} and {ms[True][1]:.3f} ms, fuse_pair=False "
              f"{ms[False][0]:.3f} and {ms[False][1]:.3f} ms per forward (CUDA events, "
              f"medians of 10, in turns off, on, on, off); max_abs_diff={diff:.3e} on "
              f"outputs up to {scale:.3f}; launches={launches}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


# Launches of A, B and C per forward of the serving U-Net (base 64), so per
# sweep chunk: the two convs of conv0_0 and of conv0_1 (out <= 64) take A,
# the LSTM B, the four decoder upsamples C.
SWEEP_LAUNCHES = {"conv3x3_fused": 4, "lstm_last_hidden": 1, "resize_pack": 4}
# Rows of phase 9's benchmark suites on the card: inference at B = 1, 8, 16
# and U-Net++, lstm with B and plain at B = 8 and 1, eval with D and plain.
BENCH_ROWS = 4 + 4 + 2


def check_sweep_json(path: str, sweeps: dict[str, int], heatmaps: int) -> dict:
    """A sweep export's schema: each sweep's points, both channels' mean and
    std, ``heatmaps`` 20×20 grids per channel, every number finite."""
    with open(path) as f:
        export = json.load(f)
    numbers = []
    if set(export["sweeps"]) != set(sweeps) or len(export["heatmaps"]) != heatmaps:
        raise AssertionError(f"{path}: sweeps {list(export['sweeps'])}, "
                             f"{len(export['heatmaps'])} heatmaps")
    for name, steps in sweeps.items():
        sweep = export["sweeps"][name]
        curves = [sweep["x"]] + [c[k] for c in sweep["channels"].values() for k in ("mean", "std")]
        if len(sweep["channels"]) != 2 or any(len(c) != steps for c in curves):
            raise AssertionError(f"{path}: sweep {name} is not {steps} points of 2 channels")
        numbers += [v for c in curves for v in c]
    for hm in export["heatmaps"].values():
        for data in hm["channels"].values():
            values = np.asarray(data["values"], dtype=float)
            if values.shape != (20, 20) or len(data["lats"]) != 20 or len(data["lons"]) != 20:
                raise AssertionError(f"{path}: a heatmap is not 20 x 20")
            numbers += values.ravel().tolist()
    if not all(map(math.isfinite, numbers)):
        raise AssertionError(f"{path}: a value is not finite")
    return export


def research_path(dev, tmpdir: str, data: str, checkpoint: str) -> None:
    """Phase 9: the sweeps, the benchmark suites and a study through the
    port's research command line, on the serving U-Net's checkpoint."""
    from maunet_tpu_torch import benchmarks, cli
    from maunet_tpu_torch.analysis import sensitivity
    from maunet_tpu_torch.data.dataset import NpzDataset
    from maunet_tpu_torch.data.schema import NormalizationStats
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack
    from maunet_tpu_torch.train.config import TrainConfig

    t_phase = time.perf_counter()
    eval_csv = os.path.join(tmpdir, "reports", "smoke_unet_emb_0_job1_evaluation.csv")
    rows = sensitivity.read_eval_csv(eval_csv)
    out_dir = os.path.join(tmpdir, "sensitivity")

    def chunks(n: int) -> int:
        return -(-n // sensitivity.VARIANT_CHUNK)

    def sweep(run, what, n_chunks, **kw):
        """``run`` on the card with the launch counters from 0, the model it
        loads kept and weights_prepared() read after its first forward."""
        seen = {}
        real = sensitivity.load_any_checkpoint

        def after_first_forward(*_):      # a hook that returns None keeps the output
            seen.setdefault("prepared", weights_prepared())

        def loading(*a, **k):
            loaded = real(*a, **k)
            loaded.model.register_forward_hook(after_first_forward)
            seen["loaded"] = loaded
            return loaded

        with mock.patch.object(sensitivity, "load_any_checkpoint", loading):
            fns = reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = run(checkpoint, eval_csv, TrainConfig(), data_dir=data,
                       output_dir=out_dir, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {name: fns[name].launches for name in SWEEP_LAUNCHES}
        want = {name: k * n_chunks for name, k in SWEEP_LAUNCHES.items()}
        print(f"{what}: {n_chunks} chunks in {wall:.2f} s, launches={launches} "
              f"(A, B, C per chunk {[launches[n] / n_chunks for n in SWEEP_LAUNCHES]})")
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
        require_nothing_prepared(seen["prepared"], what)
        return path, wall, seen["loaded"]

    # The metadata sweep: every test sample, 50 + 50 variants, and 400 for
    # each highlighted sample.
    all_idx, targets, _, _ = sensitivity.select_samples(rows)
    n_chunks = 2 * len(all_idx) * chunks(sensitivity.LAT_STEPS) + len(targets) * chunks(
        sensitivity.HEAT_STEPS ** 2)
    variants = 100 * len(all_idx) + sensitivity.HEAT_STEPS ** 2 * len(targets)
    path, wall, loaded = sweep(sensitivity.run_sensitivity, "metadata sweep", n_chunks,
                               make_plots=False)
    check_sweep_json(path, {"latitude": 50, "longitude": 50}, len(targets))
    print(f"metadata sweep: {len(all_idx)} samples ({len(targets)} highlighted), "
          f"{variants} variants, {variants / wall:.1f} variants/s (host clock around "
          f"run_sensitivity, JSON written); schema ok")

    # One latitude chunk, timed, and against the plain versions.
    stats = NormalizationStats.from_json(os.path.join(data, "normalization_metrics.json"))
    sweeper = sensitivity.Sweeper(loaded, stats)
    sample = NpzDataset(os.path.join(data, "test"), T_SERIES)[targets[0]]
    tile = sweeper.upload(sample)
    meta = np.tile(sample["metadata"], (sensitivity.LAT_STEPS, 1))
    meta[:, 0] = (sensitivity.LAT_RANGE - stats.meta_mean[0]) / stats.meta_std[0]
    meta = torch.from_numpy(meta).to(dev)
    chunk_ms = cuda_ms(lambda: sweeper.means(*sweeper.chunk_inputs(tile, meta)))
    prepared = weights_prepared()
    got = sweeper.means(*sweeper.chunk_inputs(tile, meta))
    with mock.patch.object(packed_vgg, "conv3x3_fused", packed_vgg.conv3x3_fused_plain), \
            mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
            mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain):
        want = sweeper.means(*sweeper.chunk_inputs(tile, meta))
    require_nothing_prepared(prepared, "sweep chunk")
    scale = want.abs().amax(dim=0)
    worst = float(((got - want).abs().amax(dim=0) / scale).max())
    print(f"sweep chunk (50 variants x 256², bf16): {chunk_ms:.3f} ms (CUDA events, median "
          f"of 10, inputs expanded on the card); against the plain versions, per channel "
          f"max |diff| / max |mean| = {worst:.3e} (tol 1e-2)")
    if not worst <= 1e-2:
        raise AssertionError("a sweep chunk disagrees with its plain versions")

    # The temporal sweep: 41 offsets of each of 24 samples, one chunk each.
    t_idx, _, _, _ = sensitivity.select_samples(rows, 24)
    path, wall, _ = sweep(sensitivity.run_temporal_sensitivity, "temporal sweep",
                          len(t_idx) * chunks(sensitivity.TEMP_OFFSET_STEPS))
    check_sweep_json(path, {"temporal_offset": 41}, 0)
    print(f"temporal sweep: {len(t_idx)} samples x 41 offsets, "
          f"{len(t_idx) * 41 / wall:.1f} variants/s; schema ok")

    # The benchmark suites through the command line, each row on its own
    # line; the plain recurrence (about 0.2 s a call) at fewer iterations.
    captured = io.StringIO()
    quick_lstm = functools.partial(benchmarks.bench_lstm, iters=5, repeats=2)
    with mock.patch.dict(benchmarks.SUITES, lstm=quick_lstm), \
            contextlib.redirect_stdout(captured):
        cli.main(["bench", "--suite", "inference", "lstm", "eval", "--device", str(dev),
                  "--out", os.path.join(tmpdir, "bench.json"),
                  "--tmp-dir", os.path.join(tmpdir, "bench")])
    with open(os.path.join(tmpdir, "bench.json")) as f:
        bench_rows = json.load(f)
    for row in bench_rows:
        print(f"bench row: {json.dumps(row)}")
        if not (math.isfinite(row["value"]) and row["value"] > 0):
            raise AssertionError(f"bench row {row['metric']} is not a finite positive number")
    if len(bench_rows) != BENCH_ROWS:
        raise AssertionError(f"bench: {len(bench_rows)} rows, want {BENCH_ROWS}")

    # A one-trial study of one epoch through the command line's train.
    fns = reset_launches()
    work = os.path.join(tmpdir, "study")
    cli.main(["train", "--data-dir", data, "--work-dir", work, "--study-name", "smoke",
              "--n-trials", "1", "--epochs", "1", "--device", str(dev)])
    with open(f"{work}_hpo/smoke-emb.json") as f:
        trials = json.load(f)["trials"]
    launched = {name: fns[name].launches for name in ("lstm_forward_stash", "lstm_backward")}
    print(f"study: {len(trials)} trial, state {trials[0]['state']}, value "
          f"{trials[0]['value']}, launches={launched}")
    if [t["state"] for t in trials] != ["COMPLETE"] or not math.isfinite(trials[0]["value"]):
        raise AssertionError(f"study: the trial did not complete: {trials}")
    if 0 in launched.values():
        raise AssertionError("study: the training kernels were not launched")
    print(f"research command line: {time.perf_counter() - t_phase:.1f} s")


# Launches of A, B and C in the planner's two predicts (the baseline and the
# painted scenario), one forward each: SWEEP_LAUNCHES twice.
PLANNER_LAUNCHES = {name: 2 * n for name, n in SWEEP_LAUNCHES.items()}


def planner_path(dev, tmpdir: str, checkpoint: str) -> None:
    """Phase 10: the planner app, headless, on the serving U-Net at its
    default 512² with the bundled demo tiles and a painted canvas."""
    import importlib.util

    from maunet_tpu_torch.apps import headless, planner
    from maunet_tpu_torch.apps.engine import CANVAS_RGB, PlannerEngine
    from maunet_tpu_torch.apps.planner_core import load_demo_layers
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack

    if importlib.util.find_spec("PIL") is None:
        raise AssertionError("planner: PIL is not installed, so canvas_background cannot "
                             "build the canvas image")
    t_phase = time.perf_counter()
    models = os.path.join(tmpdir, "models")
    os.makedirs(models)
    os.symlink(checkpoint, os.path.join(models, os.path.basename(checkpoint)))
    # A block of trees painted over the demo tile's built-up centre.
    hw = PLANNER_HW
    canvas = np.zeros((hw, hw, 4), np.uint8)
    block = (slice(hw // 4, 3 * hw // 4),) * 2
    canvas[block + (slice(0, 3),)] = CANVAS_RGB[1]
    canvas[block + (3,)] = 255
    built = float((load_demo_layers(hw)["dw"][block] == 6).mean())

    seen = {"inputs": [], "outputs": []}

    class Recording(PlannerEngine):
        def predict(self, inp):
            out = super().predict(inp)
            seen.setdefault("prepared", weights_prepared())
            seen["engine"] = self
            seen["inputs"].append(inp)
            seen["outputs"].append(out)
            return out

    real_views = planner.prediction_views

    def views(*a):
        out = real_views(*a)
        seen["delta"] = out[1]
        return out

    argv = ["--models-dir", models, "--cache-dir", os.path.join(tmpdir, "app_cache"),
            "--device", str(dev), "--img-size", str(hw), "--temporal-length", str(T_SERIES)]
    with mock.patch.object(planner, "PlannerEngine", Recording), \
            mock.patch.object(planner, "prediction_views", views):
        fns = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = headless.run_planner(argv, answers={"Run Prediction": True}, canvas_rgba=canvas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fns[name].launches for name in PLANNER_LAUNCHES}
    images = st.rendered("image")
    print(f"planner (headless, {hw}², bf16, demo tiles, a {hw // 2}² block of trees over "
          f"{built:.0%} built land): {wall:.2f} s for the app's run (engine load, demo tiles "
          f"resized 256 -> {hw}, two predicts), {len(images)} images, metric "
          f"{st.rendered('metric')}, launches={launches}")
    if not any("cache-only" in str(w) for w in st.rendered("warning")):
        raise AssertionError("planner: not in cache-only mode")
    if len(images) != 7 or st.rendered("st_canvas") != ["canvas"]:
        raise AssertionError(f"planner: {len(images)} images, canvas {st.rendered('st_canvas')}")
    if not all(img.shape[:2] == (hw, hw) for img in images):
        raise AssertionError(f"planner: image shapes {[img.shape for img in images]}")
    if not math.isfinite(seen.get("delta", math.nan)):
        raise AssertionError(f"planner: the mean-ΔT metric is {seen.get('delta')}")
    if launches != PLANNER_LAUNCHES:
        raise AssertionError(f"planner: launches {launches}, want {PLANNER_LAUNCHES}")
    require_nothing_prepared(seen["prepared"], "planner")
    # From here on the engine's own predict, which records nothing.
    engine, inputs, outputs = seen["engine"], seen["inputs"], seen["outputs"]
    predict = functools.partial(PlannerEngine.predict, engine)
    for label, (ndvi, lst) in zip(("baseline", "painted"), outputs):
        check_outputs(f"planner {label}", ndvi, lst, hw)

    # The same two requests through the plain versions.
    with mock.patch.object(packed_vgg, "conv3x3_fused", packed_vgg.conv3x3_fused_plain), \
            mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
            mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain):
        plain = [predict(inp) for inp in inputs]
    s_ = engine.stats

    def normalized(outs):
        return np.stack([np.stack([nd, (ls - s_.temp_mean) / s_.temp_std]) for nd, ls in outs])

    got, want = normalized(outputs), normalized(plain)
    diff, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(f"planner vs plain versions: max_abs_diff={diff:.4e} (output max |x| {scale:.4f}, "
          f"tol {0.05 * max(scale, 1.0):.4f}); mean ΔT {seen['delta']:+.4f} °C")
    if diff > 0.05 * max(scale, 1.0):
        raise AssertionError("planner disagrees with its plain versions")

    # One predict at 512²: the forward on card-resident inputs (CUDA events),
    # and the call from host arrays to host arrays (host clock).
    inp = inputs[1]
    args = [torch.as_tensor(a, device=dev) for a in
            (inp.maps, inp.temp_series, inp.metadata, inp.temp_lengths)]
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: engine.model(*args))
    host_ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(inp)
        torch.cuda.synchronize()
        if i >= 1:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"planner predict (1 x {hw}², bf16): forward {forward_ms:.3f} ms (CUDA events, "
          f"median of 10, inputs on the card); predict {statistics.median(host_ms):.3f} ms "
          f"(host clock, median of {len(host_ms)}, {inp.maps.nbytes / 2**20:.0f} MiB of maps "
          f"copied in)")
    require_nothing_prepared(seen["prepared"], "planner predict")
    print(f"planner phase: {time.perf_counter() - t_phase:.1f} s")


# Phase 11's cut of the science loop: the JAX defaults but the sample counts
# and epochs (maunet_tpu/analysis/science.py:132-144: 192/32/48, 64 epochs).
SCIENCE = {"hw": 64, "temporal_len": T_SERIES, "base_filters": 16, "batch_size": 8,
           "epochs": 2, "samples": {"train": 48, "val": 16, "test": 24}}
SCIENCE_TRAINING = ("lstm_forward_stash", "lstm_gate_terms", "lstm_backward", "lstm_dw")


def structure(value):
    """The nested key structure of a summary."""
    if isinstance(value, dict):
        return {k: structure(v) for k, v in value.items()}
    return "number" if isinstance(value, (int, float)) else type(value).__name__


def science_path(dev, tmpdir: str) -> None:
    """Phase 11: the ablation science loop at a cut size, then ``cli stats``."""
    from maunet_tpu_torch import cli
    from maunet_tpu_torch.analysis import science
    from maunet_tpu_torch.evaluate import evaluator
    from maunet_tpu_torch.train import loop

    t_phase = time.perf_counter()
    fns = reset_launches()
    launched = {"training": dict.fromkeys(fns, 0), "evaluation": dict.fromkeys(fns, 0)}

    def counted(kind, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            before = {name: f.launches for name, f in fns.items()}
            try:
                return fn(*a, **k)
            finally:
                for name, f in fns.items():
                    launched[kind][name] += f.launches - before[name]
        return run

    work = os.path.join(tmpdir, "science")
    with mock.patch.object(loop.Trainer, "train", counted("training", loop.Trainer.train)), \
            mock.patch.object(evaluator, "evaluate_checkpoint",
                              counted("evaluation", evaluator.evaluate_checkpoint)):
        summary = science.run_science_loop(work_dir=work, device=dev, **SCIENCE)
    wall = time.perf_counter() - t_phase
    csvs = sorted(glob.glob(os.path.join(work, "tests", "*_evaluation.csv")))
    for name in ("comparative_ttests.csv", "nonparametric_tests.csv", "summary.json",
                 "REPORT.md"):
        if not os.path.exists(os.path.join(work, name)):
            raise AssertionError(f"science loop: {name} is missing")
    if len(csvs) != 4:
        raise AssertionError(f"science loop: {len(csvs)} evaluation CSVs")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "reports", "science", "summary.json")) as f:
        if structure(summary) != structure(json.load(f)):
            raise AssertionError("science loop: the summary's keys differ from the committed run's")
    sens = summary["sensitivity"]
    slopes = [sens[k]["slope_per_degree"] for k in
              ("emb_lat_response", "noemb_lat_response", "gt_lat_response")] + [
        sens[k]["slope_per_zunit"] for k in
        ("tempemb_temporal_response", "noemb_temporal_response")]
    if not all(map(math.isfinite, slopes)):
        raise AssertionError(f"science loop: slopes {slopes}")
    training = {n: launched["training"][n] for n in SCIENCE_TRAINING}
    evaluation = launched["evaluation"]["masked_class_sums"]
    mae = {n: round(v["lst_mae_c"], 3) for n, v in summary["variants"].items()}
    print(f"science loop ({SCIENCE['samples']} tiles of {SCIENCE['hw']}², "
          f"T = {SCIENCE['temporal_len']}, base {SCIENCE['base_filters']}, "
          f"{SCIENCE['epochs']} epochs, four variants): {wall:.1f} s; LST MAE {mae}; "
          f"significant wins over noemb {summary['significant_lst_wins_over_noemb']}; "
          f"slopes (emb, noemb, gt per degree; tempemb, noemb per z-unit) "
          f"{[float(f'{x:.4g}') for x in slopes]}; training launches {training}, "
          f"D in evaluation {evaluation}")
    if 0 in training.values() or evaluation == 0:
        raise AssertionError("science loop: a kernel of its path was not launched")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["stats", *csvs, "--output-dir", os.path.join(work, "stats")])
    if rc != 0 or not os.path.exists(os.path.join(work, "stats", "comparative_ttests.csv")):
        raise AssertionError(f"cli stats: exit {rc}")
    print(f"cli stats over the four CSVs: exit {rc}; science phase "
          f"{time.perf_counter() - t_phase:.1f} s")


LSTM_CU = "maunet_tpu_torch/csrc/lstm.cu"
# name: (source, TPU kernel replaced, the path whose launches the summary gives)
KERNEL_INFO = {
    "conv3x3_fused": ("maunet_tpu_torch/csrc/conv3x3_fused.cu",
                      "maunet_tpu/ops/pallas/packed_vgg.py:451", "serving"),
    "lstm_last_hidden": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:402", "serving"),
    "resize_pack": ("maunet_tpu_torch/csrc/resize_pack.cu",
                    "maunet_tpu/ops/pallas/resize_pack.py:216", "serving"),
    "lstm_forward_stash": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:290", "training"),
    # F's first launch: the gate recompute of the TPU backward (lstm.py:247-248)
    "lstm_gate_terms": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:387", "training"),
    "lstm_backward": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:334", "training"),
    # the dW sum that the TPU backward keeps in its body (lstm.py:266)
    "lstm_dw": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:334", "training"),
    "masked_class_sums": ("maunet_tpu_torch/csrc/masked_stats.cu",
                          "maunet_tpu/ops/pallas/masked_stats.py:60", "evaluation"),
    "conv3x3_pair_fused": ("maunet_tpu_torch/csrc/conv3x3_pair.cu",
                           "maunet_tpu/ops/pallas/packed_vgg.py:373", "pair"),
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
        checkpoints = {m: write_checkpoint(tmpdir, m) for m in FULL_WIDTH}
        data = make_data(tmpdir)
        launches = {"serving": serving_path(dev, checkpoints["unet"]),
                    "training": train_path(dev, tmpdir, data)}
        train_variants_path(dev, data)
        unetpp_train(dev, tmpdir, data)
        launches["evaluation"] = eval_path(dev, tmpdir, data, checkpoints)
        launches["pair"] = pair_path(dev, checkpoints)
        research_path(dev, tmpdir, data, checkpoints["unet"])
        planner_path(dev, tmpdir, checkpoints["unet"])
        science_path(dev, tmpdir)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[path][name], **table.summary(name)}
               for name, (src, replaces, path) in KERNEL_INFO.items()]
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
