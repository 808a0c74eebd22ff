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
   upsamples, and the LSTM at 16 lengths between T/2 and T.  B, E and F
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
   deep-supervised U-Net++ (base 32) then trains one epoch on the same data;
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
   turns (off, on, on, off).

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
  pair configuration vs two launches per block: as the serving path, 5%.
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
# LSTM lengths of phase 3's evaluation-batch check of B: the synthetic split
# draws each sample's from T/2..T.
EVAL_LENGTHS = [828, 414, 700, 512, 621, 799, 450, 828, 733, 580, 666, 415, 777, 502, 640, 811]
# The LSTM lengths of phase 3's predict_many batch (B=8) for B.
SERVING_LENGTHS = [828, 828, 600, 414, 100, 1, 0, 827]
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
# count that takes the kernel's one-channel-per-thread path.
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
    ((2, 15, 15, 3), (30, 31), torch.bfloat16, False))


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
    # conv2 of each level).
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
                  for hw, cins, width, with_add in UNETPP_CONVS])
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
    # mixed lengths, at B=1 (predict) and at the evaluation batch.  Its bound counts the steps this
    # batch's lengths need; the library call is cuDNN's LSTM over the raw
    # series at full length (what batch_max masking runs).
    hidden = 96
    gates = 4 * hidden

    def lstm_case(lens, hidden=hidden, t=T_SERIES):
        x_proj, w_hh, lengths = lstm_inputs(g, dev, hidden, t, lens)
        return lengths, x_proj, w_hh, f"({len(lens)}, {t}, {4 * hidden}) lengths={lens}"

    cudnn_lstm = torch.nn.LSTM(1, hidden, batch_first=True).to(dev)
    for lens, on_path in [(SERVING_LENGTHS, True), ([828], False), (EVAL_LENGTHS, False)]:
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
    r1 = Trainer(cfg, data, work_dir=work, study_name="smoke", device=dev).train(epochs=1)
    trainer = Trainer(cfg, data, work_dir=work, study_name="smoke", device=dev)
    r2 = trainer.train(epochs=2, resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
        unetpp_train(dev, tmpdir, data)
        launches["evaluation"] = eval_path(dev, tmpdir, data, checkpoints)
        launches["pair"] = pair_path(dev, checkpoints)

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
