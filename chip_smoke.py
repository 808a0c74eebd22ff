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
   Two launches of C, D and dW on the same inputs must give the same bits.
   A and G also run their f32 entries (``csrc/conv3x3_f32.cu``): A at the
   serving, evaluation (U-Net and U-Net++) and planner shapes and two odd
   sizes, G at the eleven pair blocks (B = 8) and two odd sizes, each
   against its plain version in f32 and beside cuDNN's f32 conv with the
   same epilogue (TF32 off), G also against the two f32 A launches it
   replaces, whose bits it must give (both sum each output in one order);
   ``nvcc -Xptxas -v`` on that source, run beside the build, gives
   each f32 instantiation's registers and spills for their rows.  The
   fused train-mode BatchNorm (``csrc/batchnorm_train.cu``, through
   ``bn_relu_train``, forward and backward) runs at the U-Net's 18 train
   shapes (B = 16, 256², five distinct) and U-Net++'s five, in bf16 and
   f32, and on two row-cropped views, against its plain version (the
   output, the running statistics and the gradients of y, weight and
   beta), twice with the same bits (a view also with its contiguous copy's),
   beside cuDNN's train-mode ``F.batch_norm`` with ReLU and its bound of
   10 bytes an element in bf16; a line sums a U-Net step's 18;
4. golden: the small U-Net and U-Net++ of ``tests/fixtures/golden_unet.npz``
   and ``golden_unetpp.npz`` run on the card in bf16 and in f32 (A's entry
   of that dtype alone launching) and are held against the JAX package's
   recorded f32 outputs;
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
   evaluation; ``cli stats`` over the four CSVs must exit 0;
12. research app: ``apps/research.py`` runs headless
   (``apps/headless.run_research_page``) with ``--device cuda``.  Its model
   browser loads phase 5's U-Net and phase 7's U-Net++ checkpoints and
   predicts the first test sample of phase 6's split (B = 1, 256², T =
   828): A, B and C must launch exactly one forward's worth a family
   (``BROWSER_LAUNCHES``: 4, 1, 4 and 18, 1, 10), the maps must be finite
   and agree with the same page run with the plain versions patched in,
   within 5% of the output's largest magnitude, as in phase 5; the
   ``Parameters`` metric must be the model's parameter count, the
   interactive diagram rendered once, and each of the three figures drawn
   or, without matplotlib, one info line; one ``predict_batch`` is timed on
   the host clock.  The other five pages render over phase 7's two
   evaluation CSVs and the split (the t-test frame not empty); ``cli eda
   extract`` over the test split (one row a sample) and ``analyze-csv``
   must exit 0; the native ``.npz`` decoder must give every test sample
   bit-equal to numpy's, and the loader suite prints its numpy, native and
   shards rows (16 samples).

13. data parallelism (``parallel/``) at full width (``TrainConfig``'s
   defaults, 256², T = 828, phase 6's data), TF32 off in every process:
   (a) one ``train_step`` at global batch 16 from one seeded state, plainly
   and under a world-size-1 NCCL group made by ``initialize_multihost``,
   cuDNN deterministic: the parameters, running statistics and
   ``grad_norm`` must be the same bits (the group's collectives are
   skipped at one rank), and E, F, dW and C must launch; (b) two Gloo ranks
   on ``cuda:0`` in two worker processes (``tests/torch_multihost_worker.py``):
   one f32 SGD step (lr 1e-2, no momentum) at 8 + 8 rows against this
   process's step on the same 16, parameters within 1e-5, the loss and the
   running statistics within 1e-5 relative (with a floor of 1e-5 of each
   tensor's largest statistic); both ranks must end with the same bits; then
   one ``Trainer`` epoch of the two ranks: each rank's rows of every batch,
   disjoint epoch rows covering the split, one val loss on both, and rank
   0's checkpoint restored into a state of another seed reproducing it;
   (c) ``evaluate_checkpoint`` of phase 5's U-Net over ``make_mesh`` of
   ``[cuda:0]`` (the unsharded call's rows, bit for bit) and of ``[cuda:0,
   cuda:0]`` (within phase 7's tolerance), and ``predict_many`` of 7
   requests over the two-entry mesh (padded to 8) against the unsharded
   call, within phase 5's tolerance; A, B, C and D must launch.

14. the spatial axis (``parallel/spatial.py``: each image's rows sharded
   over the ranks of a data index, halo rows exchanged around every 3x3
   conv, resize and loss window), Gloo ranks sharing ``cuda:0`` in worker
   processes: (a) C's row entry at the serving U-Net's four upsamples and
   U-Net++'s four level resizes (B = 8, bf16) for every band of 2 and 4
   ranks, each band's rows equal to the whole launch's bit for bit and held
   against the windowed plain version, timed beside the whole launch; (b)
   the full-width serving forward (B = 8, 256², bf16) at (data, spatial)
   (1, 2) and (1, 4), the gathered bands within phase 5's 5% of the
   unsharded forward, each rank launching A 4, B 1 and C's row entry 4
   times (the whole resize none); (c) one train step at ``TrainConfig``'s
   defaults in f32 (AdamW, l1-gradient-ssim) at (1, 2) and (2, 2) against
   this process's step from the same state and batch: the ranks' states
   the same bits, the loss within 1e-6 relative, the running statistics
   and the parameters within 1e-5 of (|value| + the tensor's largest),
   where a parameter may also differ by what AdamW's first update lr g /
   (|g| + eps) makes of the two gradients' difference (near g = 0 it turns
   rounding into up to 2 lr), the gradients within JAX's 2e-4 * max(1,
   max|g|), E, F's two launches and dW once a rank; each rank's step ms and
   peak of allocated memory (``utils.profiling.device_memory_stats``)
   beside this process's; (d) one ``Trainer`` epoch at (1, 2) at
   ``TrainConfig``'s defaults (bf16) on phase 6's data: the same val-loss
   bits on both ranks, within 1e-2
   relative of this process's epoch (three bf16 AdamW steps from gradients
   that any other order of their sums moves by up to 2% of a tensor's
   largest, as a data-parallel split does: ``profile_port.py
   --grad-spread``), and rank 0's checkpoint restored reproducing it;
15. f32 paths (the TPU kernels compute in the parts' dtype, so f32 models
   run A's and G's f32 entries): (a) both full-width models (U-Net base 64,
   U-Net++ base 32) in f32 on 8 test samples, against the plain versions and
   with ``fuse_pair`` (G's f32 entry at each eligible block) against the
   forward of two launches a block; (b) ``maunet-torch evaluate --precision
   float32`` on phase 6's split; (c) a ``Trainer`` epoch at ``TrainConfig``'s
   defaults in f32, its validation included; (d) one f32 train step with
   ``train_fused_conv`` (A's f32 entry exactly 4 launches) against the plain
   step; (e) the (1, 2) spatial forward of (a)'s U-Net in f32 on two Gloo
   ranks sharing the card, against (a)'s unsharded forward; in each of
   (a)-(e) the f32 counters must rise, the bf16 ones stay at 0, and no
   eval-mode block conv of at most 64 outputs may go to cuDNN.  Then the
   command line's train across ranks: (f) ``cli.main(["train", "--search",
   ...])`` on the same two ranks (one study, the same trial bits on both),
   and (g) ``python -m torch.distributed.run --nproc-per-node 1 -m
   maunet_tpu_torch.cli train`` beside the plain command, started at the
   phase's beginning, whose histories must agree.

The line before the last is the kernel summary JSON: per kernel the launch
count of its path (A, B, C: serving; E, F's gate terms, F, dW: training; D:
evaluation; G: the pair configuration; C's row entry, ``resize_rows``: one
rank's serving forward at (1, 2); A's f32 entry: phase 15's f32 U-Net
forward; G's: both models' f32 fuse_pair forwards), and over that path's
shapes in phase 3 (B = 8 at 256² for A, A in f32 and C, B = 8 for B, B = 16
for E, F's two launches (the ``lstm_backward`` row times both), dW and D,
the eleven eligible blocks at B = 8 for G and G in f32; one launch per
distinct shape; for C's row entry, phase 14's band 0 of 2 at the four
serving upsamples) the largest
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
  conv3x3_fused and conv3x3_pair_fused in f32 (f32 entries): <= 1e-5 +
    1e-5 |plain|, f32 sums of up to 1,728 products in other orders; the pair
    against two f32 A launches the same (they sum in the same order);
  golden fixtures, bf16 against f32: <= 3e-2 (the port's bf16 forward on
    the CPU is 6.4e-3 from the U-Net's, on outputs up to 0.85); f32 against
    f32: <= 1e-4;
  f32 forwards (phase 15 (a), (e)): <= 1e-3 of the output's largest
    magnitude (or 1e-3); the f32 fused train step: loss within 1e-5 and
    gradient norm within 1e-4 relative; the torchrun and plain commands'
    val losses within 1e-4 relative (cuDNN's f32 backward sums in no fixed
    order);
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
  resize row window (bf16): against the whole launch, the same bits; against
    its windowed plain version, as the resize, 1e-2 + 1e-2 |plain|;
  spatial serving forward vs unsharded: as the serving path, 5%;
  spatial train step vs one process (f32, TF32 off): see phase 14 (c);
  bn_relu_train (the statistics summed in other orders on the two sides):
    out and dy <= 1e-2 + 1e-2 |plain| in bf16, 1e-4 + 1e-4 |plain| in f32;
    dweight and dbias <= 2e-3 of the tensor's largest; running statistics
    <= 1e-5 + 1e-5 |plain|; an element within rounding of the ReLU's edge may
    take the other side (its dy left out, its term allowed in its channel's
    sums; at most 16 + 1e-6 of the elements);
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
# The golden fixtures in f32 on the card: every kernel in f32 and TF32 off,
# so only the orders of the f32 sums differ from JAX's.
GOLDEN_TOL_F32 = 1e-4
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
        if on_path:
            self.add(name, err, ms, plain_ms, bytes_ms, ops_ms, library_ms)
        return ms

    def add(self, name: str, err: float, ms: float, plain_ms: float, bytes_ms: float,
            ops_ms: float, library_ms: float | None, times: int = 1) -> None:
        """Enter one path shape, ``times`` over, into the kernel's summary row."""
        row = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0,
            "library_ms": None if library_ms is None else 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += times * ms
        row["plain_ms"] += times * plain_ms
        row["bound_ms"] += times * max(bytes_ms, ops_ms)
        row["bytes_ms"] += times * bytes_ms
        row["ops_ms"] += times * ops_ms
        if library_ms is not None:
            row["library_ms"] += times * library_ms

    def summary(self, name: str) -> dict:
        """The kernel's row of the summary line; ``bound_by`` says which of
        the two summed times is the larger."""
        row = dict(self.rows[name])
        row["bound_by"] = "bytes" if row.pop("bytes_ms") >= row.pop("ops_ms") else "operations"
        return row


def conv_work(b: int, hw, cins, cout: int, with_add: bool, kind: str = "bf16"):
    """One fused conv's bytes (parts and output in ``kind``, f32 weights,
    scale, bias and add, each once) and operations (multiply-adds in
    ``kind``: bf16 or f32)."""
    h, w = hw
    cin = sum(cins)
    nbytes = (b * h * w * (cin + cout) * (2 if kind == "bf16" else 4) + 9 * cin * cout * 4
              + 2 * cout * 4 + (b * 3 * w * cout * 4 if with_add else 0))
    return nbytes, 2 * b * h * w * 9 * cin * cout, kind


def train_conv_work(b: int, cins, cout: int):
    """A train_fused_conv forward at 256²: bf16 parts and output and the f32
    weight slices, each once, and its bf16 multiply-adds (no epilogue)."""
    cin = sum(cins)
    nbytes = b * 256 * 256 * (cin + cout) * 2 + 9 * cin * cout * 4
    return nbytes, 2 * b * 256 * 256 * 9 * cin * cout, "bf16"


def cudnn_block(parts, convs, add, dtype=torch.bfloat16):
    """The library yardstick of the conv kernels: for each (weights, scale,
    bias) of ``convs`` a cuDNN conv in ``dtype`` (bf16, or f32 with TF32 off)
    over the concatenated parts with its epilogue (bias, the first conv's
    ``add``, ReLU).  The weights are folded and laid out once, outside the
    timed call, as a deployed model would."""
    from maunet_tpu_torch.ops.kernels import packed_vgg

    folded = []
    for weights, scale, bias in convs:
        wt = (torch.cat(list(weights), 1) * scale[:, None, None, None]).to(dtype)
        folded.append((wt.contiguous(memory_format=torch.channels_last), bias.to(dtype)))
    if add is not None:
        add = (add * convs[0][1]).to(dtype)

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


F32_SOURCE = "maunet_tpu_torch/csrc/conv3x3_f32.cu"
# A and G in f32 against their plain versions (F.conv2d in f32, TF32 off):
# |kernel - plain| <= F32_TOL (1 + |plain|).  Both sum up to 9 x 192 f32
# products per output, in other orders where cuDNN splits the sum.
F32_TOL = 1e-5
# Phase 3's shapes of A in f32: (batch, (H, W), the parts' channels, cout,
# with add, on the path, note): the serving batch's three level-0 convs, the
# evaluation batch's of both models, the planner's at B = 1, and two odd ones.
F32_LEVEL0 = ((23,), (64,), (64, 128))
F32_A_CASES = tuple(
    [(8, (256, 256), cins, 64, False, True, " serving") for cins in F32_LEVEL0]
    + [(EVAL_BATCH, (256, 256), cins, 64, False, False, " evaluation U-Net")
       for cins in F32_LEVEL0]
    + [(EVAL_BATCH, hw, cins, width, with_add, False, " evaluation U-Net++")
       for hw, cins, width, with_add in UNETPP_CONVS]
    + [(1, (PLANNER_HW, PLANNER_HW), cins, 64, False, False, " planner")
       for cins in F32_LEVEL0]
    + [(2, (125, 125), (23, 40), 48, True, False, ""),
       (2, (33, 47), (16,), 80, True, False, "")])
# ... and of G: (batch, (H, W), conv1's parts' channels, cmid, cout, with add,
# on the path): the pair configuration's blocks at B = 8, and two odd ones.
F32_G_CASES = tuple(
    [(8, hw, cins, width, width, with_add, True) for hw, cins, width, with_add in PAIR_BLOCKS]
    + [(2, (125, 125), (23, 40), 48, 40, True, False),
       (2, (33, 47), (16,), 20, 7, True, False)])


def start_ptxas(source: str) -> subprocess.Popen:
    """``nvcc -Xptxas -v`` on one source, started beside the build."""
    from maunet_tpu_torch.ops.kernels import _build

    out = os.path.join(tempfile.mkdtemp(), "ptxas.o")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                             source, "-o", out], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def ptxas_registers(proc: subprocess.Popen, kernels: tuple[str, ...]) -> dict[str, str]:
    """The registers and spill stores that ptxas reported for each
    instantiation of ``kernels`` (by name), as ``name<template args>``."""
    import re

    _, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"ptxas -v failed:\n{err[-3000:]}")
    pattern = re.compile(f"({'|'.join(kernels)})I((?:Li\\d+E)+)")
    regs, name, spilled = {}, None, "?"
    for line in err.splitlines():
        m = pattern.search(line) if "Compiling entry" in line else None
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            spilled = spill.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            regs[name] = f"{used.group(1)} registers, {spilled} bytes spilled"
            name = None
    return regs


def check_f32_kernels(table: KernelTable, dev, registers: dict[str, str]) -> None:
    """Phase 3, f32: A's f32 entry at the serving, evaluation and planner
    shapes and G's at the pair configuration's blocks, each against its
    plain version in f32 and beside cuDNN's f32 conv with the same epilogue
    (TF32 off); G also against the two f32 A launches it replaces."""
    from maunet_tpu_torch.ops.kernels import packed_vgg

    g = torch.Generator(device=dev).manual_seed(SEED + 16)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def conv_params(cins, cout):
        fan_in = 9 * sum(cins)
        return ([randn(cout, c, 3, 3, std=math.sqrt(2 / fan_in)) for c in cins],
                0.5 + torch.rand(cout, generator=g, device=dev), randn(cout, std=0.1))

    f32 = torch.float32
    for b, hw, cins, cout, with_add, on_path, note in F32_A_CASES:
        parts = [randn(b, *hw, c) for c in cins]
        weights, scale, bias = conv_params(cins, cout)
        add = randn(b, 3, hw[1], cout, std=0.5) if with_add else None
        kw = dict(scale=scale, bias=bias, add=add, relu=True)
        prepared = packed_vgg.prepare_conv3x3(weights, scale, bias, f32)
        label = f"{[(b, *hw, c) for c in cins]}->{cout}{' +add' if with_add else ''}{note}"
        table.check("conv3x3_fused_f32", label,
                    lambda: packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True),
                    lambda: packed_vgg.conv3x3_fused_plain(parts, weights, **kw),
                    F32_TOL, F32_TOL, on_path, conv_work(b, hw, cins, cout, with_add, "f32"),
                    cudnn_block(parts, [(weights, scale, bias)], add, f32))
        if not torch.equal(packed_vgg.conv3x3_fused(parts, weights, **kw),
                           packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True)):
            raise AssertionError(f"conv3x3_fused_f32 {label}: prepared and raw weights differ")

    for b, hw, cins, cmid, cout, with_add, on_path in F32_G_CASES:
        parts = [randn(b, *hw, c) for c in cins]
        w1, scale1, bias1 = conv_params(cins, cmid)
        (w2,), scale2, bias2 = conv_params((cmid,), cout)
        add = randn(b, 3, hw[1], cmid, std=0.5) if with_add else None
        kw = dict(scale1=scale1, bias1=bias1, scale2=scale2, bias2=bias2, add=add)
        prepared1 = packed_vgg.prepare_conv3x3(w1, scale1, bias1, f32)
        prepared2 = packed_vgg.prepare_conv3x3([w2], scale2, bias2, f32)

        def two_launches():
            mid = packed_vgg.conv3x3_fused(parts, prepared1, add=add, relu=True)
            return packed_vgg.conv3x3_fused([mid], prepared2, relu=True)

        def pair():
            return packed_vgg.conv3x3_pair_fused(parts, prepared1, prepared2, add=add)

        n1, f1, _ = conv_work(b, hw, cins, cmid, with_add, "f32")
        n2, f2, _ = conv_work(b, hw, (cmid,), cout, False, "f32")
        mid_bytes = 2 * b * hw[0] * hw[1] * cmid * 4     # never written, never read
        label = (f"{[(b, *hw, c) for c in cins]}->{cmid}->{cout}"
                 f"{' +add' if with_add else ''}")
        ms = table.check("conv3x3_pair_fused_f32", label, pair,
                         lambda: packed_vgg.conv3x3_pair_fused_plain(parts, w1, w2, **kw),
                         F32_TOL, F32_TOL, on_path, (n1 + n2 - mid_bytes, f1 + f2, "f32"),
                         cudnn_block(parts, [(w1, scale1, bias1), ([w2], scale2, bias2)], add,
                                     f32))
        got, chained = pair(), two_launches()
        if not torch.equal(packed_vgg.conv3x3_pair_fused(parts, w1, w2, **kw), got):
            raise AssertionError(f"conv3x3_pair_fused_f32 {label}: prepared and raw weights "
                                 f"differ")
        two_ms = cuda_ms(two_launches)
        # Both sum each output in one order (part, channel, tap), so G gives
        # the two launches' bits.
        ok = torch.equal(got, chained)
        print(f"kernel conv3x3_pair_fused_f32 {label} vs two conv3x3_fused_f32 launches: "
              f"max_abs_diff={float((got - chained).abs().max()):.3e} same bits: {ok} "
              f"ms={ms:.4f} two_launches_ms={two_ms:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"conv3x3_pair_fused_f32 {label}: not the two launches' bits")
        if on_path:
            row = table.rows["conv3x3_pair_fused_f32"]
            row["two_launches_ms"] = row.get("two_launches_ms", 0.0) + two_ms
    for name, prefix in (("conv3x3_fused_f32", "conv3x3_f32_kernel"),
                         ("conv3x3_pair_fused_f32", "conv3x3_pair_f32_kernel")):
        table.rows[name]["registers"] = {k: v for k, v in registers.items()
                                         if k.startswith(prefix + "<")}
        print(f"kernel {name}: ptxas -v {table.rows[name]['registers']}")


# The fused train-mode BatchNorm (csrc/batchnorm_train.cu) at every shape a
# train step at B = 16, 256², gives it: the U-Net's (base 64) as (side, C,
# BNs of that shape a step), 18 in all, and U-Net++'s (base 32) distinct ones.
BN_TRAIN_UNET = ((256, 64, 4), (128, 128, 4), (64, 256, 4), (32, 512, 4), (16, 1024, 2))
BN_TRAIN_UNETPP = ((256, 32), (128, 64), (64, 128), (32, 256), (16, 512))
# A train step's fused calls, one a train-mode BN (U-Net++: 15 blocks), each
# four launches (two forward, two backward).
BN_TRAIN_CALLS = {"unet": 18, "unet++": 30}
BN_TRAIN_LAUNCHES = 4
# Each case's y, dout and bias are seeded draws; these (side, C, dtype) also
# run on a row-cropped view of an extended y (a spatial band's own rows).
BN_TRAIN_CROPPED = ((256, 64, torch.bfloat16), (64, 256, torch.float32))


def bn_train_inputs(g: torch.Generator, dev, side: int, c: int, dtype, rows: int = 0):
    """y (B, side + rows, side, C), bias, dout (B, side, side, C) and a
    BatchNorm with random affine and running statistics."""
    b = TRAIN_BATCH
    y = (torch.randn(b, side + rows, side, c, generator=g, device=dev) * 1.5 + 0.3).to(dtype)
    bias = (torch.randn(c, generator=g, device=dev) * 0.2).to(dtype)
    dout = torch.randn(b, side, side, c, generator=g, device=dev).to(dtype)
    bn = torch.nn.BatchNorm2d(c).to(dev)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g, device=dev) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g, device=dev) * 0.1)
        bn.running_mean.copy_(torch.randn(c, generator=g, device=dev))
        bn.running_var.copy_(torch.rand(c, generator=g, device=dev) + 0.5)
    return y, bias, dout, bn


def kernels_ms(fn, key: str, reps: int = 10) -> float:
    """Device ms a call of ``fn`` spends in kernels whose names hold ``key``:
    their summed durations in a profiler trace of ``reps`` calls, after a
    warm-up call.  Events around a call also time the host's enqueue where it
    is the slower (small shapes)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if key in e.name and e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def bn_train_run(fn, y, bias, dout, bn):
    """One forward and backward of ``fn`` (the wrapper or its plain version):
    (out, dy, dweight, dbias, running_mean, running_var)."""
    leaf = y.detach().requires_grad_(True)
    out = fn(leaf, bias, bn)
    dy, dw, db = torch.autograd.grad(out, (leaf, bn.weight, bn.bias), dout)
    return out, dy, dw, db, bn.running_mean, bn.running_var


def bn_train_compare(label: str, y, bias, dout, eps: float, got, want) -> tuple[float, int]:
    """Hold the kernels' (out, dy, dweight, dbias, running statistics) to the
    plain version's.  The two sum the statistics in other orders, so an
    element whose normalised value lies within rounding of 0 may take the
    other side of the ReLU (its output is then 0 on one side and a few ulp
    on the other): its dy is left out, and its own term is allowed in its
    channel's dweight and dbias.  Such elements are counted; at most 16 plus
    1e-6 of the elements.  Returns the largest error and the count."""
    out, dy, dw, db, rm, rv = got
    pout, pdy, pdw, pdb, prm, prv = want
    tol = 1e-2 if y.dtype == torch.bfloat16 else 1e-4
    flip = (out > 0) != (pout > 0)
    flips = int(flip.sum())
    yb = (y + bias).float()
    mean = yb.mean(dim=(0, 1, 2))
    rstd = torch.rsqrt(((yb * yb).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0) + eps)
    g_flip = dout.float().abs() * flip
    allow_b = g_flip.sum(dim=(0, 1, 2))
    allow_w = (g_flip * (yb - mean).abs()).sum(dim=(0, 1, 2)) * rstd
    errs = []
    for what, a, b, allow in (
            ("out", out, pout, tol + tol * pout.float().abs()),
            ("dy", dy.masked_fill(flip, 0), pdy.masked_fill(flip, 0),
             tol + tol * pdy.float().abs()),
            ("dbias", db, pdb, 2e-3 * pdb.abs().max() + 1.01 * allow_b),
            ("dweight", dw, pdw, 2e-3 * pdw.abs().max() + 1.01 * allow_w),
            ("running_mean", rm, prm, 1e-5 + 1e-5 * prm.abs()),
            ("running_var", rv, prv, 1e-5 + 1e-5 * prv.abs())):
        diff = (a.detach().float() - b.detach().float()).abs()
        errs.append(float(diff.max()))
        if not (bool(torch.isfinite(a).all()) and bool((diff <= allow).all())):
            raise AssertionError(f"bn_relu_train {label}: {what} disagrees with the plain "
                                 f"version (max difference {errs[-1]:.3e})")
    if flips > 16 + 1e-6 * out.numel():
        raise AssertionError(f"bn_relu_train {label}: {flips} elements on the other side of "
                             "the ReLU")
    return max(errs), flips


def check_bn_train(table: KernelTable, dev) -> None:
    """Phase 3's fused train-mode BatchNorm: forward and backward through the
    kernels against the plain version at the U-Net's 18 train shapes (five
    distinct) and U-Net++'s five, in bf16 and f32, and on two row-cropped
    views; two runs on the same inputs must give the same bits.  Times are
    events around a forward and backward through the wrapper, and the four
    kernels' own device time (``device_ms``, from a profiler trace); the bound is
    y read twice, dout once, out and dy written once (10 bytes an element
    in bf16); the library call is cuDNN's train-mode ``F.batch_norm`` with
    ReLU, forward and backward, which the port never calls."""
    from maunet_tpu_torch.ops.kernels import batchnorm_train as bnt

    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    kernel, plain = bnt.bn_relu_train, bnt.bn_relu_train_plain
    step = {dt: [0.0, 0.0, 0.0, 0.0, 0.0] for dt in (torch.bfloat16, torch.float32)}
    cases = ([("U-Net", side, c, n, dt, 0) for side, c, n in BN_TRAIN_UNET
              for dt in (torch.bfloat16, torch.float32)]
             + [("U-Net++", side, c, 0, dt, 0) for side, c in BN_TRAIN_UNETPP
                for dt in (torch.bfloat16, torch.float32)]
             + [("cropped", side, c, 0, dt, 2) for side, c, dt in BN_TRAIN_CROPPED])
    for model, side, c, times, dtype, rows in cases:
        y, bias, dout, bn = bn_train_inputs(g, dev, side, c, dtype, rows)
        if rows:
            y = y[:, rows // 2:rows // 2 + side]
        label = (f"{model} {tuple(y.shape)} {str(dtype).split('.')[-1]}"
                 + (f" x{times}" if times else ""))
        launches = kernel.launches
        got = bn_train_run(kernel, y, bias, dout, copy.deepcopy(bn))
        if kernel.launches != launches + BN_TRAIN_LAUNCHES:
            raise AssertionError(f"bn_relu_train {label}: {kernel.launches - launches} "
                                 f"launches, not {BN_TRAIN_LAUNCHES}")
        want = bn_train_run(plain, y, bias, dout, copy.deepcopy(bn))
        again = bn_train_run(kernel, y, bias, dout, copy.deepcopy(bn))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"bn_relu_train {label}: two runs differ")
        if rows:
            whole = bn_train_run(kernel, y.contiguous(), bias, dout, copy.deepcopy(bn))
            if not all(torch.equal(a, b) for a, b in zip(got, whole)):
                raise AssertionError(f"bn_relu_train {label}: the view and its copy differ")
        err, flips = bn_train_compare(label, y, bias, dout, bn.eps, got, want)
        torch.cuda.synchronize()
        timed = copy.deepcopy(bn)
        ms = cuda_ms(lambda: bn_train_run(kernel, y, bias, dout, timed))
        device_ms = kernels_ms(lambda: bn_train_run(kernel, y, bias, dout, timed),
                               "batchnorm_train_")
        plain_ms = cuda_ms(lambda: bn_train_run(plain, y, bias, dout, timed))
        library_ms = None
        if not rows:
            x = y.permute(0, 3, 1, 2)
            dx = dout.permute(0, 3, 1, 2)
            w = bn.weight.detach().clone().requires_grad_(True)
            beta = bn.bias.detach().clone().requires_grad_(True)
            rm, rv = bn.running_mean.clone(), bn.running_var.clone()

            def library():
                leaf = x.detach().requires_grad_(True)
                o = torch.relu(F.batch_norm(leaf, rm, rv, w, beta, training=True,
                                            momentum=0.1, eps=bn.eps))
                return torch.autograd.grad(o, (leaf, w, beta), dx)

            library_ms = cuda_ms(library)
        bytes_ms = 5 * y.numel() * y.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"kernel bn_relu_train {label}{' [path]' if times else ''}: max_abs_err={err:.3e} "
              f"edge_flips={flips} ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bytes_ms:.4f} "
              f"(bytes) library_ms=" + ("none" if library_ms is None else f"{library_ms:.4f}")
              + " ok")
        if times:
            for i, v in enumerate((ms, device_ms, plain_ms, bytes_ms, library_ms)):
                step[dtype][i] += times * v
            if dtype == torch.bfloat16:
                table.add("bn_relu_train", err, ms, plain_ms, bytes_ms, 0.0, library_ms, times)
    for dtype, (ms, device_ms, plain_ms, bound_ms, library_ms) in step.items():
        print(f"bn_relu_train, a U-Net64 train step's {BN_TRAIN_CALLS['unet']} BNs "
              f"(B = {TRAIN_BATCH}, 256², {str(dtype).split('.')[-1]}): ms={ms:.4f} "
              f"device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"(5 x {torch.finfo(dtype).bits // 8} bytes an element at 3.35 TB/s) "
              f"library_ms={library_ms:.4f} launches a step "
              f"{BN_TRAIN_LAUNCHES * BN_TRAIN_CALLS['unet']}")


def check_golden(dev) -> None:
    """The port's U-Net and U-Net++ on the card against the JAX package's
    recorded outputs (``tests/fixtures/golden_unet.npz`` and
    ``golden_unetpp.npz``: 50² tiles, base 4), in bf16 and in f32.  At base
    4 every conv runs kernel A (its entry of the compute dtype), with the
    embedding term at the U-Net's bottleneck and at every U-Net++ decoder
    node, and the odd 50 -> 25 -> 12 chain runs C's fix-ups (U-Net) and
    single odd resizes (U-Net++)."""
    from maunet_tpu_torch.interop.from_jax import state_dict_from_jax, variables_from_flat
    from maunet_tpu_torch.interop.torch_import import infer_hyperparams
    from maunet_tpu_torch.models.factory import build_model

    for model_type, name in [("unet", "golden_unet.npz"), ("unet++", "golden_unetpp.npz")]:
        with np.load(os.path.join(FIXTURES, name)) as z:
            state_dict = state_dict_from_jax(variables_from_flat(z))
            inputs = [torch.from_numpy(z[k]).to(dev)
                      for k in ("maps", "series", "meta", "lengths")]
            expected = z["expected"]
        for dtype, tol, entry in ((torch.bfloat16, GOLDEN_TOL, "conv3x3_fused"),
                                  (torch.float32, GOLDEN_TOL_F32, "conv3x3_fused_f32")):
            model = build_model(infer_hyperparams(state_dict, {"model_type": model_type}),
                                compute_dtype=dtype)
            model.load_state_dict(state_dict, strict=True)
            fns = reset_launches()
            with torch.inference_mode():
                got = model.to(dev)(*inputs).float().cpu().numpy()
            launches = {k: fns[k].launches for k in ("conv3x3_fused", "conv3x3_fused_f32")}
            err = float(np.abs(got - expected).max())
            kind = str(dtype).split(".")[-1]
            print(f"golden fixture {name} ({kind} on the card vs the f32 JAX output): "
                  f"max_abs_err={err:.4e} tol={tol:g}; A launches {launches}")
            if got.shape != expected.shape or not err <= tol:
                raise AssertionError(f"the port in {kind} disagrees with {name}")
            if launches[entry] == 0 or sum(launches.values()) != launches[entry]:
                raise AssertionError(f"golden fixture {name} in {kind}: A's launches {launches}")


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
    from maunet_tpu_torch.ops.kernels import (batchnorm_train, lstm, masked_stats, packed_vgg,
                                              resize_pack)

    return {fn.__name__: fn for fn in (
        packed_vgg.conv3x3_fused, lstm.lstm_last_hidden, resize_pack.resize_pack,
        lstm.lstm_forward_stash, lstm.lstm_gate_terms, lstm.lstm_backward, lstm.lstm_dw,
        masked_stats.masked_class_sums, packed_vgg.conv3x3_pair_fused,
        resize_pack.resize_rows, packed_vgg.conv3x3_fused_f32,
        packed_vgg.conv3x3_pair_fused_f32, batchnorm_train.bn_relu_train)}


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
    from maunet_tpu_torch.ops.kernels import batchnorm_train, lstm, resize_pack
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
    if launches["bn_relu_train"] != BN_TRAIN_LAUNCHES * BN_TRAIN_CALLS["unet"] * steps:
        raise AssertionError(f"training path: {launches['bn_relu_train']} fused BatchNorm "
                             f"launches, not {BN_TRAIN_LAUNCHES * BN_TRAIN_CALLS['unet']} a step")
    missing = [name for name in ("lstm_forward_stash", "lstm_gate_terms", "lstm_backward",
                                 "lstm_dw", "resize_pack", "conv3x3_fused", "lstm_last_hidden",
                                 "bn_relu_train")
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
            mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain), \
            mock.patch.object(batchnorm_train, "bn_relu_train",
                              batchnorm_train.bn_relu_train_plain):
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
    from maunet_tpu_torch.ops.kernels import batchnorm_train, packed_vgg
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
            # remat runs each block's forward again in the backward
            want_bn = (BN_TRAIN_LAUNCHES + 2 * bool(flags.get("remat"))) \
                * BN_TRAIN_CALLS[cfg.model_type]
            if batchnorm_train.bn_relu_train.launches != want_bn:
                raise AssertionError(f"train step {name}: {batchnorm_train.bn_relu_train.launches}"
                                     f" fused BatchNorm launches, not {want_bn}")
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


# Launches of A, B and C in one forward at B = 1: the U-Net's as a sweep
# chunk's; U-Net++'s (base 32) as one evaluation batch's in phase 7: A for
# the 18 convs of width <= 64 (conv0_0-conv0_4, conv1_0-conv1_3), C for the
# 10 upsamples (one a node X(i, j), j >= 1).
BROWSER_LAUNCHES = {"unet": SWEEP_LAUNCHES,
                    "unet++": {"conv3x3_fused": 18, "lstm_last_hidden": 1, "resize_pack": 10}}
# The figures the model browser draws: the static architecture figure and the
# zoomed NDVI and LST quadrants.
BROWSER_FIGURES = 3
# Samples of phase 12's loader suite (256², T = 828; the suite's default is
# 64, cut to keep the phase's time).
LOADER_SAMPLES = 16


def research_app_path(dev, tmpdir: str, data: str, checkpoints: dict[str, str],
                      card: str) -> None:
    """Phase 12: the research app headless on the card (the model browser
    for both families, then the other five pages), ``cli eda`` over the test
    split, and the native decoder against numpy with the loader suite."""
    from maunet_tpu_torch import benchmarks, cli
    from maunet_tpu_torch.analysis import plots, stats
    from maunet_tpu_torch.apps import headless
    from maunet_tpu_torch.data import native
    from maunet_tpu_torch.data.dataset import NpzDataset
    from maunet_tpu_torch.evaluate import evaluator
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack

    t_phase = time.perf_counter()
    drawn = plots.available()
    argv = ["--data-dir", data, "--device", str(dev)]
    for model_type, path in checkpoints.items():
        seen = {}
        real_predict = evaluator.predict_batch

        def predict_batch(loaded, batch):
            out = real_predict(loaded, batch)
            seen.setdefault("out", []).append(out)
            seen["loaded"], seen["batch"] = loaded, batch
            return out

        answers = {"Checkpoint path (.pth or orbax dir)": path,
                   "Predict a test sample (zoomed quadrants)": True}
        with mock.patch.object(evaluator, "predict_batch", predict_batch):
            fns = reset_launches()
            st = headless.run_research_page("Model browser", argv, answers)
            launches = {name: fn.launches for name, fn in fns.items() if fn.launches}
            with mock.patch.object(packed_vgg, "conv3x3_fused", packed_vgg.conv3x3_fused_plain), \
                    mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
                    mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain):
                headless.run_research_page("Model browser", argv, answers)
        got, want = seen["out"]
        hw = got.shape[1]
        check_outputs(f"model browser {model_type}", got[0, ..., 0], got[0, ..., 1], hw)
        diff, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        n = sum(p.numel() for p in seen["loaded"].model.parameters())
        metric = st.rendered("metric")
        figures = st.rendered("pyplot") if drawn else st.rendered("info")
        print(f"model browser {model_type} ({got.shape[0]} x {hw}², bf16, T = {T_SERIES}): "
              f"launches={launches}, Parameters {metric[0][1] if metric else None}, "
              f"{len(st.rendered('components_html'))} interactive diagram, "
              f"{len(figures)} figures {'drawn' if drawn else 'left out, one info line each'}; "
              f"vs plain versions max_abs_diff={diff:.4e} (output max |x| {scale:.4f}, "
              f"tol {0.05 * max(scale, 1.0):.4f})")
        if launches != BROWSER_LAUNCHES[model_type]:
            raise AssertionError(f"model browser {model_type}: launches {launches}, "
                                 f"want {BROWSER_LAUNCHES[model_type]}")
        if diff > 0.05 * max(scale, 1.0):
            raise AssertionError(f"model browser {model_type} disagrees with its plain versions")
        if metric != [("Parameters", f"{n:,}", None)] or len(st.rendered("components_html")) != 1:
            raise AssertionError(f"model browser {model_type}: metric {metric}, "
                                 f"{len(st.rendered('components_html'))} diagrams")
        if len(figures) != BROWSER_FIGURES or (not drawn and st.rendered("pyplot")):
            raise AssertionError(f"model browser {model_type}: figures {figures}")
        host_ms = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_predict(seen["loaded"], seen["batch"])
            if i >= 1:
                host_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"model browser {model_type} predict_batch (1 x {hw}², bf16): "
              f"{statistics.median(host_ms):.3f} ms (host clock, median of {len(host_ms)}, the "
              f"batch copied in and the maps out) on {card}")

    # The other five pages over phase 7's two evaluation CSVs and the split.
    reports = os.path.join(tmpdir, "reports")
    runs = ["smoke_unet_emb_0_job1", "smoke_unet++_emb_0_job1"]
    frames = {}
    real_ttests = stats.comparative_analysis

    def ttests(*a, **k):
        frames["ttests"] = real_ttests(*a, **k)
        return frames["ttests"]

    argv = ["--reports-dir", reports, "--data-dir", data, "--device", str(dev)]
    answers = {"Evaluation runs": runs, "Runs to compare": runs, "Run": runs[0]}
    rendered = {}
    with mock.patch.object(stats, "comparative_analysis", ttests):
        for page in ("Model comparison", "Evaluation analysis", "Statistical comparison",
                     "Dataset map", "Metric interpretation"):
            st = headless.run_research_page(page, argv, answers)
            rendered[page] = {m: len(st.rendered(m)) for m in
                              ("dataframe", "metric", "pyplot", "info", "map")}
            if page == "Model comparison" and set(st.rendered("dataframe")[0].index) != set(runs):
                raise AssertionError(f"comparison page: {st.rendered('dataframe')[0].index}")
            if page == "Dataset map" and int(st.rendered("dataframe")[0].sum()) != sum(
                    SAMPLES.values()):
                raise AssertionError("dataset page: the sample counts differ from the split's")
    significant = int((frames["ttests"]["winner"] != "insignificant").sum())
    print(f"research pages over {runs}: {rendered}; t-tests {len(frames['ttests'])} rows, "
          f"{significant} significant")
    if frames["ttests"].empty:
        raise AssertionError("statistics page: the t-test frame is empty")

    # EDA over the test split (a directory holding only it).
    eda_root = os.path.join(tmpdir, "eda")
    os.makedirs(eda_root)
    os.symlink(os.path.join(data, "test"), os.path.join(eda_root, "test"))
    out_csv = os.path.join(tmpdir, "eda_metrics.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        rc_extract = cli.main(["eda", "extract", eda_root, out_csv])
        rc_analyze = cli.main(["eda", "analyze-csv", out_csv])
    with open(out_csv, newline="") as f:
        n_rows = len(list(csv.DictReader(f)))
    print(f"cli eda extract over the test split: exit {rc_extract}, {n_rows} rows; "
          f"analyze-csv: exit {rc_analyze}")
    if rc_extract or rc_analyze or n_rows != SAMPLES["test"]:
        raise AssertionError("cli eda failed")

    # The native decoder against numpy, sample by sample, then the loader suite.
    test_split = os.path.join(data, "test")
    t0 = time.perf_counter()
    by_native = NpzDataset(test_split, T_SERIES, backend="native")
    by_numpy = NpzDataset(test_split, T_SERIES, backend="numpy")
    for i in range(len(by_numpy)):
        a, b = by_native[i], by_numpy[i]
        if list(a) != list(b) or not all(
                np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                and np.array_equal(a[k], b[k]) for k in b):
            raise AssertionError(f"native decoder: sample {i} differs from numpy's")
    print(f"native decoder ({native.library_path().name}): {len(by_numpy)} test samples "
          f"bit-equal to numpy's in {time.perf_counter() - t0:.1f} s")
    record = benchmarks.Recorder(dev)
    with tempfile.TemporaryDirectory(dir=tmpdir) as bench_dir:
        benchmarks.bench_loader(record, dev, bench_dir, n=LOADER_SAMPLES)
    if [r["metric"] for r in record.rows] != [
            "loader_numpy_256px", "loader_native_256px", "loader_shards_256px"]:
        raise AssertionError(f"loader suite: rows {record.rows}")
    print(f"research app phase: {time.perf_counter() - t_phase:.1f} s")


# Phase 13's two-rank Trainer epoch reads phase 6's train split in global
# batches of TrainConfig's 16: 3 batches of 8 rows a rank.
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "torch_multihost_worker.py")
DP_RANKS = 2
# Steps timed after the compared one, in each rank and in this process.
DP_TIMED = 3
# The kernels a training step launches: E, F's two launches, dW and C.
DP_TRAINING = ("lstm_forward_stash", "lstm_gate_terms", "lstm_backward", "lstm_dw",
               "resize_pack")


def run_ranks(tmpdir: str, name: str, tasks: list[dict], dev, world: int = DP_RANKS,
              cudnn: bool = True) -> str:
    """The worker as ``world`` Gloo ranks sharing ``dev`` (with ``cudnn``
    off, on PyTorch's own convolutions); every rank must exit 0 within 600
    s.  This process's cached device memory is released first: the ranks
    need the card's memory.  Returns the directory they wrote to."""
    torch.cuda.empty_cache()
    out = os.path.join(tmpdir, f"dp_{name}")
    os.makedirs(out)
    spec = {"store": f"file://{tmpdir}/dp_store_{name}", "world": world,
            "backend": "gloo", "device": str(dev), "threads": 2, "out": out, "tasks": tasks,
            "cudnn": cudnn}
    spec_path = os.path.join(tmpdir, f"dp_{name}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    logs = [open(os.path.join(out, f"log_{r}.txt"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, spec_path, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + 600
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:          # a rank left waiting on a failed one is stopped
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {name} exited {p.returncode}:\n{text[-3000:]}")
    return out


def same_bits(a: dict, b: dict) -> list[str]:
    """The keys of two state_dicts whose tensors differ in any bit."""
    return [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]


def parallel_path(dev, tmpdir: str, data: str, checkpoint: str, smi: str) -> None:
    """Phase 13: data-parallel training (a: a world-size-1 NCCL group, b: two
    Gloo ranks on one card) and inference over a mesh that repeats the card
    (c)."""
    import dataclasses

    import torch.distributed as dist

    from maunet_tpu_torch.apps.engine import PlannerEngine
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.models.factory import UrbanPredictor
    from maunet_tpu_torch.parallel.mesh import make_mesh
    from maunet_tpu_torch.parallel.multihost import initialize_multihost, world_size
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import train_step

    t_phase = time.perf_counter()
    cfg = TrainConfig()
    host = next(make_batches(NpzDataset(os.path.join(data, "train"), T_SERIES),
                             cfg.batch_size))
    batch = to_device(host_tensors(host, pin=dev.type == "cuda"), dev)
    loss_fn = get_loss_fn(cfg.loss)
    seeded = Trainer(cfg, data, work_dir=os.path.join(tmpdir, "dp_seed"), device=dev)

    # (a) One step plainly and one under a world-size-1 NCCL group.
    def step():
        state = seeded.init_state(23)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, batch, loss_fn)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return ({k: v.detach().clone() for k, v in state.model.state_dict().items()},
                float(metrics["grad_norm"]), ms)

    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain_sd, plain_norm, _ = step()       # the first also selects cuDNN's algorithms
        again_sd, again_norm, plain_ms = step()
        initialize_multihost(f"file://{tmpdir}/nccl_store", 1, 0, backend="nccl", device=dev)
        try:
            if not (dist.get_backend() == "nccl" and world_size() == 1):
                raise AssertionError("data parallel (a): no world-size-1 NCCL group")
            fns = reset_launches()
            group_sd, group_norm, group_ms = step()
            launches = {name: fn.launches for name, fn in fns.items()}
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    differ = same_bits(plain_sd, group_sd)
    repeat = same_bits(plain_sd, again_sd)
    hw = batch["maps"].shape[1]
    print(f"data parallel (a), NCCL at world size 1: one train step ({cfg.batch_size} x "
          f"{hw}², T = {T_SERIES}, {cfg.compute_dtype}, {cfg.optimizer}) under the group "
          f"{group_ms:.1f} ms, plain {plain_ms:.1f} ms (host clock around one synchronised "
          f"step, cuDNN deterministic; {smi}; the plain time is the second plain step's); "
          f"grad_norm {group_norm!r} vs {plain_norm!r}; tensors differing in any bit: "
          f"{len(differ)} of {len(plain_sd)} (two plain steps: {len(repeat)}, grad_norm "
          f"{again_norm!r}); launches={launches}")
    if differ or group_norm != plain_norm:
        raise AssertionError(f"data parallel (a): the group's step is not the plain step's "
                             f"bits: {differ[:5]}")
    missing = [n for n in DP_TRAINING if launches[n] == 0]
    if missing:
        raise AssertionError(f"data parallel (a): kernels not launched: {missing}")

    # (b) Two Gloo ranks sharing the card: one f32 SGD step against this
    # process's, then one Trainer epoch.
    # The Trainer's model for cfg (Trainer.init_state), in f32.
    kwargs = dict(model_type=cfg.model_type, out_channels=len(cfg.target_channels),
                  temporal_dim=cfg.temporal_dim, meta_dim=cfg.meta_dim,
                  lstm_dim=cfg.lstm_hidden, base_filters=cfg.base_filters, in_channels=23,
                  meta_features=cfg.nb_metadata_features,
                  temporal_embeddings=cfg.temporal_embeddings,
                  metadata_embeddings=cfg.metadata_embeddings, compute_dtype="float32")
    model = UrbanPredictor(**{**kwargs, "compute_dtype": torch.float32},
                           generator=torch.Generator().manual_seed(cfg.seed))
    state_path = os.path.join(tmpdir, "dp_state.pt")
    torch.save(model.state_dict(), state_path)
    batch_path = os.path.join(tmpdir, "dp_batch.npz")
    np.savez(batch_path, **host.as_dict())
    model = model.to(dev)
    state = TrainState(model, make_optimizer(model.parameters(), "sgd", 1e-2, 0.0, 0.0), 0)
    single = {k: float(v) for k, v in train_step(state, batch, loss_fn).items()}
    want = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    single_ms = []
    for _ in range(DP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, loss_fn)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    del model, state
    tasks = [{"kind": "step", "name": "step", "state": state_path, "batch": batch_path,
              "model": kwargs, "optimizer": ["sgd", 1e-2, 0.0, 0.0], "loss": cfg.loss,
              "timed": DP_TIMED},
             {"kind": "epoch", "name": "epoch", "data": data,
              "work": os.path.join(tmpdir, "dp_work"), "cfg": dataclasses.asdict(cfg)}]
    t0 = time.perf_counter()
    out = run_ranks(tmpdir, "gloo", tasks, dev)
    ranks_wall = time.perf_counter() - t0
    got = [torch.load(os.path.join(out, f"step_rank{r}.pt"), weights_only=True)
           for r in range(DP_RANKS)]
    worst = {"param": 0.0, "stat": 0.0}
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = got[0]["state_dict"][k]
        if not torch.equal(a, got[1]["state_dict"][k]):
            raise AssertionError(f"data parallel (b): the ranks' {k} differ")
        err = float((a - v).abs().max())
        if k.endswith(("running_mean", "running_var")):
            scale = float(v.abs().max())
            rel = float(((a - v).abs() / (v.abs() + scale)).max())
            worst["stat"] = max(worst["stat"], rel)
            if not bool(((a - v).abs() <= 1e-5 * v.abs() + 1e-5 * scale).all()):
                raise AssertionError(f"data parallel (b): {k} differs beyond 1e-5")
        else:
            worst["param"] = max(worst["param"], err)
            if err > 1e-5:
                raise AssertionError(f"data parallel (b): {k} differs by {err:.3e}")
    loss_rel = max(abs(r["metrics"]["total"] - single["total"]) / abs(single["total"])
                   for r in got)
    rank_launches = [json.load(open(os.path.join(out, f"step_rank{r}.launches.json")))
                     for r in range(DP_RANKS)]
    print(f"data parallel (b), two Gloo ranks on one card, one f32 SGD step ({DP_RANKS} x "
          f"{cfg.batch_size // DP_RANKS} rows) against one process ({cfg.batch_size} rows): "
          f"loss rel diff {loss_rel:.3e} (tol 1e-5), parameters max abs diff "
          f"{worst['param']:.3e} (tol 1e-5), running statistics {worst['stat']:.3e} "
          f"(tol 1e-5 of the value plus 1e-5 of the tensor's largest); f32 step "
          f"{[round(statistics.median(r['timed_ms']), 1) for r in got]} ms a rank (the "
          f"ranks share the card) against {statistics.median(single_ms):.1f} ms in one "
          f"process (host clock, median of {DP_TIMED} synchronised steps after the compared "
          f"one; {smi}); rank 0's launches={rank_launches[0]}")
    if loss_rel > 1e-5:
        raise AssertionError("data parallel (b): the loss differs beyond 1e-5")
    if not all(r["lstm_forward_stash"] and r["lstm_dw"] and r["resize_pack"]
               for r in rank_launches):
        raise AssertionError("data parallel (b): a rank launched no E, dW or C")

    ranks = [json.load(open(os.path.join(out, f"epoch_rank{r}.json")))
             for r in range(DP_RANKS)]
    per_rank, n_train = cfg.batch_size // DP_RANKS, SAMPLES["train"]
    epoch_rows = []
    for r, res in enumerate(ranks):
        if res["host_slice"] != [r * per_rank, (r + 1) * per_rank] or \
                res["data_parallel"] != DP_RANKS:
            raise AssertionError(f"data parallel (b): rank {r} loads rows {res['host_slice']}")
        if len(res["seen"]) != per_rank * (1 + n_train // cfg.batch_size):
            raise AssertionError(f"data parallel (b): rank {r} loaded {len(res['seen'])} rows")
        epoch_rows.append(set(res["seen"][per_rank:]))
        if not (math.isfinite(res["best_val_loss"])
                and res["best_val_loss"] == ranks[0]["best_val_loss"]
                and abs(res["val_restored"] - res["best_val_loss"])
                <= 1e-6 * abs(res["best_val_loss"]) and res["restored_epoch"] == 0):
            raise AssertionError(f"data parallel (b): rank {r}'s val loss {res}")
    if epoch_rows[0] & epoch_rows[1] or epoch_rows[0] | epoch_rows[1] != set(range(n_train)):
        raise AssertionError("data parallel (b): the ranks' epoch rows overlap or miss some")
    print(f"data parallel (b), one Trainer epoch of two ranks ({n_train // cfg.batch_size} "
          f"steps of {DP_RANKS} x {per_rank} rows, bf16, {cfg.optimizer}): val loss "
          f"{ranks[0]['best_val_loss']!r} on both ranks, restored {ranks[0]['val_restored']!r}; "
          f"rows disjoint and covering the split; {[round(r['seconds'], 1) for r in ranks]} s "
          f"a rank for the epoch, {ranks_wall:.1f} s for both tasks with the start of two "
          f"processes (host clock)")

    # (c) Inference over a mesh that names the card once and twice.
    cfg_eval = TrainConfig()
    fns = reset_launches()

    def evaluate(name, mesh):
        out_dir = os.path.join(tmpdir, f"dp_eval_{name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_checkpoint(checkpoint, cfg_eval, data_dir=data, study_name="dp",
                            n_visualize=0, output_dir=out_dir, batch_size=EVAL_BATCH,
                            device=dev, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = glob.glob(os.path.join(out_dir, "*_evaluation.csv"))[0]
        with open(path, newline="") as f:
            return list(csv.reader(f)), wall

    whole, whole_s = evaluate("whole", None)
    one, one_s = evaluate("one", make_mesh(devices=[dev]))
    two, two_s = evaluate("two", make_mesh(devices=[dev, dev]))
    if one != whole:
        raise AssertionError("data parallel (c): a one-entry mesh's CSV is not the unsharded one")
    header = whole[0]
    tols = {"mae": 1e-2, "rmse": 1e-2, "laplacian_var_pred": 5e-2, "laplacian_var_gt": 5e-2}
    cols = {header.index(c): c for c in tols}
    worst = dict.fromkeys(tols, 0.0)
    if len(two) != len(whole) or two[0] != header:
        raise AssertionError("data parallel (c): the two-entry mesh's CSV has other rows")
    for a, b in zip(two[1:], whole[1:]):
        if [v for i, v in enumerate(a) if i not in cols] != \
                [v for i, v in enumerate(b) if i not in cols]:
            raise AssertionError(f"data parallel (c): rows differ: {a[:3]} vs {b[:3]}")
        for i, c in cols.items():
            if (a[i] == "") != (b[i] == ""):
                raise AssertionError(f"data parallel (c): {c} is empty in one CSV only")
            if b[i]:
                rel = abs(float(a[i]) - float(b[i])) / max(abs(float(b[i])), 1e-12)
                worst[c] = max(worst[c], rel)
    if any(worst[c] > tols[c] for c in tols):
        raise AssertionError(f"data parallel (c): the two-entry mesh's rows differ: {worst}")

    engine = PlannerEngine(checkpoint, device=dev, temp_query=StubTempQuery(),
                           temporal_length=T_SERIES)
    meshed = PlannerEngine(checkpoint, device=dev, temp_query=StubTempQuery(),
                           temporal_length=T_SERIES, mesh=make_mesh(devices=[dev, dev]))
    rng = np.random.default_rng(SEED + 13)
    args = (2_800_000, 2023, 7, 2025, 7)
    requests = [engine.prepare_input(make_layers(rng, 256), None,
                                     float(rng.uniform(-60, 60)),
                                     float(rng.uniform(-180, 180)), *args) for _ in range(7)]
    many, want_many = meshed.predict_many(requests), engine.predict_many(requests)
    got_arr = np.stack([np.stack([nd, (ls - engine.stats.temp_mean) / engine.stats.temp_std])
                        for nd, ls in many])
    want_arr = np.stack([np.stack([nd, (ls - engine.stats.temp_mean) / engine.stats.temp_std])
                         for nd, ls in want_many])
    for i, (nd, ls) in enumerate(many):
        check_outputs(f"predict_many over the mesh [{i}]", nd, ls, 256)
    diff, scale = float(np.abs(got_arr - want_arr).max()), float(np.abs(want_arr).max())
    launches = {name: fn.launches for name, fn in fns.items()}
    print(f"data parallel (c), inference over a mesh of the card: evaluate_checkpoint "
          f"({SAMPLES['test']} samples, batches of {EVAL_BATCH}) unsharded {whole_s:.2f} s, "
          f"[{dev}] {one_s:.2f} s (CSV bit-equal), [{dev}, {dev}] {two_s:.2f} s (max "
          f"relative difference " + ", ".join(f"{c} {v:.2e}" for c, v in worst.items())
          + f"; tol 1e-2, Laplacian variances 5e-2) (host clock; {smi}); predict_many of 7 "
          f"over [{dev}, {dev}] against unsharded: max_abs_diff={diff:.4e} (tol "
          f"{0.05 * max(scale, 1.0):.4f}); launches={launches}")
    if diff > 0.05 * max(scale, 1.0):
        raise AssertionError("data parallel (c): predict_many over the mesh disagrees")
    missing = [n for n in ("conv3x3_fused", "lstm_last_hidden", "resize_pack",
                           "masked_class_sums") if launches[n] == 0]
    if missing:
        raise AssertionError(f"data parallel (c): kernels not launched: {missing}")
    print(f"data parallel phase: {time.perf_counter() - t_phase:.1f} s")


# Phase 14, the spatial axis.  (a) C's row window at the serving U-Net's
# four upsamples (B = 8, bf16, 256²) and U-Net++'s four level resizes (base
# 32), as (input shape, on the serving path), for every band of each axis.
SPATIAL_RESIZES = (
    ((8, 16, 16, 1024), True), ((8, 32, 32, 512), True), ((8, 64, 64, 256), True),
    ((8, 128, 128, 128), True),
    ((8, 16, 16, 512), False), ((8, 32, 32, 256), False), ((8, 64, 64, 128), False),
    ((8, 128, 128, 64), False))
SPATIAL_AXES = (2, 4)
# (data, spatial) layouts of (b) the serving forward and (c) the train step.
SPATIAL_SERVING = ((1, 2), (1, 4))
SPATIAL_TRAINING = ((1, 2), (2, 2))
# A rank's launches in one serving forward: A's four level-0 convs, B, and
# the four upsamples through C's row entry.
SPATIAL_FORWARD_LAUNCHES = {"conv3x3_fused": 4, "lstm_last_hidden": 1, "resize_rows": 4,
                            "resize_pack": 0}
# A rank's launches in one train step: E, F's two and dW once each.
SPATIAL_STEP_ONCE = ("lstm_forward_stash", "lstm_gate_terms", "lstm_backward", "lstm_dw")
SPATIAL_TIMED = 2
# The serving U-Net as phase 5 saves it (write_checkpoint), for the workers.
SERVING_MODEL = {"model_type": "unet", "base_filters": 64, "temporal_dim": 64, "meta_dim": 64,
                 "lstm_dim": 96, "in_channels": 23, "meta_features": 8,
                 "lstm_mask_mode": "batch_max", "compute_dtype": "bfloat16"}


def check_windows(table: KernelTable, dev) -> dict:
    """Phase 14 (a): every band's window of C against the whole launch, bit
    for bit, and against its plain version (the table's row
    ``resize_rows``, whose summary reads band 0 of 2 at the serving
    shapes: the windows one rank of the (1, 2) forward launches); each
    shape's whole launch timed beside its windows."""
    from maunet_tpu_torch.ops.kernels import resize_pack

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    times = {}
    for shape, serving in SPATIAL_RESIZES:
        b, n, w, c = shape
        out_hw = (2 * n, 2 * w)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        whole = resize_pack.resize_pack(x, out_hw)
        whole_ms = cuda_ms(lambda: resize_pack.resize_pack(x, out_hw))
        for sp in SPATIAL_AXES:
            band, ms = n // sp, []
            for s in range(sp):
                lo, hi = max(s * band - 1, 0), min((s + 1) * band + 1, n)
                xs = x[:, lo:hi].contiguous()
                args = ((2 * band, 2 * w), n, 2 * n, lo, s * 2 * band)
                got = resize_pack.resize_rows(xs, *args)
                if not torch.equal(got, whole[:, s * 2 * band:(s + 1) * 2 * band]):
                    raise AssertionError(f"resize_rows {shape} band {s} of {sp}: not the "
                                         f"whole launch's rows bit for bit")
                ms.append(table.check(
                    "resize_rows", f"{shape}->{out_hw} band {s}/{sp} rows [{lo}, {hi})",
                    lambda: resize_pack.resize_rows(xs, *args),
                    lambda: resize_pack.resize_rows_plain(xs, *args), 1e-2, 1e-2,
                    serving and sp == 2 and s == 0,
                    ((xs.numel() + got.numel()) * 2, 8 * got.numel(), "f32")))
            times[(shape, sp)] = (whole_ms, ms)
            print(f"spatial (a) {shape}->{out_hw} over {sp} bands: every band's rows equal "
                  f"the whole launch's bit for bit; whole {whole_ms:.4f} ms, bands "
                  f"{[round(t, 4) for t in ms]} ms (sum {sum(ms):.4f}; CUDA events)")
    return times


def adamw_first_update(g: torch.Tensor, lr: float, eps: float = 1e-8) -> torch.Tensor:
    """AdamW's first update of a parameter with gradient ``g`` (bias
    corrected: lr g / (|g| + eps)), in f64."""
    g = g.double()
    return lr * g / (g.abs() + eps)


def spatial_path(dev, tmpdir: str, data: str, checkpoint: str, smi: str,
                 table: KernelTable) -> dict[str, int]:
    """Phase 14: the spatial axis.  (a) C's windows; (b) the serving forward
    at (1, 2) and (1, 4); (c) the train step at (1, 2) and (2, 2); (d) a
    ``Trainer`` epoch at (1, 2).  Returns rank 0's launches in one serving
    forward at (1, 2)."""
    import dataclasses

    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.models.factory import UrbanPredictor
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import model_outputs, train_step
    from maunet_tpu_torch.utils.profiling import device_memory_stats

    t_phase = time.perf_counter()
    check_windows(table, dev)
    failures: list[str] = []   # every check of (b)-(d) runs; the phase fails at its end

    def gib(n):
        return "not measured" if n is None else round(n / 2.0 ** 30, 3)

    # (b) The serving forward, unsharded here.
    serve_state = os.path.join(tmpdir, "sp_serving.pt")
    torch.save(torch.load(checkpoint, weights_only=False)["model_state_dict"], serve_state)
    serve_host = next(make_batches(NpzDataset(os.path.join(data, "test"), T_SERIES), 8))
    serve_batch = os.path.join(tmpdir, "sp_serving.npz")
    np.savez(serve_batch, **serve_host.as_dict())
    model = UrbanPredictor(**{**SERVING_MODEL, "compute_dtype": torch.bfloat16})
    model.load_state_dict(torch.load(serve_state, weights_only=True), strict=True)
    model = model.to(dev).eval()
    batch = to_device(host_tensors(serve_host, pin=dev.type == "cuda"), dev)
    with torch.no_grad():
        want_out = model_outputs(model, batch).float().cpu()
        single_ms = []
        for _ in range(SPATIAL_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model_outputs(model, batch)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t0) * 1e3)
    del model, batch

    # (c) The train step, unsharded here: TrainConfig's defaults in f32.
    cfg = TrainConfig()
    kwargs = dict(model_type=cfg.model_type, out_channels=len(cfg.target_channels),
                  temporal_dim=cfg.temporal_dim, meta_dim=cfg.meta_dim,
                  lstm_dim=cfg.lstm_hidden, base_filters=cfg.base_filters, in_channels=23,
                  meta_features=cfg.nb_metadata_features,
                  temporal_embeddings=cfg.temporal_embeddings,
                  metadata_embeddings=cfg.metadata_embeddings, compute_dtype="float32")
    model = UrbanPredictor(**{**kwargs, "compute_dtype": torch.float32},
                           generator=torch.Generator().manual_seed(cfg.seed))
    step_state = os.path.join(tmpdir, "sp_step_state.pt")
    torch.save(model.state_dict(), step_state)
    train_host = next(make_batches(NpzDataset(os.path.join(data, "train"), T_SERIES),
                                   cfg.batch_size))
    step_batch = os.path.join(tmpdir, "sp_step_batch.npz")
    np.savez(step_batch, **train_host.as_dict())
    model = model.to(dev)
    optimizer = [cfg.optimizer, cfg.learning_rate, cfg.weight_decay, cfg.momentum]
    state = TrainState(model, make_optimizer(model.parameters(), *optimizer), 0)
    batch = to_device(host_tensors(train_host, pin=dev.type == "cuda"), dev)
    loss_fn = get_loss_fn(cfg.loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    single = {k: float(v) for k, v in train_step(state, batch, loss_fn).items()}
    torch.cuda.synchronize()
    single_peak = next((m["peak_bytes_in_use"] for m in device_memory_stats()
                        if m["device"] == str(dev)), None)
    # Copies: the timed steps below go on updating the model in place.
    want_sd = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    want_grads = {n: p.grad.detach().to("cpu", copy=True)
                  for n, p in model.named_parameters()}
    single_step_ms = []
    for _ in range(SPATIAL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, loss_fn)
        torch.cuda.synchronize()
        single_step_ms.append((time.perf_counter() - t0) * 1e3)
    del model, state, batch

    # (d) One Trainer epoch, unsharded here, at TrainConfig's defaults (its
    # validation runs A).  Three AdamW steps in bf16
    # from gradients that any other order of the sums moves by up to 2% of a
    # tensor's largest (profile_port.py --grad-spread): the val losses are
    # held as phase 6 holds a bf16 step's loss, within 1%.
    epoch_cfg = cfg
    t0 = time.perf_counter()
    single_val = Trainer(epoch_cfg, data, work_dir=os.path.join(tmpdir, "sp_single"),
                         study_name="sp", device=dev).train(epochs=1).best_val_loss
    single_epoch_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    def forward_task(name, sp):
        return {"kind": "forward", "name": name, "spatial": sp, "state": serve_state,
                "batch": serve_batch, "model": SERVING_MODEL, "timed": SPATIAL_TIMED}

    def step_task(name, sp):
        return {"kind": "step", "name": name, "spatial": sp, "state": step_state,
                "batch": step_batch, "model": kwargs, "optimizer": optimizer,
                "loss": cfg.loss, "timed": SPATIAL_TIMED}

    plans = {2: [forward_task("fwd_1x2", 2), step_task("step_1x2", 2),
                 {"kind": "epoch", "name": "epoch_1x2", "spatial": 2, "data": data,
                  "work": os.path.join(tmpdir, "sp_work"),
                  "cfg": dataclasses.asdict(dataclasses.replace(epoch_cfg,
                                                                spatial_parallel=2))}],
             4: [forward_task("fwd_1x4", 4), step_task("step_2x2", 2)]}
    outs, walls = {}, {}
    for world, tasks in plans.items():
        t0 = time.perf_counter()
        outs[world] = run_ranks(tmpdir, f"spatial{world}", tasks, dev, world=world)
        walls[world] = time.perf_counter() - t0

    def load(world, name):
        return [torch.load(os.path.join(outs[world], f"{name}_rank{r}.pt"), weights_only=True)
                for r in range(world)]

    # (b) The gathered bands against the unsharded forward.
    spatial_launches = None
    for (dp, sp), world in zip(SPATIAL_SERVING, (2, 4)):
        ranks = load(world, f"fwd_{dp}x{sp}")
        got = ranks[0]["out"].float()    # every band, gathered (spatial.gather_rows)
        if any(not torch.equal(r["out"], ranks[0]["out"]) for r in ranks[1:]):
            failures.append(f"spatial (b) ({dp}, {sp}): the ranks gathered other outputs")
        diff = float((got - want_out).abs().max())
        scale = float(want_out.abs().max())
        bad = [r["launches"] for r in ranks
               if any(r["launches"][k] != n for k, n in SPATIAL_FORWARD_LAUNCHES.items())]
        print(f"spatial (b) serving forward ({dp}, {sp}), full width, bf16, B = 8, 256², "
              f"T = {T_SERIES}: gathered bands against the unsharded forward "
              f"max_abs_diff={diff:.4e} (output max |x| {scale:.4f}, tol "
              f"{0.05 * max(scale, 1.0):.4f}); forward "
              f"{[round(statistics.median(r['timed_ms']), 2) for r in ranks]} ms a rank "
              f"(the ranks share the card) against {statistics.median(single_ms):.2f} ms "
              f"unsharded (host clock, median of {SPATIAL_TIMED} synchronised forwards; "
              f"{smi}); rank 0's launches={ranks[0]['launches']}")
        if not torch.isfinite(got).all() or got.shape != want_out.shape:
            failures.append(f"spatial (b) ({dp}, {sp}): output {tuple(got.shape)} "
                                 f"not finite or not {tuple(want_out.shape)}")
        if diff > 0.05 * max(scale, 1.0):
            failures.append(f"spatial (b) ({dp}, {sp}): the bands disagree")
        if bad:
            failures.append(f"spatial (b) ({dp}, {sp}): launches {bad[0]}, not "
                                 f"{SPATIAL_FORWARD_LAUNCHES}")
        if (dp, sp) == SPATIAL_SERVING[0]:
            spatial_launches = ranks[0]["launches"]

    # (c) The train step against the unsharded one.
    lr = cfg.learning_rate
    for (dp, sp), world in zip(SPATIAL_TRAINING, (2, 4)):
        ranks = load(world, f"step_{dp}x{sp}")
        worst = {"param": 0.0, "stat": 0.0, "grad": 0.0, "adam": 0, "grad_at": ""}
        for k, v in want_sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            a = ranks[0]["state_dict"][k]
            if any(not torch.equal(r["state_dict"][k], a) for r in ranks[1:]):
                failures.append(f"spatial (c) ({dp}, {sp}): the ranks' {k} differ")
            bound = 1e-5 * (v.abs() + v.abs().max())
            excess = float(((a - v).abs() / (v.abs() + v.abs().max())).max())
            if k.endswith(("running_mean", "running_var")):
                worst["stat"] = max(worst["stat"], excess)
                if not bool(((a - v).abs() <= bound).all()):
                    failures.append(f"spatial (c) ({dp}, {sp}): {k} beyond 1e-5")
                continue
            g1, g2 = want_grads[k], ranks[0]["grads"][k]
            gscale = g1.abs().max()
            rel = float(((g2 - g1).abs() / (g1.abs() + gscale).clamp_min(1e-30)).max())
            if rel > worst["grad"]:
                worst["grad"], worst["grad_at"] = rel, f"{k}, largest |g| {float(gscale):.3e}"
            # JAX's tolerance for sharded against single-device gradients.
            if float((g2 - g1).abs().max()) > 2e-4 * max(1.0, float(gscale)):
                failures.append(
                    f"spatial (c) ({dp}, {sp}): the gradient of {k} differs by "
                    f"{float((g2 - g1).abs().max()):.3e} (largest |g| {float(gscale):.3e}), "
                    f"beyond 2e-4 * max(1, max|g|)")
            # AdamW's first update is lr g / (|g| + eps): a gradient that the
            # two runs round apart near 0 moves by up to 2 lr, by rounding.
            amplified = (adamw_first_update(g2, lr) - adamw_first_update(g1, lr)).abs()
            diff = (a - v).abs().double()
            worst["param"] = max(worst["param"], excess)
            worst["adam"] += int(((diff > bound.double()) & (diff <= bound.double() + amplified
                                                           + 1e-12)).sum())
            if not bool((diff <= bound.double() + amplified + 1e-12).all()):
                failures.append(f"spatial (c) ({dp}, {sp}): {k} differs beyond 1e-5 "
                                     f"and AdamW's amplification of the gradients' rounding")
        loss_rel = max(abs(r["metrics"]["total"] - single["total"]) / abs(single["total"])
                       for r in ranks)
        bad = [r["launches"] for r in ranks
               if any(r["launches"][k] != 1 for k in SPATIAL_STEP_ONCE)
               or r["launches"]["resize_rows"] == 0 or r["launches"]["resize_pack"]]
        print(f"spatial (c) train step ({dp}, {sp}), TrainConfig's defaults in f32 (B = "
              f"{cfg.batch_size}, 256², {cfg.optimizer}, {cfg.loss}), TF32 off, against one "
              f"process: loss rel diff {loss_rel:.3e} (tol 1e-6); running statistics "
              f"{worst['stat']:.3e} and parameters {worst['param']:.3e} of (|value| + the "
              f"tensor's largest) (tol 1e-5; {worst['adam']} parameter elements beyond it "
              f"within AdamW's amplification of their gradients' rounding); gradients "
              f"{worst['grad']:.3e} of (|g| + max|g|) at {worst['grad_at']} (tol 2e-4 * "
              f"max(1, max|g|)); step "
              f"{[round(statistics.median(r['timed_ms']), 1) for r in ranks]} ms and peak "
              f"{[gib(r['peak_bytes']) for r in ranks]} GiB a rank (the ranks "
              f"share the card) against {statistics.median(single_step_ms):.1f} ms and "
              f"{gib(single_peak)} GiB in one process (host clock, median of "
              f"{SPATIAL_TIMED} synchronised steps after the compared one; peak of "
              f"max_memory_allocated through utils.profiling; {smi}); rank 0's "
              f"launches={ranks[0]['launches']}")
        if loss_rel > 1e-6:
            failures.append(f"spatial (c) ({dp}, {sp}): the loss differs beyond 1e-6")
        if bad:
            failures.append(f"spatial (c) ({dp}, {sp}): launches {bad[0]}")

    # (d) The Trainer epoch.
    epochs = [json.load(open(os.path.join(outs[2], f"epoch_1x2_rank{r}.json")))
              for r in range(2)]
    vals = [e["best_val_loss"] for e in epochs]
    rel = abs(vals[0] - single_val) / abs(single_val)
    print(f"spatial (d) Trainer epoch (1, 2), TrainConfig's defaults on phase 6's "
          f"data: val loss {vals!r} on the two ranks, {single_val!r} in one process (rel "
          f"diff {rel:.3e}, tol 1e-2); restored {epochs[0]['val_restored']!r}; epoch "
          f"{[round(e['seconds'], 1) for e in epochs]} s a rank against "
          f"{single_epoch_s:.1f} s in one process (host clock); clusters of 2 and 4 ranks "
          f"{walls[2]:.1f} and {walls[4]:.1f} s with their processes' start")
    if vals[0] != vals[1] or not math.isfinite(vals[0]) or rel > 1e-2:
        failures.append("spatial (d): the val losses differ")
    if abs(epochs[0]["val_restored"] - vals[0]) > 1e-6 * abs(vals[0]):
        failures.append("spatial (d): the restored checkpoint's val loss differs")
    print(f"spatial phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"spatial phase, {len(failures)} failed check(s): "
                             + "; ".join(failures[:10]))
    return spatial_launches


# Phase 15, the f32 model paths.  A (its f32 entry), B and C in one f32
# forward of the serving U-Net (B = 8); G's f32 entry per fuse_pair forward.
F32_FORWARD_LAUNCHES = {"conv3x3_fused_f32": 4, "conv3x3_fused": 0,
                        "lstm_last_hidden": 1, "resize_pack": 4}
# The f32 forwards (kernels against the plain versions, fuse_pair against two
# launches a block, the spatial bands against the whole image): f32 sums in
# other orders carried through 18 convs, the LSTM's 828 steps and the
# decoder: max |diff| <= 1e-3 max(|output|, 1).
F32_FORWARD_TOL = 1e-3
# The command line's train in phase 15 (f) and (g): TrainConfig cut to base
# 16 and a global batch of 8, in f32, on phase 6's data.
CLI_TRAIN_OVERRIDES = ("training.base_filters=16", "training.batch_size=8",
                       "training.compute_dtype=float32")


class NarrowBlockConvs:
    """``models/blocks``' ``F`` that records every conv of at most 64
    outputs run with gradients off (an eval-mode block): those are the convs
    JAX's kernel computes, and none may go to cuDNN."""

    def __init__(self):
        self.seen: list[tuple[int, ...]] = []

    def __getattr__(self, name):
        return getattr(F, name)

    def conv2d(self, x, w, *args, **kwargs):
        if not torch.is_grad_enabled() and w.shape[0] <= 64:
            self.seen.append(tuple(w.shape))
        return F.conv2d(x, w, *args, **kwargs)


@contextlib.contextmanager
def narrow_block_convs():
    from maunet_tpu_torch.models import blocks

    record = NarrowBlockConvs()
    with mock.patch.object(blocks, "F", record):
        yield record.seen


def f32_path(dev, tmpdir: str, data: str, checkpoints: dict[str, str],
             smi: str) -> dict[str, dict[str, int]]:
    """Phase 15: the f32 model paths, then the command line's train across
    ranks.  (a) both full-width models' f32 eval forward against the plain
    versions, and with fuse_pair; (b) ``maunet-torch evaluate --precision
    float32``; (c) a ``Trainer`` epoch in f32, its validation included; (d)
    an f32 ``train_fused_conv`` step; (e) the (1, 2) spatial forward in f32
    on two ranks, with (f) ``cli.main(["train", ...])`` on the same two Gloo
    ranks; (g) the same command under ``torch.distributed.run
    --nproc-per-node 1`` and plainly.  Returns the launches of (a)'s U-Net
    forward and of both fuse_pair forwards."""
    from maunet_tpu_torch import cli
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.interop.torch_import import load_torch_checkpoint
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.models import UrbanPredictor
    from maunet_tpu_torch.models.factory import build_model
    from maunet_tpu_torch.ops.kernels import lstm, packed_vgg, resize_pack
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import model_outputs, train_step

    t_phase = time.perf_counter()
    f32 = torch.float32
    launches: dict[str, dict[str, int]] = {"f32": {}, "f32_pair": {}}

    # (g) started first: two single-process runs of the command line's
    # train, under torchrun and plainly, beside (a)-(f).
    head = ["train", "--data-dir", data, "--study-name", "f32", "--n-trials", "1",
            "--epochs", "1"]
    overrides = [arg for item in CLI_TRAIN_OVERRIDES for arg in ("-o", item)]
    argv = [*head, "--device", dev.type, *overrides]
    runs = {}
    for name, launcher in (("torchrun", [sys.executable, "-m", "torch.distributed.run",
                                         "--nproc-per-node", "1", "--master-port",
                                         str(free_port()), "-m", "maunet_tpu_torch.cli"]),
                           ("plain", [sys.executable, "-m", "maunet_tpu_torch.cli"])):
        work = os.path.join(tmpdir, f"f32_cli_{name}")
        log = open(os.path.join(tmpdir, f"f32_cli_{name}.txt"), "w+")
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        runs[name] = (work, log, subprocess.Popen(
            [*launcher, *argv, "--work-dir", work], stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env))

    # (a) The f32 eval forward of both full-width models on the first 8 test
    # samples (the batch (e) shards).
    serve_host = next(make_batches(NpzDataset(os.path.join(data, "test"), T_SERIES), 8))
    batch_path = os.path.join(tmpdir, "f32_serving.npz")
    np.savez(batch_path, **serve_host.as_dict())
    serve_batch = to_device(host_tensors(serve_host, pin=dev.type == "cuda"), dev)
    for model_type, path in checkpoints.items():
        state_dict, hp, _ = load_torch_checkpoint(path)
        models = {}
        for fuse_pair in (False, True):
            model = build_model(hp, lstm_mask_mode="batch_max", compute_dtype=f32,
                                fuse_pair=fuse_pair)
            model.load_state_dict(state_dict, strict=True)
            models[fuse_pair] = model.to(dev)

        def forward(fuse_pair):
            with torch.inference_mode():
                return model_outputs(models[fuse_pair], serve_batch)

        fns = reset_launches()
        with narrow_block_convs() as narrow:
            got = forward(False)
            torch.cuda.synchronize()
        single = {name: fn.launches for name, fn in fns.items()}
        prepared = weights_prepared()
        forward(False)
        require_nothing_prepared(prepared, f"f32 forward {model_type}")
        with mock.patch.object(packed_vgg, "conv3x3_fused", packed_vgg.conv3x3_fused_plain), \
                mock.patch.object(lstm, "lstm_last_hidden", lstm.lstm_last_hidden_scan), \
                mock.patch.object(resize_pack, "resize_pack", resize_pack.resize_pack_plain):
            want = forward(False)
        fns = reset_launches()
        with narrow_block_convs() as narrow_pair:
            paired = forward(True)
            torch.cuda.synchronize()
        pair = {name: fn.launches for name, fn in fns.items()}
        ms = {fp: cuda_ms(lambda: forward(fp)) for fp in (False, True)}
        scale = float(want.abs().max())
        diff, pair_diff = float((got - want).abs().max()), float((paired - got).abs().max())
        print(f"f32 (a) {model_type} forward (8 x 256², f32, TF32 off): against the plain "
              f"versions max_abs_diff={diff:.4e}, fuse_pair against two launches a block "
              f"max_abs_diff={pair_diff:.4e} (same bits: {torch.equal(paired, got)}) on outputs "
              f"up to {scale:.4f} (tol {F32_FORWARD_TOL * max(scale, 1.0):.2e}); "
              f"{ms[False]:.3f} ms a forward, {ms[True]:.3f} with fuse_pair (CUDA events, "
              f"median of 10; {smi}); launches {single}, with fuse_pair {pair}; narrow "
              f"block convs on cuDNN {len(narrow) + len(narrow_pair)}")
        tol = F32_FORWARD_TOL * max(scale, 1.0)
        if (got.dtype != f32 or not bool(torch.isfinite(got).all()) or diff > tol
                or pair_diff > tol):
            raise AssertionError(f"f32 (a) {model_type}: the forward disagrees")
        if narrow or narrow_pair:
            raise AssertionError(f"f32 (a) {model_type}: convs of <= 64 outputs went to "
                                 f"cuDNN: {narrow + narrow_pair}")
        if (single["conv3x3_fused_f32"] == 0 or single["conv3x3_fused"]
                or pair["conv3x3_pair_fused_f32"] != PAIR_ELIGIBLE[model_type]
                or pair["conv3x3_pair_fused"]):
            raise AssertionError(f"f32 (a) {model_type}: launches {single}, {pair}")
        if model_type == "unet":
            if any(single[k] != n for k, n in F32_FORWARD_LAUNCHES.items()):
                raise AssertionError(f"f32 (a): launches {single}, not {F32_FORWARD_LAUNCHES}")
            launches["f32"] = single
            unet_f32 = got.cpu()
        for name, n in pair.items():
            launches["f32_pair"][name] = launches["f32_pair"].get(name, 0) + n
        del models
    del serve_batch

    # (b) The command line's evaluate in f32 on phase 6's split.
    out_dir = os.path.join(tmpdir, "f32_reports")
    fns = reset_launches()
    t0 = time.perf_counter()
    with narrow_block_convs() as narrow:
        rc = cli.main(["evaluate", checkpoints["unet"], "--data-dir", data, "--precision",
                       "float32", "--output-dir", out_dir, "--study-name", "f32",
                       "--batch-size", str(EVAL_BATCH), "--n-visualize", "0",
                       "--device", str(dev)])
    wall = time.perf_counter() - t0
    evaluated = {name: fn.launches for name, fn in fns.items()}
    csvs = glob.glob(os.path.join(out_dir, "*_evaluation.csv"))
    with open(csvs[0] if csvs else os.devnull) as f:
        rows = list(csv.DictReader(f))
    overall = [r for r in rows if r["dw_class"] == "overall"]
    finite = all(math.isfinite(float(r[k])) for r in rows for k in ("mae", "rmse"))
    print(f"f32 (b) maunet-torch evaluate --precision float32: exit {rc}, {len(rows)} rows "
          f"in {wall:.1f} s, launches {evaluated}, narrow block convs on cuDNN {len(narrow)}")
    if rc != 0 or len(overall) != 2 * SAMPLES["test"] or not finite or narrow:
        raise AssertionError(f"f32 (b): exit {rc}, {len(overall)} overall rows, finite "
                             f"{finite}, cuDNN convs {narrow}")
    if 0 in (evaluated["conv3x3_fused_f32"], evaluated["masked_class_sums"]) \
            or evaluated["conv3x3_fused"]:
        raise AssertionError(f"f32 (b): launches {evaluated}")

    # (c) A Trainer epoch in f32 at TrainConfig's defaults, its validation
    # (eval mode, gradients off) on A's f32 entry.
    cfg = TrainConfig(compute_dtype="float32")
    fns = reset_launches()
    t0 = time.perf_counter()
    with narrow_block_convs() as narrow:
        result = Trainer(cfg, data, work_dir=os.path.join(tmpdir, "f32_train"),
                         study_name="f32", device=dev).train(epochs=1)
    wall = time.perf_counter() - t0
    trained = {name: fn.launches for name, fn in fns.items()}
    print(f"f32 (c) Trainer epoch (TrainConfig's defaults in f32, {SAMPLES['train']} + "
          f"{SAMPLES['val']} samples): val loss {result.best_val_loss:.6f} in {wall:.1f} s, "
          f"launches {trained}, narrow eval-mode block convs on cuDNN {len(narrow)}")
    if not math.isfinite(result.best_val_loss) or narrow or trained["conv3x3_fused"] \
            or trained["conv3x3_fused_f32"] != F32_FORWARD_LAUNCHES["conv3x3_fused_f32"]:
        raise AssertionError(f"f32 (c): val {result.best_val_loss}, launches {trained}, "
                             f"cuDNN convs {narrow}")

    # (d) One f32 train step with train_fused_conv against the plain step.
    batch = to_device(host_tensors(next(make_batches(
        NpzDataset(os.path.join(data, "train"), T_SERIES), TRAIN_BATCH)), pin=dev.type == "cuda"), dev)
    kw = dict(model_type=cfg.model_type, out_channels=len(cfg.target_channels),
              temporal_dim=cfg.temporal_dim, meta_dim=cfg.meta_dim, lstm_dim=cfg.lstm_hidden,
              base_filters=cfg.base_filters, meta_features=cfg.nb_metadata_features,
              compute_dtype=f32)
    weights = UrbanPredictor(**kw, generator=torch.Generator().manual_seed(SEED)).state_dict()
    steps = {}
    for fused in (False, True):
        model = UrbanPredictor(**kw, train_fused_conv=fused)
        model.load_state_dict(weights)
        model.to(dev)
        state = TrainState(model, make_optimizer(model.parameters(), cfg.optimizer,
                                                 cfg.learning_rate, cfg.weight_decay,
                                                 cfg.momentum), 0)
        fns = reset_launches()
        metrics = train_step(state, batch, get_loss_fn(cfg.loss))
        torch.cuda.synchronize()
        steps[fused] = ({k: float(v) for k, v in metrics.items()},
                        fns["conv3x3_fused_f32"].launches, fns["conv3x3_fused"].launches)
        del state, model
    (plain, _, _), (fused_m, a_f32, a_bf16) = steps[False], steps[True]
    rel_loss = abs(fused_m["total"] - plain["total"]) / abs(plain["total"])
    rel_norm = abs(fused_m["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    print(f"f32 (d) train step with train_fused_conv: loss {fused_m['total']:.8f} (plain "
          f"{plain['total']:.8f}, rel {rel_loss:.3e}), grad_norm rel {rel_norm:.3e}, A f32 "
          f"launches {a_f32} (bf16 {a_bf16})")
    # The same step but for the four level-0 forwards (f32 sums in other
    # orders): loss within 1e-5, gradient norm within 1e-4, relative.
    if rel_loss > 1e-5 or rel_norm > 1e-4 or a_f32 != TRAIN_FUSED_LAUNCHES["unet"] or a_bf16:
        raise AssertionError(f"f32 (d): rel loss {rel_loss}, rel norm {rel_norm}, "
                             f"launches {a_f32}, {a_bf16}")
    del batch
    torch.cuda.empty_cache()

    # (e) and (f) on two Gloo ranks sharing the card: the (1, 2) spatial
    # forward in f32 of (a)'s U-Net on (a)'s batch, then the command line's
    # train with --search over the group the workers made.
    state_path = os.path.join(tmpdir, "f32_serving.pt")
    torch.save(torch.load(checkpoints["unet"], weights_only=False)["model_state_dict"],
               state_path)
    cli_work = os.path.join(tmpdir, "f32_cli_ranks")
    rank_argv = [*head, "--device", str(dev), *overrides, "--search", "--work-dir", cli_work]
    t0 = time.perf_counter()
    out = run_ranks(tmpdir, "f32", [
        {"kind": "forward", "name": "fwd_f32", "spatial": 2, "state": state_path,
         "batch": batch_path, "model": {**SERVING_MODEL, "compute_dtype": "float32"}},
        {"kind": "cli", "name": "cli", "argv": rank_argv}], dev)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"fwd_f32_rank{r}.pt"), weights_only=True)
             for r in range(DP_RANKS)]
    bands = ranks[0]["out"]
    diff = float((bands - unet_f32).abs().max())
    scale = float(unet_f32.abs().max())
    print(f"f32 (e) spatial forward (1, 2), f32: gathered bands against (a)'s unsharded "
          f"forward max_abs_diff={diff:.4e} (same bits: {torch.equal(bands, unet_f32)}, "
          f"tol {F32_FORWARD_TOL * max(scale, 1.0):.2e}); rank 0's launches "
          f"{ranks[0]['launches']}")
    if diff > F32_FORWARD_TOL * max(scale, 1.0) or not bool(torch.isfinite(bands).all()) \
            or any(not torch.equal(r["out"], bands) for r in ranks[1:]):
        raise AssertionError("f32 (e): the bands disagree")
    if any(r["launches"]["conv3x3_fused_f32"] != F32_FORWARD_LAUNCHES["conv3x3_fused_f32"]
           or r["launches"]["conv3x3_fused"]
           or r["launches"]["resize_rows"] != 4 for r in ranks):
        raise AssertionError(f"f32 (e): launches {[r['launches'] for r in ranks]}")
    clis = []
    for r in range(DP_RANKS):
        with open(os.path.join(out, f"cli_rank{r}.json")) as f:
            clis.append(json.load(f))
    with open(f"{cli_work}_hpo/f32-emb.json") as f:
        (trial,) = json.load(f)["trials"]
    print(f"f32 (f) cli.main(['train', '--search', ...]) on {DP_RANKS} Gloo ranks sharing "
          f"the card: exits {[c['rc'] for c in clis]}, trial {trial['state']} with "
          f"{trial['params']}, val {trial['value']}; each rank's trainers "
          f"{[c['trainers'] for c in clis]}; (e) and (f) {wall:.1f} s")
    if [c["rc"] for c in clis] != [0] * DP_RANKS or trial["state"] != "COMPLETE" \
            or any(c["trainers"] != clis[0]["trainers"] for c in clis) \
            or any(c["histories"] != clis[0]["histories"] for c in clis) \
            or clis[0]["trainers"][0]["learning_rate"] != float(
                trial["params"]["learning_rate"]).hex():
        raise AssertionError(f"f32 (f): {clis}, {trial}")

    # (g) The two single-process runs: the same trial, the same history.
    values = {}
    for name, (work, log, proc) in runs.items():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            raise AssertionError(f"f32 (g) {name}: exit {proc.returncode}\n{text[-3000:]}")
        with open(f"{work}_hpo/f32-emb.json") as f:
            (t,) = json.load(f)["trials"]
        values[name] = (t["state"], t["value"], t["intermediate"])
    (state_t, v_t, hist_t), (state_p, v_p, hist_p) = values["torchrun"], values["plain"]
    print(f"f32 (g) torch.distributed.run --nproc-per-node 1 -m maunet_tpu_torch.cli train: "
          f"{state_t}, val {v_t!r}; the plain command: {state_p}, val {v_p!r} (same bits: "
          f"{v_t == v_p}; history {hist_t} and {hist_p})")
    # One process each, the same seed and data: the histories agree within
    # 1e-4 relative (cuDNN's backward in f32 sums in no fixed order).
    if state_t != "COMPLETE" or state_p != "COMPLETE" or hist_t.keys() != hist_p.keys() \
            or any(abs(hist_t[k] - hist_p[k]) > 1e-4 * abs(hist_p[k]) for k in hist_p):
        raise AssertionError(f"f32 (g): {values}")
    print(f"f32 phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


LSTM_CU = "maunet_tpu_torch/csrc/lstm.cu"
# name: (source, TPU kernel replaced, the path whose launches the summary gives)
KERNEL_INFO = {
    "conv3x3_fused": ("maunet_tpu_torch/csrc/conv3x3_fused.cu",
                      "maunet_tpu/ops/pallas/packed_vgg.py:451", "serving"),
    "lstm_last_hidden": (LSTM_CU, "maunet_tpu/ops/pallas/lstm.py:402", "serving"),
    "resize_pack": ("maunet_tpu_torch/csrc/resize_pack.cu",
                    "maunet_tpu/ops/pallas/resize_pack.py:216", "serving"),
    # C's row entry: each rank's rows of the global resize (the spatial axis)
    "resize_rows": ("maunet_tpu_torch/csrc/resize_pack.cu",
                    "maunet_tpu/ops/pallas/resize_pack.py:216", "spatial"),
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
    # A and G in f32 (the TPU kernels compute in the parts' dtype)
    "conv3x3_fused_f32": (F32_SOURCE, "maunet_tpu/ops/pallas/packed_vgg.py:451", "f32"),
    "conv3x3_pair_fused_f32": (F32_SOURCE, "maunet_tpu/ops/pallas/packed_vgg.py:373",
                               "f32_pair"),
    # replaces no TPU kernel: the JAX package runs flax's nn.BatchNorm and
    # ReLU there (maunet_tpu/models/blocks.py:506-521)
    "bn_relu_train": ("maunet_tpu_torch/csrc/batchnorm_train.cu",
                      "none (XLA-fused flax BatchNorm)", "training"),
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
    ptxas = start_ptxas(F32_SOURCE)
    lib = _build.build()
    registers = ptxas_registers(ptxas, ("conv3x3_pair_f32_kernel", "conv3x3_f32_kernel"))
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    table = KernelTable()
    check_kernels(table, dev)
    check_f32_kernels(table, dev, registers)
    check_bn_train(table, dev)
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
        research_app_path(dev, tmpdir, data, checkpoints, smi[0])
        parallel_path(dev, tmpdir, data, checkpoints["unet"], smi[0])
        launches["spatial"] = spatial_path(dev, tmpdir, data, checkpoints["unet"], smi[0],
                                           table)
        launches.update(f32_path(dev, tmpdir, data, checkpoints, smi[0]))

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
