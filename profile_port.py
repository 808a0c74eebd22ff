#!/usr/bin/env python3
"""Profile the PyTorch port on one CUDA card: the U-Net's serving forward,
with ``--train`` one train step, with ``--eval`` one evaluation batch of
each model family, with ``--conv`` the fused 3x3 conv kernel alone, with
``--lstm`` the LSTM kernels alone, with ``--resize`` the resize kernel alone,
with ``--masked`` the masked class sums kernel alone, or with
``--grad-spread`` how far a train step's gradients move with the order of
their sums (one process, cuDNN or not, two ranks data- or spatial-parallel;
``grad_spread``).

    python3 profile_port.py [--trace PATH]           # default build/port_forward_trace.json
    python3 profile_port.py --train [--trace PATH]   # default build/port_train_trace.json
    python3 profile_port.py --eval [--trace PATH]    # default build/port_eval_trace.json
    python3 profile_port.py --conv                   # no trace
    python3 profile_port.py --conv --f32 [--parent PATH ...]  # no trace; PATH: other conv3x3_f32.cu files
    python3 profile_port.py --lstm [--parent PATH ...]   # no trace; PATH: other lstm.cu files
    python3 profile_port.py --resize [--parent PATH]     # no trace; PATH: another resize_pack.cu
    python3 profile_port.py --masked [--parent PATH ...] # no trace; PATH: other masked_stats.cu files
    python3 profile_port.py --grad-spread                # no trace

The serving mode builds the full-width serving U-Net of ``chip_smoke.py``
(seeded weights and BatchNorm statistics), assembles 8 requests at 256² as
``predict_many`` does, and prints:

* the forward's wall time on device-resident inputs (CUDA events, median of
  10 after 3 warm-up runs);
* the host pieces of ``predict_many``: the concat of the 8 maps, their
  host-to-device copy, and ``predict_many`` itself (host clock, median of 5);
* kernel A at the three level-0 shapes of that batch, with its weights
  prepared once as the model's blocks keep them, beside the same conv in
  cuDNN's bf16 (no epilogue) and A's plain version (f32);
* from a ``torch.profiler`` trace of 3 forwards: the device-busy time per
  forward, as the union of the kernel intervals, split by kernel family; and
  the device idle share, 1 - busy / wall.  The wall time is the unprofiled
  one: the profiler slows the host's dispatch, not the kernels.

The ``--train`` mode builds ``TrainConfig``'s default model and AdamW
(seeded), takes one batch of 16 synthetic 256² samples with T = 828 on the
card, and prints the train step's time (host clock around synchronised
steps, median of 10 after 3 warm-up steps) and, from a trace of 3 steps,
the same busy-time split by family and idle share.

The ``--eval`` mode builds ``chip_smoke.py``'s two full-width checkpoints (the
U-Net at base 64 and U-Net++ at base 32), takes one batch of 16 synthetic
256² samples with T = 828 on the card, and for each model prints the time of
``evaluate.evaluator.batch_metrics`` (forward, un-normalisation and every
metric; host clock around synchronised calls, median of 10 after 3 warm-up
calls) and, from a trace of 3 calls, the busy-time split by family and the
idle share.  The trace of the U-Net++ run goes beside the U-Net's with a
``_unetpp`` suffix.

The ``--conv`` mode compiles ``csrc/conv3x3_fused.cu`` alone with ``-Xptxas
-v`` and prints each instantiation's registers and spills; holds the kernel
against its plain version at nine shapes (odd sizes, two output-channel
tiles, the 2-byte path, up to four parts with ``add``), with prepared and raw
weights, which must give the same bits; and times it at the serving batch's
three level-0 convs (B=8) and at every distinct conv of an evaluation batch
(B=16) of both models: through the wrapper with prepared weights (CUDA
events around single calls, median of 10), on the device (events around ten
calls back to back), with raw weights, beside cuDNN's conv with the same
epilogue and the bound (``chip_smoke.cudnn_block``, ``conv_work``).

The ``--conv --f32`` mode takes A's and G's f32 entries
(``csrc/conv3x3_f32.cu``) instead: it compiles that file alone with
``-Xptxas -v`` and prints each instantiation's registers and spills; holds
A at every f32 shape of ``chip_smoke.py``'s phase 3 (``F32_A_CASES``: the
serving, evaluation and planner convs and two odd ones) and G at its blocks
(``F32_G_CASES``: the pair configuration's eleven and two odd ones) against
the plain version (``chip_smoke.F32_TOL``); and times each beside cuDNN's
f32 conv with the same epilogue (TF32 off, ``chip_smoke.cudnn_block``) and
the bound, G also beside the two A launches it replaces (CUDA events around
ten calls back to back, median of 5, so the wrappers' host time stays behind
the device's), with sums per group.  With ``--parent PATH
...``, other ``conv3x3_f32.cu`` files, each built into a library of its own
and called with the arguments its entry points name, with weights prepared
at the file's own K step (its ``constexpr int BK``), must give the tree's
bits or are listed where they do not, and are timed in turns with the tree
(the parents in order, the tree twice, the parents in reverse).  To compare
with the last commit, write its file first: ``git show
HEAD:maunet_tpu_torch/csrc/conv3x3_f32.cu > build/conv3x3_f32_parent.cu``.
Where ``ncu`` is on the machine it also profiles A once at the serving
batch's 64 -> 64 conv for its shared-memory wavefronts per FFMA and its
stall reasons.

The ``--lstm`` mode compiles ``csrc/lstm.cu`` alone with ``-Xptxas -v`` and
prints each kernel's registers and spills; holds B (``lstm_last_hidden``), E
(``lstm_forward_stash``) and F (``lstm_backward``: the gate terms, then the
recurrence) against their plain versions at ``chip_smoke.LSTM_EDGE_CASES``
(lengths 0, 1 and T in one batch, B = 1, H = 50, 64 and 96, T = 64 and 828);
and at the serving (B = 8), evaluation and training (B = 16) batches of
``chip_smoke.py`` (T = 828, H = 96) prints B's, E's and F's device times
(CUDA events around ten calls back to back; F as both launches through its
wrapper, and each launch alone) beside cuDNN's LSTM (``nn.LSTM`` over the
raw series at full length, the forward alone and the forward with the
backward of its last hidden state) and beside the serial chain's bound: the
batch's longest length times the H x 4H FMAs of one step on one SM's 128 f32
lanes, at the SM's maximum clock (``nvidia-smi``'s ``clocks.max.sm``).  At
the training batch and at B = 1 it also prints dW's device time
(``lstm_dw``: the split-row product and its reduce; as CUDA events around
ten calls and as the summed kernel durations of a profiler trace) beside its
plain version and the bare cuBLAS product of the pre-masked ``h_prev^T`` and
``dx_proj`` (f32, TF32 off).  At each of the three batches it prints F's two
launches as kernel time (the summed kernel durations of a profiler trace),
the gate terms beside the bare cuBLAS product of their pre-activations
(``torch.addmm`` of the x_proj rows and h_(t-1) W_hh over the rows t <
length: the product alone, without the epilogue) and their bound.  With
``--parent PATH ...``, other ``lstm.cu`` files, each built into a library of
its own, their ``maunet_lstm_gate_terms`` (called with the arguments its
signature names) must give the tree's gate terms bit for bit where t <
length at the three batches and at ``LSTM_EDGE_CASES``, and all are timed in
turns: the parents in order, the tree twice, the parents in reverse.

The ``--resize`` mode compiles ``csrc/resize_pack.cu`` alone with ``-Xptxas
-v`` and prints each instantiation's registers and spills; then at each of
the twelve path shapes of ``chip_smoke.RESIZE_CASES`` (the serving batch's
four upsamples, the U-Net's and U-Net++'s four at the evaluation batch)
prints the kernel's device time, both as CUDA events around ten calls back
to back and as the summed kernel durations of a profiler trace (at the small
shapes the events read the host's enqueue of the wrapper), beside its bytes
bound, ``F.interpolate(bilinear, align_corners=True)`` on the same data, a
write-only floor (``fill_(0)`` of an output-sized tensor) and a
read-plus-write floor (``copy_`` of an output-sized tensor), and the sums
over each path's four; and the kernel's time at each strip height of
``STRIP_SWEEP`` (output rows a thread), which must give the same bits.  With
``--parent PATH`` it also compiles PATH, another version of
``resize_pack.cu``, into a library of its own (ctypes loads it with
``RTLD_LOCAL``, so its entry point does not clash with the tree's), calls
its ``maunet_resize_align_corners`` with the arguments its signature names,
requires the same bits as the tree's kernel at all seventeen shapes of
``RESIZE_CASES``, and times the two in turns (parent, tree, tree, parent).
To compare with the last commit, write its file first: ``git show
HEAD:maunet_tpu_torch/csrc/resize_pack.cu > build/resize_pack_parent.cu``.

The ``--masked`` mode compiles ``csrc/masked_stats.cu`` alone with
``-Xptxas -v`` and prints each instantiation's registers and spills; then at
every shape of ``chip_smoke.MASKED_CASES`` holds the kernel against its plain
version and against the ``torch.bincount`` composition of the same three
outputs (several launches, not one call: a yardstick only), and prints its
kernel time (trace) and events around ten calls beside a read floor
(``torch.sum`` over a flat f32 tensor of exactly the kernel's input bytes,
one library launch reading what it reads), the composition and the bytes
bound, and the host time of one call through the wrapper.  With ``--parent
PATH ...``, other ``masked_stats.cu`` files (either signature: one output row
per sample, or the two-launch one with its scratch), each built into a
library of its own, are held to the tree's kernel within the check's
tolerance (they may sum in other orders) and timed in turns with it, as with
``--lstm``.

The busy time is read from the trace's kernel intervals, not from
``key_averages()``: there a kernel's time is counted both on its own row and
in the ``self_device_time_total`` of the aten operator that launched it, so
the sum over rows exceeds the busy time.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel families, matched in this order against the kernel's name.
FAMILIES = (
    ("A conv3x3_fused", ("conv3x3_fused",)),
    ("B lstm_last_hidden", ("lstm_last_hidden",)),
    ("C resize_align_corners", ("resize_align_corners",)),
    ("cuDNN convs (>= 128 channels)", ("xmma_fprop", "cudnn")),
    ("GEMMs (encoders' dense layers)", ("gemm",)),
)
OTHER = "other torch ops (epilogues, BN fold, casts, cat, pool)"

# The train step's families.  E is the stash instantiation of B's template
# (``<true>``, mangled ``ILb1E``); every train-mode conv is cuDNN's.
TRAIN_FAMILIES = (
    ("A conv3x3_fused", ("conv3x3_fused",)),
    ("E lstm stash forward", ("lstm_last_hidden_kernel<true", "lstm_last_hidden_kernelILb1E")),
    ("B lstm_last_hidden", ("lstm_last_hidden",)),
    ("F lstm backward", ("lstm_gate_terms", "lstm_backward")),
    ("dW lstm_dw", ("lstm_dw",)),
    ("C resize_align_corners", ("resize_align_corners",)),
    ("cuDNN convs, forward and backward", ("xmma", "cudnn", "dgrad", "wgrad", "fprop", "conv")),
    ("GEMMs (dense layers, SSIM blur, resize backward)", ("gemm", "cutlass")),
    ("optimizer (multi-tensor apply)", ("multi_tensor_apply",)),
)
TRAIN_OTHER = "other torch ops (BN, casts, cat, pool, losses)"

EVAL_FAMILIES = (
    ("A conv3x3_fused", ("conv3x3_fused",)),
    ("B lstm_last_hidden", ("lstm_last_hidden",)),
    ("C resize_align_corners", ("resize_align_corners",)),
    ("D masked_class_sums", ("masked_stats",)),
    ("cuDNN convs (>= 128 channels)", ("xmma_fprop", "cudnn")),
    ("GEMMs (encoders' dense layers)", ("gemm",)),
)
EVAL_OTHER = "other torch ops (epilogues, BN fold, cat, pool, means, Laplacian, argmax)"


def family(name: str, families=FAMILIES, other: str = OTHER) -> str:
    for label, keys in families:
        if any(k in name for k in keys):
            return label
    return other


def profile_breakdown(fn, n: int, trace: str, families=FAMILIES, other: str = OTHER) -> dict:
    """Trace ``n`` calls of ``fn`` into ``trace`` and return its breakdown."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        doc = json.load(f)
    return trace_breakdown(doc["traceEvents"] if isinstance(doc, dict) else doc, n,
                           families, other)


def print_breakdown(br: dict, what: str, n: int, wall_ms: float) -> None:
    print(f"device busy per {what}: {br['busy_ms']:.3f} ms over {br['kernels']:.0f} kernels "
          f"(union of kernel intervals, {n} profiled); idle share against the "
          f"unprofiled {wall_ms:.3f} ms: {1 - br['busy_ms'] / wall_ms:.3f}")
    for label, ms in sorted(br["families"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {100 * ms / br['busy_ms']:5.1f}%  {label}")


def trace_breakdown(events: list[dict], n_forwards: int, families=FAMILIES,
                    other: str = OTHER) -> dict:
    """Device time per forward from Chrome-trace events (``ts``/``dur`` in
    µs): ``busy_ms``, the union of the kernel intervals; ``families``, each
    family's summed kernel time; ``kernels``, the kernel count."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy = 0.0
    cur_start = cur_end = None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    per_family: dict[str, float] = {}
    for e in kernels:
        key = family(e["name"], families, other)
        per_family[key] = per_family.get(key, 0.0) + float(e["dur"]) / 1e3 / n_forwards
    return {"busy_ms": busy / 1e3 / n_forwards, "families": per_family,
            "kernels": len(kernels) / n_forwards}


def host_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def train_profile(trace: str, dev: torch.device) -> None:
    """``--train``: one full-width train step, timed and traced."""
    import chip_smoke as cs

    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.data.synthetic import generate_dataset
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.train.config import TrainConfig
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.train.steps import train_step

    cfg = TrainConfig()
    with tempfile.TemporaryDirectory() as tmpdir:
        data = generate_dataset(os.path.join(tmpdir, "data"),
                                {"train": cfg.batch_size, "val": 1},
                                hw=256, temporal_len=cs.T_SERIES, seed=cs.SEED)
        ds = NpzDataset(os.path.join(data, "train"), cfg.temporal_length)
        batch = to_device(host_tensors(next(make_batches(ds, cfg.batch_size)),
                                       pin=dev.type == "cuda"), dev)
        trainer = Trainer(cfg, data, work_dir=os.path.join(tmpdir, "work"), device=dev)
        state = trainer.init_state(batch["maps"].shape[-1])
    loss_fn = get_loss_fn(cfg.loss)

    def step():
        train_step(state, batch, loss_fn)

    for _ in range(3):
        step()
    ms = host_ms(step, reps=10)
    print(f"train step ({cfg.batch_size} x 256², T = {cs.T_SERIES}, bf16, {cfg.optimizer}, "
          f"{cfg.loss}): {ms:.3f} ms, {cfg.batch_size / ms * 1e3:.1f} tiles/s "
          f"(host clock around synchronised steps, median of 10)")
    n = 3
    print_breakdown(profile_breakdown(step, n, trace, TRAIN_FAMILIES, TRAIN_OTHER),
                    "train step", n, ms)


def eval_profile(trace: str, dev: torch.device) -> None:
    """``--eval``: one full-width evaluation batch per model family, timed
    and traced."""
    import chip_smoke as cs

    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.data.schema import NormalizationStats
    from maunet_tpu_torch.data.synthetic import generate_dataset
    from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
    from maunet_tpu_torch.evaluate.evaluator import batch_metrics

    with tempfile.TemporaryDirectory() as tmpdir:
        data = generate_dataset(os.path.join(tmpdir, "data"), {"test": cs.EVAL_BATCH},
                                hw=256, temporal_len=cs.T_SERIES, seed=cs.SEED)
        ds = NpzDataset(os.path.join(data, "test"), cs.T_SERIES)
        batch = to_device(host_tensors(next(make_batches(ds, cs.EVAL_BATCH)),
                                       pin=dev.type == "cuda"), dev)
        stats = NormalizationStats.from_json(os.path.join(data, "normalization_metrics.json"))
        models = {m: load_any_checkpoint(cs.write_checkpoint(tmpdir, m), device=dev).model
                  for m in cs.FULL_WIDTH}
    for model_type, model in models.items():
        def run():
            batch_metrics(model, batch, stats, 8)

        for _ in range(3):
            run()
        ms = host_ms(run, reps=10)
        print(f"evaluation batch {model_type} ({cs.EVAL_BATCH} x 256², T = {cs.T_SERIES}, "
              f"bf16; forward and metrics): {ms:.3f} ms, {cs.EVAL_BATCH / ms * 1e3:.1f} "
              f"tiles/s (host clock around synchronised calls, median of 10)")
        n = 3
        path = trace if model_type == "unet" else trace.replace(".json", "_unetpp.json")
        print_breakdown(profile_breakdown(run, n, path, EVAL_FAMILIES, EVAL_OTHER),
                        f"evaluation batch ({model_type})", n, ms)


# --conv: the shapes held against the plain version, as (batch, (H, W), the
# parts' channels, cout, with add).
CONV_CHECKS = (
    (2, (256, 256), (23,), 64, False), (2, (256, 256), (64, 128), 64, False),
    (2, (256, 256), (64,), 64, True), (2, (125, 125), (23, 40), 48, True),
    (2, (33, 47), (16,), 80, True), (8, (256, 256), (32, 32, 32, 64), 32, True),
    (1, (250, 250), (23,), 64, False), (1, (5, 3), (7,), 3, True),
    (3, (16, 16), (8,), 33, False))


def ptxas_report(source: str, label) -> None:
    """Compile ``csrc/<source>`` alone with ``-Xptxas -v`` and print each
    kernel's registers and spills; ``label(entry)`` names a kernel from
    ptxas's line for its mangled name."""
    from maunet_tpu_torch.ops.kernels import _build

    with tempfile.TemporaryDirectory() as tmpdir:
        ptxas = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / source), "-o", os.path.join(tmpdir, "k.o")],
            capture_output=True, text=True, check=True).stderr
    for line in ptxas.splitlines():
        if "Compiling entry" in line:
            print(f"ptxas, {label(line)}:", end=" ")
        elif "registers" in line or "spill" in line:
            print(line.replace("ptxas info    :", "").strip(), end="; " if "spill" in line else "\n")


def conv_kernel_label(entry: str) -> str:
    nt, stages = re.search(r"conv3x3_fused_kernelILi(\d+)ELi(\d+)E", entry).groups()
    return f"BN = {8 * int(nt)} with {stages} stages"


def lstm_kernel_label(entry: str) -> str:
    """``lstm_last_hidden_kernel<stash, KS>``, ``lstm_backward_kernel<KS>``,
    another kernel with its one bool argument (``lstm_gate_terms_kernel<VEC>``,
    ``lstm_dw_partial_kernel<VEC_H>``) or the kernel's plain name, from its
    mangled name."""
    m = re.search(r"lstm_last_hidden_kernelILb(\d)ELi(\d+)E", entry)
    if m:
        return f"lstm_last_hidden_kernel<{'true' if m.group(1) == '1' else 'false'}, KS = {m.group(2)}>"
    m = re.search(r"lstm_backward_kernelILi(\d+)E", entry)
    if m:
        return f"lstm_backward_kernel<KS = {m.group(1)}>"
    m = re.search(r"(lstm_\w+?_kernel)ILb(\d)E", entry)
    if m:
        return f"{m.group(1)}<{'true' if m.group(2) == '1' else 'false'}>"
    m = re.search(r"(lstm_\w+?_kernel)", entry)
    return m.group(1) if m else entry


def device_ms(fn, calls: int = 10) -> float:
    """Device time per call: CUDA events around ``calls`` calls back to back
    (median of 5)."""
    import chip_smoke as cs

    return cs.cuda_ms(lambda: [fn() for _ in range(calls)], reps=5) / calls


def lstm_checks(dev: torch.device, parents: dict | None = None) -> None:
    """B, E and F against their plain versions at ``chip_smoke.LSTM_EDGE_CASES``;
    F's gate terms also bit for bit against each of ``parents`` (name ->
    ``parent_gate_terms``)."""
    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import lstm

    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for hidden, t, lens in cs.LSTM_EDGE_CASES:
        x_proj, w_hh, lengths = cs.lstm_inputs(g, dev, hidden, t, lens)
        grad = torch.randn((len(lens), hidden), generator=g, device=dev)
        with torch.no_grad():
            got = (lstm.lstm_last_hidden(x_proj, w_hh, lengths),
                   *lstm.lstm_forward_stash(x_proj, w_hh, lengths))
            want = (lstm.lstm_last_hidden_scan(x_proj, w_hh, lengths),
                    *lstm.lstm_forward_stash_plain(x_proj, w_hh, lengths))
            dx = lstm.lstm_backward(x_proj, w_hh, lengths, *want[2:], grad)
            dx_want = lstm.lstm_backward_plain(x_proj, w_hh, lengths, *want[2:], grad)[0]
            for name, parent in (parents or {}).items():
                same_gate_bits(f"H = {hidden}, T = {t}, lengths {lens}", lengths,
                               lstm.lstm_gate_terms(x_proj, w_hh, lengths, *want[2:]),
                               parent(x_proj, w_hh, lengths, *want[2:]), name)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        f_err = float((dx - dx_want).abs().max())
        ok = (err <= 1e-4 and all(bool(torch.isfinite(a).all()) for a in (*got, dx))
              and bool(((dx - dx_want).abs() <= 1e-4 + 1e-4 * dx_want.abs()).all()))
        print(f"check B, E and F, H = {hidden}, T = {t}, lengths {lens}: max_abs_err={err:.3e} "
              f"(tol 1e-4), F {f_err:.3e} (tol 1e-4 + 1e-4|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"lstm H = {hidden}, T = {t}, lengths {lens} disagrees")


def sm_clock_ghz() -> float:
    """The SM's maximum clock, from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) / 1e3


def gate_arguments(params, x_proj, w_hh, lengths, h_all, c_all, terms, stream: int) -> list:
    """The values for ``params`` of one ``maunet_lstm_gate_terms`` launch."""
    b, t, four_h = x_proj.shape
    values = {"x_proj": x_proj.data_ptr(), "w_hh": w_hh.data_ptr(),
              "lengths": lengths.data_ptr(), "h_all": h_all.data_ptr(),
              "c_all": c_all.data_ptr(), "terms": terms.data_ptr(), "B": b, "T": t,
              "H": four_h // 4, "stream": stream}
    return named_arguments("maunet_lstm_gate_terms", params, values)


def parent_gate_terms(path: str, name: str | None = None):
    """Compile another ``lstm.cu`` into a library of its own and return a
    function (x_proj, w_hh, lengths, h_all, c_all) -> terms that launches its
    gate-terms kernel."""
    from maunet_tpu_torch.ops.kernels import _build

    fn, params = parent_entry(path, "maunet_lstm_gate_terms", name)

    def launch(x_proj, w_hh, lengths, h_all, c_all):
        b, t, four_h = x_proj.shape
        terms = torch.empty((b, t, 6 * (four_h // 4)), dtype=torch.float32,
                            device=x_proj.device)
        code = fn(*gate_arguments(params, x_proj, w_hh, lengths, h_all, c_all, terms,
                                  _build.stream_of(x_proj)))
        if code != 0:
            raise RuntimeError(f"parent lstm gate terms: CUDA error {code}")
        return terms

    return launch


def same_gate_bits(label: str, lengths, got, want, name: str = "the parent") -> None:
    """Require the same bits of two (B, T, 6H) gate terms at t < length,
    the rows the kernels write: the tree's (``got``) and ``name``'s."""
    active = (torch.arange(got.shape[1], device=got.device)[None, :]
              < lengths[:, None])[..., None]
    got, want = torch.where(active, got, 0.0), torch.where(active, want, 0.0)
    same = torch.equal(got, want)
    print(f"bits gate terms {label}: " + (f"the same as {name}'s at t < length" if same
                                          else f"DIFFER from {name}'s (max |diff| "
                                               f"{float((got - want).abs().max()):.3e})"))
    if not same:
        raise AssertionError(f"gate terms {label}: the tree's kernel and {name}'s "
                             "give other bits")


def gate_times(label: str, x_proj, w_hh, lengths, h_all, c_all, terms, grad,
               parents: dict | None = None) -> None:
    """F's two launches as kernel time (trace), the gate terms beside the
    bare cuBLAS product of their pre-activations and their bound, and in
    turns with each of ``parents`` (name -> ``parent_gate_terms``): the
    parents in order, the tree twice, the parents in reverse."""
    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import lstm

    b, t, gates = x_proj.shape
    hidden = gates // 4
    active = torch.arange(t, device=x_proj.device)[None, :] < lengths[:, None]
    steps = int(active.sum())
    h_prev = torch.cat([torch.zeros_like(h_all[:, :1]), h_all[:, :-1]], 1)
    x_rows, h_rows = x_proj[active].contiguous(), h_prev[active].contiguous()
    calls = {"tree": lambda: lstm.lstm_gate_terms(x_proj, w_hh, lengths, h_all, c_all),
             "recurrence": lambda: lstm._backward_recur(terms, w_hh, lengths, grad),
             "cuBLAS": lambda: torch.addmm(x_rows, h_rows, w_hh)}
    parents = parents or {}
    for name, parent in parents.items():
        same_gate_bits(label, lengths, calls["tree"](),
                       parent(x_proj, w_hh, lengths, h_all, c_all), name)
        calls[name] = (lambda p: lambda: p(x_proj, w_hh, lengths, h_all, c_all))(parent)
    order = [*parents, "tree", "tree", *reversed(parents)]
    times: dict[str, list[float]] = {}
    for key in order + ["cuBLAS", "recurrence"]:
        times.setdefault(key, []).append(kernel_ms(calls[key]))
    nbytes = (steps * (gates + 2 * hidden + 6 * hidden)) * 4 + hidden * gates * 4
    flops = steps * (2 * hidden * gates + 20 * gates)
    bytes_ms, ops_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3, flops / cs.PEAK_FLOPS["f32"] * 1e3
    print(f"gate terms {label}, {steps} rows t < length: tree "
          + " and ".join(f"{v:.4f}" for v in times["tree"])
          + ("" if not parents else
             " (" + "; ".join(f"{n} " + " and ".join(f"{v:.4f}" for v in times[n])
                             for n in parents)
             + "; in turns " + ", ".join(order) + ")")
          + f" ms of kernel time (trace); cuBLAS addmm of the x_proj rows and h_(t-1) W_hh, "
          f"the product alone, without the epilogue, {times['cuBLAS'][0]:.4f}; bound "
          f"{max(bytes_ms, ops_ms):.4f} ({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
          f"bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); the recurrence "
          f"{times['recurrence'][0]:.4f} ms of kernel time")


def lstm_times(dev: torch.device, parents: dict | None = None) -> None:
    """B, E and F at the three batches of ``chip_smoke.py``, beside cuDNN and
    the serial chain's bound, and F's launches as kernel time (``gate_times``);
    dW at the training batch and at B = 1."""
    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import lstm

    hidden = 96
    clock = sm_clock_ghz()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    cudnn = torch.nn.LSTM(1, hidden, batch_first=True).to(dev)
    for label, lens in (("serving", cs.SERVING_LENGTHS), ("evaluation", cs.EVAL_LENGTHS),
                        ("training", cs.TRAIN_LENGTHS)):
        x_proj, w_hh, lengths = cs.lstm_inputs(g, dev, hidden, cs.T_SERIES, lens)
        b = len(lens)
        series = torch.randn((b, cs.T_SERIES, 1), generator=g, device=dev)
        grad = torch.randn((b, hidden), generator=g, device=dev)
        with torch.no_grad():
            _, h_all, c_all = lstm.lstm_forward_stash(x_proj, w_hh, lengths)
            terms = lstm.lstm_gate_terms(x_proj, w_hh, lengths, h_all, c_all)
            b_ms = device_ms(lambda: lstm.lstm_last_hidden(x_proj, w_hh, lengths))
            e_ms = device_ms(lambda: lstm.lstm_forward_stash(x_proj, w_hh, lengths))
            f_ms = device_ms(lambda: lstm.lstm_backward(x_proj, w_hh, lengths, h_all, c_all, grad))
            fa_ms = device_ms(lambda: lstm.lstm_gate_terms(x_proj, w_hh, lengths, h_all, c_all))
            fb_ms = device_ms(lambda: lstm._backward_recur(terms, w_hh, lengths, grad))
            cudnn_ms = device_ms(lambda: cudnn(series))
        series_g = series.clone().requires_grad_()
        cudnn_bwd_ms = device_ms(lambda: torch.autograd.grad(
            cudnn(series_g)[1][0].sum(), series_g))
        chain_ms = max(lens) * hidden * 4 * hidden / 128 / (clock * 1e6)
        print(f"time {label} ({b}, {cs.T_SERIES}, {4 * hidden}), {sum(lens)} steps in all: "
              f"B {b_ms:.4f} ms, E {e_ms:.4f}, F {f_ms:.4f} (gate terms {fa_ms:.4f} + "
              f"recurrence {fb_ms:.4f} = {fa_ms + fb_ms:.4f}) on the device; cuDNN LSTM "
              f"forward {cudnn_ms:.4f}, forward and backward {cudnn_bwd_ms:.4f}; serial "
              f"chain bound of B, E and F {chain_ms:.4f} ({max(lens)} steps x "
              f"{hidden * 4 * hidden // 128} cycles at {clock:.3f} GHz)")
        with torch.no_grad():
            gate_times(label, x_proj, w_hh, lengths, h_all, c_all, terms, grad, parents)
        if label == "training":
            dw_times(b, hidden, lens, lengths, h_all,
                     lstm.lstm_backward(x_proj, w_hh, lengths, h_all, c_all, grad))
    # dW also at B = 1, where the slices hold few rows each.
    x_proj, w_hh, lengths = cs.lstm_inputs(g, dev, hidden, cs.T_SERIES, [cs.T_SERIES])
    with torch.no_grad():
        _, h_all, c_all = lstm.lstm_forward_stash(x_proj, w_hh, lengths)
        dx = lstm.lstm_backward(x_proj, w_hh, lengths, h_all, c_all,
                                torch.randn((1, hidden), generator=g, device=dev))
    dw_times(1, hidden, [cs.T_SERIES], lengths, h_all, dx)


def dw_times(b: int, hidden: int, lens, lengths, h_all, dx) -> None:
    """dW's device time beside its plain version, the bare cuBLAS product of
    the pre-masked operands, and its bound by operations."""
    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import lstm

    rows = b * cs.T_SERIES
    steps = torch.arange(cs.T_SERIES, device=dx.device)[None, :]
    active = (steps >= 1) & (steps < lengths[:, None])
    h_prev = torch.cat([torch.zeros_like(h_all[:, :1]), h_all[:, :-1]], 1)
    h_prev = torch.where(active[..., None], h_prev, 0.0).reshape(rows, hidden)
    dx2 = dx.reshape(rows, 4 * hidden)
    calls = {"lstm_dw": lambda: lstm.lstm_dw(h_all, dx, lengths),
             "plain": lambda: lstm.lstm_dw_plain(h_all, dx, lengths),
             "cuBLAS f32 matmul of the pre-masked operands": lambda: torch.matmul(h_prev.t(), dx2)}
    with torch.no_grad():
        times = {k: (device_ms(fn), kernel_ms(fn)) for k, fn in calls.items()}
    flops = 2 * sum(lens) * hidden * 4 * hidden
    dw_trace = times["lstm_dw"][1]
    print(f"time dW ({b}, {cs.T_SERIES}, {hidden} x {4 * hidden}), {sum(lens)} steps: "
          + ", ".join(f"{k} {t:.4f}" for k, (_, t) in times.items())
          + f" ms of kernel time (trace; lstm_dw {flops / dw_trace / 1e9:.1f} TFLOP/s on the "
          f"steps t < length); events around ten calls: "
          + ", ".join(f"{k} {e:.4f}" for k, (e, _) in times.items())
          + f"; bound {flops / cs.PEAK_FLOPS['f32'] * 1e3:.4f} (operations)")


def resize_kernel_label(entry: str) -> str:
    """``resize_align_corners_kernel<T, V>`` from its mangled name."""
    m = re.search(r"resize_align_corners_kernelI(13__nv_bfloat16|f)Li(\d+)E", entry)
    if not m:
        return entry
    return (f"resize_align_corners_kernel<{'f32' if m.group(1) == 'f' else 'bf16'}, "
            f"V = {m.group(2)}>")


def entry_params(source: str, entry: str) -> list[tuple[str, object]]:
    """The parameters of the C entry point ``entry`` in a ``csrc`` source,
    in order, as (name, ctypes type): ``c_void_p`` for a pointer,
    ``c_longlong`` for a ``long long``, else ``c_int``."""
    import ctypes

    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source)
    if not m:
        raise ValueError(f"no {entry} entry point in the source")
    params = []
    for p in m.group(1).split(","):
        kind = (ctypes.c_void_p if "*" in p else
                ctypes.c_longlong if "long long" in p else ctypes.c_int)
        params.append((re.split(r"[\s*]+", p.strip())[-1], kind))
    return params


def named_arguments(entry: str, params, values: dict) -> list:
    """``values`` in the order of ``params`` (``entry_params``); a parameter
    that ``values`` does not name raises."""
    unknown = [name for name, _ in params if name not in values]
    if unknown:
        raise ValueError(f"unknown parameters of {entry}: {unknown}")
    return [values[name] for name, _ in params]


def resize_entry_params(source: str) -> list[tuple[str, bool]]:
    """The parameters of ``maunet_resize_align_corners`` in a
    ``resize_pack.cu`` source, in order, as (name, is a pointer)."""
    import ctypes

    return [(name, kind is ctypes.c_void_p)
            for name, kind in entry_params(source, "maunet_resize_align_corners")]


def resize_arguments(params: list[tuple[str, bool]], x: torch.Tensor, y: torch.Tensor,
                     rows: int, stream: int) -> list[int]:
    """The values for ``params`` (``resize_entry_params``) of one launch
    from ``x`` (B, h, w, C) into ``y`` (B, oh, ow, C); ``rows`` goes to a
    parameter named ``rows``, if the entry point has one."""
    from maunet_tpu_torch.ops.kernels import resize_pack

    b, h, w, c = x.shape
    _, oh, ow, _ = y.shape
    values = {"x": x.data_ptr(), "y": y.data_ptr(), "dtype": resize_pack._DTYPES[x.dtype],
              "B": b, "h": h, "w": w, "C": c, "oh": oh, "ow": ow, "rows": rows,
              "stream": stream}
    return named_arguments("maunet_resize_align_corners", params, values)


# Each parent file's library, by (path, stem): built once, however many of
# its entry points are asked for.
_PARENT_LIBRARIES: dict = {}


def parent_entry(path: str, entry: str, stem: str | None = None):
    """Compile ``path``, another version of a ``csrc`` source, into a
    library of its own (named by ``stem``, by default the file's) and return
    (its entry point ``entry`` with argument types declared, the entry's
    parameters as ``entry_params`` gives them).  ctypes loads the library
    with ``RTLD_LOCAL``, so its names do not clash with the tree's library."""
    import ctypes

    from maunet_tpu_torch.ops.kernels import _build

    with open(path) as f:
        params = entry_params(f.read(), entry)
    stem = stem or os.path.splitext(os.path.basename(path))[0]
    if (path, stem) not in _PARENT_LIBRARIES:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                               f"parent_{stem}")
        os.makedirs(out_dir, exist_ok=True)
        lib_path = os.path.join(out_dir, f"libparent_{stem}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", path, "-o", lib_path],
                       check=True)
        _PARENT_LIBRARIES[(path, stem)] = ctypes.CDLL(lib_path, mode=os.RTLD_LOCAL)
    fn = getattr(_PARENT_LIBRARIES[(path, stem)], entry)
    fn.argtypes = [kind for _, kind in params]
    fn.restype = ctypes.c_int
    return fn, params


def parent_names(paths: list[str]) -> list[str]:
    """A distinct name for each parent file: its stem, with the file's
    position appended where two stems are alike."""
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    return [s if stems.count(s) == 1 else f"{s}_{i}" for i, s in enumerate(stems)]


def parent_resize(path: str, dev: torch.device):
    """Compile another ``resize_pack.cu`` into a library of its own and
    return a function (x, out_hw) -> y that launches its kernel."""
    import ctypes

    from maunet_tpu_torch.ops.kernels import _build, resize_pack

    fn, params = parent_entry(path, "maunet_resize_align_corners")
    params = [(name, kind is ctypes.c_void_p) for name, kind in params]

    def launch(x, out_hw):
        y = torch.empty((x.shape[0], *out_hw, x.shape[3]), dtype=x.dtype, device=dev)
        code = fn(*resize_arguments(params, x, y, resize_pack._rows_for(x, out_hw),
                                    _build.stream_of(x)))
        if code != 0:
            raise RuntimeError(f"parent resize_pack: CUDA error {code}")
        return y

    return launch


def resize_profile(dev: torch.device, parent_path: str | None) -> None:
    """``--resize``: kernel C alone: registers, bits against a parent
    version, device times beside the floors, the library call and the
    bound."""
    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import resize_pack

    ptxas_report("resize_pack.cu", resize_kernel_label)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    inputs = [torch.randn(shape, generator=g, device=dev).to(dtype)
              for shape, _, dtype, _ in cs.RESIZE_CASES]
    parent = parent_resize(parent_path, dev) if parent_path else None
    if parent is not None:
        for x, (shape, out_hw, dtype, _) in zip(inputs, cs.RESIZE_CASES):
            got, want = resize_pack.resize_pack(x, out_hw), parent(x, out_hw)
            diff = float((got.float() - want.float()).abs().max())
            same = torch.equal(got, want)
            print(f"bits {shape}->{out_hw} {str(dtype).split('.')[-1]}: "
                  f"{'the same as the parent' if same else f'DIFFER (max |diff| {diff:.3e})'}")
            if not same:
                raise AssertionError(f"resize {shape}->{out_hw}: the tree's kernel and the "
                                     "parent's give other bits")
    # Each time twice: CUDA events around ten calls back to back, which at
    # the small shapes reads the host's enqueue of the wrapper, and the summed
    # kernel durations of a profiler trace, the device's own time.
    names = {"parent": "parent", "tree": "C", "write": "write-only floor",
             "copy": "read-plus-write floor", "interpolate": "F.interpolate"}
    sums = {label: {} for label, _ in RESIZE_PATHS}
    for label, first in RESIZE_PATHS:
        for i in range(first, first + 4):
            shape, out_hw, dtype, _ = cs.RESIZE_CASES[i]
            x = inputs[i]
            y = torch.empty((shape[0], *out_hw, shape[3]), dtype=dtype, device=dev)
            z = torch.empty_like(y)
            calls = {"tree": lambda: resize_pack.resize_pack(x, out_hw),
                     "write": lambda: y.fill_(0), "copy": lambda: y.copy_(z),
                     "interpolate": lambda: interpolate_nhwc(x, out_hw)}
            order = ["tree", "tree"]
            if parent is not None:
                calls["parent"] = lambda: parent(x, out_hw)
                order = ["parent", "tree", "tree", "parent"]
            order += ["write", "copy", "interpolate"]
            row: dict[str, list[tuple[float, float]]] = {}
            turns = []
            for key in order:
                row.setdefault(key, []).append((device_ms(calls[key]), kernel_ms(calls[key])))
                if key in ("parent", "tree"):
                    turns.append(f"{key} {row[key][-1][0]:.4f}/{row[key][-1][1]:.4f}")
            nbytes = (x.numel() + y.numel()) * x.element_size()
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            mean = {k: tuple(statistics.mean(v[j] for v in vs) for j in (0, 1))
                    for k, vs in row.items()}
            print(f"time {label} {shape}->{out_hw}: " + ", ".join(
                f"{names[k]} {mean[k][1]:.4f}" for k in names if k in mean)
                + f" ms of kernel time (trace); bound {bound:.4f} (bytes: {nbytes / 1e6:.1f} MB); "
                "events around ten calls: " + ", ".join(
                    f"{names[k]} {mean[k][0]:.4f}" for k in names if k in mean)
                + f"; in turns, events/trace: {', '.join(turns)}")
            # The kernel at other strip heights: the same bits, and the
            # kernel time of each (the wrapper picks _strip_rows).
            want = resize_pack.resize_pack(x, out_hw)
            heights = []
            for rows in STRIP_SWEEP:
                if not torch.equal(resize_pack._launch(x, out_hw, rows), want):
                    raise AssertionError(f"resize {shape}->{out_hw}: {rows} rows a thread "
                                         "give other bits")
                ms = kernel_ms(lambda: resize_pack._launch(x, out_hw, rows))
                heights.append(f"{rows}: {ms:.4f}")
            print(f"strips {label} {shape}->{out_hw} (the wrapper takes "
                  f"{resize_pack._rows_for(x, out_hw)}), rows a thread: "
                  + ", ".join(heights) + " ms of kernel time (trace)")
            total = sums[label]
            total["bound"] = total.get("bound", 0.0) + bound
            for k, (e, t) in mean.items():
                prev = total.get(k, (0.0, 0.0))
                total[k] = (prev[0] + e, prev[1] + t)
    for label, total in sums.items():
        print(f"sum {label} (four upsamples): " + ", ".join(
            f"{names[k]} {total[k][1]:.4f}" for k in names if k in total)
            + f" ms of kernel time (trace); bound {total['bound']:.4f}; events around ten "
            "calls: " + ", ".join(f"{names[k]} {total[k][0]:.4f}" for k in names if k in total))


def masked_kernel_label(entry: str) -> str:
    """``masked_stats_*kernel<T, C[, VEC]>`` or the kernel's plain name,
    from its mangled name."""
    m = re.search(r"(masked_stats_\w*kernel)I(f|13__nv_bfloat16|6__half)Li(\d+)E(?:Lb(\d)E)?",
                  entry)
    if not m:
        m = re.search(r"(masked_stats_\w*kernel)", entry)
        return m.group(1) if m else entry
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}[m.group(2)]
    vec = "" if m.group(4) is None else f", VEC = {'true' if m.group(4) == '1' else 'false'}"
    return f"{m.group(1)}<{dtype}, C = {m.group(3)}{vec}>"


# kChunk of masked_stats.cu while D was two launches: the pixels of one
# sample a block of the first launch owned; its entry point takes scratch
# sized by it and refuses another size.
TWO_LAUNCH_CHUNK = 2048


def masked_outputs(params, pred: torch.Tensor):
    """The buffers that a ``maunet_masked_class_sums`` with ``params``
    writes, for ``pred``: (pointers by parameter name, (sum_abs, sum_sq,
    counts)).  One (B, 9 (2C + 1)) row per sample where the entry point takes
    ``out``; else the two-launch signature's scratch and three outputs."""
    from maunet_tpu_torch.ops.kernels import masked_stats

    b, h, w, c = pred.shape
    nv = masked_stats.NUM_CLASSES * (2 * c + 1)
    f32 = dict(dtype=torch.float32, device=pred.device)
    if "out" in {name for name, _ in params}:
        out = torch.empty((b, nv), **f32)
        return {"out": out}, masked_stats.split_sums(out, c)
    bufs = {"partial": torch.empty((b, -(-(h * w) // TWO_LAUNCH_CHUNK), nv), **f32),
            "sum_abs": torch.empty((b, c, 9), **f32), "sum_sq": torch.empty((b, c, 9), **f32),
            "counts": torch.empty((b, 9), **f32)}
    return bufs, (bufs["sum_abs"], bufs["sum_sq"], bufs["counts"])


def masked_arguments(params, pred, target, dw, bufs: dict, stream: int) -> list:
    """The values for ``params`` of one ``maunet_masked_class_sums`` launch
    (either signature) into ``bufs`` (``masked_outputs``)."""
    from maunet_tpu_torch.ops.kernels import masked_stats

    b, h, w, c = pred.shape
    values = {"pred": pred.data_ptr(), "target": target.data_ptr(), "dw": dw.data_ptr(),
              **{name: t.data_ptr() for name, t in bufs.items()},
              "B": b, "hw": h * w, "nchunks": -(-(h * w) // TWO_LAUNCH_CHUNK), "C": c,
              "dtype": masked_stats._DTYPES[pred.dtype], "stream": stream}
    return named_arguments("maunet_masked_class_sums", params, values)


def parent_masked(path: str, name: str | None = None):
    """Compile another ``masked_stats.cu`` into a library of its own and
    return a function (pred, target, dw) -> (sum_abs, sum_sq, counts)."""
    from maunet_tpu_torch.ops.kernels import _build

    fn, params = parent_entry(path, "maunet_masked_class_sums", name)

    def launch(pred, target, dw):
        bufs, sums = masked_outputs(params, pred)
        code = fn(*masked_arguments(params, pred, target, dw, bufs, _build.stream_of(pred)))
        if code != 0:
            raise RuntimeError(f"parent masked_stats: CUDA error {code}")
        return sums

    return launch


def masked_bincount(pred, target, dw):
    """D's three outputs composed of ``torch.bincount`` calls with weights:
    a yardstick of several launches, not one call.  Pixels whose class lies
    outside 0..8 go to a bin past the last, which is dropped."""
    b, h, w, c = pred.shape
    err = (pred - target).float().reshape(b * h * w, c)
    cls = dw.reshape(b, h * w).long()
    bins = b * 9
    idx = torch.where((cls >= 0) & (cls < 9),
                      cls + 9 * torch.arange(b, device=pred.device)[:, None], bins).reshape(-1)
    counts = torch.bincount(idx, minlength=bins + 1)[:bins].float().view(b, 9)
    vals = torch.cat([err.abs(), err * err], 1)          # (pixels, 2C)
    cols = torch.arange(2 * c, device=pred.device)
    sums = torch.bincount((idx[:, None] * (2 * c) + cols).reshape(-1), weights=vals.reshape(-1),
                          minlength=(bins + 1) * 2 * c)[:bins * 2 * c]
    sums = sums.float().view(b, 9, 2, c).permute(2, 0, 3, 1)  # (2, B, C, 9)
    return sums[0], sums[1], counts


def host_call_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` back to back (the device keeps up):
    what the wrapper costs the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def masked_profile(dev: torch.device, parent_paths: list[str] | None) -> None:
    """``--masked``: kernel D alone: registers, agreement with the plain
    version and the parent versions, kernel and host times beside the read
    floor, the bincount composition and the bound."""
    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import masked_stats

    ptxas_report("masked_stats.cu", masked_kernel_label)
    paths = parent_paths or []
    parents = {n: parent_masked(p, n) for n, p in zip(parent_names(paths), paths)}
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for shape, dtype, tol, absent, outside, _ in cs.MASKED_CASES:
        pred, target, dw = cs.masked_inputs(g, dev, shape, dtype, absent, outside)
        label = f"{shape} {str(dtype).split('.')[-1]}"
        calls = {"tree": lambda: masked_stats.masked_class_sums(pred, target, dw)}
        checks = {"plain": masked_stats.masked_class_sums_plain(pred, target, dw),
                  "bincount": masked_bincount(pred, target, dw)}
        for name, parent in parents.items():
            calls[name] = (lambda p: lambda: p(pred, target, dw))(parent)
            checks[name] = calls[name]()
        got = calls["tree"]()
        agree = []
        for name, want in checks.items():
            diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all()) for a, b in zip(got, want))
            agree.append(f"{name} {diff:.3e} {'ok' if ok else 'FAIL'}")
            if not ok and name != "bincount":
                raise AssertionError(f"masked_class_sums {label}: the tree's kernel and the "
                                     f"{name} version disagree")
        nbytes = cs.masked_work(shape, pred.element_size())[0]
        # The read floor: one library launch reading exactly D's input bytes.
        flat = torch.zeros((pred.numel() * 2 * pred.element_size() + dw.numel() * 4) // 4,
                           dtype=torch.float32, device=dev)
        calls["read floor"] = lambda: torch.sum(flat)
        calls["bincount (not one call)"] = lambda: masked_bincount(pred, target, dw)
        order = [*parents, "tree", "tree", *reversed(parents)]
        times: dict[str, list[tuple[float, float]]] = {}
        turns = []
        for key in order + ["read floor", "bincount (not one call)"]:
            times.setdefault(key, []).append((kernel_ms(calls[key]), device_ms(calls[key])))
            if key == "tree" or key in parents:
                turns.append(f"{key} {times[key][-1][0]:.4f}")
        mean = {k: tuple(statistics.mean(v[j] for v in vs) for j in (0, 1))
                for k, vs in times.items()}
        host = host_call_ms(calls["tree"])
        launches = launches_per_call(device_events(calls["tree"]), 10)
        print(f"check {label}: max |tree - x| " + ", ".join(agree)
              + f" (tol {tol:g} + {tol:g}|x|)")
        print(f"time {label}: " + ", ".join(f"{k} {t:.4f}" for k, (t, _) in mean.items())
              + f" ms of kernel time (trace); bound {nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} "
              f"(bytes: {nbytes / 1e6:.2f} MB); events around ten calls: "
              + ", ".join(f"{k} {e:.4f}" for k, (_, e) in mean.items())
              + f"; host time per wrapper call {host:.4f} ms; in turns (trace): "
              + ", ".join(turns) + f"; the tree's trace: {launches}")


# The path shapes of chip_smoke.RESIZE_CASES whose times --resize sums, four
# each: (label, index of the first).
RESIZE_PATHS = (("serving B=8", 0), ("evaluation U-Net B=16", 4),
                ("evaluation U-Net++ B=16", 8))
# The strip heights --resize times at each path shape.
STRIP_SWEEP = (1, 2, 4, 8, 16, 32)


def kernel_ms(fn, calls: int = 10) -> float:
    """Device time per call as the summed kernel, memset and memcpy durations
    of a ``torch.profiler`` trace of ``calls`` calls after three warm-up
    calls: the host's enqueue between the launches does not count."""
    return kernel_sum_ms(device_events(fn, calls), calls)


def device_events(fn, calls: int = 10) -> list[dict]:
    """The trace events of ``calls`` calls of ``fn`` after three warm-up
    calls, from a profiler session that recorded device work."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    # A profiler session now and then returns a trace without device events
    # (once in a process's first session, on the H100): take the next one.
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmpdir:
            path = os.path.join(tmpdir, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        if kernel_sum_ms(events, calls) > 0:
            return events
    raise RuntimeError("three profiler traces held no device events")


def launches_per_call(events: list[dict], calls: int) -> str:
    """The kernels and memsets of a trace of ``calls`` calls, per call."""
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    memsets = sum(e.get("cat") == "gpu_memset" for e in events)
    names = sorted({masked_kernel_label(n) for n in kernels})
    return (f"{len(kernels) / calls:g} kernels ({', '.join(names)}) and "
            f"{memsets / calls:g} memsets per call")


def kernel_sum_ms(events: list[dict], calls: int) -> float:
    """The summed durations (µs in the trace) of the kernel, memset and
    memcpy events (``copy_`` within the card is a memcpy), in ms per call."""
    return sum(float(e["dur"]) for e in events
               if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")) / 1e3 / calls


def interpolate_nhwc(x: torch.Tensor, out_hw) -> torch.Tensor:
    return torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=out_hw,
                                           mode="bilinear", align_corners=True)


def conv_profile(dev: torch.device) -> None:
    """``--conv``: kernel A alone: registers, agreement, times."""
    import math

    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import _build, packed_vgg

    ptxas_report("conv3x3_fused.cu", conv_kernel_label)

    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def case(b, hw, cins, cout, with_add):
        parts = [randn(b, *hw, c).to(torch.bfloat16) for c in cins]
        weights = [randn(cout, c, 3, 3, std=math.sqrt(2 / (9 * sum(cins)))) for c in cins]
        scale, bias = 0.5 + torch.rand(cout, generator=g, device=dev), randn(cout, std=0.1)
        add = randn(b, 3, hw[1], cout, std=0.5) if with_add else None
        return parts, weights, scale, bias, add

    for key in CONV_CHECKS:
        parts, weights, scale, bias, add = case(*key)
        kw = dict(scale=scale, bias=bias, add=add, relu=True)
        raw = packed_vgg.conv3x3_fused(parts, weights, **kw)
        prepared = packed_vgg.prepare_conv3x3(weights, scale, bias)
        got = packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True)
        want = packed_vgg.conv3x3_fused_plain(parts, weights, **kw).float()
        diff = (got.float() - want).abs()
        ok = (bool(torch.isfinite(got).all()) and torch.equal(got, raw)
              and bool((diff <= 1e-2 + 1e-2 * want.abs()).all()))
        print(f"check {key}: max_abs_err={float(diff.max()):.3e} (tol 1e-2 + 1e-2|plain|), "
              f"prepared and raw weights {'agree' if torch.equal(got, raw) else 'DIFFER'}: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"conv3x3_fused {key} disagrees")

    level0 = [(23,), (64,), (64, 128)]
    timed = ([("serving B=8", (8, (256, 256), c, 64, False)) for c in level0]
             + [("evaluation U-Net", (cs.EVAL_BATCH, (256, 256), c, 64, False)) for c in level0]
             + [("evaluation U-Net++", (cs.EVAL_BATCH, *conv)) for conv in cs.UNETPP_CONVS])
    sums: dict[str, list[float]] = {}
    for group, key in timed:
        parts, weights, scale, bias, add = case(*key)
        prepared = packed_vgg.prepare_conv3x3(weights, scale, bias)

        def call():
            return packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True)

        ms, dev_ms = cs.cuda_ms(call), device_ms(call)
        raw_ms = cs.cuda_ms(lambda: packed_vgg.conv3x3_fused(
            parts, weights, scale=scale, bias=bias, add=add, relu=True))
        cudnn_ms = cs.cuda_ms(cs.cudnn_block(parts, [(weights, scale, bias)], add))
        nbytes, flops, _ = cs.conv_work(*key)
        bound = max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.PEAK_FLOPS["bf16"]) * 1e3
        print(f"time {group} {key}: prepared {ms:.4f} ms, on the device {dev_ms:.4f}, raw "
              f"weights {raw_ms:.4f}, cuDNN {cudnn_ms:.4f}, bound {bound:.4f} "
              f"({flops / dev_ms / 1e9:.0f} TFLOP/s, {nbytes / dev_ms / 1e6:.0f} GB/s on the device)")
        for i, v in enumerate((ms, dev_ms, raw_ms, cudnn_ms, bound)):
            sums.setdefault(group, [0.0] * 5)[i] += v
    for group, (ms, dev_ms, raw_ms, cudnn_ms, bound) in sums.items():
        print(f"sum {group} (each distinct conv once): prepared {ms:.4f} ms, on the device "
              f"{dev_ms:.4f}, raw weights {raw_ms:.4f}, cuDNN {cudnn_ms:.4f}, bound {bound:.4f}")

    parts, weights, scale, bias, add = case(1, (5, 3), (7,), 3, True)
    prepared = packed_vgg.prepare_conv3x3(weights, scale, bias)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True)
    print(f"wrapper host time per prepared call: {(time.perf_counter() - t0) / 200 * 1e6:.1f} us")
    torch.cuda.synchronize()


def grad_spread(dev) -> None:
    """How far one f32 SGD step's gradients (``TrainConfig``'s model at full
    width, B = 16, 256², l1-gradient-ssim, TF32 off) move when only the
    order of the sums changes: one process against itself, with cuDNN
    against PyTorch's own convolutions, and against two Gloo ranks sharing
    the card at (data, spatial) (2, 1) and (1, 2), with cuDNN and without.
    Per comparison, the six tensors whose largest difference is largest
    against their largest |g|."""
    import tempfile

    import numpy as np

    import chip_smoke as cs
    from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
    from maunet_tpu_torch.data.pipeline import host_tensors, to_device
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.models.factory import UrbanPredictor
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import train_step

    loss = "l1-gradient-ssim"
    kwargs = dict(model_type="unet", out_channels=2, temporal_dim=64, meta_dim=64,
                  lstm_dim=96, base_filters=64, in_channels=23, meta_features=8,
                  compute_dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        data = cs.make_data(tmp)
        model = UrbanPredictor(**{**kwargs, "compute_dtype": torch.float32},
                               generator=torch.Generator().manual_seed(42))
        state_path, batch_path = os.path.join(tmp, "s.pt"), os.path.join(tmp, "b.npz")
        torch.save(model.state_dict(), state_path)
        host = next(make_batches(NpzDataset(os.path.join(data, "train"), cs.T_SERIES), 16))
        np.savez(batch_path, **host.as_dict())
        model = model.to(dev)
        batch = to_device(host_tensors(host, pin=True), dev)

        def single():
            model.load_state_dict(torch.load(state_path, weights_only=True))
            st = TrainState(model, make_optimizer(model.parameters(), "sgd", 1e-2, 0.0, 0.0), 0)
            train_step(st, batch, get_loss_fn(loss))
            return {n: p.grad.detach().to("cpu", copy=True) for n, p in model.named_parameters()}

        def report(label, got, want):
            rows = sorted(((float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30),
                            n, float(w.abs().max())) for n, w in want.items()), reverse=True)
            print(f"{label}: " + "; ".join(f"{n} {r:.3e} of max|g| {m:.3e}"
                                           for r, n, m in rows[:6]), flush=True)

        def ranks(name, cudnn):
            tasks = [{"kind": "step", "name": f"{name}_sp{sp}", "spatial": sp,
                      "state": state_path, "batch": batch_path, "model": kwargs,
                      "optimizer": ["sgd", 1e-2, 0.0, 0.0], "loss": loss} for sp in (1, 2)]
            out = cs.run_ranks(tmp, name, tasks, dev, world=2, cudnn=cudnn)
            return {sp: torch.load(os.path.join(out, f"{name}_sp{sp}_rank0.pt"),
                                   weights_only=True)["grads"] for sp in (1, 2)}

        want = single()
        report("one process, twice", single(), want)
        got = ranks("cudnn", True)
        report("two ranks (2, 1)", got[1], want)
        report("two ranks (1, 2)", got[2], want)
        torch.backends.cudnn.enabled = False
        want_own = single()
        report("one process, PyTorch's convolutions against cuDNN's", want_own, want)
        got = ranks("own", False)
        report("two ranks (2, 1), PyTorch's convolutions", got[1], want_own)
        report("two ranks (1, 2), PyTorch's convolutions", got[2], want_own)
        torch.backends.cudnn.enabled = True


# --conv --f32: the f32 entries of A and G, and their kernels.
F32_ENTRIES = ("maunet_conv3x3_fused_f32", "maunet_conv3x3_pair_f32")


def f32_kernel_label(entry: str) -> str:
    """``conv3x3_f32_kernel<...>`` or ``conv3x3_pair_f32_kernel<...>`` with
    its integer template arguments, from its mangled name."""
    m = re.search(r"(conv3x3_(?:pair_)?f32_kernel)I((?:Li\d+E)+)", entry)
    if not m:
        return entry
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def f32_k_width(source: str) -> int:
    """The input channels of one K step (``constexpr int BK``) of a
    ``conv3x3_f32.cu`` source: the width its prepared weights are laid out
    for."""
    m = re.search(r"constexpr int BK = (\d+);", source)
    if not m:
        raise ValueError("no `constexpr int BK = N;` in the source")
    return int(m.group(1))


@contextlib.contextmanager
def f32_tile_k(width: int):
    """``prepare_conv3x3`` lays f32 weights out for K steps of ``width``
    channels while the block runs."""
    from maunet_tpu_torch.ops.kernels import packed_vgg

    saved = packed_vgg.TILE_K_F32
    packed_vgg.TILE_K_F32 = width
    try:
        yield
    finally:
        packed_vgg.TILE_K_F32 = saved


def f32_arguments(entry: str, params, parts, prepared, out, add, stream: int,
                  prepared2=None) -> tuple[list, list]:
    """The values for ``params`` (``entry_params`` of ``entry``: A's or G's
    f32 entry) of one launch on ``parts`` into ``out``, and the host arrays
    they point to, which must outlive the call."""
    xs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    cins = (ctypes.c_int * len(parts))(*prepared.cins)
    b, h, w, _ = parts[0].shape

    def ptr(t):
        return None if t is None else t.data_ptr()

    values = {"xs": ctypes.addressof(xs), "cins": ctypes.addressof(cins),
              "nparts": len(parts), "add": ptr(add), "out": out.data_ptr(), "B": b, "H": h,
              "W": w, "cout": out.shape[3], "stream": stream}
    if prepared2 is None:
        values.update(wpk=prepared.packed.data_ptr(), bias=ptr(prepared.bias), relu=1,
                      scale=ptr(prepared.scale))
    else:
        values.update(w1pk=prepared.packed.data_ptr(), w2pk=prepared2.packed.data_ptr(),
                      bias1=ptr(prepared.bias), bias2=ptr(prepared2.bias),
                      cmid=prepared.cout, scale1=ptr(prepared.scale))
    return named_arguments(entry, params, values), [xs, cins]


class ParentF32:
    """Another ``conv3x3_f32.cu``, built into a library of its own: its A
    and G entries on weights prepared at its own K step."""

    def __init__(self, path: str, name: str):
        with open(path) as f:
            source = f.read()
        self.width = f32_k_width(source)
        self.fns = {}
        for entry in F32_ENTRIES:
            self.fns[entry] = parent_entry(path, entry, name)

    def prepare(self, weights, scale, bias):
        from maunet_tpu_torch.ops.kernels import packed_vgg

        with f32_tile_k(self.width):
            return packed_vgg.prepare_conv3x3(weights, scale, bias, torch.float32)

    def _launch(self, entry, parts, prepared, add, cout, prepared2=None):
        from maunet_tpu_torch.ops.kernels import _build

        fn, params = self.fns[entry]
        out = torch.empty((*parts[0].shape[:3], cout), dtype=torch.float32,
                          device=parts[0].device)
        args, _keep = f32_arguments(entry, params, parts, prepared, out, add,
                                    _build.stream_of(out), prepared2)
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"parent {entry}: CUDA error {code}")
        return out

    def fused(self, parts, prepared, add):
        return self._launch(F32_ENTRIES[0], parts, prepared, add, prepared.cout)

    def pair(self, parts, prepared1, prepared2, add):
        return self._launch(F32_ENTRIES[1], parts, prepared1, add, prepared2.cout, prepared2)


def ncu_f32_report() -> None:
    """Where ``ncu`` exists: A's shared-memory wavefronts per FFMA and its
    stall reasons at the serving batch's 64 -> 64 conv."""
    ncu = shutil.which("ncu")
    print(f"ncu: {ncu or 'not on this machine; no wavefront count or stall reasons'}")
    if not ncu:
        return
    script = ("import torch; from maunet_tpu_torch.ops.kernels import packed_vgg as p; "
              "x = torch.randn(8, 256, 256, 64, device='cuda'); "
              "w = p.prepare_conv3x3([torch.randn(64, 64, 3, 3, device='cuda') * 0.05], "
              "dtype=torch.float32); p.conv3x3_fused([x], w, relu=True); "
              "torch.cuda.synchronize()")
    metrics = ("l1tex__data_pipe_lsu_wavefronts_mem_shared_op_ld.sum,"
               "smsp__sass_thread_inst_executed_op_ffma_pred_on.sum,"
               "smsp__inst_executed_op_shared_ld.sum,"
               "smsp__average_warp_latency_issue_stalled_barrier.ratio,"
               "smsp__average_warp_latency_issue_stalled_short_scoreboard.ratio,"
               "smsp__average_warp_latency_issue_stalled_mio_throttle.ratio,"
               "smsp__average_warp_latency_issue_stalled_long_scoreboard.ratio,"
               "smsp__average_warp_latency_issue_stalled_math_pipe_throttle.ratio")
    run = subprocess.run([ncu, "--kernel-name", "regex:conv3x3_f32_kernel", "--metrics",
                          metrics, sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    print(f"ncu exit {run.returncode}:\n" + "\n".join((run.stdout + run.stderr).splitlines()[-24:]))


def conv_f32_profile(dev: torch.device, parent_paths: list[str] | None) -> None:
    """``--conv --f32``: A and G in f32: registers, agreement with the plain
    version and with each parent, times."""
    import math

    import chip_smoke as cs

    from maunet_tpu_torch.ops.kernels import packed_vgg

    ptxas_report("conv3x3_f32.cu", f32_kernel_label)
    ncu_f32_report()
    paths = parent_paths or []
    parents = {n: ParentF32(p, n) for n, p in zip(parent_names(paths), paths)}
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 16)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def conv_params(cins, cout):
        return ([randn(cout, c, 3, 3, std=math.sqrt(2 / (9 * sum(cins)))) for c in cins],
                0.5 + torch.rand(cout, generator=g, device=dev), randn(cout, std=0.1))

    differ: list[str] = []
    sums: dict[str, dict[str, float]] = {}

    def timed(kind, group, label, tree, plain, by_parent, cudnn, bound, extra=None):
        """Check ``tree()`` against ``plain()`` and each parent's call, then
        time them in turns; print one line and add it to its group's sums."""
        got, want = tree(), plain()
        diff = (got - want).abs()
        if not (bool(torch.isfinite(got).all())
                and bool((diff <= cs.F32_TOL * (1 + want.abs())).all())):
            raise AssertionError(f"{kind} {label}: disagrees with its plain version")
        bits = []
        for name, call in by_parent.items():
            same = torch.equal(call(), got)
            bits.append(f"{name} {'same bits' if same else 'DIFFERENT BITS'}")
            if not same:
                differ.append(f"{kind} {label} ({name})")
        order = list(by_parent) + ["tree", "tree"] + list(reversed(by_parent))
        calls = {**by_parent, "tree": tree}
        times: dict[str, list[float]] = {}
        for name in order:
            times.setdefault(name, []).append(device_ms(calls[name]))
        row = {name: statistics.mean(v) for name, v in times.items()}
        row["cuDNN f32"] = device_ms(cudnn)
        row["bound"] = bound
        if extra:
            row.update({name: device_ms(fn) for name, fn in extra.items()})
        print(f"{kind} {group} {label}: max_abs_err={float(diff.max()):.3e} "
              + " ".join(f"{k}={v:.4f}" for k, v in row.items())
              + (f" ms; {', '.join(bits)}" if bits else " ms"))
        total = sums.setdefault(f"{kind} {group}", {})
        for k, v in row.items():
            total[k] = total.get(k, 0.0) + v

    for b, hw, cins, cout, with_add, _, note in cs.F32_A_CASES:
        parts = [randn(b, *hw, c) for c in cins]
        weights, scale, bias = conv_params(cins, cout)
        add = randn(b, 3, hw[1], cout, std=0.5) if with_add else None
        prepared = packed_vgg.prepare_conv3x3(weights, scale, bias, f32)
        by_parent = {}
        for name, parent in parents.items():
            pp = parent.prepare(weights, scale, bias)
            by_parent[name] = (lambda parent=parent, pp=pp:
                               parent.fused(parts, pp, add))
        nbytes, flops, _ = cs.conv_work(b, hw, cins, cout, with_add, "f32")
        timed("A", note.strip() or "odd", f"{[(b, *hw, c) for c in cins]}->{cout}",
              lambda: packed_vgg.conv3x3_fused(parts, prepared, add=add, relu=True),
              lambda: packed_vgg.conv3x3_fused_plain(parts, weights, scale=scale, bias=bias,
                                                     add=add, relu=True),
              by_parent, cs.cudnn_block(parts, [(weights, scale, bias)], add, f32),
              max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.PEAK_FLOPS["f32"]) * 1e3)
        del parts, add
        torch.cuda.empty_cache()

    for b, hw, cins, cmid, cout, with_add, on_path in cs.F32_G_CASES:
        parts = [randn(b, *hw, c) for c in cins]
        w1, scale1, bias1 = conv_params(cins, cmid)
        (w2,), scale2, bias2 = conv_params((cmid,), cout)
        add = randn(b, 3, hw[1], cmid, std=0.5) if with_add else None
        p1 = packed_vgg.prepare_conv3x3(w1, scale1, bias1, f32)
        p2 = packed_vgg.prepare_conv3x3([w2], scale2, bias2, f32)
        by_parent = {}
        for name, parent in parents.items():
            pp1, pp2 = parent.prepare(w1, scale1, bias1), parent.prepare([w2], scale2, bias2)
            by_parent[name] = (lambda parent=parent, pp1=pp1, pp2=pp2:
                               parent.pair(parts, pp1, pp2, add))

        def two_launches():
            mid = packed_vgg.conv3x3_fused(parts, p1, add=add, relu=True)
            return packed_vgg.conv3x3_fused([mid], p2, relu=True)

        n1, f1, _ = cs.conv_work(b, hw, cins, cmid, with_add, "f32")
        n2, f2, _ = cs.conv_work(b, hw, (cmid,), cout, False, "f32")
        nbytes = n1 + n2 - 2 * b * hw[0] * hw[1] * cmid * 4
        tree = lambda: packed_vgg.conv3x3_pair_fused(parts, p1, p2, add=add)  # noqa: E731
        if not torch.equal(tree(), two_launches()):
            differ.append(f"G {[(b, *hw, c) for c in cins]}->{cmid}->{cout} "
                          f"(two A launches)")
        timed("G", "pair blocks" if on_path else "odd",
              f"{[(b, *hw, c) for c in cins]}->{cmid}->{cout}", tree,
              lambda: packed_vgg.conv3x3_pair_fused_plain(
                  parts, w1, w2, scale1=scale1, bias1=bias1, scale2=scale2, bias2=bias2,
                  add=add),
              by_parent,
              cs.cudnn_block(parts, [(w1, scale1, bias1), ([w2], scale2, bias2)], add, f32),
              max(nbytes / cs.HBM_BYTES_PER_S, (f1 + f2) / cs.PEAK_FLOPS["f32"]) * 1e3,
              {"two A launches": two_launches})
        del parts, add
        torch.cuda.empty_cache()

    for group, row in sums.items():
        print(f"sum {group}: " + " ".join(f"{k}={v:.4f}" for k, v in row.items()) + " ms")
    n = len(cs.F32_A_CASES) + len(cs.F32_G_CASES)
    if differ:
        print(f"bits: {len(differ)} differ: " + "; ".join(differ))
    else:
        print(f"bits: the tree's kernels give {'each parent' if parents else 'G'}'s bits "
              f"at all {n} shapes" + ("" if parents else " (G against two A launches)"))



def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile one train step instead of the serving forward")
    mode.add_argument("--eval", action="store_true",
                      help="profile one evaluation batch of each model family")
    mode.add_argument("--conv", action="store_true",
                      help="check and time the fused 3x3 conv kernel alone")
    mode.add_argument("--lstm", action="store_true",
                      help="check and time the LSTM kernels alone")
    parser.add_argument("--f32", action="store_true",
                        help="with --conv: A's and G's f32 entries (csrc/conv3x3_f32.cu)")
    mode.add_argument("--resize", action="store_true",
                      help="check and time the resize kernel alone")
    mode.add_argument("--masked", action="store_true",
                      help="check and time the masked class sums kernel alone")
    mode.add_argument("--grad-spread", action="store_true",
                      help="how far one f32 step's gradients move with the order of "
                           "the sums: one process, cuDNN or not, two ranks at (2, 1) "
                           "and (1, 2)")
    parser.add_argument("--parent", nargs="+", default=None, metavar="PATH",
                        help="with --resize, --masked, --lstm or --conv --f32: another "
                             "resize_pack.cu (one), masked_stats.cu, lstm.cu or "
                             "conv3x3_f32.cu (one or more) to hold the tree's kernel (with "
                             "--lstm: the gate terms) against and time in turns with it")
    parser.add_argument("--trace", default=None,
                        help="where the Chrome trace is written (default: "
                             "build/port_forward_trace.json, port_train_trace.json "
                             "or port_eval_trace.json)")
    args = parser.parse_args(argv)
    if args.f32 and not args.conv:
        parser.error("--f32 needs --conv")
    if args.parent is not None and not (args.resize or args.masked or args.lstm or args.f32):
        parser.error("--parent needs --resize, --masked, --lstm or --conv --f32")
    if args.resize and args.parent is not None and len(args.parent) > 1:
        parser.error("--resize takes one --parent")
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    trace = args.trace or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "port_train_trace.json" if args.train else
        "port_eval_trace.json" if args.eval else "port_forward_trace.json")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.conv and args.f32:
        conv_f32_profile(dev, args.parent)
    elif args.conv:
        conv_profile(dev)
    elif args.resize:
        resize_profile(dev, args.parent[0] if args.parent else None)
    elif args.lstm:
        ptxas_report("lstm.cu", lstm_kernel_label)
        paths = args.parent or []
        parents = {n: parent_gate_terms(p, n) for n, p in zip(parent_names(paths), paths)}
        lstm_checks(dev, parents)
        lstm_times(dev, parents)
    elif args.masked:
        masked_profile(dev, args.parent)
    elif args.grad_spread:
        grad_spread(dev)
    elif args.train:
        train_profile(trace, dev)
    elif args.eval:
        eval_profile(trace, dev)
    else:
        serve_profile(trace)
    return 0


def serve_profile(trace: str) -> None:
    """The serving forward at B=8, 256², and the host pieces around it."""
    import chip_smoke as cs

    from maunet_tpu_torch.apps.engine import PlannerEngine
    from maunet_tpu_torch.ops.kernels import packed_vgg

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmpdir:
        engine = PlannerEngine(cs.write_checkpoint(tmpdir, "unet"), device=dev,
                               temp_query=cs.StubTempQuery(), temporal_length=cs.T_SERIES)
    rng = np.random.default_rng(cs.SEED)
    batch = [engine.prepare_input(cs.make_layers(rng, 256), None,
                                  float(rng.uniform(-60, 60)), float(rng.uniform(-180, 180)),
                                  2_800_000, 2023, 7, 2025, 7) for _ in range(8)]
    np_maps = np.concatenate([b.maps for b in batch])
    inputs = [torch.as_tensor(np_maps, device=dev)] + [
        torch.as_tensor(np.concatenate([getattr(b, k) for b in batch]), device=dev)
        for k in ("temp_series", "metadata", "temp_lengths")]

    def forward():
        with torch.inference_mode():
            return engine.model(*inputs)

    fwd_ms = cs.cuda_ms(forward)
    print(f"forward, 8 x 256², device-resident inputs: {fwd_ms:.3f} ms "
          f"(CUDA events, median of 10)")
    print(f"host concat of the maps: "
          f"{host_ms(lambda: np.concatenate([b.maps for b in batch])):.3f} ms")
    print(f"H2D copy of the maps ({np_maps.nbytes / 2**20:.1f} MiB, pageable): "
          f"{host_ms(lambda: torch.as_tensor(np_maps, device=dev)):.3f} ms")
    print(f"predict_many: {host_ms(lambda: engine.predict_many(batch)):.3f} ms")

    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for cins in [(23,), (64,), (64, 128)]:
        parts = [torch.randn((8, 256, 256, c), generator=g, device=dev).to(torch.bfloat16)
                 for c in cins]
        weights = [torch.randn((64, c, 3, 3), generator=g, device=dev) * 0.05 for c in cins]
        kw = dict(scale=torch.ones(64, device=dev), bias=torch.zeros(64, device=dev), relu=True)
        prepared = packed_vgg.prepare_conv3x3(weights, kw["scale"], kw["bias"])
        a_ms = cs.cuda_ms(lambda: packed_vgg.conv3x3_fused(parts, prepared, relu=True))
        plain_ms = cs.cuda_ms(lambda: packed_vgg.conv3x3_fused_plain(parts, weights, **kw))
        x = torch.cat(parts, -1).permute(0, 3, 1, 2)
        w = torch.cat(weights, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = cs.cuda_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1))
        tflops = 2 * 8 * 256 * 256 * 64 * 9 * sum(cins) / a_ms / 1e9
        print(f"conv (8, 256, 256, {'+'.join(map(str, cins))}) -> 64: A {a_ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s), cuDNN bf16 conv alone {cudnn_ms:.4f} ms, "
              f"plain f32 {plain_ms:.4f} ms")

    n = 3
    print_breakdown(profile_breakdown(forward, n, trace), "forward", n, fwd_ms)


if __name__ == "__main__":
    sys.exit(main())
