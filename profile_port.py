#!/usr/bin/env python3
"""Profile the PyTorch port's U-Net on one CUDA card: the serving forward,
or with ``--train`` one train step.

    python3 profile_port.py [--trace PATH]           # default build/port_forward_trace.json
    python3 profile_port.py --train [--trace PATH]   # default build/port_train_trace.json

The serving mode builds the full-width serving U-Net of ``chip_smoke.py``
(seeded weights and BatchNorm statistics), assembles 8 requests at 256² as
``predict_many`` does, and prints:

* the forward's wall time on device-resident inputs (CUDA events, median of
  10 after 3 warm-up runs);
* the host pieces of ``predict_many``: the concat of the 8 maps, their
  host-to-device copy, and ``predict_many`` itself (host clock, median of 5);
* kernel A at the three level-0 shapes of that batch, beside the same conv
  in cuDNN's bf16 (no epilogue) and A's plain version (f32);
* from a ``torch.profiler`` trace of 3 forwards: the device-busy time per
  forward, as the union of the kernel intervals, split by kernel family; and
  the device idle share, 1 - busy / wall.  The wall time is the unprofiled
  one: the profiler slows the host's dispatch, not the kernels.

The ``--train`` mode builds ``TrainConfig``'s default model and AdamW
(seeded), takes one batch of 16 synthetic 256² samples with T = 828 on the
card, and prints the train step's time (host clock around synchronised
steps, median of 10 after 3 warm-up steps) and, from a trace of 3 steps,
the same busy-time split by family and idle share.

The busy time is read from the trace's kernel intervals, not from
``key_averages()``: there a kernel's time is counted both on its own row and
in the ``self_device_time_total`` of the aten operator that launched it, so
the sum over rows exceeds the busy time.
"""

from __future__ import annotations

import argparse
import json
import os
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
    ("E lstm stash forward", ("lstm_last_hidden_kernel<true>", "lstm_last_hidden_kernelILb1E")),
    ("B lstm_last_hidden", ("lstm_last_hidden",)),
    ("F lstm backward", ("lstm_backward",)),
    ("dW lstm_dw", ("lstm_dw",)),
    ("C resize_align_corners", ("resize_align_corners",)),
    ("cuDNN convs, forward and backward", ("xmma", "cudnn", "dgrad", "wgrad", "fprop", "conv")),
    ("GEMMs (dense layers, SSIM blur, resize backward)", ("gemm", "cutlass")),
    ("optimizer (multi-tensor apply)", ("multi_tensor_apply",)),
)
TRAIN_OTHER = "other torch ops (BN, casts, cat, pool, losses)"


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train", action="store_true",
                        help="profile one train step instead of the serving forward")
    parser.add_argument("--trace", default=None,
                        help="where the Chrome trace is written (default: "
                             "build/port_forward_trace.json, or build/port_train_trace.json)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    trace = args.trace or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "port_train_trace.json" if args.train else "port_forward_trace.json")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        train_profile(trace, torch.device("cuda", 0))
    else:
        serve_profile(trace)
    return 0


def serve_profile(trace: str) -> None:
    """The serving forward at B=8, 256², and the host pieces around it."""
    import chip_smoke as cs

    from maunet_tpu_torch.apps.engine import PlannerEngine
    from maunet_tpu_torch.models.factory import build_model
    from maunet_tpu_torch.ops.kernels import packed_vgg

    dev = torch.device("cuda", 0)
    hp = {"model_type": "unet", "base_filters": 64, "temporal_dim": 64,
          "meta_dim": 64, "lstm_hidden": 96, "temporal_embeddings": True,
          "metadata_embeddings": True, "metadata_input_length": 8}
    model = build_model(hp, lstm_mask_mode="batch_max")
    cs.randomize_(model, torch.Generator().manual_seed(cs.SEED))
    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "unet64.pth")
        torch.save({"model_state_dict": model.state_dict(), "hyperparameters": hp,
                    "model_type": "unet"}, path)
        engine = PlannerEngine(path, device=dev, temp_query=cs.StubTempQuery(),
                               temporal_length=cs.T_SERIES)
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
        a_ms = cs.cuda_ms(lambda: packed_vgg.conv3x3_fused(parts, weights, **kw))
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
