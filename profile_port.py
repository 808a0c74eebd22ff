#!/usr/bin/env python3
"""Profile the PyTorch port's U-Net serving forward on one CUDA card.

    python3 profile_port.py [--trace PATH]   # default build/port_forward_trace.json

It builds the full-width serving U-Net of ``chip_smoke.py`` (seeded weights
and BatchNorm statistics), assembles 8 requests at 256² as ``predict_many``
does, and prints:

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


def family(name: str) -> str:
    for label, keys in FAMILIES:
        if any(k in name for k in keys):
            return label
    return OTHER


def trace_breakdown(events: list[dict], n_forwards: int) -> dict:
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
    families: dict[str, float] = {}
    for e in kernels:
        key = family(e["name"])
        families[key] = families.get(key, 0.0) + float(e["dur"]) / 1e3 / n_forwards
    return {"busy_ms": busy / 1e3 / n_forwards, "families": families,
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trace", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "port_forward_trace.json"),
        help="where the Chrome trace of 3 forwards is written (default: %(default)s)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from maunet_tpu_torch.apps.engine import PlannerEngine
    from maunet_tpu_torch.models.factory import build_model
    from maunet_tpu_torch.ops.kernels import packed_vgg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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

    n_fwd = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_fwd):
            forward()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        doc = json.load(f)
    br = trace_breakdown(doc["traceEvents"] if isinstance(doc, dict) else doc, n_fwd)
    print(f"device busy per forward: {br['busy_ms']:.3f} ms over {br['kernels']:.0f} kernels "
          f"(union of kernel intervals, {n_fwd} profiled forwards); idle share against the "
          f"unprofiled {fwd_ms:.3f} ms: {1 - br['busy_ms'] / fwd_ms:.3f}")
    for label, ms in sorted(br["families"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {100 * ms / br['busy_ms']:5.1f}%  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
