#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``maunet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each (or a few for the kernel table):

1. device: exits non-zero without CUDA; prints ``nvidia-smi``'s card name
   and power limit;
2. build: compiles ``maunet_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the serving path's shapes, with the tolerance stated below,
   and both times from CUDA events (median of 10 after 3 warm-up runs);
4. golden: the small U-Net of ``tests/fixtures/golden_unet.npz`` runs on
   the card in bf16 and is held against the JAX package's recorded f32
   output;
5. main path: a full-width serving U-Net (base 64, LSTM 96, T = 828, bf16)
   with seeded random weights and BatchNorm statistics is saved as a
   reference-layout ``.pth`` and served through ``PlannerEngine`` on the
   card: three ``predict`` requests (256², 256² with a painted canvas, 250²)
   and one ``predict_many`` over 8 requests at 256².  Every kernel's launch
   counter must rise in this phase.  The same batch is then run with the
   plain versions patched in, and the two outputs are compared.

The line before the last is the kernel summary JSON: per kernel the main
path's launch count, and over the shapes ``predict_many`` serves (B = 8,
256² tiles; one launch per distinct shape) the largest error against the
plain version and the summed kernel and plain times.  The other shapes of
phase 3 (B = 1 at 250², the embedding term, odd sizes) are pass/fail
checks printed on their own lines.  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises, and the
script then exits non-zero without printing either line.

Tolerances (the plain versions compute in f32 from the same bf16 operands):
  conv3x3_fused, resize (bf16): |kernel - plain| <= 1e-2 + 1e-2 |plain|,
    one bf16 ulp of the shared f32 result, since the two sum in other orders;
  resize (f32) <= 1e-5 + 1e-5 |plain|;
  lstm (f32, 828 steps): <= 1e-4;
  golden fixture, bf16 against f32: <= 3e-2 (the port's bf16 forward on
    the CPU is 6.4e-3 from it, on outputs up to 0.85);
  main path, kernels vs plain versions, bf16 end to end: the output's max
    difference <= 5% of its largest magnitude (rounding flips of one bf16
    ulp in the conv and resize outputs, carried through 18 convs).
TF32 is off for cuDNN and matmuls, so the plain versions run in full f32.
"""

from __future__ import annotations

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
              rtol: float, serving: bool = False) -> None:
        """Compare ``kernel()`` with ``plain()``; a ``serving`` shape also
        enters the kernel's summary row."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        err = float(diff.max())
        rel = float((diff / want.float().abs().clamp_min(1e-6)).max())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        ok = bool(torch.isfinite(got).all()) and bool((diff <= bound).all())
        print(f"kernel {name} {label}{' [serving]' if serving else ''}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"tol=({atol:g} + {rtol:g}|plain|) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        if not serving:
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
    # (batch, (H, W), input parts' channels, cout, with add, serving)
    a_cases = ([(8, (256, 256), cins, 64, False, True) for cins in level0]
               + [(2, (256, 256), cins, 64, False, False) for cins in level0]
               + [(1, (250, 250), cins, 64, False, False) for cins in level0]
               + [(2, (256, 256), (64,), 64, True, False),
                  (2, (125, 125), (23, 40), 48, True, False),
                  (2, (33, 47), (16,), 80, True, False)])
    for b, hw, cins, cout, with_add, serving in a_cases:
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
                    1e-2, 1e-2, serving)

    # B: the temporal encoder's recurrence at the predict_many batch with
    # mixed lengths, and at B=1 (predict).
    for lens, serving in [([828, 828, 600, 414, 100, 1, 0, 827], True), ([828], False)]:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        b, hidden = len(lens), 96
        x_proj = randn(b, T_SERIES, 4 * hidden, std=0.5)
        w_hh = (torch.rand((hidden, 4 * hidden), generator=g, device=dev) * 2 - 1) / math.sqrt(hidden)
        table.check("lstm_last_hidden", f"({b}, {T_SERIES}, {4 * hidden}) lengths={lens.tolist()}",
                    lambda: lstm.lstm_last_hidden(x_proj, w_hh, lens),
                    lambda: lstm.lstm_last_hidden_scan(x_proj, w_hh, lens), 1e-4, 0.0,
                    serving)

    # C: the four decoder upsamples at B=8; the bottleneck's double
    # interpolation of a 250² tile at B=1 (15 -> 30, then the odd fix-up
    # 30 -> 31); one f32 case and one channel count that takes the kernel's
    # one-channel-per-thread path.
    for shape, out_hw, dtype, tol, serving in [
            ((8, 16, 16, 1024), (32, 32), bf, 1e-2, True),
            ((8, 32, 32, 512), (64, 64), bf, 1e-2, True),
            ((8, 64, 64, 256), (128, 128), bf, 1e-2, True),
            ((8, 128, 128, 128), (256, 256), bf, 1e-2, True),
            ((1, 15, 15, 1024), (30, 30), bf, 1e-2, False),
            ((1, 30, 30, 1024), (31, 31), bf, 1e-2, False),
            ((2, 15, 15, 64), (30, 30), torch.float32, 1e-5, False),
            ((2, 15, 15, 3), (30, 31), bf, 1e-2, False)]:
        x = randn(*shape, dtype=dtype)
        table.check("resize_pack", f"{shape}->{out_hw} {str(dtype).split('.')[-1]}",
                    lambda: resize_pack.resize_pack(x, out_hw),
                    lambda: resize_pack.resize_pack_plain(x, out_hw), tol, tol, serving)


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


def main_path(dev, tmpdir: str) -> dict[str, int]:
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
    wrappers = (packed_vgg.conv3x3_fused, lstm.lstm_last_hidden, resize_pack.resize_pack)
    for fn in wrappers:
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
    launches = {fn.__name__: fn.launches for fn in wrappers}
    print(f"main path: predict x3 + predict_many x8 ok, cooling={cooling:.4f} °C, "
          f"launches={launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

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
    print(f"main path vs plain versions: max_abs_diff={diff:.4e} "
          f"(output max |x| {scale:.4f}, tol {0.05 * max(scale, 1.0):.4f})")
    if diff > 0.05 * max(scale, 1.0):
        raise AssertionError("main path disagrees with its plain versions")

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


KERNEL_INFO = {
    "conv3x3_fused": ("maunet_tpu_torch/csrc/conv3x3_fused.cu",
                      "maunet_tpu/ops/pallas/packed_vgg.py:451"),
    "lstm_last_hidden": ("maunet_tpu_torch/csrc/lstm.cu",
                         "maunet_tpu/ops/pallas/lstm.py:402"),
    "resize_pack": ("maunet_tpu_torch/csrc/resize_pack.cu",
                    "maunet_tpu/ops/pallas/resize_pack.py:216"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
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
        launches = main_path(dev, tmpdir)

    kernels = [{"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
                "replaces": KERNEL_INFO[name][1], "launches": launches[name],
                **table.rows[name]}
               for name in KERNEL_INFO]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
