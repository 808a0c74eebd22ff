"""Benchmark suites of the port: every hot path, one JSON row each.

Port of ``maunet_tpu/benchmarks.py``:

    python -m maunet_tpu_torch.benchmarks [--suite inference ...] [--out rows.json] [--device cuda]

Suites, with the JAX package's metric names:

- inference: the serving U-Net's forward at B = 1, 8 and 16, and U-Net++ at
  its reference width at B = 8 (tiles/sec/chip);
- train: one train step per loss function;
- lstm: the temporal encoder with kernel B (``cuda``) and with its plain
  version (``plain``), at B = 8 and 1;
- eval: the evaluation metrics of a batch, with kernel D and with its plain
  version;
- loader: host ``.npz`` decode, per-sample files (numpy, and the native
  decoder where it builds) and packed shards;
- eval_pipeline: ``evaluate_checkpoint`` end to end from packed shards.

Timing keeps the JAX semantics (``_time_device``): a host clock around
``iters`` calls, closed by ``torch.cuda.synchronize()``, best of ``repeats``.
A plain version is timed by calling the plain function directly; nothing in
the model switches to it.  The sizes (tile size, series length, widths,
batches, iterations) are keyword arguments of each suite whose defaults are
the JAX values, and the metric names follow them.  Every row carries the
card's name and power limit from ``nvidia-smi`` (``device``,
``power_limit_w``); a run on the CPU, which only the tests make, says
``cpu`` and ``None``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch


def device_fields(device: torch.device) -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return {"device": device.type, "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()
    name, limit = out[device.index or 0].rsplit(",", 1)
    return {"device": name.strip(), "power_limit_w": float(limit)}


class Recorder:
    """Collects the rows of one run and prints each as a JSON line."""

    def __init__(self, device: torch.device):
        self.fields = device_fields(device)
        self.rows: list[dict] = []

    def __call__(self, name: str, value: float, unit: str, **extra) -> None:
        row = {"metric": name, "value": round(value, 3), "unit": unit, **extra,
               **self.fields}
        self.rows.append(row)
        print(json.dumps(row), flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_device(fn, device: torch.device, iters: int = 20, repeats: int = 3) -> float:
    """Seconds per call: best of ``repeats`` host-clock windows of ``iters``
    calls, each closed by a synchronise."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _model(model_type: str, base: int, device: torch.device):
    from maunet_tpu_torch.models.factory import UrbanPredictor

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UrbanPredictor(model_type, base_filters=base, temporal_dim=64,
                               meta_dim=64, lstm_dim=96)
    return model.to(device)


def _model_inputs(gen: torch.Generator, b: int, hw: int, t: int, device: torch.device):
    return (torch.randn((b, hw, hw, 23), generator=gen, device=device).to(torch.bfloat16),
            torch.randn((b, t), generator=gen, device=device),
            torch.randn((b, 8), generator=gen, device=device),
            torch.full((b,), t, dtype=torch.int32, device=device))


def _forward(model, args):
    with torch.inference_mode():
        return model(*args)


def bench_inference(record: Recorder, device: torch.device, hw: int = 256, t: int = 828,
                    base: int = 64, batches=(1, 8, 16), base_pp: int = 32,
                    iters: int = 40, repeats: int = 3) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    model = _model("unet", base, device).eval()
    for b in batches:
        args = _model_inputs(gen, b, hw, t, device)
        dt = _time_device(lambda: _forward(model, args), device, iters, repeats)
        record(f"inference_unet{base}_{hw}px_b{b}", b / dt, "tiles/sec/chip",
               ms_per_batch=round(dt * 1000, 2))

    # U-Net++ at its reference width (reference src/model.py:53-96).
    pp = _model("unet++", base_pp, device).eval()
    args = _model_inputs(gen, 8, hw, t, device)
    dt = _time_device(lambda: _forward(pp, args), device, iters, repeats)
    record(f"inference_unetpp{base_pp}_{hw}px_b8", 8 / dt, "tiles/sec/chip",
           ms_per_batch=round(dt * 1000, 2))


def bench_train(record: Recorder, device: torch.device, hw: int = 256, t: int = 828,
                base: int = 64, b: int = 8, iters: int = 15, repeats: int = 3) -> None:
    from maunet_tpu_torch.losses import get_loss_fn
    from maunet_tpu_torch.train.optimizers import make_optimizer
    from maunet_tpu_torch.train.state import TrainState
    from maunet_tpu_torch.train.steps import train_step

    gen = torch.Generator(device=device).manual_seed(0)
    batch = {
        "maps": torch.randn((b, hw, hw, 23), generator=gen, device=device),
        "targets": torch.randn((b, hw, hw, 2), generator=gen, device=device),
        "metadata": torch.randn((b, 4), generator=gen, device=device),
        "temp_series": torch.randn((b, t), generator=gen, device=device),
        "temp_lengths": torch.full((b,), t, dtype=torch.int32, device=device),
        "t1_dates": torch.tensor([[2020.0, 6.0]] * b, device=device),
        "t2_dates": torch.tensor([[2023.0, 6.0]] * b, device=device),
    }
    for loss_name in ("mse-gradient", "l1-gradient-ssim"):
        model = _model("unet", base, device)
        state = TrainState(model, make_optimizer(model.parameters(), "adamw", 1e-4))
        loss_fn = get_loss_fn(loss_name)
        dt = _time_device(lambda: train_step(state, batch, loss_fn, gradient_clipping=1.0),
                          device, iters, repeats)
        record(f"train_step_unet{base}_{hw}px_b{b}_{loss_name}", b / dt, "tiles/sec/chip",
               ms_per_step=round(dt * 1000, 2))


def bench_lstm(record: Recorder, device: torch.device, t: int = 828, hidden: int = 96,
               batches=(8, 1), iters: int = 50, repeats: int = 3) -> None:
    """The temporal encoder; ``cuda`` runs it as the model does (kernel B),
    ``plain`` the same projection and head around the plain recurrence."""
    from maunet_tpu_torch.models.encoders import TemporalEncoder
    from maunet_tpu_torch.ops.kernels import lstm

    gen = torch.Generator(device=device).manual_seed(0)
    series = torch.randn((max(batches), t), generator=gen, device=device)
    lengths = torch.full((max(batches),), t, dtype=torch.int32, device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc = TemporalEncoder(hidden, 64, compute_dtype=torch.float32).to(device)

    def plain(s, ln):
        return enc.fc(lstm.lstm_last_hidden_scan(*enc.recurrence_inputs(s, ln)))

    for backend, fn in (("cuda", enc), ("plain", plain)):
        if backend == "cuda" and device.type != "cuda":
            continue
        for b in batches:
            s, ln = series[:b], lengths[:b]

            def call():
                with torch.inference_mode():
                    return fn(s, ln)

            dt = _time_device(call, device, iters, repeats)
            record(f"lstm{t}_{backend}_b{b}", dt * 1000, "ms")


def bench_eval_metrics(record: Recorder, device: torch.device, hw: int = 256, b: int = 8,
                       iters: int = 20, repeats: int = 3) -> None:
    from maunet_tpu_torch.evaluate.metrics import eval_metrics
    from maunet_tpu_torch.ops.kernels import masked_stats

    gen = torch.Generator(device=device).manual_seed(0)
    pred = torch.randn((b, hw, hw, 2), generator=gen, device=device)
    tgt = torch.randn((b, hw, hw, 2), generator=gen, device=device)
    dw = torch.randint(0, 9, (b, hw, hw), generator=gen, device=device, dtype=torch.int32)
    backends = [("plain", masked_stats.masked_class_sums_plain)]
    if device.type == "cuda":
        backends.insert(0, ("cuda", masked_stats.masked_class_sums))
    for backend, class_sums in backends:
        dt = _time_device(lambda: eval_metrics(pred, tgt, dw, class_sums=class_sums),
                          device, iters, repeats)
        record(f"eval_metrics_{hw}px_b{b}_{backend}", dt * 1000, "ms")


def bench_loader(record: Recorder, device: torch.device, tmp_dir: str, n: int = 64,
                 hw: int = 256, t: int = 828) -> None:
    from maunet_tpu_torch.data import native
    from maunet_tpu_torch.data.dataset import NpzDataset
    from maunet_tpu_torch.data.shards import ShardedNpzDataset, pack_dataset
    from maunet_tpu_torch.data.synthetic import generate_dataset

    root = os.path.join(tmp_dir, f"bench_data_{n}x{hw}px_t{t}")
    if not os.path.isdir(os.path.join(root, "train")):
        generate_dataset(root, {"train": n, "val": 1, "test": 1}, hw=hw, temporal_len=t)
    packed = os.path.join(tmp_dir, f"bench_packed_{n}x{hw}px_t{t}")
    if not os.path.isdir(packed):
        pack_dataset(os.path.join(root, "train"), packed, shard_size=16, temporal_length=t)

    def run(ds):
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        return len(ds) / (time.perf_counter() - t0)

    record(f"loader_numpy_{hw}px",
           run(NpzDataset(f"{root}/train", temporal_length=t, backend="numpy")), "samples/sec")
    if native.available():
        record(f"loader_native_{hw}px",
               run(NpzDataset(f"{root}/train", temporal_length=t, backend="native")),
               "samples/sec")
    record(f"loader_shards_{hw}px", run(ShardedNpzDataset(packed, temporal_length=t)),
           "samples/sec")


def bench_eval_pipeline(record: Recorder, device: torch.device, tmp_dir: str,
                        n_test: int = 256, hw: int = 256, t: int = 828, base: int = 64,
                        batch_size: int = 8) -> None:
    """End-to-end evaluator throughput: loader, host to device, the forward
    and metrics on the device, and the CSV, as one pipeline over packed
    shards (reference test/evaluate.py:181-293).  Compare with the
    inference rows to see what the host pipeline costs."""
    import shutil

    from maunet_tpu_torch.data.shards import pack_dataset
    from maunet_tpu_torch.data.synthetic import generate_dataset
    from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
    from maunet_tpu_torch.train.config import TrainConfig

    # Enough samples that the per-call fixed costs (checkpoint load, CSV
    # write) amortise and the steady loop dominates.
    root = os.path.join(tmp_dir, f"bench_eval_data_{n_test}x{hw}px_t{t}")
    if not os.path.isdir(os.path.join(root, "test")):
        generate_dataset(root, {"train": 2, "val": 1, "test": n_test}, hw=hw, temporal_len=t)
        packed = os.path.join(root, "test_packed")
        pack_dataset(os.path.join(root, "test"), packed, shard_size=16, temporal_length=t)
        # evaluate_checkpoint reads <data_dir>/test: swap in the packed form
        shutil.rmtree(os.path.join(root, "test"))
        os.rename(packed, os.path.join(root, "test"))

    hp = {"model_type": "unet", "base_filters": base, "temporal_dim": 64, "meta_dim": 64,
          "lstm_hidden": 96, "batch_size": batch_size, "temporal_embeddings": True,
          "metadata_embeddings": True, "metadata_input_length": 8}
    ckpt = os.path.join(tmp_dir, f"bench_eval_unet{base}.pth")
    torch.save({"model_state_dict": _model("unet", base, torch.device("cpu")).state_dict(),
                "hyperparameters": hp, "model_type": "unet", "metadata_input_length": 8,
                "trial_id": 0}, ckpt)

    out_dir = os.path.join(tmp_dir, "bench_eval_out")
    for run in ("cold", "warm"):   # warm: kernels built, page cache filled
        t0 = time.perf_counter()
        rows = evaluate_checkpoint(ckpt, TrainConfig(temporal_length=t), data_dir=root,
                                   study_name=f"bench-{run}", output_dir=out_dir,
                                   n_visualize=0, batch_size=batch_size, device=device)
        _sync(device)
        dt = time.perf_counter() - t0
        n = len({r["sample_idx"] for r in rows})
        if run == "warm":
            record(f"eval_pipeline_unet{base}_{hw}px", n / dt, "tiles/sec",
                   seconds_total=round(dt, 2), samples=n)


SUITES = {
    "inference": bench_inference,
    "train": bench_train,
    "lstm": bench_lstm,
    "eval": bench_eval_metrics,
    "loader": bench_loader,
    "eval_pipeline": bench_eval_pipeline,
}
_NEED_TMP = ("loader", "eval_pipeline")


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--suite", nargs="+", default=list(SUITES), choices=list(SUITES))
    parser.add_argument("--out", default=None, help="write the JSON rows to this file")
    parser.add_argument("--tmp-dir", default=os.path.join(tempfile.gettempdir(),
                                                          "maunet_torch_bench"))
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda unless a test asks for cpu)")


def run(args: argparse.Namespace) -> list[dict]:
    """Run the chosen suites; returns their rows."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the benchmark runs on a CUDA card and none is available; "
                           "--device cpu runs it on the CPU")
    record = Recorder(device)
    for name in args.suite:
        if name in _NEED_TMP:
            SUITES[name](record, device, args.tmp_dir)
        else:
            SUITES[name](record, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record.rows, f, indent=2)
    return record.rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(parser)
    run(parser.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
