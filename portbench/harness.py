"""The general harness: one cell, one seed, one window, one result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the model as it is run (the ``file`` of its
  ``configs`` entry);
- ``traffic/<traffic>.json``: the parameters of a mix, and the program entry
  it drives (``entry``: a module of ``portbench/entries/``);
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, of a
  per-layer metric from the traced window; a metric named ``<name>.<cell
  suffix>`` with no file of its own is read by ``metrics/<name>.py``;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.

Set-up first loads the program's CUDA library, building it where the
checkout has none yet (``build_s``, recorded apart in the result and part
of ``setup_s``), then makes the inputs and weights from the seed and warms
up every shape the cell uses; the window then runs units back to back for ``seconds``
(``--trace 0``), or a fixed number of units under the profiler
(``--trace 1``, the traffic's ``trace_units``).  After the window the peak
memory is read, the program's state is freed and the plain reference judges
the sampled answers.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import trace as tr

# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "maunet_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload's entries from ``BENCHMARK.json`` and the files they name."""
    root: Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def find(root: Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    workload = next((w for w in spec["workloads"] if w["name"] == name), None)
    if workload is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == workload["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{workload['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(root, workload, config, traffic, limits, e2e, per_layer)


@dataclass
class Context:
    """What an entry's set-up and units see."""
    cell: Cell
    seed: int
    device: torch.device
    tmp: str
    spans: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program, named ``portbench.*``,
        on the wall clock (``time.time_ns``), which a trace counts in."""
        start = time.time_ns()
        yield
        self.spans.append((name, start, time.time_ns()))


@dataclass
class Run:
    """What a per-layer reader reads: the traced window and the cell's counts."""
    trace: tr.TraceView | None
    units: int
    state: object


def load_reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ctx: Context, state, seconds: float | None, units: int | None):
    """Units back to back until ``seconds`` pass (or ``units`` are done),
    then the entry's finish (a synchronise, or the last fetches).  Returns
    each unit's host seconds and the window's length."""
    lat = []
    start = time.perf_counter()
    i = 0
    while (i < units) if units is not None else (time.perf_counter() - start < seconds):
        s = time.perf_counter()
        state.unit(i)
        lat.append(time.perf_counter() - s)
        i += 1
    state.finish()
    return lat, time.perf_counter() - start


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> tuple[dict, list[str]]:
    """One run of one cell: (the result line's object, the check lines)."""
    cell = find(root, name)
    build_s = build_kernels(device)
    entry = importlib.import_module(f"portbench.entries.{cell.traffic['entry']}")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(cell, seed, device, tmp)
        state = entry.setup(ctx)
        sync(device)
        setup_s = time.perf_counter() - t0
        ctx.spans.clear()
        view = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
            with profile(activities=acts) as prof:
                with ctx.span(tr.WINDOW):
                    lat, window_s = window(ctx, state, None, int(cell.traffic["trace_units"]))
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            view = tr.read_file(path, ctx.spans)
            os.remove(path)
        else:
            before = resource.getrusage(resource.RUSAGE_SELF)
            lat, window_s = window(ctx, state, seconds, None)
            after = resource.getrusage(resource.RUSAGE_SELF)
            host_cpu = (after.ru_utime - before.ru_utime, after.ru_stime - before.ru_stime)
        units = len(lat)
        metrics = {}
        if not trace:
            values = state.end_to_end(lat, window_s)
            values["setup_s"] = setup_s
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        run = Run(view, units, state)
        if trace:
            for m in cell.per_layer:
                value = load_reader(root, m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        state.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = state.check()
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {
        "correct": correct,
        "attempted": units,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(device, peak),
        "build_s": build_s,
    }
    if view is not None:
        result["device"]["busy_s"] = view.busy_s()
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.device_ops(), "idle_gaps": view.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    lines = [f"detail build_s {build_s}"]
    if not trace:
        lines.append(f"detail window_user_s {host_cpu[0]} window_sys_s {host_cpu[1]}")
    lines += [f"detail {k} {v}" for k, v in getattr(state, "detail", {}).items()]
    lines += [f"check {n} = {v!r} limit {lim!r} {'ok' if math.isfinite(v) and v <= lim else 'FAIL'}"
             for n, v, lim in checks]
    return result, lines


def build_kernels(device: torch.device) -> float:
    """Seconds to build the program's CUDA library, or only to find it where
    this checkout has built it before; nothing on the CPU."""
    if device.type != "cuda":
        return 0.0
    from maunet_tpu_torch.ops.kernels import _build

    start = time.perf_counter()
    _build.build()
    return time.perf_counter() - start


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}
