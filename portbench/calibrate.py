"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed: the cell's set-up and as many window units as the check
samples from, then the program's numbers (what a run's check compares); for
each control seed also the control's numbers (the reference in the next
precision below the configuration's, in the program's place) and, for a
training cell, the fault of half the batch left out.  One JSON line each.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(root: Path, name: str, seed: int, controls: bool, device) -> list[dict]:
    import torch

    from portbench import harness

    cell = harness.find(root, name)
    entry = importlib.import_module(f"portbench.entries.{cell.traffic['entry']}")
    out = []
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = harness.Context(cell, seed, device, tmp)
        state = entry.setup(ctx)
        harness.window(ctx, state, None, int(cell.traffic.get("check_among", 0)))
        state.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        nums = state.check()
        out.append({"seed": seed, "kind": "program", "numbers": {n: v for n, v, _ in nums},
                    "detail": getattr(state, "detail", {})})
        if controls:
            for kind, nums in state.controls().items():
                out.append({"seed": seed, "kind": kind, "numbers": {n: v for n, v, _ in nums}})
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            for row in readings(ROOT, args.workload, seed, seed in controls, dev):
                row["workload"] = args.workload
                row["seconds"] = time.perf_counter() - t
                line = json.dumps(row)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
