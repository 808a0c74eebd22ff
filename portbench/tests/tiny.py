"""Each cell cut to a size the CPU runs in seconds: the plain versions of
the kernels, base 4, T = 32, batches of 2.  ``make_root`` writes a checkout
of the benchmark's data files with every configuration and traffic mix cut
so, which the harness reads as it reads the real one."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345

CFG = {"base_filters": 4, "lstm_hidden": 8, "temporal_dim": 4, "meta_dim": 4,
       "temporal_length": 32}
CFG_F32 = {**CFG, "compute_dtype": "float32"}
TRAFFIC = {
    "click_unet64_512": {"img_size": 64, "block_px": [8, 32], "locations": 3, "canvases": 4,
                         "warmup_units": 1, "trace_units": 4, "check_among": 4, "check_units": 2},
    "serve_unet64_b8": {"img_size": 32, "batch": 2, "pool": 6, "block_px": [4, 16],
                        "lengths": [10, 32], "warmup_units": 1, "trace_units": 4,
                        "check_among": 4, "check_units": 2},
    "eval_unetpp32_b16": {"img_size": 32, "batch": 2, "pool": 3, "lengths": [10, 32],
                          "warmup_units": 1, "trace_units": 6, "check_among": 4,
                          "check_units": 2, "in_flight": 2},
    "train_unet64_b16": {"img_size": 32, "batch": 4, "pool": 4, "lengths": [10, 32],
                         "warmup_units": 1, "trace_units": 3},
}
CELLS = tuple(TRAFFIC)
DATA = ("configs", "traffic", "limits", "metrics")


def harness_cfg(name: str) -> dict:
    """A configuration file of the benchmark, as the harness reads it."""
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def make_root(dest: Path, cfg: dict = CFG) -> Path:
    """``BENCHMARK.json`` and the data files under ``dest``, every
    configuration updated with ``cfg`` and every cell's traffic with its
    ``TRAFFIC`` entry."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in DATA:
        shutil.copytree(ROOT / "portbench" / sub, dest / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in spec["configs"]:
        path = dest / c["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()), **cfg}))
    for w in spec["workloads"]:
        path = dest / "portbench" / "traffic" / f"{w['traffic']}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **TRAFFIC[w["name"]]}))
    return dest
