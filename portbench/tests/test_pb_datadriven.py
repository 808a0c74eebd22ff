"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and entries in a copy of the benchmark are found by name and run,
and no file that was there changes."""

import hashlib
import json
import shutil
import time

import torch

from portbench import harness, readers
from portbench.tests import tiny

READER = '''"""Units in the traced window: a reader that needs no device."""


def read(run):
    return float(run.units) if run.units else None
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()}


def test_a_new_cell_is_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(root)

    bench = root / "portbench"
    cfg = {**tiny.harness_cfg("unet64"), **tiny.CFG, "name": "tinynet"}
    (bench / "configs" / "tinynet.json").write_text(json.dumps(cfg))
    traffic = {**json.loads((bench / "traffic" / "eval_b16.json").read_text()),
               **tiny.TRAFFIC["eval_unetpp32_b16"], "lengths": [4, 32]}
    (bench / "traffic" / "eval_tiny.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "units_seen.tiny.py").write_text(READER)
    (bench / "limits" / "eval_tinynet.json").write_text(
        json.dumps({"ndvi_err": 1.0, "lst_err": 1.0, "metrics_rel": 1.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinynet", "source": "https://example.org/tinynet",
                            "file": "portbench/configs/tinynet.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "eval_tinynet", "config": "tinynet",
                              "traffic": "eval_tiny", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "eval_tiles_per_s":
            m["workloads"].append("eval_tinynet")
    spec["per_layer"].append({"name": "units_seen.tiny", "unit": "units", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "eval_tiles_per_s", "workloads": ["eval_tinynet"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    added = digest(root)

    cpu = torch.device("cpu")
    plain, _ = harness.run_cell(root, "eval_tinynet", 5, 0.3, False, cpu, time.perf_counter())
    assert set(plain["metrics"]) == {"eval_tiles_per_s", "setup_s"} and plain["correct"]
    traced, _ = harness.run_cell(root, "eval_tinynet", 5, 0.3, True, cpu, time.perf_counter())
    assert traced["metrics"]["units_seen.tiny"]["value"] == traffic["trace_units"]
    # A new cell's name of a shared metric needs no file of its own.
    assert harness.load_reader(root, "idle_share.tinynet") is readers.idle_share
    after = digest(root)
    assert {k: after[k] for k in before} == before
    assert after == added
