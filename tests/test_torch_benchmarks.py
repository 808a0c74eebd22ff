"""The port's benchmark suites run on the CPU at small sizes and print one
JSON row per metric, named as the JAX package's rows are at the same sizes;
the rows carry the device and its power limit."""

import functools
import json
import subprocess
import types

import pytest
import torch

from maunet_tpu_torch import benchmarks, cli

CPU = torch.device("cpu")
SMALL = {
    "inference": dict(hw=32, t=12, base=4, batches=(1, 2), base_pp=4, iters=2, repeats=1),
    "train": dict(hw=32, t=12, base=4, b=2, iters=1, repeats=1),
    "lstm": dict(t=12, hidden=8, batches=(3, 1), iters=2, repeats=1),
    "eval": dict(hw=32, b=2, iters=2, repeats=1),
    "loader": dict(n=3, hw=32, t=12),
    "eval_pipeline": dict(n_test=3, hw=32, t=12, base=4, batch_size=2),
}
# The rows of each suite at those sizes: the JAX package's names with the
# sizes in them (at the default sizes, its names exactly: e.g.
# inference_unet64_256px_b8, lstm828_scan_b8 -> lstm828_plain_b8).  The
# kernel rows (lstm cuda, eval cuda) need a card.
NAMES = {
    "inference": ["inference_unet4_32px_b1", "inference_unet4_32px_b2",
                  "inference_unetpp4_32px_b8"],
    "train": ["train_step_unet4_32px_b2_mse-gradient",
              "train_step_unet4_32px_b2_l1-gradient-ssim"],
    "lstm": ["lstm12_plain_b3", "lstm12_plain_b1"],
    "eval": ["eval_metrics_32px_b2_plain"],
    "loader": ["loader_numpy_32px", "loader_shards_32px"],
    "eval_pipeline": ["eval_pipeline_unet4_32px"],
}
UNITS = {"inference": "tiles/sec/chip", "train": "tiles/sec/chip", "lstm": "ms",
         "eval": "ms", "loader": "samples/sec", "eval_pipeline": "tiles/sec"}


@pytest.mark.parametrize("suite", list(benchmarks.SUITES))
def test_suite_prints_one_row_per_metric(suite, tmp_path, capsys):
    record = benchmarks.Recorder(CPU)
    fn = benchmarks.SUITES[suite]
    if suite in ("loader", "eval_pipeline"):
        fn(record, CPU, str(tmp_path), **SMALL[suite])
    else:
        fn(record, CPU, **SMALL[suite])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == record.rows
    assert [r["metric"] for r in printed] == NAMES[suite]
    for row in printed:
        assert row["unit"] == UNITS[suite] and row["value"] > 0
        assert (row["device"], row["power_limit_w"]) == ("cpu", None)
    if suite == "eval_pipeline":
        assert printed[0]["samples"] == 3


def test_main_runs_the_chosen_suites_and_writes_the_rows(tmp_path, monkeypatch):
    for name in ("lstm", "eval"):
        monkeypatch.setitem(benchmarks.SUITES, name,
                            functools.partial(benchmarks.SUITES[name], **SMALL[name]))
    out = tmp_path / "rows.json"
    assert benchmarks.main(["--suite", "lstm", "eval", "--device", "cpu",
                            "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["metric"] for r in rows] == NAMES["lstm"] + NAMES["eval"]
    # The command line's bench runs the same function.
    out2 = tmp_path / "rows2.json"
    assert cli.main(["bench", "--suite", "eval", "--device", "cpu", "--out", str(out2)]) == 0
    assert [r["metric"] for r in json.loads(out2.read_text())] == NAMES["eval"]


def test_the_card_is_the_default_and_is_required():
    args = cli.build_parser().parse_args(["bench"])
    assert args.device == "cuda" and args.suite == list(benchmarks.SUITES)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA card"):
        benchmarks.run(args)


def test_device_fields_read_nvidia_smi(monkeypatch):
    calls = []

    def fake_run(argv, **kw):
        calls.append(argv)
        return types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00\n"
                                            "NVIDIA H100 80GB HBM3, 500.00\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert benchmarks.device_fields(torch.device("cuda", 1)) == {
        "device": "NVIDIA H100 80GB HBM3", "power_limit_w": 500.0}
    assert benchmarks.device_fields(torch.device("cuda")) == {
        "device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
    assert calls[0][:2] == ["nvidia-smi", "--query-gpu=name,power.limit"]


def test_time_device_is_the_best_of_its_windows(monkeypatch):
    """One warm-up call, then ``repeats`` windows of ``iters`` calls; the
    result is the fastest window's time per call."""
    clock = iter([0.0, 1.0, 10.0, 10.5, 20.0, 23.0])
    monkeypatch.setattr(benchmarks.time, "perf_counter", lambda: next(clock))
    calls = []
    assert benchmarks._time_device(lambda: calls.append(1), CPU, iters=5, repeats=3) == 0.1
    assert len(calls) == 1 + 5 * 3
