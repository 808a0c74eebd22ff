"""The port's command line: every subcommand parses, the overrides map onto
``TrainConfig``, and ``synth-data``, ``pack``, ``evaluate``, ``sensitivity``,
``gt-sensitivity`` and ``compare-sensitivity`` run end to end on the CPU
(32² tiles, base 4, T = 16) and write what the direct calls write."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from maunet_tpu_torch import cli
from maunet_tpu_torch.analysis.sensitivity import run_sensitivity
from maunet_tpu_torch.data.shards import pack_dataset
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
from maunet_tpu_torch.models.factory import build_model
from maunet_tpu_torch.train.config import TrainConfig

T = 16
HP = {"model_type": "unet", "base_filters": 4, "temporal_dim": 4, "meta_dim": 6,
      "lstm_hidden": 8, "batch_size": 2, "temporal_embeddings": True,
      "metadata_embeddings": True, "metadata_input_length": 8}


@pytest.fixture(scope="module")
def parser():
    return cli.build_parser()


@pytest.mark.parametrize("argv", [
    ["train", "--data-dir", "d", "--model-type", "unet++", "--no-temporal-embeddings",
     "--seeds", "1", "2", "--epochs", "3", "--resume", "--wandb", "--search"],
    ["evaluate", "ckpt.pth", "--data-dir", "d", "--precision", "float32", "--batch-size", "4"],
    ["synth-data", "/tmp/x", "--train", "8"],
    ["pack", "/tmp/x", "--shard-size", "32"],
    ["bench", "--suite", "inference", "lstm", "--out", "rows.json"],
    ["sensitivity", "ckpt.pth", "eval.csv", "--data-dir", "d", "--max-samples", "5"],
    ["sensitivity", "ckpt.pth", "eval.csv", "--data-dir", "d", "--no-plots"],
    ["gt-sensitivity", "--data-dir", "d"],
    ["compare-sensitivity", "dir"],
    ["export-optuna", "s.json", "s.db"],
    ["import-optuna", "s.db", "s.json", "--study-name", "s"],
    ["stats", "a_evaluation.csv", "b_evaluation.csv", "--output-dir", "o"],
    ["science-loop", "--work-dir", "w", "--hw", "32", "--epochs", "2"],
])
def test_every_subcommand_parses(parser, argv):
    args = parser.parse_args(argv)
    assert callable(args.fn)
    # Every subcommand that touches a model runs on the card unless asked.
    if argv[0] in ("train", "evaluate", "bench", "sensitivity", "science-loop"):
        assert args.device == "cuda"
        assert parser.parse_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("argv", [
    ["train", "--model-type", "resnet", "--data-dir", "d"],
    ["evaluate", "ckpt.pth", "--data-dir", "d", "--precision", "fp8"],
    ["evaluate", "ckpt.pth"],                 # TrainConfig holds no paths
    ["bench", "--suite", "nope"],
])
def test_invalid_arguments_are_refused(parser, argv):
    with pytest.raises(SystemExit):
        parser.parse_args(argv)


def test_overrides_map_onto_train_config(parser):
    args = parser.parse_args(
        ["train", "--data-dir", "d", "-o", "training.batch_size=4", "-o", "seed=7",
         "-o", "training.loss=mse", "-o", "dataset.temporal_length=64",
         "-o", "dataset.target_channels=['after_temp']", "-o", "logging.frequency_log=3",
         "-o", "training.compute_dtype=float32"])
    cfg = cli.load_cfg(args)
    assert cfg == TrainConfig(batch_size=4, seed=7, loss="mse", temporal_length=64,
                              target_channels=("after_temp",), frequency_log=3,
                              compute_dtype="float32")


@pytest.mark.parametrize("key", ["parallel.data_parallel", "training.keep_last_checkpoints",
                                 "dataset.tile_size", "training.frequency_plt",
                                 "training.seed", "paths.data_root", "batch_size"])
def test_unknown_override_raises_naming_the_key(parser, key):
    args = parser.parse_args(["pack", "d", "-o", f"{key}=1"])
    with pytest.raises(ValueError, match=f"unknown config key '{key}'"):
        cli.load_cfg(args)


def test_remat_and_plot_frequency_overrides(parser):
    """The JAX keys of the two training features ported since: both map."""
    args = parser.parse_args(["pack", "d", "-o", "training.remat=True",
                              "-o", "logging.frequency_plt=5"])
    assert cli.load_cfg(args) == TrainConfig(remat=True, frequency_plt=5)


def test_yaml_config_and_its_absence(parser, tmp_path, monkeypatch):
    """--config reads the JAX layout's known keys (others ignored, as the
    JAX loader does); -o applies after it; without PyYAML it says so."""
    path = tmp_path / "c.yaml"
    path.write_text("seed: 3\ntraining:\n  batch_size: 2\n  remat: true\n"
                    "dataset:\n  temporal_length: 40\n  tile_size: 128\n"
                    "paths:\n  data_root: x\nparallel:\n  data_parallel: 1\n")
    args = parser.parse_args(["pack", "d", "--config", str(path), "-o", "seed=9"])
    assert cli.load_cfg(args) == TrainConfig(seed=9, batch_size=2, temporal_length=40,
                                             remat=True)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="needs PyYAML"):
        cli.load_cfg(args)


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_arrays(a, b):
    za, zb = _arrays(a), _arrays(b)
    return za.keys() == zb.keys() and all(np.array_equal(za[k], zb[k]) for k in za)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def data(root):
    """The split that ``synth-data`` writes (two test samples of two cities)."""
    out = str(root / "cli_data")
    assert cli.main(["synth-data", out, "--train", "3", "--val", "1", "--test", "2",
                     "--hw", "32", "--temporal-len", str(T), "--seed", "4"]) == 0
    return out


@pytest.fixture(scope="module")
def checkpoint(root):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = build_model(HP)
    path = str(root / "model.pth")
    torch.save({"model_state_dict": model.state_dict(), "hyperparameters": HP,
                "model_type": "unet", "metadata_input_length": 8, "trial_id": 3}, path)
    return path


def test_synth_data_writes_the_direct_calls_files(data, root):
    direct = generate_dataset(str(root / "direct_data"), {"train": 3, "val": 1, "test": 2},
                              hw=32, temporal_len=T, seed=4)
    for split in ("train", "val", "test"):
        names = sorted(os.listdir(os.path.join(data, split)))
        assert names == sorted(os.listdir(os.path.join(direct, split))) and names
        assert all(_same_arrays(os.path.join(data, split, n), os.path.join(direct, split, n))
                   for n in names)
    assert filecmp.cmp(os.path.join(data, "normalization_metrics.json"),
                       os.path.join(direct, "normalization_metrics.json"), shallow=False)


def test_pack_writes_the_direct_calls_shards(data, root):
    out = str(root / "packed")
    assert cli.main(["pack", data, "--out-dir", out, "--shard-size", "2",
                     "-o", f"dataset.temporal_length={T}"]) == 0
    for split in ("train", "val", "test"):
        direct = pack_dataset(os.path.join(data, split), str(root / "direct_packed" / split),
                              shard_size=2, temporal_length=T)
        names = sorted(os.listdir(os.path.join(out, split)))
        assert names == sorted(os.listdir(direct))
        for n in names:
            a, b = os.path.join(out, split, n), os.path.join(direct, n)
            assert (filecmp.cmp(a, b, shallow=False) if n.endswith(".json")
                    else _same_arrays(a, b)), n
    assert os.path.exists(os.path.join(out, "normalization_metrics.json"))


@pytest.fixture(scope="module")
def eval_csv(data, checkpoint, root):
    out = str(root / "eval_cli")
    assert cli.main(["evaluate", checkpoint, "--data-dir", data, "--device", "cpu",
                     "--study-name", "c", "--jobid", "1", "--n-visualize", "0",
                     "--precision", "float32", "--output-dir", out,
                     "-o", f"dataset.temporal_length={T}"]) == 0
    return os.path.join(out, "c_unet_emb_3_job1_evaluation.csv")


def test_evaluate_writes_the_direct_calls_csv(eval_csv, data, checkpoint, root):
    direct = str(root / "eval_direct")
    evaluate_checkpoint(checkpoint, TrainConfig(temporal_length=T), data_dir=data,
                        study_name="c", jobid="1", output_dir=direct, precision="float32",
                        device="cpu")
    for name in ("c_unet_emb_3_job1_evaluation.csv", "c_unet_emb_3_job1_info.csv"):
        with open(os.path.join(os.path.dirname(eval_csv), name)) as a, \
                open(os.path.join(direct, name)) as b:
            got, want = a.read(), b.read()
        if name.endswith("_info.csv"):        # the first field is the CSV's own path
            got, want = got.split("\n", 1)[1].split(",", 1)[1], want.split("\n", 1)[1].split(",", 1)[1]
        assert got == want


def test_sensitivity_commands_write_the_direct_calls_files(eval_csv, data, checkpoint, root,
                                                          monkeypatch):
    from maunet_tpu_torch.analysis import sensitivity

    monkeypatch.setattr(sensitivity, "HEAT_STEPS", 4)      # 16-point heatmaps: one chunk
    out = str(root / "sens_cli")
    assert cli.main(["sensitivity", checkpoint, eval_csv, "--data-dir", data,
                     "--device", "cpu", "--output-dir", out,
                     "-o", f"dataset.temporal_length={T}"]) == 0
    direct = run_sensitivity(checkpoint, eval_csv, TrainConfig(temporal_length=T),
                             data_dir=data, output_dir=str(root / "sens_direct"),
                             make_plots=False, device="cpu")
    path = os.path.join(out, "sensitivity_data_emb.json")
    assert filecmp.cmp(path, direct, shallow=False)
    with open(path) as f:
        assert len(json.load(f)["heatmaps"]) == 2
    # The figures, after the JSON: averages, the highlighted samples' sweeps,
    # heatmaps (each also as .png).
    figures = set(os.listdir(out))
    assert {"avg_sensitivity_longitude_after_temp_emb.pdf",
            "individual_sensitivity_latitude_after_ndvi.png",
            "heatmap_sample0_after_ndvi.pdf", "heatmap_sample1_after_temp.png"} <= figures
    # Without figures (where matplotlib is absent) only the JSON is written.
    bare = str(root / "sens_bare")
    assert cli.main(["sensitivity", checkpoint, eval_csv, "--data-dir", data, "--no-plots",
                     "--device", "cpu", "--output-dir", bare,
                     "-o", f"dataset.temporal_length={T}"]) == 0
    assert os.listdir(bare) == ["sensitivity_data_emb.json"]

    assert cli.main(["gt-sensitivity", "--data-dir", data, "--output-dir", out]) == 0
    cmp_dir = str(root / "compare")
    assert cli.main(["compare-sensitivity", out, "--output-dir", cmp_dir]) == 0
    assert {"compare_latitude_after_temp.pdf", "avg_heatmap_emb_after_ndvi.pdf"} <= set(
        os.listdir(cmp_dir))


def test_figure_defaults_follow_matplotlib(parser, monkeypatch):
    """Unset, the figure options are on where matplotlib is installed and
    off where it is not; a value given stands either way."""
    args = parser.parse_args(["evaluate", "c.pth", "--data-dir", "d"])
    assert args.n_visualize is None
    assert parser.parse_args(["sensitivity", "c.pth", "e.csv", "--data-dir", "d"]).plots is None
    assert cli.figures_default(None, 10, 0, "x") == 10
    assert cli.figures_default(3, 10, 0, "x") == 3
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert cli.figures_default(None, 10, 0, "x") == 0
    assert cli.figures_default(None, True, False, "x") is False
    assert cli.figures_default(True, True, False, "x") is True


def test_default_commands_run_without_matplotlib(eval_csv, data, checkpoint, root,
                                                 monkeypatch, capsys):
    """Where matplotlib is absent (the GPU host), ``evaluate`` with its
    defaults writes both CSVs and ``sensitivity`` its JSON; an explicit
    request for figures still raises; ``compare-sensitivity``, which only
    draws, exits non-zero with one line naming matplotlib."""
    from maunet_tpu_torch.analysis import sensitivity

    monkeypatch.setattr(sensitivity, "HEAT_STEPS", 4)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    common = ["--data-dir", data, "--device", "cpu", "-o", f"dataset.temporal_length={T}"]
    out = str(root / "eval_bare")
    assert cli.main(["evaluate", checkpoint, "--study-name", "c", "--jobid", "1",
                     "--precision", "float32", "--output-dir", out, *common]) == 0
    assert sorted(os.listdir(out)) == ["c_unet_emb_3_job1_evaluation.csv",
                                       "c_unet_emb_3_job1_info.csv"]
    with open(os.path.join(out, "c_unet_emb_3_job1_evaluation.csv")) as a, open(eval_csv) as b:
        assert a.read() == b.read()
    with pytest.raises(ImportError):
        cli.main(["evaluate", checkpoint, "--n-visualize", "1", "--output-dir",
                  str(root / "eval_figures"), *common])

    sens = str(root / "sens_default_bare")
    assert cli.main(["sensitivity", checkpoint, eval_csv, "--output-dir", sens, *common]) == 0
    assert os.listdir(sens) == ["sensitivity_data_emb.json"]
    with pytest.raises(ImportError):
        cli.main(["sensitivity", checkpoint, eval_csv, "--plots", "--output-dir",
                  str(root / "sens_figures"), *common])

    capsys.readouterr()
    assert cli.main(["compare-sensitivity", sens, "--output-dir", str(root / "cmp_bare")]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "matplotlib" in err[0]
    assert not os.path.exists(root / "cmp_bare")
