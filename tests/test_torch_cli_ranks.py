"""``maunet-torch train`` across ranks, on the CPU over Gloo.

JAX's ``cmd_train`` trains on every device of its mesh and takes the
``parallel.*`` keys; the port's command line does the same over the ranks
of a process group: one it finds initialised (here, two ranks of
``tests/torch_multihost_worker.py``, each calling ``cli.main``), or one it
joins where a launcher sets ``WORLD_SIZE`` (two plain subprocesses of
``python -m maunet_tpu_torch.cli train`` with torchrun's variables).  Rank 0
holds the study; every rank trains the trial it samples.  One trial of one
epoch at 32², base 4, T = 32, global batch 4.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from maunet_tpu_torch import cli
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.train.config import TrainConfig

from test_torch_parallel_train import REPO, run_cluster

OVERRIDES = ["training.base_filters=4", "training.temporal_dim=4", "training.meta_dim=4",
             "training.lstm_hidden=4", "training.compute_dtype=float32", "training.loss=mse",
             "training.batch_size=4", "dataset.temporal_length=32", "logging.frequency_plt=0"]
STUDY = "ranks-emb"


def train_argv(data: str, work: str, device: str = "cpu") -> list[str]:
    argv = ["train", "--data-dir", data, "--work-dir", work, "--study-name", "ranks",
            "--search", "--n-trials", "1", "--epochs", "1", "--device", device]
    for item in OVERRIDES:
        argv += ["-o", item]
    return argv


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("cli_ranks") / "d"),
                            {"train": 8, "val": 2, "test": 2}, hw=32, temporal_len=32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def env_ranks(data, tmp_path_factory):
    """Two plain processes of the command with torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), no group made
    beforehand; started before the worker ranks, beside which they run."""
    tmp = tmp_path_factory.mktemp("cli_env")
    work = str(tmp / "work")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.txt", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "maunet_tpu_torch.cli",
                               *train_argv(data, work)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    yield work, procs, logs
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for log in logs:
        log.close()


@pytest.fixture(scope="module")
def worker_ranks(data, env_ranks, tmp_path_factory):
    """Two worker ranks (a group made before the command runs), each
    running the command, then a Trainer built directly with the trial's
    configuration."""
    tmp = tmp_path_factory.mktemp("cli_worker")
    work = str(tmp / "work")
    task = {"kind": "cli", "name": "cli", "argv": train_argv(data, work), "data": data,
            "epochs": 1, "direct_work": str(tmp / "direct")}
    out = run_cluster(tmp, "cli", 2, [task])
    results = [json.loads((out / f"cli_rank{r}.json").read_text()) for r in range(2)]
    return results, work


def _study(work: str) -> dict:
    files = sorted(os.listdir(f"{work}_hpo"))
    assert files == [f"{STUDY}.json"], files
    with open(os.path.join(f"{work}_hpo", files[0])) as f:
        return json.load(f)


def test_ranks_train_rank0s_trial_into_one_study(worker_ranks):
    """Both ranks train the trial rank 0 sampled, to the same bits; rank 0
    alone writes the one study file, and its trial is complete with the
    history's validation loss."""
    results, work = worker_ranks
    assert [r["rc"] for r in results] == [0, 0]
    assert results[0]["trainers"] == results[1]["trainers"]
    (trainer,) = results[0]["trainers"]
    (trial,) = _study(work)["trials"]
    assert trial["state"] == "COMPLETE" and trainer["trial_id"] == trial["number"] == 0
    assert trainer["learning_rate"] == float(trial["params"]["learning_rate"]).hex()
    assert trainer["weight_decay"] == float(trial["params"]["weight_decay"]).hex()
    assert trainer["optimizer"] == trial["params"]["optimizer"]
    (history,) = results[0]["histories"]
    assert results[1]["histories"] == [history]
    assert trial["value"] == history[-1]["val_loss"]


def test_ranks_history_equals_a_direct_two_rank_trainer(worker_ranks):
    results, _ = worker_ranks
    for r in results:
        assert r["direct"] == r["histories"][0]


def test_world_size_from_the_environment_joins_the_ranks(env_ranks, worker_ranks):
    """The two ranks that joined through torchrun's variables train the same
    trial as the worker ranks did (a trial samples from its study's name and
    number), to the same validation loss."""
    work, procs, logs = env_ranks
    deadline = time.monotonic() + 300
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        time.sleep(0.05)
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        assert p.poll() == 0, f"rank {r} exited {p.poll()}:\n{log.read()[-4000:]}"
    (trial,) = _study(work)["trials"]
    (reference,) = _study(worker_ranks[1])["trials"]
    assert trial["state"] == "COMPLETE"
    assert trial["params"] == reference["params"] and trial["value"] == reference["value"]


@pytest.mark.parametrize("key,value,world,match", [
    ("parallel.spatial_parallel", 2, 1, "parallel.spatial_parallel=2 does not divide the 1"),
    ("parallel.spatial_parallel", 3, 4, "parallel.spatial_parallel=3 does not divide the 4"),
    ("parallel.data_parallel", 4, 2, "parallel.data_parallel=4, but 2 rank"),
    ("parallel.data_parallel", 2, 4, r"parallel.spatial_parallel=1 make a data axis of 4"),
])
def test_a_size_that_disagrees_with_the_group_names_its_key(key, value, world, match):
    cfg = cli.with_overrides(TrainConfig(), {key: value})
    with pytest.raises(ValueError, match=match):
        cli.check_mesh_sizes(cfg, world)


def test_parallel_keys_through_o_and_config(tmp_path, monkeypatch):
    """-o and --config set the mesh sizes (-1: the data axis is whatever the
    spatial axis leaves); the command refuses one process with two spatial
    ranks before it builds anything."""
    parser = cli.build_parser()
    path = tmp_path / "c.yaml"
    path.write_text("parallel:\n  data_parallel: -1\n  spatial_parallel: 2\n"
                    "  data_axis: data\n")
    args = parser.parse_args(["train", "--data-dir", "d", "--config", str(path),
                              "-o", "parallel.data_parallel=1"])
    assert cli.load_cfg(args) == TrainConfig(data_parallel=1, spatial_parallel=2)
    cli.check_mesh_sizes(TrainConfig(spatial_parallel=2), 4)
    cli.check_mesh_sizes(TrainConfig(data_parallel=2, spatial_parallel=2), 4)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="parallel.spatial_parallel=2 does not divide the 1"):
        cli.main(["train", "--data-dir", str(tmp_path), "--device", "cpu",
                  "--work-dir", str(tmp_path / "w"), "-o", "parallel.spatial_parallel=2"])
    assert not os.path.exists(tmp_path / "w_hpo")
