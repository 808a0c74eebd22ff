"""The port's HPO studies, optuna storage and trackers against the JAX
package's: the same samplers' draws and prune decisions, study files either
package resumes, the same SQLite rows, ``cli train`` on the CPU, and the
rows the trainer gives its trackers."""

import csv
import json
import os
import sqlite3

import numpy as np
import pytest

from maunet_tpu.config import Config
from maunet_tpu.train import hpo as jax_hpo
from maunet_tpu.train import optuna_storage as jax_optuna_storage

from maunet_tpu_torch import cli
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.train import hpo, optuna_storage
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.loop import Trainer
from maunet_tpu_torch.utils import tracking

from test_torch_train_loop import _jitted_create_train_state

# The shapes and config of test_torch_train_loop's JAX run: the JAX trainer
# below compiles the same programs (the persistent cache may hold them).
T = 40


def _objective(module, fail_at=()):
    """Every suggest call, four reported epochs with pruning, and a failure
    at the trial numbers of ``fail_at``."""

    def objective(trial):
        lr = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
        x = trial.suggest_float("x", -1.0, 1.0)
        layers = trial.suggest_int("layers", 1, 4)
        opt = trial.suggest_categorical("opt", ["adam", "adamw", "sgd"])
        if trial.number in fail_at:
            raise RuntimeError("boom")
        value = (x - 0.3) ** 2 + 0.01 * layers + (opt == "sgd") * 0.1 + lr
        for epoch in range(4):
            trial.report(value + 0.1 / (epoch + 1), epoch)
            if trial.should_prune():
                raise module.TrialPruned()
        return value

    return objective


def _study(module, storage, name="s"):
    return module.create_study(name, storage_dir=str(storage),
                               pruner=module.MedianPruner(n_startup_trials=2),
                               sampler=module.TPESampler(n_startup_trials=4))


def _trials(storage, name="s"):
    with open(os.path.join(storage, f"{name}.json")) as f:
        return json.load(f)


def test_samplers_and_pruner_match_jax(tmp_path):
    for module, side in ((hpo, "port"), (jax_hpo, "jax")):
        _study(module, tmp_path / side).optimize(_objective(module, fail_at=(3,)), n_trials=16)
    got, want = _trials(tmp_path / "port"), _trials(tmp_path / "jax")
    assert got == want
    states = {t["state"] for t in got["trials"]}
    assert {"COMPLETE", "PRUNED", "FAIL"} <= states
    assert hpo.suggest_training_params.__doc__ and hpo.TPESampler().n_candidates == \
        jax_hpo.TPESampler().n_candidates


@pytest.mark.parametrize("first,second", [(jax_hpo, hpo), (hpo, jax_hpo)])
def test_either_package_resumes_the_others_study(tmp_path, first, second):
    """Six trials (one failing) by one package, then six more by the other
    from the same file, equal twelve by the first alone (the failed trial's
    parameters are enqueued again on resume)."""
    _study(first, tmp_path / "a").optimize(_objective(first, fail_at=(2,)), n_trials=6)
    resumed = _study(second, tmp_path / "a")
    assert len(resumed.trials) == 6
    resumed.optimize(_objective(second), n_trials=6)

    alone = _study(first, tmp_path / "b")
    alone.optimize(_objective(first, fail_at=(2,)), n_trials=6)
    _study(first, tmp_path / "b").optimize(_objective(first), n_trials=6)
    got, want = _trials(tmp_path / "a"), _trials(tmp_path / "b")
    assert got == want and len(got["trials"]) == 12
    assert got["trials"][6]["params"] == got["trials"][2]["params"]


def _tables(db):
    con = sqlite3.connect(db)
    try:
        names = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        out = {}
        for name in names:
            cols = [r[1] for r in con.execute(f"PRAGMA table_info({name})")]
            keep = [c for c in cols if not c.startswith("datetime")]
            out[name] = con.execute(f"SELECT {', '.join(keep)} FROM {name}").fetchall()
        return out
    finally:
        con.close()


def test_optuna_storage_writes_the_same_rows(tmp_path):
    _study(jax_hpo, tmp_path).optimize(_objective(jax_hpo, fail_at=(1,)), n_trials=8)
    study = str(tmp_path / "s.json")
    optuna_storage.export_study_to_sqlite(study, str(tmp_path / "port.db"))
    jax_optuna_storage.export_study_to_sqlite(study, str(tmp_path / "jax.db"))
    got, want = _tables(tmp_path / "port.db"), _tables(tmp_path / "jax.db")
    assert got == want and len(got["trials"]) == 8 and got["trial_params"]
    optuna_storage.import_study_from_sqlite(str(tmp_path / "port.db"), str(tmp_path / "p.json"))
    jax_optuna_storage.import_study_from_sqlite(str(tmp_path / "jax.db"),
                                                str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("hpo") / "data"),
                            {"train": 8, "val": 3}, hw=32, temporal_len=T, seed=2)


TINY = ["-o", "training.batch_size=4", "-o", "training.base_filters=2",
        "-o", "training.temporal_dim=2", "-o", "training.meta_dim=2",
        "-o", "training.lstm_hidden=4", "-o", "training.compute_dtype=float32",
        "-o", "training.loss=mse", "-o", f"dataset.temporal_length={T}"]


def test_cli_train_completes_both_trials(data, tmp_path):
    work = str(tmp_path / "w")
    assert cli.main(["train", "--data-dir", data, "--work-dir", work, "--study-name", "srch",
                     "--n-trials", "2", "--epochs", "1", "--search", "--device", "cpu",
                     *TINY]) == 0
    path = f"{work}_hpo/srch-emb.json"
    trials = json.load(open(path))["trials"]
    assert [t["state"] for t in trials] == ["COMPLETE", "COMPLETE"]
    assert trials[0]["params"] != trials[1]["params"]
    assert set(trials[0]["params"]) == {"learning_rate", "weight_decay", "optimizer"}
    assert all(np.isfinite(t["value"]) and t["intermediate"] == {"0": t["value"]}
               for t in trials)
    for n in (0, 1):
        assert os.path.exists(os.path.join(work, f"srch-emb_trial_{n}_best.pth"))
    # The study goes to optuna's SQLite layout and back through the CLI.
    assert cli.main(["export-optuna", path, str(tmp_path / "s.db")]) == 0
    assert cli.main(["import-optuna", str(tmp_path / "s.db"), str(tmp_path / "back.json")]) == 0
    back = json.load(open(tmp_path / "back.json"))
    assert [t["params"] for t in back["trials"]] == [t["params"] for t in trials]


class Recorder:
    def __init__(self):
        self.rows = []
        self.finished = False

    def log(self, row, step=None):
        self.rows.append((step, dict(row)))

    def finish(self):
        self.finished = True


def test_trackers_receive_the_rows_the_jax_loop_logs(data, tmp_path, monkeypatch):
    """Two steps and an epoch: the step rows are the CSV's rows and carry
    their step, the epoch row has the JAX loop's keys at the step count;
    the JAX Trainer, on the same data and config, logs the same sequence of
    steps and keys."""
    mine = Recorder()
    cfg = TrainConfig(batch_size=4, base_filters=4, temporal_dim=4, meta_dim=4,
                      lstm_hidden=8, compute_dtype="float32", loss="mse-gradient",
                      gradient_clipping=1.0, temporal_length=T, frequency_log=1,
                      frequency_plt=0)
    Trainer(cfg, data, work_dir=str(tmp_path / "port"), study_name="t", device="cpu",
            trackers=[mine, tracking.NullTracker()]).train(epochs=1)

    from maunet_tpu.train import loop as jax_loop

    monkeypatch.setattr(jax_loop, "create_train_state", _jitted_create_train_state)
    theirs = Recorder()
    jax_cfg = Config().with_overrides(**{
        "training.batch_size": 4, "training.base_filters": 4, "training.temporal_dim": 4,
        "training.meta_dim": 4, "training.lstm_hidden": 8,
        "training.compute_dtype": "float32", "training.loss": "mse-gradient",
        "training.gradient_clipping": 1.0, "dataset.temporal_length": T,
        "logging.frequency_log": 1, "logging.frequency_plt": 0})
    jax_loop.Trainer(jax_cfg, data_dir=data, work_dir=str(tmp_path / "jax"), study_name="t",
                     use_mesh=False, trackers=[theirs]).train(epochs=1)

    shape = lambda rows: [(step, sorted(row)) for step, row in rows]
    assert shape(mine.rows) == shape(theirs.rows)
    assert [step for step, _ in mine.rows] == [0, 1, 2]
    with open(tmp_path / "port" / "t_trial0_train_log.csv") as f:
        logged = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    assert [row for _, row in mine.rows[:2]] == logged
    assert mine.rows[2][1]["epoch"] == 0 and np.isfinite(mine.rows[2][1]["val_loss"])


def test_wandb_tracker_is_a_no_op_without_wandb(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)
    tracker = tracking.WandbTracker(project="p", name="n", config={"a": 1})
    tracker.log({"loss": 1.0}, step=0)
    tracker.log_image("k", "x.png")
    tracker.log_table("t", None)
    tracker.finish()
    assert tracker._run is None
    for flags in [(True, True), (True, False), (False, True), (False, False)]:
        from maunet_tpu.utils.tracking import make_emb_tag as jax_make_emb_tag

        assert tracking.make_emb_tag(*flags) == jax_make_emb_tag(*flags)
