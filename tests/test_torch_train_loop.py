"""The PyTorch port's data pipeline, config, checkpoints and ``Trainer``
against the JAX package, on the CPU at a small size (32² tiles, T = 40,
base 4)."""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from maunet_tpu.config import Config
from maunet_tpu.data.dataset import NpzDataset as JaxNpzDataset
from maunet_tpu.data.dataset import make_batches as jax_make_batches
from maunet_tpu.data.synthetic import generate_dataset as jax_generate_dataset
from maunet_tpu.data.transforms import RandomFlip as JaxRandomFlip
from maunet_tpu.interop import torch_import as jax_torch_import
from maunet_tpu.train.metrics import CSVLogger as JaxCSVLogger
from maunet_tpu.train.metrics import RunningLoss as JaxRunningLoss

from maunet_tpu_torch.apps.engine import PlannerEngine
from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
from maunet_tpu_torch.data.pipeline import prefetch_to_device
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.data.transforms import RandomFlip
from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.loop import Trainer
from maunet_tpu_torch.train.metrics import CSVLogger, RunningLoss

T = 40
SPLITS = {"train": 9, "val": 3}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic dataset written by the port and by the JAX package."""
    base = tmp_path_factory.mktemp("synth")
    port = generate_dataset(str(base / "port"), SPLITS, hw=32, temporal_len=T, seed=3)
    ref = jax_generate_dataset(str(base / "jax"), SPLITS, hw=32, temporal_len=T, seed=3)
    return port, ref


def _tiny_cfg(**kw):
    return TrainConfig(batch_size=4, base_filters=4, temporal_dim=4, meta_dim=4,
                       lstm_hidden=8, compute_dtype="float32", loss="mse-gradient",
                       learning_rate=1e-3, gradient_clipping=1.0, temporal_length=T,
                       frequency_log=1, frequency_plt=0, **kw)


def test_generate_dataset_writes_jax_arrays(roots):
    port, ref = roots
    for split in ["", *SPLITS]:
        names = sorted(os.listdir(os.path.join(port, split)))
        assert names == sorted(os.listdir(os.path.join(ref, split)))
        for name in names:
            a, b = os.path.join(port, split, name), os.path.join(ref, split, name)
            if name.endswith(".json"):
                assert open(a).read() == open(b).read()
            elif name.endswith(".npz"):
                with np.load(a) as za, np.load(b) as zb:
                    assert sorted(za) == sorted(zb)
                    for k in za:
                        np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_make_batches_yields_jax_batches(roots, shuffle, drop_last):
    """Seeded epoch-keyed shuffle, the padded tail with its ``valid`` mask,
    and RandomFlip's draws."""
    port, ref = roots
    ours = make_batches(NpzDataset(os.path.join(port, "train"), T, transform=RandomFlip(5)),
                        4, shuffle=shuffle, seed=7, epoch=2, drop_last=drop_last)
    theirs = jax_make_batches(
        JaxNpzDataset(os.path.join(ref, "train"), T, transform=JaxRandomFlip(5),
                      backend="numpy"),
        4, shuffle=shuffle, seed=7, epoch=2, drop_last=drop_last)
    pairs = list(zip(ours, theirs, strict=True))
    assert len(pairs) == (2 if drop_last else 3)
    for a, b in pairs:
        da, db = a.as_dict(), b.as_dict()
        assert sorted(da) == sorted(db)
        for k in da:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    if not drop_last:
        assert pairs[-1][0].valid.tolist() == [True, False, False, False]


def test_random_flip_skip_continues_the_stream():
    x, y = np.arange(6.0).reshape(1, 3, 2), np.arange(3.0).reshape(1, 3, 1)
    a, b = RandomFlip(9), RandomFlip(9)
    for _ in range(5):
        a(x, y)
    b.skip(5)
    for _ in range(8):
        np.testing.assert_array_equal(a(x, y)[0], b(x, y)[0])


def test_prefetch_to_device_on_cpu(roots):
    port, _ = roots
    ds = NpzDataset(os.path.join(port, "val"), T)
    want = list(make_batches(ds, 2))
    got = list(prefetch_to_device(make_batches(ds, 2), torch.device("cpu")))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k, v in w.as_dict().items():
            np.testing.assert_array_equal(g[k].numpy(), v, err_msg=k)
    # Abandoned after one batch: the worker stops and the generator closes.
    gen = prefetch_to_device(make_batches(ds, 1), "cpu")
    next(gen)
    gen.close()

    def failing():
        yield next(make_batches(ds, 1))
        raise OSError("unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(prefetch_to_device(failing(), "cpu"))


def test_train_config_defaults_equal_jax():
    """Every field has the default of its JAX counterpart; the JAX fields
    left out are the features not ported."""
    cfg, ref = TrainConfig(), Config()
    sections = [ref.training, ref.logging, ref.dataset, ref]
    left_out = {"deep_supervision", "keep_last_checkpoints"}
    for f in dataclasses.fields(cfg):
        owner = next(s for s in sections if f.name in {g.name for g in dataclasses.fields(s)})
        assert getattr(cfg, f.name) == getattr(owner, f.name), f.name
    for section in (ref.training, ref.logging):
        missing = {g.name for g in dataclasses.fields(section)} - {
            f.name for f in dataclasses.fields(cfg)}
        assert missing <= left_out, missing


def test_metrics_match_jax(tmp_path):
    for mode in ("cumulative", "ema", "sma"):
        a, b = RunningLoss(mode, window_size=3), JaxRunningLoss(mode, window_size=3)
        for i, v in enumerate([0.5, 0.25, 1.0, 2.0, 0.125]):
            assert a.update(v, n=i % 2 + 1) == b.update(v, n=i % 2 + 1)
    rows = [{"step": 0, "loss": 1.5}, {"step": 1, "loss": 0.5, "extra": 3}]
    for cls, name in ((CSVLogger, "a.csv"), (JaxCSVLogger, "b.csv")):
        log = cls(str(tmp_path / name))
        for r in rows:
            log.log(r)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


@pytest.fixture(scope="module")
def trained(roots, tmp_path_factory):
    """Two epochs in one run, and one epoch plus a resumed second."""
    port, _ = roots
    base = tmp_path_factory.mktemp("trainer")
    full = Trainer(_tiny_cfg(), port, work_dir=str(base / "full"), study_name="t",
                   device="cpu")
    r_full = full.train(epochs=2)
    first = Trainer(_tiny_cfg(), port, work_dir=str(base / "split"), study_name="t",
                    device="cpu")
    r_first = first.train(epochs=1)
    second = Trainer(_tiny_cfg(), port, work_dir=str(base / "split"), study_name="t",
                     device="cpu")
    r_second = second.train(epochs=2, resume=True)
    return base, (full, r_full), (first, r_first), (second, r_second)


def test_trainer_resume_equals_one_run(trained):
    base, (full, r_full), (_, r_first), (second, r_second) = trained
    assert r_full.epochs_run == 2 and r_first.epochs_run == 1 and r_second.epochs_run == 2
    assert len(r_second.history) == 1 and second.state.step == full.state.step == 4
    assert r_second.history[0] == r_full.history[1]
    a, b = full.state.model.state_dict(), second.state.model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    oa, ob = full.state.optimizer.state_dict(), second.state.optimizer.state_dict()
    for i, st in oa["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(v, ob["state"][i][k], rtol=0, atol=0)
    rows = lambda d: list(csv.DictReader(open(os.path.join(base, d, "t_trial0_train_log.csv"))))
    assert rows("full") == rows("split")
    assert [int(r["step"]) for r in rows("full")] == [0, 1, 2, 3]
    assert all(np.isfinite(float(r["batch_loss"])) for r in rows("full"))


def _jitted_create_train_state(model, optimizer, rng, batch, metadata_features=8):
    """``create_train_state`` with ``model.init`` jitted: run op by op, the
    init takes most of a minute on the CPU."""
    import jax
    import jax.numpy as jnp

    from maunet_tpu.train.state import TrainState

    meta = np.concatenate([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], 1)
    v = jax.jit(model.init)(rng, batch["maps"], batch["temp_series"], meta,
                            batch["temp_lengths"])
    return TrainState(params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=optimizer.init(v["params"]), step=jnp.zeros((), jnp.int32))


def test_trainer_csv_columns_equal_jax(trained, roots, tmp_path, monkeypatch):
    """The JAX Trainer, one epoch on the same data and config, writes the
    same file name with the same columns."""
    from maunet_tpu.train import loop as jax_loop

    monkeypatch.setattr(jax_loop, "create_train_state", _jitted_create_train_state)
    JaxTrainer = jax_loop.Trainer

    cfg = Config().with_overrides(**{
        "training.batch_size": 4, "training.base_filters": 4, "training.temporal_dim": 4,
        "training.meta_dim": 4, "training.lstm_hidden": 8,
        "training.compute_dtype": "float32", "training.loss": "mse-gradient",
        "training.gradient_clipping": 1.0, "dataset.temporal_length": T,
        "logging.frequency_log": 1, "logging.frequency_plt": 0})
    JaxTrainer(cfg, data_dir=roots[1], work_dir=str(tmp_path), study_name="t",
               use_mesh=False).train(epochs=1)
    header = lambda path: next(csv.reader(open(path)))
    name = "t_trial0_train_log.csv"
    assert header(os.path.join(trained[0], "full", name)) == header(tmp_path / name)


def test_trainer_checkpoint_loads_in_the_engine_and_in_jax(trained, roots):
    base, (full, r_full), _, _ = trained
    path = r_full.best_checkpoint
    assert path == os.path.join(base, "full", "t_trial_0_best.pth")
    assert os.path.exists(os.path.join(base, "full", "t_trial_0_last.pth"))
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["hyperparameters"]["model_type"] == "unet" and ckpt["metadata_input_length"] == 8
    assert {"epoch", "step", "loss", "study_name", "trial_id", "optimizer_state_dict"} <= set(ckpt)

    loaded = load_any_checkpoint(path, device="cpu")
    for k, v in loaded.model.state_dict().items():
        torch.testing.assert_close(v, ckpt["model_state_dict"][k], rtol=0, atol=0)
    variables, hp, _ = jax_torch_import.load_torch_checkpoint(path)
    assert hp["base_filters"] == 4 and hp["lstm_hidden"] == 8
    assert variables["params"]["conv0_0"]["conv1"]["kernel"].shape == (3, 3, 23, 4)

    engine = PlannerEngine(path, device="cpu", temporal_length=T)
    x = engine.prepare_input(
        {"dw": np.zeros((32, 32), np.float32), "rgb": np.full((3, 32, 32), 100.0, np.float32),
         "ndvi": np.zeros((32, 32), np.float32), "temp": np.full((32, 32), 30.0, np.float32)},
        None, 41.9, 12.5, 2_800_000, 2023, 7, 2025, 7)
    ndvi, lst = engine.predict(x)
    assert ndvi.shape == lst.shape == (32, 32) and np.isfinite(lst).all()
