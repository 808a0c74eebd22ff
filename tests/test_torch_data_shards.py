"""Packed splits in the PyTorch port (``maunet_tpu_torch/data/shards.py``,
``data.open_split``) against the JAX package's, on the CPU at a small size
(32² tiles, T = 40): the two packers write the same shards, each reader
reads both, and batches (flips included) and a trainer's state equal the
per-sample split's."""

import json
import os

import numpy as np
import pytest
import torch

from maunet_tpu.data.shards import ShardedNpzDataset as JaxShardedNpzDataset
from maunet_tpu.data.shards import pack_dataset as jax_pack_dataset

from maunet_tpu_torch.data import open_split
from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
from maunet_tpu_torch.data.shards import INDEX_FILE, ShardedNpzDataset, pack_dataset
from maunet_tpu_torch.data.synthetic import generate_dataset
from maunet_tpu_torch.data.transforms import RandomFlip
from maunet_tpu_torch.train.config import TrainConfig
from maunet_tpu_torch.train.loop import Trainer

T = 40
SPLITS = {"train": 9, "val": 3}
SHARD = 4          # 9 samples: two full shards and one of a single sample


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """A per-sample dataset, the same packed by the port (train and val) and
    its train split packed by the JAX package."""
    base = tmp_path_factory.mktemp("shards")
    flat = generate_dataset(str(base / "flat"), SPLITS, hw=32, temporal_len=T, seed=4)
    packed = base / "packed"
    for split in SPLITS:
        pack_dataset(os.path.join(flat, split), str(packed / split), shard_size=SHARD,
                     temporal_length=T)
    jax_packed = jax_pack_dataset(os.path.join(flat, "train"), str(base / "jax" / "train"),
                                  shard_size=SHARD, temporal_length=T)
    return flat, str(packed), jax_packed


def _equal_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k


def test_port_and_jax_packers_write_the_same_shards(splits):
    _, packed, jax_packed = splits
    port_train = os.path.join(packed, "train")
    assert sorted(os.listdir(port_train)) == sorted(os.listdir(jax_packed))
    with open(os.path.join(port_train, INDEX_FILE)) as f, \
            open(os.path.join(jax_packed, INDEX_FILE)) as g:
        assert json.load(f) == json.load(g)
    for name in os.listdir(port_train):
        if name.endswith(".npz"):
            with np.load(os.path.join(port_train, name)) as a, \
                    np.load(os.path.join(jax_packed, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


@pytest.mark.parametrize("packer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_packed_split_reads_back_the_per_sample_split(splits, packer, reader):
    flat, packed, jax_packed = splits
    shard_dir = os.path.join(packed, "train") if packer == "port" else jax_packed
    cls = ShardedNpzDataset if reader == "port" else JaxShardedNpzDataset
    ds = cls(shard_dir, temporal_length=T)
    _equal_samples(ds, NpzDataset(os.path.join(flat, "train"), T))
    want = NpzDataset(os.path.join(flat, "train"), T)
    assert [ds.get_metadata_from_idx(i) for i in range(len(ds))] == \
        [want.get_metadata_from_idx(i) for i in range(len(want))]


def test_packed_split_refuses_a_longer_series(splits):
    _, packed, _ = splits
    with pytest.raises(ValueError, match="exceeds packed length"):
        ShardedNpzDataset(os.path.join(packed, "train"), temporal_length=T + 1)
    short = ShardedNpzDataset(os.path.join(packed, "train"), temporal_length=T // 2)
    assert short[0]["temp_series"].shape == (T // 2,)


def test_open_split_picks_the_format(splits):
    flat, packed, _ = splits
    assert isinstance(open_split(flat, "train", T), NpzDataset)
    ds = open_split(packed, "val", T, transform=RandomFlip(0))
    assert isinstance(ds, ShardedNpzDataset) and ds.transform is not None
    with pytest.raises(FileNotFoundError):
        open_split(flat, "test", T)


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
def test_make_batches_over_packed_and_per_sample_splits_are_equal(splits, shuffle, drop_last):
    """Flips included: each dataset draws from its own RandomFlip of one seed,
    one draw per loaded sample in loading order."""
    flat, packed, _ = splits
    per_sample = open_split(flat, "train", T, transform=RandomFlip(11))
    sharded = open_split(packed, "train", T, transform=RandomFlip(11))
    for epoch in range(2):
        got = list(make_batches(sharded, 4, shuffle=shuffle, seed=2, epoch=epoch,
                                drop_last=drop_last))
        want = list(make_batches(per_sample, 4, shuffle=shuffle, seed=2, epoch=epoch,
                                 drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for a, b in zip(got, want):
            for k, v in a.as_dict().items():
                np.testing.assert_array_equal(v, getattr(b, k), err_msg=k)
                assert v.dtype == getattr(b, k).dtype, k


def test_trainer_reads_a_packed_split(splits, tmp_path):
    """One epoch from the packed split ends in the same state as one from
    the per-sample split."""
    flat, packed, _ = splits
    cfg = TrainConfig(batch_size=4, base_filters=4, temporal_dim=4, meta_dim=4,
                      lstm_hidden=8, compute_dtype="float32", loss="mse-gradient",
                      learning_rate=1e-3, temporal_length=T, frequency_log=1)
    results = {}
    for name, root in (("flat", flat), ("packed", packed)):
        trainer = Trainer(cfg, root, work_dir=str(tmp_path / name), device="cpu")
        results[name] = (trainer, trainer.train(epochs=1))
    (a, ra), (b, rb) = results["flat"], results["packed"]
    assert isinstance(b.train_ds, ShardedNpzDataset) and isinstance(b.val_ds, ShardedNpzDataset)
    assert ra.history == rb.history and a.state.step == b.state.step == 2
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)
