"""Datasets, batching and the host-to-device pipeline (numpy copies of the JAX package's)."""

import os as _os


def open_split(data_dir: str, split: str, temporal_length: int = 828,
               transform=None):
    """Open a split as a dataset: packed shards when the split holds a shard
    index (``data/shards.py``), per-sample .npz otherwise
    (``maunet_tpu/data/__init__.py`` ``open_split``)."""
    from maunet_tpu_torch.data.dataset import NpzDataset
    from maunet_tpu_torch.data.shards import INDEX_FILE, ShardedNpzDataset

    split_dir = _os.path.join(data_dir, split)
    if _os.path.exists(_os.path.join(split_dir, INDEX_FILE)):
        return ShardedNpzDataset(split_dir, temporal_length=temporal_length,
                                 transform=transform)
    return NpzDataset(split_dir, temporal_length=temporal_length,
                      transform=transform)
