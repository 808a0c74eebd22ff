"""Packed-shard dataset format.

A numpy-only copy of ``maunet_tpu/data/shards.py``, carried so that the port
imports nothing of ``maunet_tpu`` (whose ``data/__init__.py`` imports its JAX
input pipeline).  The two read and write the same files.

A per-sample split stores one compressed ``.npz`` per sample, and opening and
inflating each file costs the host more than the device spends on the
sample.  A packed shard stacks ``shard_size`` samples into one uncompressed
``.npz``:

    inputs   (N, 23, H, W) f32      targets (N, 2, H, W) f32
    metadata (N, 4) f32             series  (N, T) f32 (zero-padded)
    lengths  (N,) i32               t1_dates, t2_dates (N, 2) f32

and the split's ``shards_index.json`` lists the shards and the samples'
original file names, from which the metadata of a sample is parsed.
Uncompressed members are memory-mapped, so reading one sample faults in only
its pages.  ``ShardedNpzDataset`` has ``NpzDataset``'s ``__getitem__``
contract, so ``make_batches`` reads either.
"""

from __future__ import annotations

import json
import logging
import os
import zipfile
from collections import OrderedDict
from typing import Callable

import numpy as np

from maunet_tpu_torch.data.dataset import NpzDataset
from maunet_tpu_torch.data.schema import parse_sample_filename

log = logging.getLogger(__name__)

INDEX_FILE = "shards_index.json"


def pack_dataset(src_dir: str, out_dir: str, shard_size: int = 64,
                 temporal_length: int = 828) -> str:
    """Pack a per-sample .npz split directory into shards under ``out_dir``."""
    ds = NpzDataset(src_dir, temporal_length=temporal_length)
    os.makedirs(out_dir, exist_ok=True)
    index = {"shard_size": shard_size, "temporal_length": temporal_length,
             "shards": [], "names": []}

    for start in range(0, len(ds), shard_size):
        idx = range(start, min(start + shard_size, len(ds)))
        samples = [ds[i] for i in idx]
        names = [os.path.basename(ds.files[i]) for i in idx]
        shard_name = f"shard_{start // shard_size:05d}.npz"
        np.savez(
            os.path.join(out_dir, shard_name),
            inputs=np.stack([s["maps"].transpose(2, 0, 1) for s in samples]),
            targets=np.stack([s["targets"].transpose(2, 0, 1) for s in samples]),
            metadata=np.stack([s["metadata"] for s in samples]),
            series=np.stack([s["temp_series"] for s in samples]),
            lengths=np.asarray([s["temp_lengths"] for s in samples], np.int32),
            t1_dates=np.stack([s["t1_dates"] for s in samples]),
            t2_dates=np.stack([s["t2_dates"] for s in samples]),
        )
        index["shards"].append(shard_name)
        index["names"].extend(names)

    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump(index, f)
    log.info(f"Packed {len(index['names'])} samples into "
             f"{len(index['shards'])} shards at {out_dir}")
    return out_dir


def _mmap_npz_members(path: str) -> dict[str, np.ndarray]:
    """Memory-map every array of an *uncompressed* ``.npz``.

    ``np.load`` decodes whole members, so one sample from a 64-sample shard
    would read the whole shard.  A stored (deflate-free) zip member is
    ``.npy`` bytes at a file offset, so each maps as a ``np.memmap`` and the
    page cache faults in only the rows read.  Raises ``ValueError`` on a
    compressed or Fortran-ordered member (the caller then decodes eagerly)."""
    arrays: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}:{info.filename} is compressed")
            # The local header's name and extra lengths can differ from the
            # central directory's: read them to find where the member starts.
            f.seek(info.header_offset)
            local = f.read(30)
            name_len = int.from_bytes(local[26:28], "little")
            extra_len = int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            if fortran:
                raise ValueError(f"{path}:{info.filename} is Fortran-ordered")
            arrays[info.filename.removesuffix(".npy")] = np.memmap(
                path, dtype=dtype, mode="r", offset=f.tell(), shape=shape)
    return arrays


class ShardedNpzDataset:
    """``NpzDataset``'s interface over packed shards, with a small LRU of
    memory-mapped shards."""

    def __init__(self, shard_dir: str, temporal_length: int | None = None,
                 transform: Callable | None = None, cache_shards: int = 2):
        with open(os.path.join(shard_dir, INDEX_FILE)) as f:
            self.index = json.load(f)
        self.shard_dir = shard_dir
        self.shard_size = int(self.index["shard_size"])
        self.names = self.index["names"]
        self.files = [os.path.join(shard_dir, n) for n in self.names]  # virtual
        self.transform = transform
        packed_t = int(self.index["temporal_length"])
        self.temporal_length = temporal_length or packed_t
        if self.temporal_length > packed_t:
            raise ValueError(f"temporal_length {self.temporal_length} exceeds "
                             f"packed length {packed_t}")
        self._cache: OrderedDict[int, dict] = OrderedDict()
        self._cache_shards = cache_shards

    def __len__(self) -> int:
        return len(self.names)

    def get_metadata_from_idx(self, idx: int) -> dict:
        info = parse_sample_filename(self.names[idx])
        return {"city": info["city"], "lat": info["lat"], "lon": info["lon"]}

    def _shard(self, shard_idx: int) -> dict:
        if shard_idx in self._cache:
            self._cache.move_to_end(shard_idx)
            return self._cache[shard_idx]
        path = os.path.join(self.shard_dir, self.index["shards"][shard_idx])
        try:
            shard = _mmap_npz_members(path)
        except ValueError:
            with np.load(path) as z:     # a compressed shard: decode it whole
                shard = {k: z[k] for k in z.files}
        self._cache[shard_idx] = shard
        if len(self._cache) > self._cache_shards:
            self._cache.popitem(last=False)
        return shard

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        shard = self._shard(idx // self.shard_size)
        j = idx % self.shard_size
        maps = np.ascontiguousarray(shard["inputs"][j].transpose(1, 2, 0))
        target = np.ascontiguousarray(shard["targets"][j].transpose(1, 2, 0))
        if self.transform is not None:
            maps, target = self.transform(maps, target)
        t = self.temporal_length
        return {
            "maps": maps,
            "targets": target,
            "metadata": shard["metadata"][j],
            "temp_series": shard["series"][j][:t],
            "temp_lengths": np.int32(min(int(shard["lengths"][j]), t)),
            "t1_dates": shard["t1_dates"][j],
            "t2_dates": shard["t2_dates"][j],
        }
