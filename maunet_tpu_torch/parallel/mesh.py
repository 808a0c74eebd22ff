"""Device mesh.

Port of ``maunet_tpu/parallel/mesh.py``.  JAX compiles one SPMD program
over a (data x spatial) mesh.  Here the two parallel paths each read their
own part of it:

- training runs one process per device, and the process group's ranks form
  the grid (``parallel.multihost``): the data axis is the world size over
  the spatial axis, and the ranks of one data index share each image's rows
  (``parallel.spatial``); ``data_axis_size`` checks a configuration against
  the group, ``validate_spatial_sharding`` a tile against the spatial axis;
- inference in one process shards a batch over every device of a
  :class:`Mesh`, flat over both axes, as JAX's ``parallel/infer.py`` does
  (``parallel.infer``): no rows are sharded there.  A mesh may name one
  device more than once: each entry gets a replica of its own, so one card
  can stand in for several.

The sharding specs serve GSPMD and have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from maunet_tpu_torch.parallel.multihost import axes, world_size

# Encoder downsampling factor of both models (4 pooling levels): the
# bottleneck feature map is H / 16.
MODEL_DOWNSAMPLE = 16


@dataclass(frozen=True)
class Mesh:
    """A (data x spatial) mesh: ``devices`` flat in JAX's order, data-major,
    so entry d * spatial + s sits at (d, s)."""

    devices: tuple[torch.device, ...]
    spatial: int = 1
    axis_names: ClassVar[tuple[str, str]] = ("data", "spatial")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) // self.spatial, "spatial": self.spatial}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(data_parallel: int = -1, spatial_parallel: int = 1, devices=None) -> Mesh:
    """A ``data_parallel`` x ``spatial_parallel`` mesh over the first of
    ``devices`` (by default every visible CUDA device), laid out as JAX's
    ``reshape(data_parallel, spatial_parallel)``; ``data_parallel=-1``
    takes every device the spatial axis leaves."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
    devices = tuple(torch.device(d) for d in devices)
    sp = max(spatial_parallel, 1)
    if data_parallel == -1:
        data_parallel = len(devices) // sp
    used = data_parallel * sp
    if data_parallel < 1 or used > len(devices):
        raise ValueError(f"mesh {data_parallel}x{sp} needs {used} devices, "
                         f"have {len(devices)}")
    return Mesh(devices[:used], sp)


def validate_spatial_sharding(tile_h: int, spatial_parallel: int,
                              downsample: int = MODEL_DOWNSAMPLE) -> None:
    """Require the bottleneck feature map's height (``tile_h / downsample``)
    to be at least 4 rows and to divide over the spatial axis: JAX's guard,
    which accepts and rejects the same (tile, axis) pairs.

    Here the reason is the port's own.  Every rank then holds an equal,
    even number of rows at each of the four pooled levels, so the 2x2 pools
    stay local and a rank's rows at one level are the pools of its rows at
    the level above; and every rank holds at least one bottleneck row and
    16 input rows, so no halo (one row for a 3x3 conv or a resize, two for
    the pair kernel, ten for the SSIM window) reaches past a neighbour."""
    if spatial_parallel <= 1:
        return
    bottleneck = max(tile_h // downsample, 1)
    if bottleneck % spatial_parallel or bottleneck < 4:
        raise ValueError(
            f"spatial sharding over {spatial_parallel} ranks requires the bottleneck "
            f"feature-map height (tile {tile_h} / {downsample} = {bottleneck}) to be >= 4 "
            f"and divisible by the 'spatial' axis: each rank then holds equal, even rows "
            f"at every pooled level and no halo reaches past a neighbour (the accepted "
            f"tiles are the JAX package's)")


def data_axis_size(data_parallel: int = -1, spatial_parallel: int = 1) -> int:
    """The training data axis for a configuration: the process group's
    world size (1 without one) over ``spatial_parallel``, which must be the
    spatial axis the group was laid out with
    (``multihost.initialize_multihost(spatial_parallel=)``);
    ``data_parallel`` must equal the data axis unless it is -1."""
    world, grid = world_size(), axes()
    sp = max(spatial_parallel, 1)
    if world % sp:
        raise ValueError(f"spatial_parallel={sp} does not divide the process group's "
                         f"{world} rank(s)")
    if sp != grid.spatial:
        raise ValueError(f"spatial_parallel={sp}, but the process group's ranks are laid "
                         f"out {grid.data} x {grid.spatial}: pass spatial_parallel={sp} "
                         f"to initialize_multihost (or multihost.set_spatial_parallel)")
    data = world // sp
    if data_parallel not in (-1, data):
        raise ValueError(f"data_parallel={data_parallel}, but the process group has "
                         f"{world} rank(s) over spatial_parallel={sp}: one rank per "
                         f"data-parallel device and spatial shard")
    return data
