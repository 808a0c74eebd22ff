"""Device mesh.

Port of ``maunet_tpu/parallel/mesh.py``.  JAX compiles one SPMD program
over a (data x spatial) mesh.  Here the two data-parallel paths each read
their own part of it:

- training runs one process per device, and its data axis is the world
  size of the process group (``parallel.multihost``); ``make_mesh`` checks
  a configuration against it;
- inference in one process shards a batch over the devices of a
  :class:`Mesh` (``parallel.infer``).  A mesh may name one device more than
  once: each entry gets a replica of its own, so one card can stand in for
  several.

The spatial axis (the image rows sharded, with halo exchanges around every
3x3 conv, the align-corners resize and the SSIM and gradient losses) is not
ported: ``spatial_parallel > 1`` raises.  ``validate_spatial_sharding`` and
the sharding specs serve GSPMD and have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from maunet_tpu_torch.parallel.multihost import world_size

# Encoder downsampling factor of both models (4 pooling levels): the
# bottleneck feature map is H / 16.
MODEL_DOWNSAMPLE = 16

SPATIAL_NOT_PORTED = ("spatial_parallel > 1 (the image rows sharded over devices) is not "
                      "ported: it needs halo exchanges around every 3x3 conv, the "
                      "align-corners resize and the SSIM and gradient losses "
                      "(ROADMAP.md, section 1: the spatial mesh axis)")


@dataclass(frozen=True)
class Mesh:
    """A data-parallel mesh: ``devices`` in data-axis order."""

    devices: tuple[torch.device, ...]
    axis_names: ClassVar[tuple[str, str]] = ("data", "spatial")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "spatial": 1}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(data_parallel: int = -1, spatial_parallel: int = 1, devices=None) -> Mesh:
    """A mesh of ``data_parallel`` devices (-1: all of ``devices``), by
    default every visible CUDA device."""
    if spatial_parallel > 1:
        raise NotImplementedError(SPATIAL_NOT_PORTED)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
    devices = tuple(torch.device(d) for d in devices)
    if data_parallel == -1:
        data_parallel = len(devices)
    if not 1 <= data_parallel <= len(devices):
        raise ValueError(f"mesh {data_parallel}x1 needs {data_parallel} devices, "
                         f"have {len(devices)}")
    return Mesh(devices[:data_parallel])


def data_axis_size(data_parallel: int = -1, spatial_parallel: int = 1) -> int:
    """The training data axis for a configuration: the world size of the
    process group (1 without one), which ``data_parallel`` must equal
    unless it is -1."""
    if spatial_parallel > 1:
        raise NotImplementedError(SPATIAL_NOT_PORTED)
    world = world_size()
    if data_parallel not in (-1, world):
        raise ValueError(f"data_parallel={data_parallel}, but the process group has "
                         f"{world} rank(s): one rank per data-parallel device")
    return world
