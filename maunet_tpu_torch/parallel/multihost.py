"""Process-group set-up and each rank's rows of a global batch.

Port of ``maunet_tpu/parallel/multihost.py``.  JAX runs one process per host
and shards within it over the host's devices; here one process drives one
device (a rank).  The ranks of the initialised ``torch.distributed`` process
group (one without it) form a (data x spatial) grid as JAX's
``make_mesh`` lays devices out, ``reshape(data, spatial)``: rank r sits at
data index r // spatial and spatial index r % spatial.  The ranks of one
data index hold the same samples, each its own rows of every image
(``parallel.spatial``).  Ranks join either through
:func:`initialize_multihost` or through a launcher that sets
``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` and calls ``init_process_group``
itself, then :func:`set_spatial_parallel` for a spatial axis: everything
else reads the group that exists.

JAX's ``make_global_batch`` has no counterpart: each rank keeps its own rows
on its own device, and the train step all-reduces what the global batch
shares (BatchNorm's batch statistics, the gradients, the logged losses).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None,
                         device: str | torch.device | None = None,
                         spatial_parallel: int = 1) -> torch.device:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``, and return the device the rank computes on.
    ``spatial_parallel`` ranks share each image's rows
    (:func:`set_spatial_parallel`); the rest of the world is the data axis.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there, as JAX's
    coordinator does), an ``init_method`` URL (``tcp://...``,
    ``file:///shared/path``), or None: ``env://``, the ``MASTER_ADDR`` and
    ``MASTER_PORT`` that a launcher such as ``torchrun`` sets.  ``device``
    defaults to CUDA device ``process_id`` modulo the visible count, which
    is made current.  The backend follows the device, NCCL for CUDA and Gloo
    for the CPU, unless ``backend`` names one; a failed NCCL start raises.

    As in JAX, a single process (``num_processes`` None or <= 1) makes no
    group, unless ``backend`` is named: a group of one rank runs the
    process-group code paths, whose collectives it then skips."""
    me = process_id or 0
    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("initialize_multihost: no CUDA device; pass device='cpu' "
                               "to train on the CPU")
        device = torch.device("cuda", me % count)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if (num_processes is None or num_processes <= 1) and backend is None:
        return device
    world = num_processes or 1
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    address = coordinator_address or "env://"
    init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=me)
    set_spatial_parallel(spatial_parallel)
    log.info(f"torch.distributed initialized ({backend}): rank {me} of {world} on {device}, "
             f"{axes().data} x {axes().spatial} (data x spatial)")
    return device


def world_size() -> int:
    """The data axis: the ranks of the initialised process group, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the group, 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def coordinates(rank: int, spatial_parallel: int) -> tuple[int, int]:
    """(data index, spatial index) of ``rank``: its place in JAX's
    ``devices.reshape(data, spatial)``."""
    return divmod(rank, spatial_parallel)


@dataclass(frozen=True)
class Axes:
    """This rank's place in the (data x spatial) grid of the process group.
    ``data_group`` holds the ranks of this spatial index (one per data
    index), ``spatial_group`` those of this data index in spatial order
    (``spatial_ranks``); both are None where the axis is the whole world
    or a single rank."""

    data: int = 1
    spatial: int = 1
    data_index: int = 0
    spatial_index: int = 0
    data_group: object = None
    spatial_group: object = None
    spatial_ranks: tuple[int, ...] = (0,)


_axes = Axes()


def set_spatial_parallel(spatial_parallel: int) -> Axes:
    """Lay the process group's ranks out as (world / ``spatial_parallel``) x
    ``spatial_parallel`` and make the subgroups of each axis.  Every rank
    must call it with the same value: each makes every group, in the same
    order, the groups it is not in too (``dist.new_group``'s rule)."""
    global _axes
    world = world_size()
    if spatial_parallel < 1 or world % spatial_parallel:
        raise ValueError(f"spatial_parallel={spatial_parallel} does not divide the "
                         f"{world} rank(s) of the process group")
    dp, sp = world // spatial_parallel, spatial_parallel
    d, s = coordinates(rank(), sp)
    data_group = spatial_group = None
    if sp > 1:
        for i in range(dp):
            g = dist.new_group([i * sp + j for j in range(sp)])
            if i == d:
                spatial_group = g
        for j in range(sp):
            g = dist.new_group([i * sp + j for i in range(dp)])
            if j == s:
                data_group = g
    _axes = Axes(dp, sp, d, s, data_group, spatial_group,
                 tuple(d * sp + j for j in range(sp)))
    return _axes


def axes() -> Axes:
    """The grid of the process group: one data-parallel axis of every rank
    unless :func:`set_spatial_parallel` laid out another."""
    if _axes.data * _axes.spatial != world_size():
        return Axes(world_size(), 1, rank(), 0, None, None, (rank(),))
    return _axes


def host_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous rows of a global batch: JAX's
    ``host_local_batch_slice`` (and ``host_batch_slice_for_sharding``, for
    one device per process), by the rank's data index: the ranks of one
    data index load the same rows.  The batch must divide by the data
    axis."""
    grid = axes()
    if global_batch % grid.data:
        raise ValueError(f"global batch {global_batch} does not divide over the "
                         f"{grid.data} data-parallel rank(s)")
    per_rank = global_batch // grid.data
    start = grid.data_index * per_rank
    return slice(start, start + per_rank)
