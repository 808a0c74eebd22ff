"""Process-group set-up and each rank's rows of a global batch.

Port of ``maunet_tpu/parallel/multihost.py``.  JAX runs one process per host
and shards within it over the host's devices; here one process drives one
device (a rank), and the data axis is the world size of the initialised
``torch.distributed`` process group (1 when there is none).  Ranks join
either through :func:`initialize_multihost` or through a launcher that sets
``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` and calls ``init_process_group``
itself: everything else reads the group that exists.

JAX's ``make_global_batch`` has no counterpart: each rank keeps its own rows
on its own device, and the train step all-reduces what the global batch
shares (BatchNorm's batch statistics, the gradients, the logged losses).
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None,
                         device: str | torch.device | None = None) -> torch.device:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``, and return the device the rank computes on.

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
    log.info(f"torch.distributed initialized ({backend}): rank {me} of {world} on {device}")
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


def host_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous rows of a global batch: JAX's
    ``host_local_batch_slice`` (and ``host_batch_slice_for_sharding``, for
    one device per process).  The batch must divide by the world size."""
    world = world_size()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide over {world} ranks")
    per_rank = global_batch // world
    start = rank() * per_rank
    return slice(start, start + per_rank)
