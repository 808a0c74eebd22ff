"""Data-parallel inference and evaluation over the devices of a mesh.

Port of ``maunet_tpu/parallel/infer.py``.  The evaluator's forward and
metrics, the sensitivity sweeps and the serving engine's ``predict_many``
are independent per sample, so they scale out by splitting the batch over
every device of the mesh, flat over both its axes (a data x spatial mesh
shards no rows here, as in JAX), with the model replicated and no
collectives.  JAX runs the split as one ``shard_map`` program; here one
process drives the
mesh's devices in turn: each device gets a replica of the model, made once,
its shard of the batch, and the work is issued on every device before any
result is gathered, so the devices run side by side.

One difference from JAX, on purpose: a model whose LSTM runs every sample
to its batch's longest series (``lstm_mask_mode="batch_max"``, the
reference's padding leak, which ``.pth`` checkpoints load with) would, split,
run each shard to the shard's own longest, as JAX's shards do.  Here every
row's length is first set to the whole batch's longest, so the shards
compute what the unsharded batch does.
"""

from __future__ import annotations

import copy
import weakref
from typing import Any, Callable

import torch

from maunet_tpu_torch.models.blocks import VGGBlock
from maunet_tpu_torch.parallel.mesh import Mesh
from maunet_tpu_torch.train.steps import forward_fn


def round_up_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """The smallest batch size >= ``batch_size`` that divides over the mesh
    (the loader pads a last partial batch with ``valid=False`` rows, so
    rounding up costs only masked rows)."""
    n = mesh.size
    return -(-batch_size // n) * n


def replicate(model: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One copy of ``model`` per mesh entry, on that entry's device; a device
    named twice gets two copies, each keeping its own constants."""
    replicas = []
    for device in mesh.devices:
        replica = copy.deepcopy(model).to(device)
        for m in replica.modules():
            if isinstance(m, VGGBlock):
                m.forget_constants()
        replicas.append(replica)
    return replicas


def _gather(parts: list, device: torch.device) -> Any:
    """The shards' outputs joined on axis 0 on ``device``, as a tree of the
    same structure."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([p[i] for p in parts], device) for i in range(len(first)))
    raise TypeError(f"shard outputs must be tensors, dicts or tuples, not {type(first)}")


def shard_batch_fn(fn: Callable[[torch.nn.Module, dict], Any], mesh: Mesh) -> Callable:
    """Wrap a per-sample-independent ``(model, batch) -> tree`` function to
    run data-parallel over ``mesh``: ``(model, batch) -> tree``.

    The model's replicas are made at its first call and kept (a later change
    of the model's weights is not seen by them).  Every batch tensor splits
    on axis 0 into equal shards, which must divide over the mesh; every
    output tensor must be batch-major, and comes back on the mesh's first
    device in sample order.  ``fn`` must not mix samples, but for the
    ``batch_max`` LSTM, whose lengths are made the batch's longest first."""
    replicas: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def sharded(model: torch.nn.Module, batch: dict[str, torch.Tensor]):
        if model not in replicas:
            batch_max = any(getattr(m, "mask_mode", None) == "batch_max"
                            for m in model.modules())
            replicas[model] = replicate(model, mesh), batch_max
        copies, batch_max = replicas[model]
        if batch_max and "temp_lengths" in batch:
            lengths = batch["temp_lengths"]
            batch = {**batch, "temp_lengths": lengths.max().expand_as(lengths).contiguous()}
        n = next(iter(batch.values())).shape[0]
        if n % mesh.size:
            raise ValueError(f"batch of {n} does not divide over the mesh's {mesh.size} "
                             f"devices (round_up_to_mesh)")
        per = n // mesh.size
        outs = []
        for i, (device, replica) in enumerate(zip(mesh.devices, copies)):
            shard = {k: v[i * per:(i + 1) * per].to(device, non_blocking=True)
                     for k, v in batch.items()}
            outs.append(fn(replica, shard))
        return _gather(outs, mesh.devices[0])

    return sharded


def make_sharded_forward_fn(model: torch.nn.Module, metadata_features: int, mesh: Mesh):
    """Data-parallel counterpart of ``train.steps.forward_fn``: ``batch ->
    (B, H, W, out)`` over the mesh, in inference mode."""
    def forward(replica, batch):
        with torch.inference_mode():
            return forward_fn(replica, batch, metadata_features)

    sharded = shard_batch_fn(forward, mesh)
    return lambda batch: sharded(model, batch)
