"""Train and eval steps.

Port of ``maunet_tpu/train/steps.py`` (reference src/train.py:243-256 and
the masked validation of src/train.py:20-60) for one device.  A batch is a
dict of tensors on the model's device, as ``data.pipeline`` yields it.

One train step: forward in train mode (``compute_dtype`` activations, BN on
batch statistics, running statistics updated), f32 loss, backward, a zero
gradient for every parameter that has none (the detached conv biases:
optax updates every parameter, so their AdamW decay and Adam moments must
run here too, and torch optimizers skip a parameter whose ``.grad`` is
None), the global-norm clip, the optimizer update, and the step counter.
A deep-supervised U-Net++ returns four heads: training averages each loss
component over them, validation and inference read the last.

Data parallelism (one rank per device, ``parallel.multihost``): each rank
steps on its rows of the global batch, BatchNorm's statistics are the global
batch's (``models.blocks.batch_norm_train``, on the card the kernels of
``ops/kernels/batchnorm_train.py``), and after the backward the
gradients are averaged over the ranks in a few flat buckets before the norm,
the clip and the update, so every rank applies the same global update, as
JAX's GSPMD step does.  The logged loss components are averaged alike.  An
explicit all-reduce keeps the module's own state_dict keys, which a
``DistributedDataParallel`` wrapper would prefix with ``module.``.  With one
rank nothing is exchanged.

Spans (``utils.profiling``, recorded while a profiler runs): ``train.step``
holds ``train.forward``, ``train.loss``, ``train.backward`` and
``train.optimizer`` (the zero gradients, the norm, the clip and the update),
which holds ``train.allreduce`` where there is more than one rank.  They are
host time: a phase's span ends once its work is enqueued, or once the host
has waited for it.

The spatial axis (``parallel/spatial.py``): the ranks of one data index hold
bands of the same images' rows, and both steps run the model and the losses
under :func:`~maunet_tpu_torch.parallel.spatial.row_shards`.  Each rank's
loss is then its share of its data index's loss, so its gradient is a share
too (the LSTM and the metadata MLP, which run whole on every rank, get the
part their band's rows give them): the gradients and the logged losses are
summed over every rank and divided by the data axis, which sums them over
the spatial group and averages them over the data axis at once.  The
backward runs under the context too: ``remat``'s recompute exchanges halos
again.  The eval step's per-sample losses are whole-image values on every
rank of a spatial group (``losses.per_sample_losses``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from maunet_tpu_torch.losses.combined import per_sample_losses
from maunet_tpu_torch.parallel.multihost import axes, world_size
from maunet_tpu_torch.parallel.spatial import row_shards
from maunet_tpu_torch.train.optimizers import clip_by_global_norm_, global_norm
from maunet_tpu_torch.train.state import TrainState
from maunet_tpu_torch.utils.profiling import span

Batch = dict[str, torch.Tensor]
LossFn = Callable[[torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]


def metadata_full(batch: Batch, metadata_features: int) -> torch.Tensor:
    """8-feature metadata = concat(meta, t1_dates, t2_dates) (reference
    src/train.py:244); 4-feature models take meta as it is (reference
    test/evaluate.py:184-185)."""
    if metadata_features == 8:
        return torch.cat([batch["metadata"], batch["t1_dates"], batch["t2_dates"]], dim=1)
    return batch["metadata"]


def ds_loss(loss_fn: LossFn, outputs, targets: torch.Tensor) -> dict[str, torch.Tensor]:
    """Deep supervision: each loss component averaged over the heads (JAX
    ``_ds_loss``); a single output passes through."""
    if not isinstance(outputs, (tuple, list)):
        return loss_fn(outputs, targets)
    per_head = [loss_fn(o, targets) for o in outputs]
    return {k: sum(d[k] for d in per_head) / len(per_head) for k in per_head[0]}


def last_head(outputs) -> torch.Tensor:
    return outputs[-1] if isinstance(outputs, (tuple, list)) else outputs


def model_outputs(model: torch.nn.Module, batch: Batch, metadata_features: int = 8):
    """The model on a batch, in whatever mode the model is in: (B, H, W, C)
    f32, or a deep-supervised model's tuple of them."""
    return model(batch["maps"], batch["temp_series"],
                 metadata_full(batch, metadata_features), batch["temp_lengths"])


def forward_fn(model: torch.nn.Module, batch: Batch,
               metadata_features: int = 8) -> torch.Tensor:
    """The model's prediction on a batch (the last head's, under deep
    supervision): (B, H, W, C) f32 (JAX ``make_forward_fn``)."""
    return last_head(model_outputs(model, batch, metadata_features))


def train_step(state: TrainState, batch: Batch, loss_fn: LossFn, *,
               gradient_clipping: float = 0.0,
               metadata_features: int = 8) -> dict[str, torch.Tensor]:
    """One update of ``state`` in place.  Returns the loss components and
    ``grad_norm`` (the global norm before clipping) as device scalars."""
    losses, norm, _ = _update(state, batch, loss_fn, gradient_clipping, metadata_features)
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = norm.detach()
    return metrics


def train_step_with_outputs(state: TrainState, batch: Batch, loss_fn: LossFn, *,
                            gradient_clipping: float = 0.0, metadata_features: int = 8
                            ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """:func:`train_step`'s update, for the steps that plot their predictions
    (JAX ``make_train_step_with_outputs``, steps.py:87-118): returns the loss
    components, without ``grad_norm`` as there, and the last head's outputs
    (B, H, W, C) f32, detached."""
    losses, _, outputs = _update(state, batch, loss_fn, gradient_clipping, metadata_features)
    return {k: v.detach() for k, v in losses.items()}, last_head(outputs).detach()


def _update(state: TrainState, batch: Batch, loss_fn: LossFn, gradient_clipping: float,
            metadata_features: int):
    """The step itself: (loss components, global gradient norm, outputs)."""
    model, opt = state.model, state.optimizer
    with span("train.step"):
        model.train()
        with row_shards(batch["maps"].shape[1]):
            with span("train.forward"):
                outputs = model_outputs(model, batch, metadata_features)
            with span("train.loss"):
                losses = ds_loss(loss_fn, outputs, batch["targets"])
            with span("train.backward"):
                opt.zero_grad(set_to_none=True)
                losses["total"].backward()
        with span("train.optimizer"):
            params = [p for group in opt.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            if world_size() > 1:
                with span("train.allreduce"):
                    data = axes().data
                    average_over_ranks_(grads, data)
                    losses = dict(zip(losses, average_over_ranks_(
                        [torch.stack([v.detach() for v in losses.values()])], data)[0]))
            norm = global_norm(grads)
            if gradient_clipping and gradient_clipping > 0:
                clip_by_global_norm_(grads, norm, gradient_clipping)
            opt.step()
        state.step += 1
    return losses, norm, outputs


# Elements per all-reduce of the gradient average: 16 MiB of f32 (a larger
# tensor goes alone), so the full-width U-Net's 32.6M gradients take 9.
BUCKET_ELEMENTS = 1 << 22


def average_over_ranks_(tensors: list[torch.Tensor], data: int) -> list[torch.Tensor]:
    """Replace each tensor in place by its sum over the process group's
    ranks divided by ``data``, the data axis: the mean over the data axis of
    the sums over each spatial group (with one spatial rank, the mean over
    the ranks).  The tensors are packed, dtype by dtype, into flat buckets
    of up to :data:`BUCKET_ELEMENTS`, each summed by one all-reduce, divided
    and unpacked.  Returns ``tensors``."""
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for t in tensors:
        if not buckets or size + t.numel() > BUCKET_ELEMENTS or buckets[-1][0].dtype != t.dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(data)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Batch,
              metadata_features: int = 8) -> dict[str, torch.Tensor]:
    """Masked per-sample loss sums over the batch's valid samples, plus
    ``num_samples``, in eval mode: the host adds them up over batches, so
    the padded tail of the last batch drops out exactly.  Under a spatial
    axis the per-sample losses are summed over the spatial group before the
    mask, so every rank of it returns its data index's sums."""
    model.eval()
    with row_shards(batch["maps"].shape[1]):
        outputs = forward_fn(model, batch, metadata_features)
        per_sample = per_sample_losses(outputs, batch["targets"])
    valid = batch["valid"].float()
    sums = {k: (v * valid).sum() for k, v in per_sample.items()}
    sums["num_samples"] = valid.sum()
    return sums
