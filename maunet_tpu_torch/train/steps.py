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
"""

from __future__ import annotations

from typing import Callable

import torch

from maunet_tpu_torch.losses.combined import per_sample_losses
from maunet_tpu_torch.train.optimizers import clip_by_global_norm_, global_norm
from maunet_tpu_torch.train.state import TrainState

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
    model.train()
    outputs = model_outputs(model, batch, metadata_features)
    losses = ds_loss(loss_fn, outputs, batch["targets"])
    opt.zero_grad(set_to_none=True)
    losses["total"].backward()
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    if gradient_clipping and gradient_clipping > 0:
        clip_by_global_norm_(grads, norm, gradient_clipping)
    opt.step()
    state.step += 1
    return losses, norm, outputs


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Batch,
              metadata_features: int = 8) -> dict[str, torch.Tensor]:
    """Masked per-sample loss sums over the batch's valid samples, plus
    ``num_samples``, in eval mode: the host adds them up over batches, so
    the padded tail of the last batch drops out exactly."""
    model.eval()
    outputs = forward_fn(model, batch, metadata_features)
    per_sample = per_sample_losses(outputs, batch["targets"])
    valid = batch["valid"].float()
    sums = {k: (v * valid).sum() for k, v in per_sample.items()}
    sums["num_samples"] = valid.sum()
    return sums
