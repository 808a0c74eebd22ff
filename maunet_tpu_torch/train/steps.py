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


def forward_fn(model: torch.nn.Module, batch: Batch,
               metadata_features: int = 8) -> torch.Tensor:
    """The model on a batch, in whatever mode the model is in: (B, H, W, C) f32."""
    return model(batch["maps"], batch["temp_series"],
                 metadata_full(batch, metadata_features), batch["temp_lengths"])


def train_step(state: TrainState, batch: Batch, loss_fn: LossFn, *,
               gradient_clipping: float = 0.0,
               metadata_features: int = 8) -> dict[str, torch.Tensor]:
    """One update of ``state`` in place.  Returns the loss components and
    ``grad_norm`` (the global norm before clipping) as device scalars."""
    model, opt = state.model, state.optimizer
    model.train()
    outputs = forward_fn(model, batch, metadata_features)
    losses = loss_fn(outputs, batch["targets"])
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
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = norm.detach()
    return metrics


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
