"""Optimizers and global-norm gradient clipping.

Port of ``maunet_tpu/train/optimizers.py`` (reference src/train.py:209-216)
onto ``torch.optim``, update for update with the optax chains it builds:

- ``sgd``: ``optax.sgd(lr, momentum)`` is a trace ``t = g + momentum t``
  then ``-lr t``, which is torch SGD with momentum and no dampening;
- ``adam``: ``add_decayed_weights`` before ``scale_by_adam`` is L2 decay added
  to the gradient, which is ``torch.optim.Adam(weight_decay=...)``;
- ``adamw``: ``optax.adamw`` is decoupled decay, ``torch.optim.AdamW``.

Both Adams use b1 0.9, b2 0.999, eps 1e-8 (optax's defaults and torch's).
Clipping is optax's ``clip_by_global_norm`` (:func:`clip_by_global_norm_`),
which the train step applies before the update; ``clip_grad_norm_`` is not
used, as it scales by ``max / (norm + 1e-6)``.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adamw",
                   learning_rate: float = 1e-4, weight_decay: float = 1e-3,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    name = name.lower()
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, weight_decay=weight_decay)
    raise NotImplementedError(f"Optimizer {name!r} not implemented.")


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32
    (``optax.global_norm``)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """In place, ``g / norm * max_norm`` when ``norm >= max_norm`` and ``g``
    otherwise, as optax's ``clip_by_global_norm`` selects; decided on the
    device, without a host sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
