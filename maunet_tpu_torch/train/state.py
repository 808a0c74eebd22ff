"""Training state: the model (parameters and BatchNorm statistics), its
optimizer and the step counter.

Port of ``maunet_tpu/train/state.py``.  The JAX state is an immutable
pytree that every step replaces; here the model and the optimizer are
updated in place and the holder only carries them with the step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from maunet_tpu_torch.models.factory import UrbanPredictor


@dataclass
class TrainState:
    model: UrbanPredictor
    optimizer: torch.optim.Optimizer
    step: int = 0


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
