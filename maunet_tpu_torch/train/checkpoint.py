"""Full-state ``.pth`` checkpoints in the reference layout.

Takes the place of ``maunet_tpu/train/checkpoint.py`` (orbax directories
with a JSON sidecar).  One ``torch.save`` file holds what the reference's
checkpoints hold (src/train.py:303-320): ``model_state_dict`` under the
reference's key names, ``optimizer_state_dict`` (torch keys optimizer state
by parameter index, and the port registers its parameters in the
reference's order, ``maunet_tpu/interop/torch_export.py``
``reference_param_order``), ``hyperparameters``, ``model_type``,
``metadata_input_length``, and the loop's fields (``epoch``, ``step``,
``loss`` or ``best_val_loss``, ``study_name``, ``trial_id``).  The step
counter is saved too, so training resumes exactly.  Every tensor is saved
from the CPU, so the file loads on a machine without a card, in the port's
engine and in the JAX package's ``interop.torch_import``.
"""

from __future__ import annotations

from typing import Any

import torch

from maunet_tpu_torch.train.state import TrainState


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def save_checkpoint(path: str, state: TrainState, metadata: dict[str, Any]) -> None:
    torch.save({
        "model_state_dict": _to_cpu(state.model.state_dict()),
        "optimizer_state_dict": _to_cpu(state.optimizer.state_dict()),
        **metadata,
        "step": state.step,
    }, path)


def restore_checkpoint(path: str, state: TrainState) -> dict[str, Any]:
    """Load parameters, BN statistics, optimizer state and step into
    ``state`` in place (a file without a step, as the reference's and
    ``export_torch_checkpoint``'s are, restarts the count at 0); returns the
    file's other fields."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model_state_dict"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt.get("step", 0))
    return {k: v for k, v in ckpt.items()
            if k not in ("model_state_dict", "optimizer_state_dict")}
