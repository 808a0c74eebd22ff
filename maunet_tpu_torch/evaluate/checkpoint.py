"""Checkpoint loading for inference.

Port of the ``.pth`` branch of ``maunet_tpu/evaluate/evaluator.py::
load_any_checkpoint`` (evaluator.py:71-81).  Native orbax checkpoint
directories need JAX to read and are refused; export them to ``.pth`` first
with ``maunet_tpu.interop.torch_export.export_torch_checkpoint``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from maunet_tpu_torch.interop.torch_import import load_torch_checkpoint
from maunet_tpu_torch.models.factory import UrbanPredictor, build_model


@dataclass
class LoadedModel:
    model: UrbanPredictor
    hyperparams: dict
    meta: dict[str, Any]


def load_any_checkpoint(path: str, study_name: str = "",
                        compute_dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cpu") -> LoadedModel:
    """Load a reference ``.pth`` file into an eval-mode model on ``device``."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"{path!r} is not a .pth/.pt file; orbax checkpoint directories "
            "need JAX -- export them with maunet_tpu.interop.torch_export."
            "export_torch_checkpoint first")
    state_dict, hyperparams, ckpt = load_torch_checkpoint(path, study_name)
    # Converted torch checkpoints reproduce the reference's batch-max LSTM
    # padding behaviour (SURVEY.md section 7).
    model = build_model(hyperparams, lstm_mask_mode="batch_max",
                        compute_dtype=compute_dtype)
    model.load_state_dict(state_dict, strict=True)
    meta = {k: v for k, v in ckpt.items() if k != "model_state_dict"}
    return LoadedModel(model.to(device), hyperparams, meta)
