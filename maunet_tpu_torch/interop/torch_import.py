"""Reference ``.pth`` checkpoint loading.

Port of ``maunet_tpu/interop/torch_import.py``.  The port's modules carry the
reference's state_dict names, so a checkpoint's ``model_state_dict`` loads as
it is; what remains is reading the file and deriving the architecture
hyperparameters.  ``resolve_embedding_flags`` and ``infer_hyperparams`` are
copies of the JAX package's functions (torch_import.py:107-173), carried so
that the port imports nothing of ``maunet_tpu``, whose package imports pull
in JAX and PyYAML.
"""

from __future__ import annotations

from typing import Any

import torch


def resolve_embedding_flags(checkpoint: dict[str, Any], study_name: str = "") -> tuple[bool, bool]:
    """Three-generation legacy flag resolution (reference test/evaluate.py:92-114)."""
    hp = checkpoint.get("hyperparameters", {}) or {}
    if "temporal_embeddings" in hp:
        return bool(hp["temporal_embeddings"]), bool(hp["metadata_embeddings"])
    default_emb = True
    ckpt_study = checkpoint.get("study_name", "") or ""
    if "noemb" in study_name or "noemb" in ckpt_study:
        default_emb = False
    if checkpoint.get("additional_embeddings", default_emb):
        return True, True
    if checkpoint.get("metadata_only_embeddings", False):
        return False, True
    return False, False


def infer_hyperparams(state_dict: dict[str, Any], checkpoint: dict[str, Any] | None = None,
                      study_name: str = "") -> dict[str, Any]:
    """Derive architecture hyperparameters from checkpoint metadata, filling
    gaps from weight shapes (robust to stripped/legacy checkpoints — the
    reference app mutates checkpoints on disk, app/model_utils.py:22-36)."""
    checkpoint = checkpoint or {}
    hp = dict(checkpoint.get("hyperparameters", {}) or {})

    def shape(key):
        t = state_dict.get(key)
        return None if t is None else tuple(t.shape)

    prefix = "model." if any(k.startswith("model.") for k in state_dict) else ""
    s = lambda k: shape(prefix + k)

    c00 = s("conv0_0.conv1.weight")
    if c00:
        hp.setdefault("base_filters", c00[0])
        hp["spatial_channels"] = c00[1]
    lstm = s("temporal_encoder.lstm.weight_hh_l0")
    if lstm:
        hp.setdefault("lstm_hidden", lstm[1])
    tfc = s("temporal_encoder.fc.weight")
    if tfc:
        hp.setdefault("temporal_dim", tfc[0])
    mfc = s("meta_encoder.fc.2.weight")
    if mfc:
        hp.setdefault("meta_dim", mfc[0])
    mfc0 = s("meta_encoder.fc.0.weight")
    if mfc0:
        hp.setdefault("meta_features", mfc0[1])
    fin = s("final.weight") or s("final4.weight")
    if fin:
        hp.setdefault("out_channels", fin[0])
    hp.setdefault("model_type", checkpoint.get("model_type", "unet"))
    hp["deep_supervision"] = prefix + "final4.weight" in state_dict

    temporal, metadata = resolve_embedding_flags(checkpoint, study_name)
    # U-Net++ always instantiates both encoders regardless of flags
    # (reference quirk, src/model.py:53 — flags swallowed by **kwargs).
    if hp["model_type"] == "unet++":
        temporal = metadata = True
    # Trust the weights over the flags: if an encoder is present in the
    # state_dict it participated in the graph.
    if hp["model_type"] == "unet":
        temporal = prefix + "temporal_encoder.lstm.weight_ih_l0" in state_dict and temporal
        metadata = prefix + "meta_encoder.fc.0.weight" in state_dict and metadata
    hp["temporal_embeddings"] = temporal
    hp["metadata_embeddings"] = metadata
    hp.setdefault("metadata_input_length", checkpoint.get("metadata_input_length", 4))
    return hp


def load_torch_checkpoint(path: str, study_name: str = ""):
    """Load a reference ``.pth`` -> (state_dict with the ``model.`` prefix,
    hyperparams, raw checkpoint dict).  Only tensors, containers and plain
    values are unpickled (``weights_only=True``)."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in checkpoint:
        state_dict = checkpoint["model_state_dict"]
    else:  # bare state_dict file
        state_dict, checkpoint = checkpoint, {}
    hyperparams = infer_hyperparams(state_dict, checkpoint, study_name)
    if not any(k.startswith("model.") for k in state_dict):
        state_dict = {"model." + k: v for k, v in state_dict.items()}
    return state_dict, hyperparams, checkpoint
