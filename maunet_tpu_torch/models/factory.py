"""Model facade and constructors.

Port of ``maunet_tpu/models/factory.py`` (reference ``UrbanPredictor``,
src/model.py:295-329).  The facade holds the network as ``.model``, so its
state_dict carries the reference's ``model.`` key prefix.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from maunet_tpu_torch.models.unet import MetaUNet
from maunet_tpu_torch.models.unetpp import MetaUNetPP

MODEL_TYPES = ("unet", "unet++")


class UrbanPredictor(nn.Module):
    """Facade over the model types (reference src/model.py:295-326).

    Unlike the JAX facade, torch modules are built before they see an input,
    so the spatial channel count (``in_channels``) and the metadata feature
    count (``meta_features``) are arguments."""

    def __init__(self, model_type: str = "unet", out_channels: int = 2,
                 temporal_dim: int = 64, meta_dim: int = 64,
                 lstm_dim: int = 96, base_filters: int = 64,
                 in_channels: int = 23, meta_features: int = 8,
                 temporal_embeddings: bool = True,
                 metadata_embeddings: bool = True,
                 lstm_mask_mode: str = "per_sample",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 deep_supervision: bool = False, bn_fused: bool = False,
                 fuse_pair: bool = False):
        super().__init__()
        if model_type not in MODEL_TYPES:
            raise ValueError(f"Unsupported model_type: {model_type!r} "
                             f"(expected one of {MODEL_TYPES})")
        self.model_type = model_type
        kw = dict(
            in_channels=in_channels, out_channels=out_channels,
            temporal_dim=temporal_dim, meta_dim=meta_dim, lstm_dim=lstm_dim,
            base_filters=base_filters, meta_features=meta_features,
            temporal_embeddings=temporal_embeddings,
            metadata_embeddings=metadata_embeddings,
            lstm_mask_mode=lstm_mask_mode, compute_dtype=compute_dtype,
            bn_fused=bn_fused, fuse_pair=fuse_pair)
        if model_type == "unet":   # deep supervision is a U-Net++ option
            self.model = MetaUNet(**kw)
        else:
            self.model = MetaUNetPP(deep_supervision=deep_supervision, **kw)

    def forward(self, maps: torch.Tensor, temp_series: torch.Tensor,
                metadata: torch.Tensor,
                temp_lengths: torch.Tensor | None = None):
        """(B, H, W, out_channels) f32; a deep-supervised U-Net++ returns its
        four heads' outputs as a tuple."""
        return self.model(maps, temp_series, metadata, temp_lengths)


def build_model(hyperparams: dict[str, Any], *, out_channels: int = 2,
                lstm_mask_mode: str = "per_sample",
                compute_dtype: torch.dtype = torch.bfloat16,
                bn_fused: bool = False, fuse_pair: bool = False) -> UrbanPredictor:
    """Build a model (in eval mode) from a checkpoint hyperparameter dict.

    Defaults follow the reference evaluator (temporal_dim=16, meta_dim=8,
    lstm_hidden=32 -- test/evaluate.py:157-160); the app's serving defaults
    are 64/64/96 (app/model_utils.py:71-74).  ``spatial_channels`` and
    ``meta_features`` are what ``interop.torch_import.infer_hyperparams``
    reads off the weights."""
    model = UrbanPredictor(
        model_type=hyperparams.get("model_type", "unet"),
        out_channels=out_channels,
        temporal_dim=int(hyperparams.get("temporal_dim", 16)),
        meta_dim=int(hyperparams.get("meta_dim", 8)),
        lstm_dim=int(hyperparams.get("lstm_hidden", 32)),
        base_filters=int(hyperparams.get("base_filters", 64)),
        in_channels=int(hyperparams.get("spatial_channels", 23)),
        meta_features=int(hyperparams.get(
            "meta_features", hyperparams.get("metadata_input_length", 8))),
        temporal_embeddings=bool(hyperparams.get("temporal_embeddings", True)),
        metadata_embeddings=bool(hyperparams.get("metadata_embeddings", True)),
        lstm_mask_mode=lstm_mask_mode,
        compute_dtype=compute_dtype,
        deep_supervision=bool(hyperparams.get("deep_supervision", False)),
        bn_fused=bn_fused,
        fuse_pair=fuse_pair,
    )
    return model.eval()
