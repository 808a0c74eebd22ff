"""Model definitions (NHWC)."""

from maunet_tpu_torch.models.factory import UrbanPredictor, build_model

__all__ = ["UrbanPredictor", "build_model"]
