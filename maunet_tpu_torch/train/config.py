"""Training configuration.

The fields of ``maunet_tpu/config/config.py`` that the port's ``Trainer``
reads, flat, with the same defaults: ``TrainingConfig`` (reference
conf/config.yaml:40-52), ``LoggingConfig.frequency_log`` and
``frequency_plt``, ``seed``, and the dataset fields the loop needs.  A copy,
because ``maunet_tpu.config`` imports PyYAML.  Left out:
``keep_last_checkpoints`` (read by nothing) and the mesh (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class TrainConfig:
    # TrainingConfig
    optimizer: str = "adamw"           # adamw | adam | sgd
    loss: str = "l1-gradient-ssim"     # mse | mse-gradient | l1-gradient-ssim
    epochs: int = 50
    gradient_clipping: float = 0.0     # global-norm clip; 0 disables
    batch_size: int = 16
    learning_rate: float = 1e-4
    momentum: float = 0.9
    lstm_hidden: int = 96
    meta_dim: int = 64
    temporal_dim: int = 64
    weight_decay: float = 1e-3
    base_filters: int = 64
    model_type: str = "unet"           # unet | unet++
    deep_supervision: bool = False     # U-Net++ only: four heads
    temporal_embeddings: bool = True
    metadata_embeddings: bool = True
    compute_dtype: str = "bfloat16"    # bfloat16 | float32
    remat: bool = False                # activation checkpointing per VGGBlock
    # LoggingConfig
    frequency_log: int = 200
    frequency_plt: int = 1000          # prediction plots every N steps; 0 disables
    # Config
    seed: int = 42
    # DatasetConfig
    nb_metadata_features: int = 8
    temporal_length: int = 828
    input_channels: tuple[str, ...] = (
        "before_ghap", "before_ndvi", "before_temp", "before_rgb",
        "change_mask", "before_dw", "after_dw",
    )
    target_channels: tuple[str, ...] = ("after_ndvi", "after_temp")


def hyperparams_from_config(cfg: TrainConfig) -> dict[str, Any]:
    """The hyperparameter dict a checkpoint carries: the reference's keys
    (src/train.py:156-168) plus the optimizer fields the JAX package adds
    (maunet_tpu/train/loop.py:57-80)."""
    return {
        "learning_rate": cfg.learning_rate,
        "batch_size": cfg.batch_size,
        "weight_decay": cfg.weight_decay,
        "temporal_dim": cfg.temporal_dim,
        "meta_dim": cfg.meta_dim,
        "lstm_hidden": cfg.lstm_hidden,
        "base_filters": cfg.base_filters,
        "model_type": cfg.model_type,
        "target_channels": ",".join(cfg.target_channels),
        "input_channels": ",".join(cfg.input_channels),
        "temporal_embeddings": cfg.temporal_embeddings,
        "metadata_embeddings": cfg.metadata_embeddings,
        "deep_supervision": cfg.deep_supervision,
        "optimizer": cfg.optimizer,
        "momentum": cfg.momentum,
        "gradient_clipping": cfg.gradient_clipping,
    }
