"""Training losses (NHWC, f32)."""

from maunet_tpu_torch.losses.basic import gradient_loss, l1_loss, mse_loss  # noqa: F401
from maunet_tpu_torch.losses.combined import (  # noqa: F401
    LOSS_REGISTRY,
    compute_all_loss,
    compute_loss_l1_grad_ssim,
    compute_loss_mse,
    compute_loss_mse_gradient,
    get_loss_fn,
    per_sample_losses,
)
from maunet_tpu_torch.losses.ssim import ssim  # noqa: F401
