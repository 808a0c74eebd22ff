"""Training-time prediction plotter.

Port of ``maunet_tpu/train/visualize.py`` (reference
src/utils/visualize_predictions.py:9-165): every ``frequency_plt`` steps the
``Trainer`` renders sample 0 of the current batch (input panels DW t1/t2,
RGB, NDVI, LST; ground truth and prediction per channel; the CRU series) to
a PNG under the work directory.  The batch arrives as numpy arrays.
matplotlib is imported inside the function: a machine without it trains
with the plots off (``train/loop.py``).
"""

from __future__ import annotations

import os

import numpy as np

from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.utils.dw import dw_to_rgb


def plot_predictions_vs_targets(
    batch: dict,
    outputs: np.ndarray,
    out_dir: str,
    study_name: str,
    trial_id,
    step: int,
    loss: float,
    stats: NormalizationStats | None = None,
    channels: tuple[str, ...] = ("after_ndvi", "after_temp"),
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    maps = np.asarray(batch["maps"][0])          # (H, W, 23)
    targets = np.asarray(batch["targets"][0])    # (H, W, 2)
    outputs = np.asarray(outputs[0])
    meta = np.asarray(batch["metadata"][0])
    series = np.asarray(batch["temp_series"][0])
    length = int(np.asarray(batch["temp_lengths"][0]))

    def unnorm_lst(x):
        return x * stats.temp_std + stats.temp_mean if stats else x

    fig, axes = plt.subplots(2, 5, figsize=(26, 10))
    panels = [
        (dw_to_rgb(np.argmax(maps[..., :9], -1)), "DW t1", {}),
        (dw_to_rgb(np.argmax(maps[..., 14:23], -1)), "DW t2", {}),
        (np.clip(maps[..., 9:12] * 0.2 + 0.4, 0, 1), "RGB t1 (z)", {}),
        (maps[..., 12], "NDVI t1", dict(cmap="RdYlGn", vmin=-1, vmax=1)),
        (unnorm_lst(maps[..., 13]), "LST t1", dict(cmap="inferno")),
    ]
    for ax, (img, title, kw) in zip(axes[0], panels):
        im = ax.imshow(img, **kw)
        ax.set_title(title)
        ax.axis("off")
        if kw:
            plt.colorbar(im, ax=ax, fraction=0.045)

    for i, ch in enumerate(channels):
        gt = targets[..., i]
        pred = outputs[..., i]
        if "temp" in ch:
            gt, pred = unnorm_lst(gt), unnorm_lst(pred)
        vmin, vmax = min(gt.min(), pred.min()), max(gt.max(), pred.max())
        for j, (img, title) in enumerate([(gt, f"GT {ch}"), (pred, f"Pred {ch}")]):
            ax = axes[1][i * 2 + j]
            im = ax.imshow(img, cmap="viridis", vmin=vmin, vmax=vmax)
            ax.set_title(title)
            ax.axis("off")
            plt.colorbar(im, ax=ax, fraction=0.045)

    ax = axes[1][4]
    ax.plot(series[:length], lw=0.7)
    ax.set_title(f"CRU series (len={length})")
    fig.suptitle(f"{study_name} trial {trial_id} step {step} | "
                 f"loss {loss:.4f} | meta {np.round(meta[:4], 3)}")
    fig.tight_layout()
    path = os.path.join(out_dir, f"{study_name}_t{trial_id}_step{step}.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
