"""Per-sample evaluation figures.

Port of ``maunet_tpu/evaluate/visualize.py`` (reference test/evaluate.py:
363-443, ``plot_evaluation_results``): the input DW map and RGB, per channel
the ground truth, the prediction and the error map on shared colour scales,
and a bar chart of the MAE per DW class.  The sample's metric rows arrive as
a list of dicts, not a DataFrame, and matplotlib is imported inside the
function: a machine without it can still evaluate with ``n_visualize=0``.
"""

from __future__ import annotations

import os

import numpy as np

from maunet_tpu_torch.data.schema import NormalizationStats
from maunet_tpu_torch.utils.dw import dw_to_rgb, get_dw_legend_patches


def plot_evaluation_sample(
    maps_hwc: np.ndarray,
    gt_unnorm: np.ndarray,
    pred_unnorm: np.ndarray,
    metric_rows: list[dict],
    channels: list[str],
    stats: NormalizationStats | None,
    sample_info: dict,
    study_name: str,
    trial_id,
    sample_idx: int,
    out_dir: str,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)

    dw_rgb = dw_to_rgb(np.argmax(maps_hwc[..., :9], axis=-1))
    rgb = maps_hwc[..., 9:12]
    if stats is not None:
        rgb = (rgb * np.array(stats.rgb_std) + np.array(stats.rgb_mean)) * 255.0
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    else:
        rgb = np.clip(rgb, 0, 1)

    city = sample_info.get("city", "?")
    fig = plt.figure(figsize=(24, 18))
    fig.suptitle(f"Evaluation - {city} ({sample_info.get('lat')}, "
                 f"{sample_info.get('lon')})\nSample {sample_idx} "
                 f"(Trial {trial_id})", fontsize=20)
    gs = fig.add_gridspec(3, max(2, len(channels) * 2))

    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(dw_rgb); ax.set_title("Input DW (t1)"); ax.axis("off")
    ax.legend(handles=get_dw_legend_patches(), bbox_to_anchor=(1.05, 1),
              loc="upper left", borderaxespad=0.0)
    ax = fig.add_subplot(gs[0, 1])
    ax.imshow(rgb); ax.set_title("Input RGB (t1)"); ax.axis("off")

    for i, ch_name in enumerate(channels):
        gt, pred = gt_unnorm[..., i], pred_unnorm[..., i]
        error = pred - gt
        vmin, vmax = min(gt.min(), pred.min()), max(gt.max(), pred.max())
        emax = np.max(np.abs(error))
        for col, (img, title, kw) in enumerate([
            (gt, f"GT: {ch_name}", dict(cmap="viridis", vmin=vmin, vmax=vmax)),
            (pred, f"Pred: {ch_name}", dict(cmap="viridis", vmin=vmin, vmax=vmax)),
        ]):
            ax = fig.add_subplot(gs[1, i * 2 + col])
            im = ax.imshow(img, **kw)
            ax.set_title(title); ax.axis("off")
            plt.colorbar(im, ax=ax, orientation="horizontal", pad=0.05)
        ax = fig.add_subplot(gs[2, i * 2])
        im = ax.imshow(error, cmap="coolwarm", vmin=-emax, vmax=emax)
        ax.set_title("Error (Pred - GT)"); ax.axis("off")
        plt.colorbar(im, ax=ax, orientation="horizontal", pad=0.05)

        ax = fig.add_subplot(gs[2, i * 2 + 1])
        per_class = [r for r in metric_rows
                     if r["channel"] == ch_name and r["dw_class"] != "overall"]
        if per_class:
            ax.bar([r["dw_class"] for r in per_class], [r["mae"] for r in per_class])
            ax.set_xlabel("dw_class")
        ax.set_title("MAE per DW Class"); ax.set_ylabel("MAE")
        ax.tick_params(axis="x", rotation=45)

    fig.tight_layout(rect=[0, 0, 1, 0.96])
    path = os.path.join(out_dir,
                        f"{study_name}_trial_{trial_id}_sample_{city}_{sample_idx}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
