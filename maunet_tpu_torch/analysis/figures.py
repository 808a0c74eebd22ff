"""Research-app figures.

The port's copy of ``maunet_tpu/analysis/figures.py``: the figures that the
reference draws inside its app_dev pages, as library functions that return
matplotlib figures (the app calls ``st.pyplot``, the tests draw them
headlessly):

- the pairwise-significance and error-correlation matrices (reference
  app_dev/pages/3_Statistical_Comparison.py:326-396), which also return
  their frames;
- zoomed-quadrant ground truth against prediction (reference
  app_dev/app_src/utils.py:105-271);
- the dataset's geo-distribution, a world-extent scatter in the place of
  the reference's leafmap page (app_dev/pages/3_Dataset.py);
- a static architecture figure beside the interactive one
  (``analysis/diagram_html.py``).

pandas, scipy, matplotlib and seaborn are imported inside the functions that
use them: the GPU host has no matplotlib and no seaborn.
"""

from __future__ import annotations

import numpy as np

from maunet_tpu_torch.analysis.plots import PALETTE, _styled_ax, convert_label


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _sample_errors(csv_paths: list[str], names: list[str], channel: str,
                   metric: str = "mae"):
    """Pivot per-sample overall errors to (unique sample) × (model) — the
    paired layout the matrix tests need (reference
    3_Statistical_Comparison.py:322-328), as a DataFrame."""
    import pandas as pd

    frames = []
    for path, name in zip(csv_paths, names):
        df = pd.read_csv(path)
        sub = df[(df["channel"] == channel) & (df["dw_class"] == "overall")].copy()
        sub["unique_id"] = sub["sample_idx"].astype(str) + "_" + sub["city"].astype(str)
        sub["model"] = name
        frames.append(sub[["unique_id", "model", metric]])
    longf = pd.concat(frames)
    return longf.pivot_table(index="unique_id", columns="model",
                             values=metric).dropna()


def significance_matrix(csv_paths: list[str], names: list[str], channel: str,
                        metric: str = "mae"):
    """Pairwise Wilcoxon signed-rank p-value matrix + heatmap figure
    (reference 3_Statistical_Comparison.py:326-356: Greens_r, vmax=0.05,
    scientific annotations)."""
    import pandas as pd
    import seaborn as sns
    from scipy.stats import wilcoxon

    pivot = _sample_errors(csv_paths, names, channel, metric)
    p_values = pd.DataFrame(index=names, columns=names, dtype=float)
    for m1 in names:
        for m2 in names:
            if m1 == m2:
                p_values.loc[m1, m2] = np.nan
                continue
            try:
                _, p = wilcoxon(pivot[m1], pivot[m2])
            except ValueError:  # identical series
                p = 1.0
            p_values.loc[m1, m2] = p

    fig, ax = _styled_ax(figsize=(2 + 1.6 * len(names), 1.5 + 1.4 * len(names)))
    ax.grid(False)
    sns.heatmap(p_values.astype(float), annot=True, fmt=".1e", cmap="Greens_r",
                vmax=0.05, ax=ax, cbar_kws={"label": "p-value"})
    ax.set_title(f"Pairwise Wilcoxon p-values — {convert_label(channel)} "
                 f"({metric.upper()})")
    fig.tight_layout()
    return p_values, fig


def error_correlation_matrix(csv_paths: list[str], names: list[str],
                             channel: str, metric: str = "mae"):
    """Sample-wise error Pearson-correlation matrix (do models fail on the
    same tiles?) with the upper triangle masked (reference
    3_Statistical_Comparison.py:358-396)."""
    import seaborn as sns

    pivot = _sample_errors(csv_paths, names, channel, metric)
    corr = pivot.corr(method="pearson")
    mask = np.triu(np.ones_like(corr, dtype=bool))
    fig, ax = _styled_ax(figsize=(2 + 1.6 * len(names), 1.5 + 1.4 * len(names)))
    ax.grid(False)
    sns.heatmap(corr, mask=mask, annot=True, fmt=".2f", cmap="coolwarm",
                vmin=-1, vmax=1, ax=ax, cbar_kws={"label": "Pearson r"})
    ax.set_title(f"Sample-wise error correlation — {convert_label(channel)}")
    fig.tight_layout()
    return corr, fig


def _quadrants(h: int, w: int) -> dict[str, tuple[int, int, int, int]]:
    return {
        "Top-Left": (0, h // 2, 0, w // 2),
        "Top-Right": (0, h // 2, w // 2, w),
        "Bottom-Left": (h // 2, h, 0, w // 2),
        "Bottom-Right": (h // 2, h, w // 2, w),
    }


def plot_zoomed_views(gt_img: np.ndarray, pred_img: np.ndarray,
                      title_prefix: str, error: bool = False):
    """4 zoomed quadrants of GT vs prediction (reference
    app_src/utils.py:105-134; error=True adds a signed-error column,
    :171-231)."""
    plt = _pyplot()
    h, w = gt_img.shape
    ncols = 3 if error else 2
    fig, axes = plt.subplots(4, ncols, figsize=(3 * ncols, 12))
    fig.suptitle(f"Zoomed quadrants — {title_prefix}", fontsize=14)
    for i, (name, (y1, y2, x1, x2)) in enumerate(_quadrants(h, w).items()):
        panels = [(gt_img, f"GT {name}", "viridis", None),
                  (pred_img, f"Pred {name}", "viridis", None)]
        if error:
            diff = pred_img - gt_img
            vmax = float(np.abs(diff).max()) or 1.0
            panels.append((diff, f"Error {name}", "coolwarm", vmax))
        for j, (img, title, cmap, vmax) in enumerate(panels):
            ax = axes[i, j]
            kw = {"vmin": -vmax, "vmax": vmax} if vmax else {}
            im = ax.imshow(img[y1:y2, x1:x2], cmap=cmap, **kw)
            ax.set_title(title, fontsize=9)
            ax.axis("off")
            fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.tight_layout(rect=[0, 0, 1, 0.96])
    return fig


def plot_zoomed_comparison(gt_img: np.ndarray, pred_imgs: list[np.ndarray],
                           pred_names: list[str], title_prefix: str):
    """4 zoomed quadrants of GT vs several models' predictions side-by-side
    (reference app_src/utils.py:136-169)."""
    plt = _pyplot()
    h, w = gt_img.shape
    ncols = 1 + len(pred_imgs)
    fig, axes = plt.subplots(4, ncols, figsize=(3 * ncols, 12), squeeze=False)
    fig.suptitle(f"Zoomed quadrants — {title_prefix}", fontsize=14)
    for i, (name, (y1, y2, x1, x2)) in enumerate(_quadrants(h, w).items()):
        im = axes[i][0].imshow(gt_img[y1:y2, x1:x2], cmap="viridis")
        axes[i][0].set_title(f"GT {name}", fontsize=9)
        axes[i][0].axis("off")
        fig.colorbar(im, ax=axes[i][0], fraction=0.046, pad=0.04)
        for j, (pred, pname) in enumerate(zip(pred_imgs, pred_names)):
            ax = axes[i][j + 1]
            im = ax.imshow(pred[y1:y2, x1:x2], cmap="viridis")
            ax.set_title(f"{pname[:12]} {name}", fontsize=9)
            ax.axis("off")
            fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.tight_layout(rect=[0, 0, 1, 0.96])
    return fig


def plot_dataset_geomap(df):
    """Dataset geo-distribution: world-extent lat/lon scatter, colored by
    split, sized by per-city sample count, from a DataFrame with split,
    city, lat and lon columns (stands in for the reference's leafmap page,
    app_dev/pages/3_Dataset.py)."""
    counts = (df.groupby(["split", "city", "lat", "lon"]).size()
              .rename("samples").reset_index())
    fig, ax = _styled_ax(figsize=(12, 6))
    for i, (split, g) in enumerate(counts.groupby("split")):
        ax.scatter(g["lon"], g["lat"], s=18 + 6 * g["samples"],
                   color=PALETTE[i % len(PALETTE)], alpha=0.75, label=split,
                   edgecolors="black", linewidths=0.4)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-65, 80)
    ax.set_xlabel("Longitude (°)")
    ax.set_ylabel("Latitude (°)")
    ax.set_title(f"Dataset geo-distribution — {counts['city'].nunique()} "
                 f"cities, {int(counts['samples'].sum())} samples")
    ax.legend()
    fig.tight_layout()
    return fig


def plot_architecture_diagram(hp: dict):
    """Rendered U-Net / U-Net++ architecture diagram: encoder/decoder boxes
    with channel widths plus the embedding branches fused at the bottleneck
    (U-Net) or every decoder node (U-Net++).  Matplotlib stand-in for the
    reference's interactive streamlit-flow diagram
    (app_dev/app_src/model_diagram.py:8-222)."""
    plt = _pyplot()
    bf = int(hp.get("base_filters", 64))
    model_type = hp.get("model_type", "unet")
    filters = [bf * 2 ** i for i in range(5)]
    temporal = bool(hp.get("temporal_embeddings", True))
    meta = bool(hp.get("metadata_embeddings", True))

    fig, ax = plt.subplots(figsize=(12, 7))
    ax.axis("off")

    def box(x, y, text, color, w=1.6, h=0.7):
        ax.add_patch(plt.Rectangle((x - w / 2, y - h / 2), w, h,
                                   facecolor=color, edgecolor="black",
                                   linewidth=1, zorder=2))
        ax.text(x, y, text, ha="center", va="center", fontsize=8, zorder=3)
        return x, y

    def arrow(p1, p2, style="-"):
        ax.annotate("", xy=p2, xytext=p1, zorder=1,
                    arrowprops=dict(arrowstyle="->", linestyle=style,
                                    color="gray", lw=1.2))

    enc_color, dec_color, emb_color = "#cfe3f7", "#d8f0d3", "#fde6c4"
    # encoder column going down, decoder column going up
    prev = box(1.5, 5 - 0, "Input\n(H,W,23)", "#eeeeee")
    enc_pos = []
    for i, f in enumerate(filters[:4]):
        p = box(2.5 + i * 0.0, 4 - i, f"conv{i}_0\n{f}ch", enc_color)
        arrow(prev, p)
        enc_pos.append(p)
        prev = p
    bott = box(4.5, 0, f"bottleneck\nconv4_0 {filters[4]}ch", enc_color)
    arrow(prev, bott)

    y_emb = -1.2
    if temporal:
        t = box(1.2, y_emb, f"LSTM {hp.get('lstm_hidden', 96)}h\n→"
                            f"{hp.get('temporal_dim', 64)}d", emb_color)
        arrow(t, bott, style="--")
    if meta:
        m = box(3.0, y_emb, f"MLP meta\n→{hp.get('meta_dim', 64)}d", emb_color)
        arrow(m, bott, style="--")

    prev = bott
    for i in reversed(range(4)):
        p = box(6.5, 4 - i, f"conv{i}_1\n{filters[i]}ch ↑2", dec_color)
        arrow(prev, p)
        arrow(enc_pos[i], p, style=":")  # skip connection
        if model_type != "unet" and (temporal or meta):
            ax.text(p[0] + 1.0, p[1], "+emb", fontsize=7, color="#b07020")
        prev = p
    out = box(8.0, 5, "1×1 conv\nNDVI:tanh LST:id", "#eeeeee")
    arrow(prev, out)

    extra = " (dense grid, per-node fusion)" if model_type != "unet" else ""
    ax.set_title(f"{model_type} — base_filters={bf}{extra}", fontsize=12)
    ax.set_xlim(0, 9.5)
    ax.set_ylim(-2.2, 6)
    return fig
