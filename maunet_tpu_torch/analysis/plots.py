"""Styled plotting for sensitivity analyses.

A copy of ``maunet_tpu/analysis/plots.py`` whose per-sample figure takes the
sweep's row dicts in place of a DataFrame (the port does not depend on pandas).
Capability parity with the reference's "BeautifulFigures"-derived styling
(src/utils/plot_utils.py:11-135: monospace fonts, major+minor grids, TrueType
PDF fonts) and the sensitivity figure set (test/metadata_sensitivity.py:
447-623: average curves with ±1σ bands, per-sample best/worst overlays, and
lat-lon heatmaps with the original location marked).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

PALETTE = ["#2D3142", "#E1DAAE", "#058ED9", "#848FA2", "#CC2D35"]


def available() -> bool:
    """Whether matplotlib can be imported here (the GPU host may lack it)."""
    return importlib.util.find_spec("matplotlib") is not None


def _styled_ax(figsize=(10, 6)):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({
        "font.family": "monospace",
        "font.size": 14,
        "pdf.fonttype": 42,
        "ps.fonttype": 42,
        "axes.grid": True,
        "grid.alpha": 0.4,
    })
    fig, ax = plt.subplots(figsize=figsize)
    ax.grid(which="major", alpha=0.5)
    ax.grid(which="minor", alpha=0.2)
    ax.minorticks_on()
    return fig, ax


def convert_label(label: str) -> str:
    """Humanize channel/metric labels (reference src/utils/plot_utils.py:62-83)."""
    mapping = {
        "after_ndvi": "NDVI", "after_temp": "LST (°C)",
        "latitude": "Latitude (°)", "longitude": "Longitude (°)",
        "mae": "MAE", "rmse": "RMSE",
    }
    return mapping.get(label, label.replace("_", " ").title())


def plot_average_sensitivity(export: dict, output_dir: str) -> list[str]:
    import matplotlib.pyplot as plt

    paths = []
    for sweep_name, sweep in export["sweeps"].items():
        x = np.asarray(sweep["x"])
        for ch, curves in sweep["channels"].items():
            mean = np.asarray(curves["mean"])
            std = np.asarray(curves["std"])
            fig, ax = _styled_ax()
            ax.plot(x, mean, color=PALETTE[2], lw=2, label="Mean response")
            ax.fill_between(x, mean - std, mean + std, color=PALETTE[2],
                            alpha=0.25, label="±1σ")
            ax.set_xlabel(convert_label(sweep_name))
            ax.set_ylabel(convert_label(ch))
            ax.set_title(f"Average {convert_label(ch)} sensitivity to "
                         f"{convert_label(sweep_name)}\n({export['model_name']})")
            ax.legend()
            path = os.path.join(
                output_dir,
                f"avg_sensitivity_{sweep_name}_{ch}_{export['model_name']}.pdf")
            fig.savefig(path, bbox_inches="tight")
            fig.savefig(path[:-4] + ".png", bbox_inches="tight", dpi=110)
            plt.close(fig)
            paths.append(path)
    return paths


def plot_individual_sensitivity(rows: list[dict], sweep_name: str,
                                channels: list[str], output_dir: str) -> list[str]:
    """One figure per channel: each highlighted sample's sweep, from rows
    ``{"sample_label", sweep_name, channel: value, ...}`` (samples in label
    order, as a DataFrame ``groupby`` gives them)."""
    import matplotlib.pyplot as plt

    paths = []
    xcol = sweep_name
    for ch in channels:
        if not any(ch in r for r in rows):
            continue
        fig, ax = _styled_ax(figsize=(12, 7))
        labels = sorted({r["sample_label"] for r in rows})
        for i, label in enumerate(labels):
            group = [r for r in rows if r["sample_label"] == label and ch in r]
            color = PALETTE[i % len(PALETTE)]
            style = "-" if str(label).startswith("Best") else "--"
            ax.plot([r[xcol] for r in group], [r[ch] for r in group], style,
                    color=color, lw=1.5, label=str(label), alpha=0.9)
        ax.set_xlabel(convert_label(xcol))
        ax.set_ylabel(convert_label(ch))
        ax.set_title(f"{convert_label(ch)} sensitivity per sample")
        ax.legend(fontsize=8, ncol=2)
        path = os.path.join(output_dir, f"individual_sensitivity_{sweep_name}_{ch}.pdf")
        fig.savefig(path, bbox_inches="tight")
        fig.savefig(path[:-4] + ".png", bbox_inches="tight", dpi=110)
        plt.close(fig)
        paths.append(path)
    return paths


def plot_heatmaps(export: dict, output_dir: str) -> list[str]:
    import matplotlib.pyplot as plt

    paths = []
    for idx, hm in export.get("heatmaps", {}).items():
        for ch, data in hm["channels"].items():
            fig, ax = _styled_ax(figsize=(10, 7))
            vals = np.asarray(data["values"])
            im = ax.imshow(
                vals, origin="lower", aspect="auto", cmap="coolwarm",
                extent=[data["lons"][0], data["lons"][-1],
                        data["lats"][0], data["lats"][-1]])
            ax.plot(hm["orig_lon"], hm["orig_lat"], marker="*", ms=18,
                    color="black", mec="white", label="Original location")
            ax.set_xlabel("Longitude (°)")
            ax.set_ylabel("Latitude (°)")
            ax.set_title(f"{convert_label(ch)} response — {hm['sample_label']}")
            fig.colorbar(im, ax=ax)
            ax.legend()
            path = os.path.join(output_dir, f"heatmap_sample{idx}_{ch}.pdf")
            fig.savefig(path, bbox_inches="tight")
            fig.savefig(path[:-4] + ".png", bbox_inches="tight", dpi=110)
            plt.close(fig)
            paths.append(path)
    return paths
