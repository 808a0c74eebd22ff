"""Cross-model sensitivity comparison.

A copy of ``maunet_tpu/analysis/compare.py`` on the port's ``plots``.
Capability parity with reference test/compare_sensitivity.py:20-191: loads
every ``sensitivity_data_*.json`` in a directory (model sweeps and the
ground-truth export share one schema) and overlays mean±σ response curves
per sweep/channel across models, plus average heatmaps per model.
"""

from __future__ import annotations

import glob
import json
import logging
import os

import numpy as np

from maunet_tpu_torch.analysis.plots import PALETTE, _styled_ax, convert_label

log = logging.getLogger(__name__)


def load_sensitivity_files(data_dir: str) -> list[dict]:
    files = sorted(glob.glob(os.path.join(data_dir, "sensitivity_data_*.json")))
    out = []
    for f in files:
        try:
            with open(f) as fh:
                out.append(json.load(fh))
        except (OSError, json.JSONDecodeError) as e:
            log.warning(f"Skipping {f}: {e}")
    return out


def compare_sensitivity(data_dir: str,
                        output_dir: str = "reports/sensitivity/comparison") -> list[str]:
    import matplotlib.pyplot as plt

    datasets = load_sensitivity_files(data_dir)
    if not datasets:
        log.warning(f"No sensitivity_data_*.json found in {data_dir}")
        return []
    os.makedirs(output_dir, exist_ok=True)
    paths = []

    sweep_names = {k for d in datasets for k in d.get("sweeps", {})}
    channels = {ch for d in datasets for s in d.get("sweeps", {}).values()
                for ch in s.get("channels", {})}

    for sweep_name in sorted(sweep_names):
        for ch in sorted(channels):
            fig, ax = _styled_ax(figsize=(11, 7))
            plotted = False
            for i, d in enumerate(datasets):
                sweep = d.get("sweeps", {}).get(sweep_name)
                if not sweep or ch not in sweep.get("channels", {}):
                    continue
                x = np.asarray(sweep["x"], dtype=float)
                mean = np.asarray(sweep["channels"][ch]["mean"], dtype=float)
                std = np.asarray(sweep["channels"][ch]["std"], dtype=float)
                name = d.get("model_name", f"model{i}")
                color = PALETTE[i % len(PALETTE)]
                style = ":" if name == "ground_truth" else "-"
                ax.plot(x, mean, style, color=color, lw=2, label=name)
                ax.fill_between(x, mean - std, mean + std, color=color, alpha=0.15)
                plotted = True
            if not plotted:
                plt.close(fig)
                continue
            ax.set_xlabel(convert_label(sweep_name))
            ax.set_ylabel(convert_label(ch))
            ax.set_title(f"{convert_label(ch)} sensitivity to "
                         f"{convert_label(sweep_name)} across models")
            ax.legend()
            path = os.path.join(output_dir, f"compare_{sweep_name}_{ch}.pdf")
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
            paths.append(path)

    # average heatmaps per model
    for i, d in enumerate(datasets):
        heatmaps = d.get("heatmaps") or {}
        if not heatmaps:
            continue
        by_channel: dict[str, list] = {}
        lats = lons = None
        for hm in heatmaps.values():
            for ch, data in hm["channels"].items():
                by_channel.setdefault(ch, []).append(np.asarray(data["values"]))
                lats, lons = data["lats"], data["lons"]
        for ch, stack in by_channel.items():
            avg = np.mean(np.stack(stack), axis=0)
            fig, ax = _styled_ax(figsize=(10, 7))
            im = ax.imshow(avg, origin="lower", aspect="auto", cmap="coolwarm",
                           extent=[lons[0], lons[-1], lats[0], lats[-1]])
            ax.set_xlabel("Longitude (°)")
            ax.set_ylabel("Latitude (°)")
            ax.set_title(f"Average {convert_label(ch)} response — "
                         f"{d.get('model_name', f'model{i}')}")
            fig.colorbar(im, ax=ax)
            path = os.path.join(
                output_dir, f"avg_heatmap_{d.get('model_name', i)}_{ch}.pdf")
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
            paths.append(path)

    log.info(f"Wrote {len(paths)} comparison figures to {output_dir}")
    return paths
