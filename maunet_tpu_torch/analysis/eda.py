"""Dataset EDA: per-sample metrics, their correlation analysis, and a
one-sample figure.

The port's copy of ``maunet_tpu/analysis/eda.py`` (reference
src/utils/visualize_npz.py):

- ``extract_metrics_csv``: one row per ``.npz`` sample of every split:
  per-channel statistics, Dynamic World class proportions and entropy at t1
  and t2, per-class change, the CRU series' trend slope, lag-12
  autocorrelation and annual FFT amplitude, and the deltas between the t1
  inputs and the t2 targets (reference ``extract_metrics`` :19-134);
- ``analyze_csv``: Pearson correlations between land-cover change and the
  LST and NDVI deltas (reference ``analyze_csv`` :783-811);
- ``visualize_sample``: one sample's channels in one figure (reference
  ``visualize`` :136-255).

pandas, scipy and matplotlib are imported inside the functions that use
them; ``extract_metrics_csv`` and ``analyze_csv`` need no matplotlib.
"""

from __future__ import annotations

import os

import numpy as np

from maunet_tpu_torch.data.dataset import NpzDataset
from maunet_tpu_torch.data.schema import parse_sample_filename
from maunet_tpu_torch.utils.dw import DW_CLASSES, dw_to_rgb
from maunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _series_features(series: np.ndarray) -> dict:
    s = np.asarray(series, dtype=np.float64)
    n = len(s)
    out = {"temp_series_mean": float(s.mean()) if n else np.nan,
           "temp_series_std": float(s.std()) if n else np.nan}
    if n >= 2:
        x = np.arange(n)
        out["temp_series_slope"] = float(np.polyfit(x, s, 1)[0])
    else:
        out["temp_series_slope"] = np.nan
    if n > 24 and s.std() > 0:
        a = s - s.mean()
        out["temp_series_autocorr12"] = float(
            np.corrcoef(a[:-12], a[12:])[0, 1])
        spectrum = np.abs(np.fft.rfft(a))
        freqs = np.fft.rfftfreq(n)
        annual = np.argmin(np.abs(freqs - 1.0 / 12.0))
        out["temp_series_seasonal_amp"] = float(spectrum[annual] / n * 2)
    else:
        out["temp_series_autocorr12"] = np.nan
        out["temp_series_seasonal_amp"] = np.nan
    return out


def extract_sample_metrics(sample: dict, filename: str) -> dict:
    maps, target = sample["maps"], sample["targets"]  # HWC
    info = parse_sample_filename(filename)
    row: dict = {"file": os.path.basename(filename), **info}

    dw_t1 = maps[..., :9]
    dw_t2 = maps[..., 14:23]
    for tag, dw in [("t1", dw_t1), ("t2", dw_t2)]:
        props = dw.mean(axis=(0, 1))
        for k, name in DW_CLASSES.items():
            row[f"dw_{tag}_prop_{name}"] = float(props[k])
        p = props[props > 0]
        row[f"dw_{tag}_entropy"] = float(-(p * np.log(p)).sum())
    change = np.abs(dw_t2 - dw_t1).mean(axis=(0, 1))
    for k, name in DW_CLASSES.items():
        row[f"dw_change_{name}"] = float(change[k])
    row["dw_change_max"] = float(change.max())

    for name, arr in [("rgb", maps[..., 9:12]), ("ndvi_t1", maps[..., 12]),
                      ("lst_t1", maps[..., 13]), ("ndvi_t2", target[..., 0]),
                      ("lst_t2", target[..., 1])]:
        row[f"{name}_mean"] = float(np.mean(arr))
        row[f"{name}_std"] = float(np.std(arr))

    row["delta_ndvi_mean"] = float(np.mean(target[..., 0] - maps[..., 12]))
    row["delta_lst_mean"] = float(np.mean(target[..., 1] - maps[..., 13]))
    row["delta_ndvi_l1"] = float(np.mean(np.abs(target[..., 0] - maps[..., 12])))
    row["delta_lst_l1"] = float(np.mean(np.abs(target[..., 1] - maps[..., 13])))

    length = int(sample["temp_lengths"])
    row.update(_series_features(sample["temp_series"][:length]))
    return row


def extract_metrics_csv(data_dir: str, out_csv: str,
                        temporal_length: int = 828):
    """Write the per-sample metrics of ``data_dir``'s splits to ``out_csv``;
    returns them as a DataFrame."""
    import pandas as pd

    rows = []
    for split in ("train", "val", "test"):
        split_dir = os.path.join(data_dir, split)
        if not os.path.isdir(split_dir):
            continue
        ds = NpzDataset(split_dir, temporal_length=temporal_length)
        for i in range(len(ds)):
            row = extract_sample_metrics(ds[i], ds.files[i])
            row["split"] = split
            rows.append(row)
    df = pd.DataFrame(rows)
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    df.to_csv(out_csv, index=False)
    log.success(f"Extracted {len(df)} sample rows → {out_csv}")
    return df


def analyze_csv(csv_path: str):
    """Pearson correlations between land-cover change and target deltas
    (reference analyze_csv :783-811, e.g. built-area change vs ΔLST), as a
    DataFrame sorted by p-value."""
    import pandas as pd
    from scipy import stats as sstats

    df = pd.read_csv(csv_path)
    pairs = []
    targets = ["delta_lst_mean", "delta_ndvi_mean"]
    drivers = [c for c in df.columns if c.startswith("dw_change_")]
    drivers += ["temp_series_slope", "dw_t1_entropy"]
    for t in targets:
        for d in drivers:
            sub = df[[t, d]].dropna()
            if len(sub) < 3 or sub[d].std() == 0 or sub[t].std() == 0:
                continue
            r, p = sstats.pearsonr(sub[d], sub[t])
            pairs.append({"driver": d, "target": t, "pearson_r": r,
                          "p_value": p, "n": len(sub)})
    out = pd.DataFrame(pairs).sort_values("p_value")
    for _, row in out.head(10).iterrows():
        log.info(f"{row['driver']} → {row['target']}: "
                 f"r={row['pearson_r']:+.3f} (p={row['p_value']:.3g}, n={row['n']})")
    return out


def visualize_sample(npz_path: str, out_path: str | None = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(npz_path) as data:
        maps = data["input"].transpose(1, 2, 0)
        target = data["target"].transpose(1, 2, 0)
        series = data["temperature_serie"]

    fig, axes = plt.subplots(2, 4, figsize=(22, 10))
    panels = [
        (dw_to_rgb(np.argmax(maps[..., :9], -1)), "DW t1", {}),
        (np.clip(maps[..., 9:12] * 0.2 + 0.4, 0, 1), "RGB t1 (approx)", {}),
        (maps[..., 12], "NDVI t1", dict(cmap="RdYlGn", vmin=-1, vmax=1)),
        (maps[..., 13], "LST t1 (z)", dict(cmap="inferno")),
        (dw_to_rgb(np.argmax(maps[..., 14:23], -1)), "DW t2", {}),
        (target[..., 0], "NDVI t2 (target)", dict(cmap="RdYlGn", vmin=-1, vmax=1)),
        (target[..., 1], "LST t2 (target, z)", dict(cmap="inferno")),
    ]
    for ax, (img, title, kw) in zip(axes.ravel(), panels):
        im = ax.imshow(img, **kw)
        ax.set_title(title)
        ax.axis("off")
        if kw:
            plt.colorbar(im, ax=ax, fraction=0.045)
    ax = axes.ravel()[-1]
    ax.plot(series, lw=0.7)
    ax.set_title(f"CRU temperature series (n={len(series)})")
    fig.suptitle(os.path.basename(npz_path))
    fig.tight_layout()
    out_path = out_path or npz_path.replace(".npz", "_viz.png")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    log.success(f"Sample visualization → {out_path}")
    return out_path
