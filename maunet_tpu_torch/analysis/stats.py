"""Statistical interpretation and model comparison over evaluation CSVs.

Capability parity with reference test/statistical_tests.py:
- single CSV → threshold-based quality interpretation per
  (known/unknown × temporal distance × channel): LST MAE <2 °C excellent /
  <4 good; NDVI MAE <0.05 / <0.1; Laplacian smoothness ratio 0.5–1.5
  realistic (reference :23-88);
- ≥2 CSVs → paired t-tests per (known, temporal distance, channel, DW class)
  with winner calls at p<0.05 (reference :91-168).

Returns structured results (list of row dicts / DataFrame) in addition to
printing, so the research app can reuse them.

A copy of ``maunet_tpu/analysis/stats.py`` that imports pandas and scipy
inside the functions that use them, so the port's modules import without
them; the return types are the JAX package's.
"""

from __future__ import annotations

import logging
import os
from itertools import combinations

log = logging.getLogger(__name__)


def get_temporal_distance(t1_year: int) -> str:
    """(reference test/statistical_tests.py:12-20)"""
    if t1_year <= 2021:
        return "long_distance"
    if t1_year in (2022, 2023):
        return "mid_distance"
    if t1_year > 2023:
        return "short_distance"
    return "other"


def _with_groups(df):
    df = df.copy()
    if "is_known_city" not in df.columns:
        df["is_known_city"] = True
    if "t1_year" in df.columns:
        df["temporal_distance"] = df["t1_year"].apply(get_temporal_distance)
    else:
        df["temporal_distance"] = "not_available"
    return df


def interpret_channel(channel: str, mae: float) -> str:
    if "temp" in channel:
        if mae < 2.0:
            return "excellent"
        return "good" if mae < 4.0 else "needs_improvement"
    if "ndvi" in channel:
        if mae < 0.05:
            return "excellent"
        return "good" if mae < 0.1 else "needs_improvement"
    return "unknown_channel"


def interpret_smoothness(ratio: float) -> str:
    if ratio > 1.5:
        return "noisy"
    if ratio < 0.5:
        return "over_smooth"
    return "realistic"


def interpret_metrics(csv_path_or_df, model_name: str | None = None,
                      output_dir: str | None = None) -> list[dict]:
    """Single-model interpretation; returns one row per
    (is_known, temporal_distance, channel)."""
    import pandas as pd

    if isinstance(csv_path_or_df, pd.DataFrame):
        df = csv_path_or_df
        model_name = model_name or "model"
    else:
        df = pd.read_csv(csv_path_or_df)
        model_name = model_name or os.path.basename(
            str(csv_path_or_df)).replace("_evaluation.csv", "")
    df = _with_groups(df)

    rows = []
    for (is_known, temp_dist), group in df.groupby(["is_known_city", "temporal_distance"]):
        overall = (group[group["dw_class"] == "overall"]
                   .groupby("channel")[["mae", "rmse", "laplacian_var_pred",
                                        "laplacian_var_gt"]].mean())
        for channel, r in overall.iterrows():
            row = {
                "model": model_name,
                "is_known_city": bool(is_known),
                "temporal_distance": temp_dist,
                "channel": channel,
                "mae": r["mae"],
                "rmse": r["rmse"],
                "quality": interpret_channel(channel, r["mae"]),
            }
            if pd.notna(r["laplacian_var_pred"]) and pd.notna(r["laplacian_var_gt"]) \
                    and r["laplacian_var_gt"] > 0:
                ratio = r["laplacian_var_pred"] / r["laplacian_var_gt"]
                row["smoothness_ratio"] = ratio
                row["smoothness"] = interpret_smoothness(ratio)
            rows.append(row)
            log.info(f"{model_name} | {'known' if is_known else 'unknown'} | "
                     f"{temp_dist} | {channel}: MAE={r['mae']:.4f} "
                     f"RMSE={r['rmse']:.4f} → {row['quality']}"
                     + (f", smoothness={row.get('smoothness')}" if "smoothness" in row else ""))

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        pd.DataFrame(rows).to_csv(
            os.path.join(output_dir, f"{model_name}_interpretation.csv"), index=False)
    return rows


def comparative_analysis(csv_paths: list, model_names: list[str] | None = None,
                         output_dir: str | None = None,
                         alpha: float = 0.05):
    """Pairwise paired t-tests between model evaluation CSVs
    (reference test/statistical_tests.py:91-168); a DataFrame."""
    import pandas as pd
    from scipy.stats import ttest_rel

    dfs, names = [], []
    for i, p in enumerate(csv_paths):
        df = p if isinstance(p, pd.DataFrame) else pd.read_csv(p)
        name = (model_names[i] if model_names else
                os.path.basename(str(p)).replace("_evaluation.csv", ""))
        df = _with_groups(df)
        df["model"] = name
        dfs.append(df)
        names.append(name)

    merged = pd.concat(dfs, ignore_index=True)
    pivot = merged.pivot_table(
        index=["is_known_city", "temporal_distance", "sample_idx", "channel", "dw_class"],
        columns="model", values=["mae", "rmse"])

    results = []
    for m1, m2 in combinations(names, 2):
        for metric in ("mae", "rmse"):
            cols = [(metric, m1), (metric, m2)]
            compare = pivot[cols].dropna()
            if compare.empty:
                continue
            for key, group in compare.groupby(
                    ["is_known_city", "temporal_distance", "channel", "dw_class"]):
                s1, s2 = group[cols[0]], group[cols[1]]
                if len(s1) < 2:
                    continue
                try:
                    stat, p_value = ttest_rel(s1, s2, nan_policy="omit")
                except ValueError:
                    continue
                mean_diff = s1.mean() - s2.mean()
                winner = "insignificant"
                if p_value < alpha:
                    winner = m2 if mean_diff > 0 else m1  # lower is better
                results.append({
                    "model_1": m1, "model_2": m2, "metric": metric,
                    "is_known_city": key[0], "temporal_distance": key[1],
                    "channel": key[2], "dw_class": key[3],
                    "n": len(s1), "mean_diff": mean_diff,
                    "t_stat": float(stat), "p_value": float(p_value),
                    "winner": winner,
                })

    out = pd.DataFrame(results)
    if not out.empty:
        sig = out[out["winner"] != "insignificant"]
        log.info(f"Paired t-tests: {len(out)} comparisons, "
                 f"{len(sig)} significant at p<{alpha}.")
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        out.to_csv(os.path.join(output_dir, "comparative_ttests.csv"), index=False)
    return out


def nonparametric_tests(csv_paths: list, model_names: list[str] | None = None,
                        metric: str = "mae", alpha: float = 0.05):
    """Wilcoxon signed-rank + Mann-Whitney U + Pearson correlation between
    model pairs on overall per-sample metrics — the research app's
    statistical-comparison page (reference
    app_dev/pages/3_Statistical_Comparison.py); a DataFrame."""
    import pandas as pd
    from scipy.stats import mannwhitneyu, pearsonr, wilcoxon

    frames, names = [], []
    for i, p in enumerate(csv_paths):
        df = p if isinstance(p, pd.DataFrame) else pd.read_csv(p)
        name = (model_names[i] if model_names else
                os.path.basename(str(p)).replace("_evaluation.csv", ""))
        overall = df[df["dw_class"] == "overall"]
        frames.append(overall.set_index(["sample_idx", "channel"])[metric]
                      .rename(name))
        names.append(name)

    results = []
    for m1, m2 in combinations(names, 2):
        joined = pd.concat([frames[names.index(m1)], frames[names.index(m2)]],
                           axis=1).dropna()
        if len(joined) < 3:
            continue
        a, b = joined[m1].values, joined[m2].values
        row = {"model_1": m1, "model_2": m2, "metric": metric, "n": len(a)}
        try:
            _, row["wilcoxon_p"] = wilcoxon(a, b)
        except ValueError:
            row["wilcoxon_p"] = float("nan")
        _, row["mannwhitney_p"] = mannwhitneyu(a, b)
        row["pearson_r"], row["pearson_p"] = pearsonr(a, b)
        row["significant"] = bool(row["wilcoxon_p"] < alpha) \
            if pd.notna(row["wilcoxon_p"]) else False
        results.append(row)
    return pd.DataFrame(results)
