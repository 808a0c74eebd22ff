"""End-to-end ablation science loop on a planted-signal synthetic dataset.

The reference's entire reason to exist is "metadata/temporal embeddings
improve LST prediction" (reports/tests/app/metrics_results/all_all.csv:
metaemb 5.33 °C vs noemb 7.11 °C MAE).  The real GEE dataset is unreachable
from this environment, so this module proves the full scientific loop on an
attainable dataset with a *planted* signal (VERDICT r2 next #3):

1. generate a synthetic dataset whose LST target contains a metadata-
   dependent offset (∝ z-scored latitude) and a temporal-series-dependent
   offset (∝ recent CRU mean) that the spatial input cannot explain
   (data/synthetic.py make_sample);
2. train the four reference ablation variants — noemb / metaemb / tempemb /
   emb (study-suffix encoding, reference src/train.py:79-87) — to
   convergence;
3. evaluate each on the test split (reference-schema CSVs);
4. run the statistical comparison (paired t-tests + Wilcoxon/Mann-Whitney,
   reference test/statistical_tests.py:91-168) — the emb variants must beat
   noemb significantly;
5. run the metadata sensitivity sweep on the full-embedding checkpoint and
   the ground-truth binning — the latitude response curve must recover the
   planted slope (reference test/metadata_sensitivity.py +
   generate_ground_truth_sensitivity.py);
6. write reports/science/summary.json + a human-readable report.

Run: ``python -m maunet_tpu_torch.analysis.science --work-dir reports/science``
(on the card unless ``--device`` says otherwise).

The port of ``maunet_tpu/analysis/science.py`` onto the port's
``generate_dataset``, ``Trainer``, ``evaluate_checkpoint``, sweeps and
``stats``, with the same defaults and the same summary; there is no mesh.
pandas is imported inside the functions that read the CSVs.  Where
matplotlib is not installed the metadata sweeps write their JSONs only and
the cross-model comparison figures are skipped, each with a logged line.

Fixture notes (learned the hard way, rounds 3-4): latitude must carry real
per-sample spread — with one latitude per city the lat/lon/pop features are
perfectly collinear and the model can attribute the planted offset to any
of them, flattening the latitude-only sweep.  And because the metadata MLP
ingests RAW year features (~2020; parity with reference src/train.py:244 —
no date normalization there either), the planted signal needs to be strong
(default gain 1.5) and training long enough for the latitude weight to grow
against that conditioning.  The temporal (LSTM) channel learns SLOWER than
the metadata MLP: at 32 epochs (round 3) tempemb scored zero significant
wins, and at temporal gain 1.0 / 48 epochs it still lost to noemb on the
full fixture (the planted metadata offset, σ≈1.65 z-units of unexplained
LST, drowns the LSTM's slow learning).  A controlled probe matrix
(reports/science_probe) found the working recipe: temporal gain 1.5 (equal
to the metadata gain) at 64 epochs gives tempemb 17 significant paired-t
LST wins over noemb (MAE 10.00 vs 10.39 °C, val 0.778 vs 0.880) — hence
the gain-1.5 / 64-epoch defaults.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from maunet_tpu_torch.train.config import TrainConfig

log = logging.getLogger(__name__)

# study-name suffix encoding of the ablation (reference src/train.py:79-87)
VARIANTS: dict[str, tuple[bool, bool]] = {
    "noemb": (False, False),
    "tempemb": (True, False),
    "metaemb": (False, True),
    "emb": (True, True),
}


def _science_config(temporal: bool, metadata: bool, hw: int,
                    temporal_len: int, base_filters: int,
                    batch_size: int, epochs: int) -> TrainConfig:
    return TrainConfig(
        batch_size=batch_size,
        base_filters=base_filters,
        temporal_dim=16,
        meta_dim=16,
        lstm_hidden=32,
        learning_rate=2e-3,
        weight_decay=1e-5,
        optimizer="adamw",
        gradient_clipping=1.0,
        loss="mse",
        epochs=epochs,
        temporal_embeddings=temporal,
        metadata_embeddings=metadata,
        temporal_length=temporal_len,
        frequency_plt=0,
    )


def _lst_mae(csv_path: str) -> float:
    import pandas as pd

    df = pd.read_csv(csv_path)
    sub = df[(df["channel"] == "after_temp") & (df["dw_class"] == "overall")]
    return float(sub["mae"].mean())


def _ndvi_mae(csv_path: str) -> float:
    import pandas as pd

    df = pd.read_csv(csv_path)
    sub = df[(df["channel"] == "after_ndvi") & (df["dw_class"] == "overall")]
    return float(sub["mae"].mean())


def _sweep_response(sensitivity_json: str, sweep_key: str,
                    slope_name: str) -> dict:
    """Slope statistics of a sweep for the LST channel."""
    with open(sensitivity_json) as f:
        data = json.load(f)
    sweep = data["sweeps"][sweep_key]
    x = np.asarray(sweep["x"], dtype=float)
    mean = np.asarray(sweep["channels"]["after_temp"]["mean"], dtype=float)
    ok = np.isfinite(mean)  # GT binning leaves empty bins as NaN
    x, mean = x[ok], mean[ok]
    if len(x) < 3 or np.ptp(mean) == 0:
        return {slope_name: 0.0, "pearson_r": 0.0, "range": 0.0,
                "n_bins": int(len(x))}
    slope = float(np.polyfit(x, mean, 1)[0])
    r = float(np.corrcoef(x, mean)[0, 1])
    return {slope_name: slope, "pearson_r": r,
            "range": float(mean.max() - mean.min()), "n_bins": int(len(x))}


def _lat_response(sensitivity_json: str) -> dict:
    return _sweep_response(sensitivity_json, "latitude", "slope_per_degree")


def _temporal_response(sensitivity_json: str) -> dict:
    return _sweep_response(sensitivity_json, "temporal_offset",
                           "slope_per_zunit")


def run_science_loop(
    work_dir: str = "reports/science",
    hw: int = 64,
    temporal_len: int = 828,
    base_filters: int = 16,
    batch_size: int = 8,
    epochs: int = 64,
    samples: dict | None = None,
    meta_signal: float = 1.5,
    temporal_signal: float = 1.5,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    from maunet_tpu_torch.analysis import plots
    from maunet_tpu_torch.analysis.compare import compare_sensitivity
    from maunet_tpu_torch.analysis.gt_sensitivity import run_gt_sensitivity
    from maunet_tpu_torch.analysis.sensitivity import run_sensitivity
    from maunet_tpu_torch.analysis.stats import comparative_analysis, nonparametric_tests
    from maunet_tpu_torch.data.synthetic import generate_dataset
    from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint
    from maunet_tpu_torch.train.loop import Trainer

    os.makedirs(work_dir, exist_ok=True)
    samples = samples or {"train": 192, "val": 32, "test": 48}

    data_dir = os.path.join(work_dir, "data")
    if not os.path.isdir(os.path.join(data_dir, "train")):
        log.info(f"Generating planted-signal dataset under {data_dir} "
                 f"(meta_signal={meta_signal}, temporal_signal={temporal_signal})")
        generate_dataset(data_dir, samples, hw=hw, temporal_len=temporal_len,
                         seed=seed, meta_signal=meta_signal,
                         temporal_signal=temporal_signal)

    eval_dir = os.path.join(work_dir, "tests")
    sens_dir = os.path.join(work_dir, "sensitivity")
    variant_rows: dict[str, dict] = {}
    csv_by_variant: dict[str, str] = {}

    for name, (temporal, metadata) in VARIANTS.items():
        cfg = _science_config(temporal, metadata, hw, temporal_len,
                              base_filters, batch_size, epochs)
        study = f"science-{name}"
        trainer = Trainer(cfg, data_dir=data_dir,
                          work_dir=os.path.join(work_dir, "training"),
                          study_name=study, device=device)
        log.info(f"=== Training variant {name} "
                 f"(temporal={temporal}, metadata={metadata}) ===")
        result = trainer.train(epochs=epochs)

        df = evaluate_checkpoint(result.best_checkpoint, cfg,
                                 data_dir=data_dir, study_name=study,
                                 output_dir=eval_dir, batch_size=batch_size,
                                 device=device)
        csv_path = [os.path.join(eval_dir, f) for f in os.listdir(eval_dir)
                    if f.startswith(study + "_") and f.endswith("_evaluation.csv")][0]
        csv_by_variant[name] = csv_path
        variant_rows[name] = {
            "best_val_loss": float(result.best_val_loss),
            "checkpoint": result.best_checkpoint,
            "lst_mae_c": _lst_mae(csv_path),
            "ndvi_mae": _ndvi_mae(csv_path),
            "temporal_embeddings": temporal,
            "metadata_embeddings": metadata,
        }
        log.info(f"{name}: LST MAE {variant_rows[name]['lst_mae_c']:.3f} °C, "
                    f"NDVI MAE {variant_rows[name]['ndvi_mae']:.4f}")

    # --- statistics: do the embeddings beat noemb? -------------------------
    names = list(VARIANTS)
    paths = [csv_by_variant[n] for n in names]
    ttests = comparative_analysis(paths, names, output_dir=work_dir)
    nonpar = nonparametric_tests(paths, names)
    nonpar.to_csv(os.path.join(work_dir, "nonparametric_tests.csv"), index=False)

    def wins(winner: str, loser: str) -> int:
        if ttests.empty:
            return 0
        sub = ttests[(ttests["winner"] == winner)
                     & (ttests["channel"] == "after_temp")]
        return int(((sub["model_1"] == loser) | (sub["model_2"] == loser)).sum())

    # --- sensitivity: does the sweep recover the planted latitude slope? ---
    make_plots = plots.available()
    if not make_plots:
        log.info("matplotlib is not installed: the metadata sweeps write their "
                 "JSONs only")
    sens_emb = run_sensitivity(
        variant_rows["emb"]["checkpoint"], csv_by_variant["emb"],
        _science_config(True, True, hw, temporal_len, base_filters,
                        batch_size, epochs),
        data_dir=data_dir, output_dir=sens_dir, max_samples=24,
        study_name="science-emb", make_plots=make_plots, device=device)
    sens_noemb = run_sensitivity(
        variant_rows["noemb"]["checkpoint"], csv_by_variant["noemb"],
        _science_config(False, False, hw, temporal_len, base_filters,
                        batch_size, epochs),
        data_dir=data_dir, output_dir=sens_dir, max_samples=24,
        study_name="science-noemb", make_plots=make_plots, device=device)
    gt_path = run_gt_sensitivity(
        _science_config(True, True, hw, temporal_len, base_filters,
                        batch_size, epochs),
        data_dir=data_dir, output_dir=sens_dir)
    if make_plots:
        compare_sensitivity(sens_dir, output_dir=os.path.join(sens_dir, "comparison"))
    else:
        log.info("matplotlib is not installed: compare_sensitivity is skipped")

    # --- temporal sweep: does the LSTM channel recover the planted gain? ---
    # (round 4, VERDICT r3 next #2 — the temporal analog of the latitude
    # sweep: shift each tile's series by δ; the tempemb model's LST response
    # slope in °C per z-unit must approach temporal_signal · temp_std, the
    # temporal-blind noemb model must read ~flat.)
    from maunet_tpu_torch.analysis.sensitivity import run_temporal_sensitivity
    from maunet_tpu_torch.data.schema import NormalizationStats

    tsens_temp = run_temporal_sensitivity(
        variant_rows["tempemb"]["checkpoint"], csv_by_variant["tempemb"],
        _science_config(True, False, hw, temporal_len, base_filters,
                        batch_size, epochs),
        data_dir=data_dir, output_dir=sens_dir, max_samples=24,
        study_name="science-tempemb", device=device)
    tsens_noemb = run_temporal_sensitivity(
        variant_rows["noemb"]["checkpoint"], csv_by_variant["noemb"],
        _science_config(False, False, hw, temporal_len, base_filters,
                        batch_size, epochs),
        data_dir=data_dir, output_dir=sens_dir, max_samples=24,
        study_name="science-noemb", device=device)
    stats_json = NormalizationStats.from_json(
        os.path.join(data_dir, "normalization_metrics.json"))
    expected_temporal_slope = temporal_signal * stats_json.temp_std

    summary = {
        "planted": {"meta_signal": meta_signal,
                    "temporal_signal": temporal_signal,
                    "hw": hw, "samples": samples, "epochs": epochs},
        "variants": variant_rows,
        "lst_mae_ranking": sorted(names, key=lambda n: variant_rows[n]["lst_mae_c"]),
        "significant_lst_wins_over_noemb": {
            n: wins(n, "noemb") for n in ("metaemb", "tempemb", "emb")},
        "sensitivity": {
            "emb_lat_response": _lat_response(sens_emb),
            "noemb_lat_response": _lat_response(sens_noemb),
            "gt_lat_response": _lat_response(gt_path),
            "tempemb_temporal_response": _temporal_response(tsens_temp),
            "noemb_temporal_response": _temporal_response(tsens_noemb),
            "expected_temporal_slope_c_per_zunit": expected_temporal_slope,
        },
    }
    with open(os.path.join(work_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    _write_report(summary, ttests, nonpar, os.path.join(work_dir, "REPORT.md"))
    log.info(f"Science loop complete → {work_dir}/summary.json")
    return summary


def _write_report(summary: dict, ttests, nonpar, path: str) -> None:
    v = summary["variants"]
    lines = [
        "# Ablation science loop — planted-signal synthetic dataset",
        "",
        "Counterpart of the reference's headline experiment (metaemb 5.33 °C "
        "vs noemb 7.11 °C on real GEE data): the LST target carries a planted "
        f"latitude signal (gain {summary['planted']['meta_signal']}) and a "
        f"recent-CRU-mean signal (gain {summary['planted']['temporal_signal']}) "
        "that spatial inputs cannot explain.  Four ablation variants trained "
        f"for {summary['planted']['epochs']} epochs on "
        f"{summary['planted']['samples']['train']} tiles "
        f"({summary['planted']['hw']}²), evaluated on "
        f"{summary['planted']['samples']['test']} test tiles.",
        "",
        "## Results (test split)",
        "",
        "| variant | temporal | metadata | LST MAE (°C) | NDVI MAE | val loss |",
        "|---|---|---|---|---|---|",
    ]
    for name in ("noemb", "tempemb", "metaemb", "emb"):
        r = v[name]
        lines.append(
            f"| {name} | {r['temporal_embeddings']} | "
            f"{r['metadata_embeddings']} | {r['lst_mae_c']:.3f} | "
            f"{r['ndvi_mae']:.4f} | {r['best_val_loss']:.4f} |")
    lines += [
        "",
        f"MAE ranking (best first): {' < '.join(summary['lst_mae_ranking'])}",
        "",
        "## Statistical significance (paired t-tests, LST)",
        "",
        f"Significant wins over noemb: "
        f"{summary['significant_lst_wins_over_noemb']}",
        "",
        "## Sensitivity recovery of the planted latitude slope",
        "",
        "| source | slope (°C / °lat) | Pearson r | range (°C) |",
        "|---|---|---|---|",
    ]
    for key, label in (("gt_lat_response", "ground truth"),
                       ("emb_lat_response", "emb model sweep"),
                       ("noemb_lat_response", "noemb model sweep")):
        r = summary["sensitivity"][key]
        lines.append(f"| {label} | {r['slope_per_degree']:.4f} | "
                     f"{r['pearson_r']:.3f} | {r['range']:.3f} |")
    lines += [
        "",
        "The emb sweep must show the ground-truth-matching positive slope; "
        "the noemb model is lat-blind by construction (flat curve).",
        "",
        "## Temporal sweep recovery of the planted CRU gain",
        "",
        "Each tile's z-scored series is shifted by δ ∈ [-2, 2]; a model "
        "whose LSTM reads the recent local climate responds linearly at "
        f"~{summary['sensitivity']['expected_temporal_slope_c_per_zunit']:.2f}"
        " °C per z-unit (the planted gain × temp_std); a temporal-blind "
        "model reads flat.",
        "",
        "| source | slope (°C / z-unit) | Pearson r | range (°C) |",
        "|---|---|---|---|",
    ]
    for key, label in (("tempemb_temporal_response", "tempemb model sweep"),
                       ("noemb_temporal_response", "noemb model sweep")):
        r = summary["sensitivity"][key]
        lines.append(f"| {label} | {r['slope_per_zunit']:.4f} | "
                     f"{r['pearson_r']:.3f} | {r['range']:.3f} |")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--work-dir", default="reports/science")
    p.add_argument("--hw", type=int, default=64)
    p.add_argument("--epochs", type=int, default=64)
    p.add_argument("--base-filters", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--temporal-len", type=int, default=828)
    p.add_argument("--train", type=int, default=192)
    p.add_argument("--val", type=int, default=32)
    p.add_argument("--test", type=int, default=48)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless asked for cpu)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    start = time.perf_counter()
    summary = run_science_loop(
        work_dir=args.work_dir, hw=args.hw, epochs=args.epochs,
        base_filters=args.base_filters, batch_size=args.batch_size,
        temporal_len=args.temporal_len,
        samples={"train": args.train, "val": args.val, "test": args.test},
        device=args.device)
    log.info(f"Science loop wall: {time.perf_counter() - start:.1f} s")
    print(json.dumps({k: summary[k] for k in
                      ("lst_mae_ranking", "significant_lst_wins_over_noemb")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
