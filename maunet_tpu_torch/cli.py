"""Command line of the PyTorch port.

Port of ``maunet_tpu/cli.py`` for what the port runs; every subcommand that
touches a model takes ``--device`` (``cuda`` unless asked otherwise):

    python -m maunet_tpu_torch.cli train --data-dir D --study-name s [--search] ...
    python -m maunet_tpu_torch.cli evaluate CKPT.pth --data-dir D
    python -m maunet_tpu_torch.cli synth-data OUT_DIR [--hw 64 ...]
    python -m maunet_tpu_torch.cli pack DATA_DIR [--out-dir ...]
    python -m maunet_tpu_torch.cli process [--data-root data --image-dir D ...]
    python -m maunet_tpu_torch.cli process-temperature [--raw-dir D --out-dir D]
    python -m maunet_tpu_torch.cli bench [--suite inference ...] [--out rows.json]
    python -m maunet_tpu_torch.cli sensitivity CKPT.pth EVAL_CSV --data-dir D
    python -m maunet_tpu_torch.cli gt-sensitivity --data-dir D
    python -m maunet_tpu_torch.cli compare-sensitivity DIR
    python -m maunet_tpu_torch.cli stats EVAL_CSV [EVAL_CSV ...]
    python -m maunet_tpu_torch.cli science-loop [--work-dir D --hw 64 --epochs 6]
    python -m maunet_tpu_torch.cli export-optuna STUDY.json DB
    python -m maunet_tpu_torch.cli import-optuna DB STUDY.json
    python -m maunet_tpu_torch.cli eda extract DATA_DIR OUT.csv
    python -m maunet_tpu_torch.cli eda analyze-csv METRICS.csv
    python -m maunet_tpu_torch.cli eda visualize SAMPLE.npz [--out PNG]
    python -m maunet_tpu_torch.cli eda visualize-tiles IMAGE_DIR [--out PNG]

The configuration is the port's flat ``TrainConfig``.  ``-o section.key=value``
(the value read by ``ast.literal_eval``, else kept as a string) sets
``training.*``, ``dataset.{temporal_length,nb_metadata_features,
input_channels,target_channels}``, ``logging.{frequency_log,frequency_plt}``,
``parallel.{data_parallel,spatial_parallel}`` or ``seed``; any other key
raises.  ``--config PATH`` reads the same keys from the JAX
package's YAML layout (PyYAML needed) and, as the JAX loader does, ignores
the keys it does not know; ``-o`` applies after it.  ``TrainConfig`` holds no
paths, so ``--data-dir`` is required where the JAX command line falls back
to ``cfg.paths``; ``process`` and ``process-temperature`` take ``--data-root``
(default ``data``) and lay their paths out under it as ``cfg.paths`` does.

``train`` runs on every rank of a process group, as JAX's ``cmd_train``
trains on every device of its mesh: under a launcher that sets
``WORLD_SIZE`` > 1 (``torchrun --nproc-per-node N -m maunet_tpu_torch.cli
train ...``) each process joins the group as rank ``RANK`` on
``cuda:LOCAL_RANK`` (NCCL; Gloo with ``--device cpu``), and where a group is
already initialised it takes that one.  ``parallel.spatial_parallel`` ranks
share each image's rows, the rest is the data axis (``parallel.data_parallel``
-1, or that size).  Rank 0 holds the study: it samples each trial and makes
each pruning decision, and every rank trains that trial.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import os
import shutil
import sys
from typing import Any

from maunet_tpu_torch.train.config import TrainConfig

log = logging.getLogger(__name__)

_DATASET_KEYS = ("temporal_length", "nb_metadata_features", "input_channels",
                 "target_channels")
_LOGGING_KEYS = ("frequency_log", "frequency_plt")
# TrainConfig's mesh sizes, JAX's parallel.* keys (config.py:142-150).
_PARALLEL_KEYS = ("data_parallel", "spatial_parallel")
_TRAINING_KEYS = tuple(
    f.name for f in dataclasses.fields(TrainConfig)
    if f.name not in _DATASET_KEYS + _LOGGING_KEYS + _PARALLEL_KEYS + ("seed",))


def config_field(key: str) -> str | None:
    """The ``TrainConfig`` field a dotted config key sets, or None."""
    section, _, name = key.partition(".")
    if key == "seed":
        return "seed"
    if section == "logging" and name in _LOGGING_KEYS:
        return name
    if section == "dataset" and name in _DATASET_KEYS:
        return name
    if section == "parallel" and name in _PARALLEL_KEYS:
        return name
    if section == "training" and name in _TRAINING_KEYS:
        return name
    return None


def with_overrides(cfg: TrainConfig, dotted: dict[str, Any]) -> TrainConfig:
    """``cfg`` with dotted-key overrides; a key outside the mapping raises."""
    fields = {}
    for key, value in dotted.items():
        name = config_field(key)
        if name is None:
            raise ValueError(
                f"unknown config key {key!r}: the port's TrainConfig takes training.*, "
                f"dataset.{{{','.join(_DATASET_KEYS)}}}, logging.{{{','.join(_LOGGING_KEYS)}}}, "
                f"parallel.{{{','.join(_PARALLEL_KEYS)}}} and seed")
        fields[name] = tuple(value) if isinstance(value, list) else value
    return dataclasses.replace(cfg, **fields)


def parse_overrides(items: list[str] | None) -> dict[str, Any]:
    overrides = {}
    for item in items or []:
        key, _, value = item.partition("=")
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        overrides[key] = value
    return overrides


def yaml_overrides(path: str) -> dict[str, Any]:
    """The keys of a YAML config (the JAX package's section layout) that map
    onto ``TrainConfig``, as dotted overrides."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"--config {path} needs PyYAML, which is not installed; "
                           "give the keys as -o section.key=value instead") from e
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    dotted = {"seed": data["seed"]} if "seed" in data else {}
    for section in ("training", "dataset", "logging", "parallel"):
        for name, value in (data.get(section) or {}).items():
            if config_field(f"{section}.{name}") is not None:
                dotted[f"{section}.{name}"] = value
    return dotted


def load_cfg(args) -> TrainConfig:
    cfg = TrainConfig()
    if getattr(args, "config", None):
        cfg = with_overrides(cfg, yaml_overrides(args.config))
    return with_overrides(cfg, parse_overrides(getattr(args, "override", None)))


def check_mesh_sizes(cfg: TrainConfig, world: int) -> None:
    """``parallel.*`` against a group of ``world`` ranks; a size that
    disagrees raises, naming its key."""
    sp, dp = cfg.spatial_parallel, cfg.data_parallel
    if sp < 1 or world % sp:
        raise ValueError(f"parallel.spatial_parallel={sp} does not divide the {world} "
                         f"rank(s) of the process group")
    if dp not in (-1, world // sp):
        raise ValueError(f"parallel.data_parallel={dp}, but {world} rank(s) over "
                         f"parallel.spatial_parallel={sp} make a data axis of {world // sp} "
                         f"(-1 takes it)")


def join_ranks(cfg: TrainConfig, device: str) -> tuple:
    """The device this process trains on, and whether it started a process
    group.  An initialised group is taken as it is (laid out with
    ``parallel.spatial_parallel``); else, with ``WORLD_SIZE`` > 1 (a launcher
    such as torchrun), this process joins one as rank ``RANK`` on
    ``cuda:LOCAL_RANK`` (or the CPU), over ``env://``; else it trains alone."""
    import torch
    import torch.distributed as dist

    from maunet_tpu_torch.parallel import multihost

    if dist.is_available() and dist.is_initialized():
        check_mesh_sizes(cfg, multihost.world_size())
        if multihost.axes().spatial != cfg.spatial_parallel:
            multihost.set_spatial_parallel(cfg.spatial_parallel)   # every rank alike
        return device, False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    check_mesh_sizes(cfg, world)
    if world <= 1:
        return device, False
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return multihost.initialize_multihost(
        None, world, int(os.environ["RANK"]), spatial_parallel=cfg.spatial_parallel,
        device=device), True


def rank0_value(value):
    """Rank 0's ``value`` on every rank (pickled, so a float keeps its
    bits); ``value`` itself without a group."""
    from maunet_tpu_torch.parallel.multihost import world_size

    if world_size() == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def every_rank(value) -> list:
    """Each rank's ``value``, in rank order, on every rank."""
    from maunet_tpu_torch.parallel.multihost import world_size

    if world_size() == 1:
        return [value]
    import torch.distributed as dist

    out = [None] * world_size()
    dist.all_gather_object(out, value)
    return out


def cmd_train(args) -> int:
    from maunet_tpu_torch.parallel.multihost import rank
    from maunet_tpu_torch.train.hpo import TrialPruned, create_study
    from maunet_tpu_torch.train.loop import Trainer
    from maunet_tpu_torch.utils.tracking import WandbTracker, make_emb_tag

    cfg = dataclasses.replace(load_cfg(args), model_type=args.model_type,
                              temporal_embeddings=args.temporal_embeddings,
                              metadata_embeddings=args.metadata_embeddings)
    device, started = join_ranks(cfg, args.device)
    primary = rank() == 0
    emb_tag = make_emb_tag(args.temporal_embeddings, args.metadata_embeddings)
    study_name = args.study_name
    if not args.force_study_name:
        study_name += "-" + emb_tag

    def run_trial(seed_cfg, seed_study, number, overrides, trial):
        """One trial on this rank, ``trial`` the study's on rank 0 (None on
        the others).  Every rank learns every rank's outcome before it
        returns: a trial that failed anywhere fails everywhere."""
        seed_cfg = with_overrides(seed_cfg, overrides)
        trackers = []
        if args.wandb and primary:
            trackers.append(WandbTracker(
                project=os.getenv("WANDB_PROJECT"), group=seed_study,
                name=f"trial-{number}-{emb_tag}", config=dataclasses.asdict(seed_cfg),
                tags=[seed_study, args.model_type, f"loss_{seed_cfg.loss}"]))

        def on_epoch(epoch, val_loss):
            prune = False
            if trial is not None:
                trial.report(val_loss, epoch)
                prune = trial.should_prune()
            if rank0_value(prune):
                raise TrialPruned()

        status, error, result = "complete", None, None
        try:
            trainer = Trainer(seed_cfg, data_dir=args.data_dir, work_dir=args.work_dir,
                              study_name=seed_study, trial_id=number, device=device,
                              trackers=trackers, use_mesh=True)
            result = trainer.train(epochs=args.epochs, epoch_callback=on_epoch,
                                   resume=args.resume)
        except TrialPruned:
            status = "pruned"
        except Exception as e:   # shared below, then raised again
            status, error = "failed", e
        finally:
            for tracker in trackers:
                tracker.finish()
        statuses = every_rank(status)
        if "failed" in statuses:
            failed = [r for r, st in enumerate(statuses) if st == "failed"]
            raise error or RuntimeError(f"trial {number} failed on rank(s) {failed}")
        if status == "pruned":
            raise TrialPruned()
        return result.best_val_loss

    seeds = args.seeds or [cfg.seed]
    for seed in seeds:
        seed_cfg = dataclasses.replace(cfg, seed=int(seed))
        seed_study = study_name if len(seeds) == 1 else f"{study_name}-seed{seed}"
        if not primary:
            # Rank 0's study runs n_trials trials; each starts with its
            # number and parameters from there.
            for _ in range(args.n_trials):
                number, overrides = rank0_value(None)
                try:
                    run_trial(seed_cfg, seed_study, number, overrides, None)
                except TrialPruned:
                    pass
                except Exception as e:
                    log.error(f"Trial {number} failed: {e!r}")
            continue
        study = create_study(seed_study, storage_dir=f"{args.work_dir}_hpo")

        def objective(trial, seed_cfg=seed_cfg, seed_study=seed_study):
            overrides = {}
            if args.search:
                from maunet_tpu_torch.train.hpo import suggest_training_params

                overrides = suggest_training_params(trial)
                log.info(f"Trial {trial.number} params: {trial.params}")
            rank0_value((trial.number, overrides))
            return run_trial(seed_cfg, seed_study, trial.number, overrides, trial)

        study.optimize(objective, n_trials=args.n_trials)
        best = study.best_trial
        log.info(f"Study {seed_study} finished. Best trial: {best.number} "
                 f"(min val_loss {best.value:.4f})")
    if started:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def figures_default(requested, default, off, what: str):
    """``requested`` where it was given (a missing matplotlib then raises
    where the figures are drawn); else ``default`` where matplotlib is
    installed, and ``off`` with one logged line where it is not."""
    from maunet_tpu_torch.analysis import plots

    if requested is not None:
        return requested
    if plots.available():
        return default
    log.info(f"matplotlib is not installed: {what}")
    return off


def cmd_evaluate(args) -> int:
    from maunet_tpu_torch.evaluate.evaluator import evaluate_checkpoint

    n_visualize = figures_default(args.n_visualize, 10, 0,
                                  "evaluate draws no figures (--n-visualize 0)")
    evaluate_checkpoint(
        args.checkpoint_path, load_cfg(args), data_dir=args.data_dir,
        study_name=args.study_name, jobid=args.jobid, n_visualize=n_visualize,
        output_dir=args.output_dir, batch_size=args.batch_size,
        precision=args.precision, device=args.device, use_mesh=args.use_mesh)
    return 0


def cmd_synth_data(args) -> int:
    from maunet_tpu_torch.data.synthetic import generate_dataset

    splits = {"train": args.train, "val": args.val, "test": args.test}
    root = generate_dataset(args.out_dir, splits, hw=args.hw,
                            temporal_len=args.temporal_len, seed=args.seed)
    log.info(f"Synthetic dataset written to {root}")
    return 0


def cmd_process(args) -> int:
    from maunet_tpu_torch.data.processing import process_future_data

    cfg = load_cfg(args)
    process_future_data(args.data_root, image_dir=args.image_dir,
                        output_dir=args.output_dir, cities_csv=args.cities_csv,
                        target_shape=(args.tile_size, args.tile_size),
                        temperature_dir=args.temperature_dir,
                        holdout_ratio=args.holdout_ratio, seed=cfg.seed)
    return 0


def cmd_process_temperature(args) -> int:
    from maunet_tpu_torch.data import processing
    from maunet_tpu_torch.data.temperature import process_temperature

    process_temperature(
        args.raw_dir or os.path.join(args.data_root, processing.RAW_TEMPERATURE_DIR),
        args.out_dir or os.path.join(args.data_root, processing.PROCESSED_TEMPERATURE_DIR))
    return 0


def cmd_pack(args) -> int:
    from maunet_tpu_torch.data.shards import pack_dataset

    cfg = load_cfg(args)
    out_root = args.out_dir or args.data_dir + "_packed"
    for split in args.splits:
        pack_dataset(f"{args.data_dir}/{split}", f"{out_root}/{split}",
                     shard_size=args.shard_size, temporal_length=cfg.temporal_length)
    stats = f"{args.data_dir}/normalization_metrics.json"
    if os.path.exists(stats):
        shutil.copy(stats, f"{out_root}/normalization_metrics.json")
    return 0


def cmd_bench(args) -> int:
    from maunet_tpu_torch import benchmarks

    benchmarks.run(args)
    return 0


def cmd_sensitivity(args) -> int:
    from maunet_tpu_torch.analysis.sensitivity import run_sensitivity

    make_plots = figures_default(args.plots, True, False,
                                 "sensitivity writes its JSON only (--no-plots)")
    run_sensitivity(args.checkpoint_path, args.eval_csv, load_cfg(args),
                    data_dir=args.data_dir, output_dir=args.output_dir,
                    max_samples=args.max_samples, make_plots=make_plots,
                    device=args.device)
    return 0


def cmd_gt_sensitivity(args) -> int:
    from maunet_tpu_torch.analysis.gt_sensitivity import run_gt_sensitivity

    run_gt_sensitivity(load_cfg(args), data_dir=args.data_dir, output_dir=args.output_dir)
    return 0


def cmd_compare_sensitivity(args) -> int:
    from maunet_tpu_torch.analysis import plots
    from maunet_tpu_torch.analysis.compare import compare_sensitivity

    if not plots.available():
        print("compare-sensitivity only draws figures, and matplotlib is not installed",
              file=sys.stderr)
        return 1
    compare_sensitivity(args.data_dir, output_dir=args.output_dir)
    return 0


def cmd_stats(args) -> int:
    from maunet_tpu_torch.analysis.stats import comparative_analysis, interpret_metrics

    if len(args.csvs) == 1:
        interpret_metrics(args.csvs[0], output_dir=args.output_dir)
    else:
        comparative_analysis(args.csvs, output_dir=args.output_dir)
    return 0


def cmd_science(args) -> int:
    from maunet_tpu_torch.analysis.science import run_science_loop

    run_science_loop(work_dir=args.work_dir, hw=args.hw, epochs=args.epochs,
                     device=args.device)
    return 0


def cmd_export_optuna(args) -> int:
    from maunet_tpu_torch.train.optuna_storage import export_study_to_sqlite

    export_study_to_sqlite(args.json_path, args.db_path)
    return 0


def cmd_import_optuna(args) -> int:
    from maunet_tpu_torch.train.optuna_storage import import_study_from_sqlite

    import_study_from_sqlite(args.db_path, args.json_path, study_name=args.study_name)
    return 0


def cmd_eda(args) -> int:
    from maunet_tpu_torch.analysis import eda, plots

    if args.eda_command in ("visualize", "visualize-tiles") and not plots.available():
        print(f"eda {args.eda_command} only draws a figure, and matplotlib is not installed",
              file=sys.stderr)
        return 1
    if args.eda_command == "extract":
        eda.extract_metrics_csv(args.data_dir, args.out_csv)
    elif args.eda_command == "visualize":
        eda.visualize_sample(args.npz_path, out_path=args.out)
    elif args.eda_command == "analyze-csv":
        eda.analyze_csv(args.csv_path)
    elif args.eda_command == "visualize-tiles":
        from maunet_tpu_torch.analysis.tile_viz import visualize_raw_tiles

        visualize_raw_tiles(args.image_dir, out_path=args.out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from maunet_tpu_torch import benchmarks

    p = argparse.ArgumentParser(prog="maunet-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--config", default=None, help="YAML config path (needs PyYAML)")
        sp.add_argument("-o", "--override", action="append",
                        help="dotted config override key=value")

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (cuda unless a test asks for cpu)")

    sp = sub.add_parser("train", help="train a model (HPO study)")
    common(sp)
    device(sp)
    sp.add_argument("--model-type", default="unet", choices=["unet", "unet++"])
    sp.add_argument("--study-name", default="urban-predictor")
    sp.add_argument("--force-study-name", action="store_true")
    sp.add_argument("--temporal-embeddings", action=argparse.BooleanOptionalAction,
                    default=True)
    sp.add_argument("--metadata-embeddings", action=argparse.BooleanOptionalAction,
                    default=True)
    sp.add_argument("--n-trials", type=int, default=1)
    sp.add_argument("--search", action="store_true",
                    help="search lr, weight_decay and optimizer (TPE-lite sampler)")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--work-dir", default="reports/training")
    sp.add_argument("--resume", action="store_true",
                    help="resume each trial from its last full-state checkpoint")
    sp.add_argument("--seeds", nargs="+", type=int, default=None,
                    help="cross-validation seeds (one study per seed)")
    sp.add_argument("--wandb", action="store_true",
                    help="log to Weights & Biases if installed")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("evaluate", help="evaluate a .pth checkpoint on the test split")
    common(sp)
    device(sp)
    sp.add_argument("checkpoint_path")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--study-name", default="test")
    sp.add_argument("--jobid", default="")
    sp.add_argument("--n-visualize", type=int, default=None,
                    help="figures to draw (default 10 where matplotlib is installed, else 0)")
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--output-dir", default="reports/tests")
    sp.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"],
                    help="float32 for exact parity with reference numbers")
    sp.add_argument("--use-mesh", action="store_true",
                    help="run the batches data-parallel over every visible CUDA device "
                         "(the batch size rounds up to a multiple of their number)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("synth-data", help="generate a synthetic dataset")
    sp.add_argument("out_dir")
    sp.add_argument("--train", type=int, default=64)
    sp.add_argument("--val", type=int, default=16)
    sp.add_argument("--test", type=int, default=16)
    sp.add_argument("--hw", type=int, default=256)
    sp.add_argument("--temporal-len", type=int, default=828)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("bench", help="run the port's benchmark suites")
    benchmarks.add_arguments(sp)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("pack", help="pack per-sample .npz splits into shards")
    common(sp)
    sp.add_argument("data_dir")
    sp.add_argument("--out-dir", default=None)
    sp.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    sp.add_argument("--shard-size", type=int, default=64)
    sp.set_defaults(fn=cmd_pack)

    from maunet_tpu_torch.data import processing

    sp = sub.add_parser("process", help="raw tiles -> processed .npz dataset")
    common(sp)
    sp.add_argument("--data-root", default=processing.DATA_ROOT)
    sp.add_argument("--image-dir", default=None)
    sp.add_argument("--output-dir", default=None)
    sp.add_argument("--cities-csv", default=None)
    sp.add_argument("--temperature-dir", default=None,
                    help="the processed CRU cube's directory")
    sp.add_argument("--tile-size", type=int, default=processing.TILE_EDGE)
    sp.add_argument("--holdout-ratio", type=float, default=processing.HOLDOUT_CITY_RATIO)
    sp.set_defaults(fn=cmd_process)

    sp = sub.add_parser("process-temperature", help="CRU z-scoring -> cube")
    sp.add_argument("--data-root", default=processing.DATA_ROOT)
    sp.add_argument("--raw-dir", default=None)
    sp.add_argument("--out-dir", default=None)
    sp.set_defaults(fn=cmd_process_temperature)

    sp = sub.add_parser("sensitivity", help="metadata sensitivity sweep")
    common(sp)
    device(sp)
    sp.add_argument("checkpoint_path")
    sp.add_argument("eval_csv")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--output-dir", default="reports/sensitivity")
    sp.add_argument("--max-samples", type=int, default=1000)
    sp.add_argument("--plots", action=argparse.BooleanOptionalAction, default=None,
                    help="draw the figures after the JSON (default: where matplotlib "
                         "is installed)")
    sp.set_defaults(fn=cmd_sensitivity)

    sp = sub.add_parser("gt-sensitivity", help="ground-truth sensitivity binning")
    common(sp)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--output-dir", default="reports/sensitivity")
    sp.set_defaults(fn=cmd_gt_sensitivity)

    sp = sub.add_parser("compare-sensitivity", help="overlay sensitivity curves")
    sp.add_argument("data_dir")
    sp.add_argument("--output-dir", default="reports/sensitivity/comparison")
    sp.set_defaults(fn=cmd_compare_sensitivity)

    sp = sub.add_parser("stats", help="statistical tests on evaluation CSVs")
    sp.add_argument("csvs", nargs="+")
    sp.add_argument("--output-dir", default="reports/statistical_tests")
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("science-loop",
                        help="planted-signal ablation: train 4 variants, "
                             "evaluate, stats, sensitivity")
    device(sp)
    sp.add_argument("--work-dir", default="reports/science")
    sp.add_argument("--hw", type=int, default=64)
    sp.add_argument("--epochs", type=int, default=6)
    sp.set_defaults(fn=cmd_science)

    sp = sub.add_parser("export-optuna",
                        help="JSON HPO study -> optuna SQLite DB (optuna-dashboard reads it)")
    sp.add_argument("json_path")
    sp.add_argument("db_path")
    sp.set_defaults(fn=cmd_export_optuna)

    sp = sub.add_parser("import-optuna", help="optuna SQLite DB -> JSON HPO study")
    sp.add_argument("db_path")
    sp.add_argument("json_path")
    sp.add_argument("--study-name", default=None)
    sp.set_defaults(fn=cmd_import_optuna)

    sp = sub.add_parser("eda", help="dataset EDA tools")
    esub = sp.add_subparsers(dest="eda_command", required=True)
    e = esub.add_parser("extract", help="per-sample metrics of every split -> CSV")
    e.add_argument("data_dir")
    e.add_argument("out_csv")
    e = esub.add_parser("visualize", help="one sample's channels -> PNG (matplotlib)")
    e.add_argument("npz_path")
    e.add_argument("--out", default=None)
    e = esub.add_parser("analyze-csv", help="land-cover change vs the target deltas")
    e.add_argument("csv_path")
    e = esub.add_parser("visualize-tiles", help="raw tiles of one location -> PNG (matplotlib)")
    e.add_argument("image_dir")
    e.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_eda)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
