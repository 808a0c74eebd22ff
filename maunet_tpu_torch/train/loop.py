"""Training loop on one device.

Port of ``maunet_tpu/train/loop.py`` (``Trainer``, loop.py:83-378; reference
src/train.py:120-331): an epoch loop over seeded, shuffled ``drop_last``
batches with ``RandomFlip``, step logging to the same CSV file and columns,
masked validation in eval mode at each epoch's end, a best and a last
checkpoint, exact resume from the last one, an ``epoch_callback`` (which
the CLI's HPO studies use) and trackers (``utils/tracking.py``), which get
the step and epoch rows the JAX loop gives them, and prediction plots every
``frequency_plt`` steps (``train/visualize.py``, handed to each tracker's
``log_image``; where matplotlib is missing, one logged line and training
goes on).  Left out (ROADMAP.md): the device mesh and multi-host input.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from maunet_tpu_torch.data import open_split
from maunet_tpu_torch.data.dataset import make_batches
from maunet_tpu_torch.data.pipeline import prefetch_to_device
from maunet_tpu_torch.data.transforms import RandomFlip
from maunet_tpu_torch.losses import get_loss_fn
from maunet_tpu_torch.models.factory import UrbanPredictor
from maunet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from maunet_tpu_torch.train.config import TrainConfig, hyperparams_from_config
from maunet_tpu_torch.train.metrics import CSVLogger, RunningLoss
from maunet_tpu_torch.train.optimizers import make_optimizer
from maunet_tpu_torch.train.state import TrainState, param_count
from maunet_tpu_torch.train.steps import eval_step, train_step, train_step_with_outputs

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainResult:
    best_val_loss: float
    best_checkpoint: str | None
    epochs_run: int
    history: list[dict] = field(default_factory=list)


class Trainer:
    def __init__(self, cfg: TrainConfig, data_dir: str,
                 work_dir: str = "reports/training",
                 study_name: str = "urban-predictor", trial_id: int = 0,
                 device: str | torch.device = "cuda", trackers: list | None = None):
        self.cfg = cfg
        self.data_dir = data_dir
        self.work_dir = work_dir
        self.study_name = study_name
        self.trial_id = trial_id
        self.device = torch.device(device)
        self.trackers = trackers or []
        os.makedirs(work_dir, exist_ok=True)
        self.loss_fn = get_loss_fn(cfg.loss)
        self.flip = RandomFlip(cfg.seed)
        # Packed shards or per-sample .npz, as the split holds them; the flip
        # is drawn in __getitem__, in loading order, for either.
        self.train_ds = open_split(data_dir, "train", cfg.temporal_length,
                                   transform=self.flip)
        self.val_ds = open_split(data_dir, "val", cfg.temporal_length)
        self.csv = CSVLogger(os.path.join(
            work_dir, f"{study_name}_trial{trial_id}_train_log.csv"))
        self.state: TrainState | None = None
        # Plot steps run where JAX's do, whether or not there is anything to
        # draw with: their metrics lack grad_norm there too.
        self.render_plots = bool(cfg.frequency_plt) and (
            importlib.util.find_spec("matplotlib") is not None)
        if cfg.frequency_plt and not self.render_plots:
            log.info("matplotlib is not installed: training without prediction plots")

    def _checkpoint_path(self, kind: str) -> str:
        return os.path.join(self.work_dir,
                            f"{self.study_name}_trial_{self.trial_id}_{kind}.pth")

    def _device_batches(self, dataset, shuffle: bool, epoch: int, drop_last: bool):
        return prefetch_to_device(
            make_batches(dataset, self.cfg.batch_size, shuffle=shuffle,
                         seed=self.cfg.seed, epoch=epoch, drop_last=drop_last),
            self.device)

    def init_state(self, in_channels: int) -> TrainState:
        """A fresh model (its weights drawn from ``cfg.seed``, as the JAX
        package initialises them) and optimizer."""
        cfg = self.cfg
        # torch's own initializers draw from the global generator before the
        # JAX-like ones replace what they drew: leave its state as it was.
        with torch.random.fork_rng(devices=[]):
            model = UrbanPredictor(
                model_type=cfg.model_type, out_channels=len(cfg.target_channels),
                temporal_dim=cfg.temporal_dim, meta_dim=cfg.meta_dim,
                lstm_dim=cfg.lstm_hidden, base_filters=cfg.base_filters,
                in_channels=in_channels, meta_features=cfg.nb_metadata_features,
                temporal_embeddings=cfg.temporal_embeddings,
                metadata_embeddings=cfg.metadata_embeddings,
                compute_dtype=_DTYPES[cfg.compute_dtype],
                deep_supervision=cfg.deep_supervision, remat=cfg.remat,
                generator=torch.Generator().manual_seed(cfg.seed))
        model = model.to(self.device)
        opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate,
                             cfg.weight_decay, cfg.momentum)
        return TrainState(model, opt, 0)

    def _render_plot(self, batch, outputs: torch.Tensor, metrics, step: int) -> None:
        """Sample 0 of the batch and its prediction to a PNG, handed to the
        trackers (JAX ``Trainer._render_plot``).  Plotting never stops
        training: a failure is logged."""
        try:
            from maunet_tpu_torch.data.schema import NormalizationStats
            from maunet_tpu_torch.train.visualize import plot_predictions_vs_targets

            stats_path = os.path.join(self.data_dir, "normalization_metrics.json")
            stats = (NormalizationStats.from_json(stats_path)
                     if os.path.exists(stats_path) else None)
            host = {k: _host(v[:1]) for k, v in batch.items()}
            png = plot_predictions_vs_targets(
                host, _host(outputs[:1]), os.path.join(self.work_dir, "visualizations"),
                self.study_name, self.trial_id, step, float(metrics["total"]), stats,
                channels=tuple(self.cfg.target_channels))
            for tracker in self.trackers:
                tracker.log_image("train/predictions", png, step=step)
        except Exception as e:
            log.warning(f"Prediction plot failed at step {step}: {e}")

    def validate(self, state: TrainState) -> dict[str, float]:
        """Masked validation over the val split (reference src/train.py:20-60)."""
        sums: dict[str, torch.Tensor] = {}
        for batch in self._device_batches(self.val_ds, False, 0, drop_last=False):
            for k, v in eval_step(state.model, batch, self.cfg.nb_metadata_features).items():
                sums[k] = sums[k] + v if k in sums else v
        totals = {k: float(v) for k, v in sums.items()}
        n = totals.pop("num_samples", 0.0)
        if n == 0:
            log.warning("Validation loader was empty.")
            return {"total": float("inf")}
        return {k: v / n for k, v in totals.items()}

    def train(self, epochs: int | None = None,
              epoch_callback: Callable[[int, float], None] | None = None,
              resume: bool = False) -> TrainResult:
        """Run the training loop.  With ``resume=True``, restore the full
        state (parameters, BN statistics, optimizer state, step) from the
        trial's last checkpoint and continue from the next epoch."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        if len(self.train_ds) == 0:
            raise ValueError(f"Train split is empty under {self.data_dir}")
        # The JAX loop draws an example batch (through the flip) to
        # initialise its state; so does this one, for the channel count.
        example = next(make_batches(self.train_ds, cfg.batch_size, drop_last=False))
        state = self.state = self.init_state(example.maps.shape[-1])

        start_epoch, best_val = 0, float("inf")
        last_path = self._checkpoint_path("last")
        if resume and os.path.exists(last_path):
            meta = restore_checkpoint(last_path, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            best_val = float(meta.get("best_val_loss", float("inf")))
            # Flip draws of the epochs already run: one per loaded sample.
            self.flip.skip(start_epoch * (len(self.train_ds) // cfg.batch_size)
                           * cfg.batch_size)
            log.info(f"Resumed from epoch {start_epoch} (step {state.step}, "
                     f"best_val {best_val:.4f}).")
        log.info(f"Model: {cfg.model_type}, params={param_count(state):,}, "
                 f"device={self.device}")

        ema = RunningLoss("ema", ema_alpha=0.98)
        sma = RunningLoss("sma", window_size=50)
        cum = RunningLoss("cumulative")
        best_path, history, epochs_run = None, [], 0
        hyperparams = hyperparams_from_config(cfg)
        common = {"hyperparameters": hyperparams, "model_type": cfg.model_type,
                  "study_name": self.study_name, "trial_id": self.trial_id,
                  "metadata_input_length": cfg.nb_metadata_features}

        for epoch in range(start_epoch, epochs):
            epochs_run = epoch + 1
            ema.reset(); sma.reset(); cum.reset()
            t_epoch = time.time()
            step_losses = []  # device scalars, fetched once at the epoch's end
            for batch in self._device_batches(self.train_ds, True, epoch, drop_last=True):
                bsz = batch["maps"].shape[0]
                step = state.step
                kw = dict(gradient_clipping=cfg.gradient_clipping,
                          metadata_features=cfg.nb_metadata_features)
                if cfg.frequency_plt and step % cfg.frequency_plt == 0:
                    metrics, outputs = train_step_with_outputs(state, batch, self.loss_fn, **kw)
                    if self.render_plots:
                        self._render_plot(batch, outputs, metrics, step)
                else:
                    metrics = train_step(state, batch, self.loss_fn, **kw)
                step_losses.append((metrics["total"], bsz))
                if step % cfg.frequency_log == 0:
                    values = {k: float(v) for k, v in metrics.items()}
                    loss_val = values["total"]
                    row = {
                        "step": step, "epoch": epoch,
                        "batch_loss": loss_val,
                        "ema_loss": ema.update(loss_val),
                        "sma_loss": sma.update(loss_val),
                        "cum_loss": cum.update(loss_val, n=bsz),
                        # sorted, as the JAX loop's metrics come out of jit
                        **{f"loss_{k}": v for k, v in sorted(values.items())
                           if k != "total"},
                    }
                    self.csv.log(row)
                    for tracker in self.trackers:
                        tracker.log(row, step=step)

            n_samples = sum(bsz for _, bsz in step_losses)
            epoch_loss = sum(float(v) * bsz for v, bsz in step_losses)
            train_loss = epoch_loss / n_samples if n_samples else float("inf")
            val = self.validate(state)
            val_loss = val["total"]
            log.info(f"Epoch {epoch + 1}/{epochs} | Train {train_loss:.4f} | "
                     f"Val {val_loss:.4f} | {time.time() - t_epoch:.1f}s")
            epoch_row = {"epoch": epoch, "val_loss": val_loss,
                         **{f"val_{k}": v for k, v in val.items() if k != "total"}}
            history.append({"epoch": epoch, "train_loss": train_loss, **epoch_row})
            for tracker in self.trackers:
                tracker.log(epoch_row, step=state.step)

            if val_loss < best_val:
                best_val = val_loss
                best_path = self._checkpoint_path("best")
                save_checkpoint(best_path, state,
                                {"epoch": epoch, "loss": best_val, **common})
                log.info(f"New best checkpoint (val={best_val:.4f}) -> {best_path}")
            # The resume point: the full state, optimizer included.
            save_checkpoint(last_path, state,
                            {"epoch": epoch, "best_val_loss": best_val, **common})
            if epoch_callback is not None:
                epoch_callback(epoch, val_loss)

        return TrainResult(best_val, best_path, epochs_run, history)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy, floating types as f32."""
    return (t.float() if t.is_floating_point() else t).cpu().numpy()
