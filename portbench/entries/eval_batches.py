"""Evaluation throughput: ``evaluate/evaluator.py`` ``batch_metrics`` over a
pool of device-resident batches, cycled.

The model is built as ``evaluate_checkpoint`` loads a checkpoint (the
published batch-max LSTM masking) and gets the cell's seeded weights.  Each
batch's metrics are fetched to the host with at most ``in_flight`` batches
waiting on the device, as ``evaluate_checkpoint`` does.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from portbench import counts, inputs, weights
from portbench.entries import common
from portbench.reference import metrics as ref_metrics

CHECKED = ("mae", "rmse", "lap_var_pred", "lap_var_gt", "class_mae", "class_rmse")


class Eval:
    def __init__(self, ctx):
        from maunet_tpu_torch.models.factory import build_model

        cfg, tr = ctx.cfg, ctx.traffic
        self.ctx, self.cfg, self.side = ctx, cfg, int(tr["img_size"])
        self.batch = self.tiles_per_unit = int(tr["batch"])
        with torch.device("meta"):
            model = build_model(common.hyperparams(cfg), lstm_mask_mode="batch_max",
                                compute_dtype=getattr(torch, cfg["compute_dtype"]))
        model = model.to_empty(device=ctx.device)
        model.load_state_dict(weights.make(cfg, ctx.seed, ctx.device))
        self.model = model.eval()
        self.stats = common.stats(cfg)
        self.pool = inputs.batch_pool(ctx.seed, int(tr["pool"]), self.batch, self.side,
                                      cfg["temporal_length"], tr["lengths"], ctx.device)
        self.in_flight = int(tr["in_flight"])
        self.pending: collections.deque = collections.deque()
        self.keep = common.kept_units(ctx.seed, tr["check_among"], tr["check_units"])
        self.kept: dict[int, tuple] = {}
        for i in range(int(tr["warmup_units"])):
            self.unit(-1 - i)
        self.finish()
        hi = int(tr["lengths"][1])
        self.flops_per_unit = counts.forward_flops(cfg, self.side, self.batch, hi * self.batch)
        self.forwards_per_unit = 1
        self.a_bound_per_forward = counts.a_bound_s(cfg, self.side, self.batch)
        self.a_launches_per_forward = len(counts.a_launches(cfg, self.side))

    def fetch(self) -> None:
        i, m, outputs, targets = self.pending.popleft()
        with self.ctx.span("portbench.fetch"):
            host = {k: v.cpu().numpy() for k, v in m.items()}
        if i in self.keep:
            self.kept[i] = (host, outputs, targets)

    def unit(self, i: int) -> None:
        from maunet_tpu_torch.evaluate.evaluator import batch_metrics

        batch = self.pool[i % len(self.pool)]
        with self.ctx.span("portbench.batch_metrics"):
            m, outputs, targets = batch_metrics(self.model, batch, self.stats,
                                                self.cfg["meta_features"])
        self.pending.append((i, m, outputs, targets))
        if len(self.pending) > self.in_flight:
            self.fetch()

    def finish(self) -> None:
        while self.pending:
            self.fetch()

    def end_to_end(self, lat, window_s) -> dict:
        return {"eval_tiles_per_s": self.batch * len(lat) / window_s}

    def release(self) -> None:
        self.model = None

    def answers(self) -> dict:
        """Per kept batch: the metrics, and the outputs with LST normalised."""
        s = self.cfg["serving_stats"]
        out = {}
        for i, (host, outputs, _) in self.kept.items():
            o = outputs.float().cpu().numpy()
            out[i] = (host, o[..., 0], common.normalised_lst(o[..., 1], s), outputs)
        return out

    def _reference_run(self, quant):
        """Per kept batch: the reference's (B, H, W, 2) forward in ``quant``'s
        precision, and the benchmark's targets un-normalised."""
        from portbench.reference.model import identity

        dev, cfg, s = self.ctx.device, self.cfg, self.cfg["serving_stats"]
        ref = common.reference(cfg, self.ctx.seed, dev)
        out = {}
        for i in sorted(self.kept):
            b = self.pool[i % len(self.pool)]
            meta = torch.cat([b["metadata"], b["t1_dates"], b["t2_dates"]], 1)
            y = common.ref_predict(ref, b["maps"], b["temp_series"], meta, b["temp_lengths"],
                                   dev, "batch_max", quant or identity)
            out[i] = (y, ref_metrics.unnormalise(b["targets"].float(), s), b["maps"])
        return out

    def reference_answers(self) -> dict:
        """The reference's forward of each kept batch, and the reference's
        metrics of the program's outputs against the benchmark's targets."""
        got = self.answers()
        out = {}
        for i, (y, targets, maps) in self._reference_run(None).items():
            m = ref_metrics.metrics(got[i][3].float(), targets, maps)
            out[i] = ({k: v.cpu().numpy() for k, v in m.items()}, y[..., 0], y[..., 1])
        return out

    def control_answers(self, quant, metric_quant) -> tuple[dict, dict]:
        """(control, reference): the forward in ``quant``'s precision and its
        metrics in ``metric_quant``'s, against the f32 forward and the f32
        metrics of the same control outputs."""
        s = self.cfg["serving_stats"]
        low, full = self._reference_run(quant), self._reference_run(None)
        got, want = {}, {}
        for i, (y, targets, maps) in low.items():
            judged = ref_metrics.unnormalise(torch.as_tensor(y, device=maps.device), s)
            mq = ref_metrics.metrics(judged, targets, maps, quant=metric_quant)
            m = ref_metrics.metrics(judged, targets, maps)
            host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
            got[i] = (host(mq), y[..., 0], y[..., 1])
            want[i] = (host(m), full[i][0][..., 0], full[i][0][..., 1])
        return got, want

    def controls(self) -> dict[str, list]:
        """The control: the forward in fp8 and the metrics in bf16."""
        from portbench.reference.quant import bf16, fp8

        return {"fp8": numbers(*self.control_answers(fp8, bf16), self.ctx.cell.limits)}

    def check(self) -> list[tuple[str, float, float]]:
        return numbers(self.answers(), self.reference_answers(), self.ctx.cell.limits)


def metric_gap(got: dict, want: dict) -> float:
    """The worst relative gap over every metric, infinite where the classes
    present or the NaN pattern differ."""
    if not np.array_equal(got["class_present"], want["class_present"]):
        return float("inf")
    worst = 0.0
    for k in CHECKED:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            return float("inf")
        ok = ~np.isnan(w)
        if ok.any():
            worst = max(worst, float((np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-6)).max()))
    return worst


def numbers(got: dict, want: dict, limits: dict) -> list[tuple[str, float, float]]:
    vals = {"ndvi_err": 0.0, "lst_err": 0.0, "metrics_rel": 0.0}
    if set(got) != set(want) or not want:
        vals = {k: float("inf") for k in vals}
    for i in want:
        if i not in got:
            continue
        g, w = got[i], want[i]
        vals["ndvi_err"] = max(vals["ndvi_err"], common.rel_err(g[1], w[1]))
        vals["lst_err"] = max(vals["lst_err"], common.rel_err(g[2], w[2]))
        vals["metrics_rel"] = max(vals["metrics_rel"], metric_gap(g[0], w[0]))
    return [(k, float(v), float(limits[k])) for k, v in vals.items()]


def setup(ctx) -> Eval:
    return Eval(ctx)
