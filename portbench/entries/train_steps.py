"""Training throughput: ``train/steps.py`` ``train_step`` back to back.

Set-up builds one training state (the model with the cell's seeded weights,
the traffic's optimizer) and drives it through its first ``checked_steps``
steps on the first batches of a pool of distinct device-resident batches;
the window then goes on stepping the same state over the pool.  The plain
reference follows the checked steps from the same weights and batches.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts, inputs, weights
from portbench.entries import common
from portbench.reference import train as ref_train
from portbench.reference.model import f32_exact, identity

# A leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a conv bias before train-mode BatchNorm): under
# Adam it moves by round-off alone, so it is left out of the comparison.
NOUGHT = 1e-3


def _meta(b: dict) -> torch.Tensor:
    return torch.cat([b["metadata"], b["t1_dates"], b["t2_dates"]], 1)


class Train:
    def __init__(self, ctx):
        from maunet_tpu_torch.losses import get_loss_fn
        from maunet_tpu_torch.models.factory import UrbanPredictor
        from maunet_tpu_torch.train.optimizers import make_optimizer
        from maunet_tpu_torch.train.state import TrainState

        cfg, tr = ctx.cfg, ctx.traffic
        self.ctx, self.cfg, self.tr, self.side = ctx, cfg, tr, int(tr["img_size"])
        self.batch = self.tiles_per_unit = int(tr["batch"])
        dev = ctx.device
        with torch.device("meta"):
            model = UrbanPredictor(
                model_type=cfg["model_type"], out_channels=cfg["out_channels"],
                temporal_dim=cfg["temporal_dim"], meta_dim=cfg["meta_dim"],
                lstm_dim=cfg["lstm_hidden"], base_filters=cfg["base_filters"],
                in_channels=cfg["in_channels"], meta_features=cfg["meta_features"],
                compute_dtype=getattr(torch, cfg["compute_dtype"]), train_fused_conv=bool(tr["train_fused_conv"]),
                remat=bool(tr["remat"]))
        model = model.to_empty(device=dev)
        model.load_state_dict(weights.make(cfg, ctx.seed, dev))
        opt = make_optimizer(model.parameters(), tr["optimizer"], tr["learning_rate"],
                             tr["weight_decay"])
        self.state = TrainState(model.train(), opt, 0)
        self.loss_fn = get_loss_fn(tr["loss"])
        self.pool = inputs.batch_pool(ctx.seed, int(tr["pool"]), self.batch, self.side,
                                      cfg["temporal_length"], tr["lengths"], dev)
        self.checked = int(tr["checked_steps"])
        names = {p: n for n, p in model.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        losses, grad1 = [], {}
        for s in range(self.checked):
            losses.append(self.step(s)["total"])
            if s == 0:
                # An optimizer that holds no first moment saw no gradient.
                grad1 = {names[p]: (opt.state[p]["exp_avg"] / (1 - beta1)).norm()
                         if "exp_avg" in opt.state[p] else torch.zeros((), device=dev)
                         for p in names}
        init = weights.make(cfg, ctx.seed, dev)
        change = {n: (p.detach() - init[n]).norm() for n, p in model.named_parameters()}
        del init
        self.got = ([float(v) for v in losses], {k: float(v) for k, v in grad1.items()},
                    {k: float(v) for k, v in change.items()})
        self.offset = self.checked + int(tr["warmup_units"])
        for s in range(self.checked, self.offset):
            self.step(s)
        lo, hi = tr["lengths"]
        steps = int(inputs.spaced(lo, hi, self.batch).sum())
        self.flops_per_unit = 3 * counts.forward_flops(cfg, self.side, self.batch, steps)
        self.forwards_per_unit = 1

    def step(self, s: int) -> dict:
        from maunet_tpu_torch.train.steps import train_step

        return train_step(self.state, self.pool[s % len(self.pool)], self.loss_fn,
                          gradient_clipping=float(self.tr["gradient_clipping"]),
                          metadata_features=self.cfg["meta_features"])

    def unit(self, i: int) -> None:
        with self.ctx.span("portbench.train_step"):
            self.step(self.offset + i)

    def finish(self) -> None:
        from portbench.harness import sync

        sync(self.ctx.device)

    def end_to_end(self, lat, window_s) -> dict:
        return {"train_tiles_per_s": self.batch * len(lat) / window_s}

    def release(self) -> None:
        self.state = None

    def reference_steps(self, quant=None, rows: int | None = None):
        """(losses, first gradient's leaf norms, leaf norms of the change
        after the checked steps) of the plain reference, from the same
        weights and batches; ``rows`` keeps only a batch's first rows."""
        cfg, tr, dev = self.cfg, self.tr, self.ctx.device
        q = quant or identity
        ref = common.reference(cfg, self.ctx.seed, dev)
        params = dict(ref.named_parameters())
        opt = ref_train.AdamW(params, tr["learning_rate"], tr["weight_decay"])
        losses, grad1 = [], {}
        sel = slice(None) if rows is None else slice(0, rows)
        for s in range(self.checked):
            b = self.pool[s % len(self.pool)]
            with f32_exact():
                out = ref(b["maps"][sel], b["temp_series"][sel], _meta(b)[sel],
                          b["temp_lengths"][sel], train=True, mask_mode="per_sample", quant=q)
                loss = ref_train.loss(out, b["targets"][sel])
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            if s == 0:
                grad1 = {n: float(g.norm()) for n, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
        init = weights.make(cfg, self.ctx.seed, dev)
        change = {n: float((p.detach() - init[n]).norm()) for n, p in params.items()}
        return losses, grad1, change

    def controls(self) -> dict[str, list]:
        """The control (the reference in fp8) and the fault of half the batch
        left out, the mean taken over the rest."""
        from portbench.reference.quant import fp8

        want, lim = self.reference_steps(), self.ctx.cell.limits
        return {"fp8": numbers(self.reference_steps(fp8), want, lim),
                "half_batch": numbers(self.reference_steps(rows=self.batch // 2), want, lim)}

    def check(self) -> list[tuple[str, float, float]]:
        want = self.reference_steps()
        self.detail = worst_leaves(self.got, want)
        return numbers(self.got, want, self.ctx.cell.limits)


def numbers(got, want, limits: dict) -> list[tuple[str, float, float]]:
    """The first gradient and the change after the checked steps, by the
    worst leaf and by the median leaf, which one small leaf's rounding cannot
    move.  Each step's loss is not compared: neither the control nor a fault
    separates it from sound runs (its readings are ``detail``'s)."""
    names = ("grad1_leaf", "change_leaf", "grad1_median", "change_median")
    _, g_grad, g_change = got
    _, w_grad, w_change = want
    if set(g_grad) != set(w_grad):
        return [(k, float("inf"), float(limits[k])) for k in names]
    median = float(np.median(list(w_grad.values())))
    keep = {k for k, v in w_grad.items() if v >= NOUGHT * median}
    grad = ref_train.leaf_gaps(g_grad, w_grad, keep)
    change = ref_train.leaf_gaps(g_change, w_change, keep)
    worst = lambda gaps: gaps[0][0] if gaps else float("inf")
    mid = lambda gaps: float(np.median([g for g, _ in gaps])) if gaps else float("inf")
    vals = (worst(grad), worst(change), mid(grad), mid(change))
    return [(k, float(v), float(limits[k])) for k, v in zip(names, vals)]


def worst_leaves(got, want, top: int = 3) -> dict[str, str]:
    """The leaves that read worst in the first gradient and in the change."""
    median = float(np.median(list(want[1].values())))
    keep = {k for k, v in want[1].items() if v >= NOUGHT * median}
    out = {"loss_rel_steps": " ".join(f"{abs(a - b) / abs(b):.3g}"
                                      for a, b in zip(got[0], want[0]))}
    return out | {label: " ".join(f"{k}={v:.3g}" for v, k in ref_train.leaf_gaps(g, w, keep)[:top])
            for label, g, w in (("grad1", got[1], want[1]), ("change", got[2], want[2]))}


def setup(ctx) -> Train:
    return Train(ctx)
