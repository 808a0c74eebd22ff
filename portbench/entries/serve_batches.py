"""Batched serving: a closed loop of ``PlannerEngine.predict_many`` calls.

A pool of the traffic's ``pool`` requests is assembled in set-up with
``prepare_input``, as the engine returns requests: a location's t1 layers, a
painted canvas and the series of a seeded stand-in for the temperature
query, whose lengths are evenly spaced over ``lengths``.  Each call serves
``batch`` distinct requests of the pool, drawn from the seed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import counts, inputs, weights
from portbench.entries import common
from portbench.reference import planner as ref_planner


class Serve:
    def __init__(self, ctx):
        from maunet_tpu_torch.apps.engine import PlannerEngine

        cfg, tr = ctx.cfg, ctx.traffic
        self.ctx, self.cfg, self.side = ctx, cfg, int(tr["img_size"])
        self.batch = self.tiles_per_unit = int(tr["batch"])
        n = int(tr["pool"])
        rng = np.random.default_rng(ctx.seed)
        self.places = [inputs.planner_place(rng) for _ in range(n)]
        self.layers = [inputs.planner_layers(rng, self.side) for _ in range(n)]
        blocks = rng.permutation(inputs.spaced(*tr["block_px"], n))
        self.canvases = [inputs.canvas(rng, self.side, int(b)) for b in blocks]
        self.source = inputs.SeriesSource()
        for p, length in zip(self.places, rng.permutation(inputs.spaced(*tr["lengths"], n))):
            self.source.add(rng, p["lat"], p["lon"], length)
        self.order = common.seq(ctx.seed, n, self.batch)
        self.keep = common.kept_units(ctx.seed, tr["check_among"], tr["check_units"])
        self.kept: dict[int, tuple] = {}
        path = common.write_checkpoint(cfg, weights.make(cfg, ctx.seed, ctx.device), ctx.tmp)
        self.engine = PlannerEngine(path, device=ctx.device, stats=common.stats(cfg),
                                    temp_query=self.source,
                                    temporal_length=cfg["temporal_length"], img_size=self.side)
        os.remove(path)
        self.pool = [self.engine.prepare_input(self.layers[j], self.canvases[j], *self.args(j))
                     for j in range(n)]
        for i in range(int(tr["warmup_units"])):
            self.call(i + len(self.order) // 2)
        hi = int(tr["lengths"][1])
        self.flops_per_unit = counts.forward_flops(cfg, self.side, self.batch, hi * self.batch)
        self.forwards_per_unit = 1

    def args(self, j: int):
        p = self.places[j]
        return (p["lat"], p["lon"], p["population"], p["year_t1"], p["month_t1"],
                p["year_t2"], p["month_t2"])

    def call(self, i: int):
        idx = self.order[i % len(self.order)]
        with self.ctx.span("portbench.predict_many"):
            return idx, self.engine.predict_many([self.pool[j] for j in idx])

    def unit(self, i: int) -> None:
        out = self.call(i)
        if i in self.keep:
            self.kept[i] = out

    def finish(self) -> None:
        pass

    def end_to_end(self, lat, window_s) -> dict:
        return {"serve_tiles_per_s": self.batch * len(lat) / window_s}

    def release(self) -> None:
        self.engine = None

    def answers(self) -> dict:
        s = self.cfg["serving_stats"]
        out = {}
        for i, (idx, preds) in self.kept.items():
            stacks = [np.concatenate([self.pool[j].maps.ravel(), self.pool[j].metadata.ravel(),
                                      self.pool[j].temp_series.ravel(),
                                      self.pool[j].temp_lengths.ravel()]) for j in idx]
            out[i] = (stacks, [p[0] for p in preds],
                      [common.normalised_lst(p[1], s) for p in preds])
        return out

    def reference_answers(self, quant=None) -> dict:
        from portbench.reference.model import identity

        q = quant or identity
        dev, cfg, s = self.ctx.device, self.cfg, self.cfg["serving_stats"]
        ref = common.reference(cfg, self.ctx.seed, dev)
        out = {}
        for i in sorted(self.kept):
            idx = self.kept[i][0]
            parts = [ref_planner.assemble(self.layers[j], self.canvases[j], *self.args(j), s,
                                          self.source.query(self.places[j]["lat"],
                                                            self.places[j]["lon"], 0, 0),
                                          cfg["temporal_length"]) for j in idx]
            maps, meta, series, lengths = (np.concatenate(a) for a in zip(*parts))
            if quant is not None:
                maps = q(torch.from_numpy(maps)).numpy()
            stacks = [np.concatenate([m.ravel(), a.ravel(), b.ravel(), c.ravel()])
                      for m, a, b, c in zip(maps, meta, series, lengths)]
            y = common.ref_predict(ref, maps, series, meta, lengths, dev, "batch_max", q)
            out[i] = (stacks, list(y[..., 0]), list(y[..., 1]))
        return out

    def controls(self) -> dict[str, list]:
        """The control: the reference in fp8 in the program's place."""
        from portbench.reference.quant import fp8

        want = self.reference_answers()
        return {"fp8": numbers(self.reference_answers(fp8), want, self.ctx.cell.limits)}

    def check(self) -> list[tuple[str, float, float]]:
        got, want = self.answers(), self.reference_answers()
        self.detail = {"lst_mean_gap": common.worst_mean_gap(got, want)}
        return numbers(got, want, self.ctx.cell.limits)


def numbers(got: dict, want: dict, limits: dict) -> list[tuple[str, float, float]]:
    """The worst tile of each number over the kept calls.  Each tile's error
    is taken over the spread of all the tiles its call returned (one tile's
    LST can be nearly flat, and its own spread no measure)."""
    vals = {"stack_max_abs": 0.0, "ndvi_err": 0.0, "lst_err": 0.0}
    if set(got) != set(want) or not want:
        vals = {k: float("inf") for k in vals}
    for i in want:
        if i not in got:
            continue
        g, w = got[i], want[i]
        if any(len(g[j]) != len(w[j]) for j in range(3)):
            return [(k, float("inf"), float(limits[k])) for k in vals]
        vals["stack_max_abs"] = max(vals["stack_max_abs"],
                                    *(common.max_abs(a, b) for a, b in zip(g[0], w[0])))
        vals["ndvi_err"] = max(vals["ndvi_err"], *common.tile_errs(g[1], w[1]))
        vals["lst_err"] = max(vals["lst_err"], *common.tile_errs(g[2], w[2]))
    return [(k, float(v), float(limits[k])) for k, v in vals.items()]


def setup(ctx) -> Serve:
    return Serve(ctx)
