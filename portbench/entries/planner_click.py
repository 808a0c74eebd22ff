"""One user of the Urban Greening Planner, clicking: a closed loop.

A click is what the app asks of the engine: the t1 input and its predict, the
input with the painted canvas and its predict, and the mean cooling.  Each
click draws a location from a pool of the traffic's ``locations`` and one of
its ``canvases``, whose painted squares have evenly spaced sides over
``block_px``.  The engine has no temperature query, as in the bundled demo,
so every series is zeros of length 1.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import counts, inputs, weights
from portbench.entries import common
from portbench.reference import planner as ref_planner


class Click:
    tiles_per_unit = 2

    def __init__(self, ctx):
        from maunet_tpu_torch.apps.engine import PlannerEngine

        cfg, tr = ctx.cfg, ctx.traffic
        self.ctx, self.cfg, self.side = ctx, cfg, int(tr["img_size"])
        rng = np.random.default_rng(ctx.seed)
        self.places = [inputs.planner_place(rng) for _ in range(tr["locations"])]
        self.layers = [inputs.planner_layers(rng, self.side) for _ in range(tr["locations"])]
        blocks = rng.permutation(inputs.spaced(*tr["block_px"], tr["canvases"]))
        self.canvases = [inputs.canvas(rng, self.side, int(b)) for b in blocks]
        self.order = np.stack([rng.integers(0, tr["locations"], 4096),
                               rng.integers(0, tr["canvases"], 4096)], 1)
        self.keep = common.kept_units(ctx.seed, tr["check_among"], tr["check_units"])
        self.kept: dict[int, tuple] = {}
        path = common.write_checkpoint(cfg, weights.make(cfg, ctx.seed, ctx.device), ctx.tmp)
        self.engine = PlannerEngine(path, device=ctx.device, stats=common.stats(cfg),
                                    temp_query=None, temporal_length=cfg["temporal_length"],
                                    img_size=self.side)
        os.remove(path)
        for i in range(int(tr["warmup_units"])):
            self.click(i + len(self.order) // 2)
        self.flops_per_unit = 2 * counts.forward_flops(cfg, self.side, 1, 1)
        self.forwards_per_unit = 2
        self.a_bound_per_forward = counts.a_bound_s(cfg, self.side, 1)
        self.a_launches_per_forward = len(counts.a_launches(cfg, self.side))

    def click(self, i: int):
        e, span = self.engine, self.ctx.span
        loc, can = self.order[i % len(self.order)]
        p, layers = self.places[loc], self.layers[loc]
        args = (p["lat"], p["lon"], p["population"], p["year_t1"], p["month_t1"],
                p["year_t2"], p["month_t2"])
        with span("portbench.prepare"):
            base = e.prepare_input(layers, None, *args)
        with span("portbench.predict"):
            before = e.predict(base)
        with span("portbench.prepare"):
            painted = e.prepare_input(layers, self.canvases[can], *args)
        with span("portbench.predict"):
            after = e.predict(painted)
        with span("portbench.cooling"):
            cooling = e.cooling_metric(before[1], after[1])
        return (int(loc), int(can)), (base, painted), (before, after), cooling

    def unit(self, i: int) -> None:
        out = self.click(i)
        if i in self.keep:
            self.kept[i] = out

    def finish(self) -> None:
        pass

    def end_to_end(self, lat, window_s) -> dict:
        return {"click_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}

    def release(self) -> None:
        self.engine = None

    def answers(self, kept: dict) -> dict:
        """The kept clicks' inputs and answers: [stack, ndvi, normalised LST,
        cooling] per click, as the numbers compare them."""
        s = self.cfg["serving_stats"]
        out = {}
        for i, (_, inps, preds, cooling) in kept.items():
            stack = [np.concatenate([x.maps.ravel(), x.metadata.ravel(), x.temp_series.ravel(),
                                     x.temp_lengths.ravel()]) for x in inps]
            out[i] = (stack, [p[0] for p in preds],
                      [common.normalised_lst(p[1], s) for p in preds], cooling,
                      [p[1] for p in preds])
        return out

    def reference_answers(self, quant=None) -> dict:
        """The same clicks through the plain reference: its own assembly and
        forward (in ``quant``'s precision for the control)."""
        from portbench.reference.model import identity

        q = quant or identity
        dev, cfg, s = self.ctx.device, self.cfg, self.cfg["serving_stats"]
        ref = common.reference(cfg, self.ctx.seed, dev)
        out = {}
        for i in sorted(self.kept):
            (loc, can) = self.kept[i][0]
            p, layers = self.places[loc], self.layers[loc]
            stacks, ndvi, lst = [], [], []
            for c in (None, self.canvases[can]):
                maps, meta, series, lengths = ref_planner.assemble(
                    layers, c, p["lat"], p["lon"], p["population"], p["year_t1"],
                    p["month_t1"], p["year_t2"], p["month_t2"], s, None, cfg["temporal_length"])
                if quant is not None:
                    maps = q(torch.from_numpy(maps)).numpy()
                stacks.append(np.concatenate([maps.ravel(), meta.ravel(), series.ravel(),
                                              lengths.ravel()]))
                y = common.ref_predict(ref, maps, series, meta, lengths, dev, "batch_max", q)[0]
                ndvi.append(y[..., 0])
                lst.append(y[..., 1])
            lst_c = [v * s["temp_std"] + s["temp_mean"] for v in lst]
            # The control's cooling is the mean in bf16, the next precision below f32.
            diff = torch.from_numpy(lst_c[1] - lst_c[0])
            cooling = float(diff.mean() if quant is None else diff.bfloat16().mean())
            out[i] = (stacks, ndvi, lst, cooling, lst_c)
        return out

    def controls(self) -> dict[str, list]:
        """The control: the reference in fp8 in the program's place."""
        from portbench.reference.quant import fp8

        want = self.reference_answers()
        return {"fp8": numbers(self.reference_answers(fp8), want, self.ctx.cell.limits)}

    def check(self) -> list[tuple[str, float, float]]:
        got, want = self.answers(self.kept), self.reference_answers()
        self.detail = {"lst_mean_gap": common.worst_mean_gap(got, want)}
        return numbers(got, want, self.ctx.cell.limits)


def numbers(got: dict, want: dict, limits: dict) -> list[tuple[str, float, float]]:
    """The worst of each number over the kept clicks, with its limit.  The
    cooling answer is judged against the mean, in f64, of the LST maps the
    same side returned, which ``lst_err`` holds to the reference's."""
    vals = {"stack_max_abs": 0.0, "ndvi_err": 0.0, "lst_err": 0.0, "cooling_gap_C": 0.0}
    if set(got) != set(want) or not want:
        vals = {k: float("inf") for k in vals}
    for i in want:
        if i not in got:
            continue
        g, w = got[i], want[i]
        vals["stack_max_abs"] = max(vals["stack_max_abs"], *(common.max_abs(a, b)
                                                             for a, b in zip(g[0], w[0])))
        vals["ndvi_err"] = max(vals["ndvi_err"], *(common.rel_err(a, b)
                                                         for a, b in zip(g[1], w[1])))
        vals["lst_err"] = max(vals["lst_err"], *(common.rel_err(a, b)
                                                       for a, b in zip(g[2], w[2])))
        mean = float(np.mean(np.asarray(g[4][1], np.float64) - np.asarray(g[4][0], np.float64)))
        vals["cooling_gap_C"] = max(vals["cooling_gap_C"], abs(g[3] - mean))
    return [(k, float(v), float(limits[k])) for k, v in vals.items()]


def setup(ctx) -> Click:
    return Click(ctx)
