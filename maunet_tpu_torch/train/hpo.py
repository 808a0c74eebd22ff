"""Hyperparameter-optimization studies.

A copy of ``maunet_tpu/train/hpo.py``, carried because ``maunet_tpu.train``
imports JAX; a study file written by either package is read by both.

Capability parity with the reference's Optuna wrapper (src/train.py:333-347):
named studies with persistent storage, median pruning on intermediate
validation values, failed-trial re-enqueue on resume, and a
suggest_float/int/categorical API (seeded random search).  Storage is a
plain JSON file per study (optuna and its SQLite storage are not
dependencies); the public surface mirrors optuna's so swapping back is
mechanical.
"""

from __future__ import annotations

import json
import logging
import os
import random
from dataclasses import asdict, dataclass, field
from typing import Any, Callable

log = logging.getLogger(__name__)

RUNNING, COMPLETE, PRUNED, FAIL = "RUNNING", "COMPLETE", "PRUNED", "FAIL"


class TrialPruned(Exception):
    pass


@dataclass
class TrialRecord:
    number: int
    state: str = RUNNING
    value: float | None = None
    params: dict[str, Any] = field(default_factory=dict)
    intermediate: dict[str, float] = field(default_factory=dict)  # step → value


class Trial:
    def __init__(self, study: "Study", record: TrialRecord):
        self.study = study
        self.record = record
        # Stable across processes (builtin str hashing is salted per run).
        import hashlib

        digest = hashlib.sha256(
            f"{study.study_name}:{record.number}".encode()).digest()
        self._rng = random.Random(int.from_bytes(digest[:8], "big"))
        self._enqueued = dict(record.params)

    @property
    def number(self) -> int:
        return self.record.number

    @property
    def params(self) -> dict[str, Any]:
        return self.record.params

    # -- suggest API (honors re-enqueued params; delegates to the sampler) --
    def _remember(self, name: str, value):
        self.record.params[name] = value
        return value

    def suggest_float(self, name: str, low: float, high: float, log: bool = False):
        if name in self._enqueued:
            return self._remember(name, self._enqueued[name])
        value = self.study.sampler.sample_float(
            self.study, self._rng, name, low, high, log)
        return self._remember(name, value)

    def suggest_int(self, name: str, low: int, high: int):
        if name in self._enqueued:
            return self._remember(name, int(self._enqueued[name]))
        # Sample the continuous relaxation over [low-0.5, high+0.5) so every
        # integer gets a full unit interval — rounding a [low, high] sample
        # would give the endpoints half the probability of interior values.
        value = int(round(self.study.sampler.sample_float(
            self.study, self._rng, name, low - 0.5, high + 0.5, False)))
        return self._remember(name, max(low, min(high, value)))

    def suggest_categorical(self, name: str, choices: list):
        if name in self._enqueued:
            return self._remember(name, self._enqueued[name])
        value = self.study.sampler.sample_categorical(
            self.study, self._rng, name, list(choices))
        return self._remember(name, value)

    # -- pruning ----------------------------------------------------------
    def report(self, value: float, step: int) -> None:
        self.record.intermediate[str(step)] = float(value)
        self.study._save()

    def should_prune(self) -> bool:
        return self.study.pruner.should_prune(self.study, self.record)


class RandomSampler:
    """Independent uniform sampling — the reference's effective behavior
    (its Optuna objective never calls suggest_*, so its TPE never engages)."""

    def sample_float(self, study: "Study", rng: random.Random, name: str,
                     low: float, high: float, log_scale: bool) -> float:
        import math

        if log_scale:
            return math.exp(rng.uniform(math.log(low), math.log(high)))
        return rng.uniform(low, high)

    def sample_categorical(self, study: "Study", rng: random.Random,
                           name: str, choices: list):
        return rng.choice(choices)


class TPESampler(RandomSampler):
    """Tree-structured-Parzen-estimator-lite (Bergstra et al. 2011).

    Splits completed trials into the best gamma fraction ("good") and the
    rest ("bad"), fits a 1-D Parzen window (gaussian KDE) to each group's
    values of the parameter, samples candidates from the good KDE and keeps
    the one maximizing l_good(x)/l_bad(x).  Falls back to random sampling
    until ``n_startup_trials`` trials have completed.  Pure-stdlib — optuna
    is not a dependency."""

    def __init__(self, n_startup_trials: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    def _split(self, study: "Study", name: str):
        done = [t for t in study.trials
                if t.state == COMPLETE and t.value is not None
                and name in t.params]
        if len(done) < self.n_startup_trials:
            return None, None
        reverse = study.direction != "minimize"
        done.sort(key=lambda t: t.value, reverse=reverse)
        n_good = max(1, int(self.gamma * len(done)))
        good = [t.params[name] for t in done[:n_good]]
        bad = [t.params[name] for t in done[n_good:]] or good
        return good, bad

    @staticmethod
    def _kde_logpdf(x: float, points: list[float], bandwidth: float) -> float:
        import math

        if bandwidth <= 0:
            bandwidth = 1e-12
        acc = 0.0
        for p in points:
            z = (x - p) / bandwidth
            acc += math.exp(-0.5 * z * z)
        return math.log(acc / (len(points) * bandwidth) + 1e-300)

    def sample_float(self, study: "Study", rng: random.Random, name: str,
                     low: float, high: float, log_scale: bool) -> float:
        import math

        good, bad = self._split(study, name)
        if good is None:
            return super().sample_float(study, rng, name, low, high, log_scale)
        to_u = (lambda v: math.log(v)) if log_scale else (lambda v: v)
        from_u = (lambda u: math.exp(u)) if log_scale else (lambda u: u)
        lo_u, hi_u = to_u(low), to_u(high)
        good_u = [to_u(v) for v in good]
        bad_u = [to_u(v) for v in bad]
        # Scott's-rule-flavored bandwidth, floored at 1/20 of the range so a
        # tight good-cluster still explores.
        span = hi_u - lo_u

        def bw(pts):
            if len(pts) < 2:
                return span / 4
            mean = sum(pts) / len(pts)
            var = sum((p - mean) ** 2 for p in pts) / (len(pts) - 1)
            return max(math.sqrt(var) * len(pts) ** -0.2, span / 20)

        bw_good, bw_bad = bw(good_u), bw(bad_u)
        best_u, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            center = rng.choice(good_u)
            cand = min(hi_u, max(lo_u, rng.gauss(center, bw_good)))
            score = (self._kde_logpdf(cand, good_u, bw_good)
                     - self._kde_logpdf(cand, bad_u, bw_bad))
            if score > best_score:
                best_u, best_score = cand, score
        return from_u(best_u)

    def sample_categorical(self, study: "Study", rng: random.Random,
                           name: str, choices: list):
        good, bad = self._split(study, name)
        if good is None:
            return super().sample_categorical(study, rng, name, choices)
        # Weighted by smoothed good-count / smoothed bad-count.
        weights = [(good.count(c) + 1.0) / (bad.count(c) + 1.0) for c in choices]
        return rng.choices(choices, weights=weights, k=1)[0]


def suggest_training_params(trial: Trial) -> dict[str, Any]:
    """Default search space for ``maunet train --search`` (the reference
    ships an Optuna study that suggests nothing, src/train.py:120-225; this
    makes the HPO subsystem actually search).  Returns dotted config
    overrides for :meth:`Config.with_overrides`."""
    return {
        "training.learning_rate": trial.suggest_float(
            "learning_rate", 1e-5, 1e-2, log=True),
        "training.weight_decay": trial.suggest_float(
            "weight_decay", 1e-6, 1e-2, log=True),
        "training.optimizer": trial.suggest_categorical(
            "optimizer", ["adam", "adamw", "sgd"]),
    }


class MedianPruner:
    """Prune if the latest reported value is worse than the median of the
    values other trials reported at the same step (optuna semantics)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, study: "Study", record: TrialRecord) -> bool:
        if not record.intermediate:
            return False
        step = max(int(s) for s in record.intermediate)
        if step < self.n_warmup_steps:
            return False
        value = record.intermediate[str(step)]
        peers = []
        for t in study.trials:
            if t.number == record.number or t.state not in (COMPLETE, PRUNED):
                continue
            if str(step) in t.intermediate:
                peers.append(t.intermediate[str(step)])
        if len(peers) < self.n_startup_trials:
            return False
        peers.sort()
        median = peers[len(peers) // 2] if len(peers) % 2 else (
            (peers[len(peers) // 2 - 1] + peers[len(peers) // 2]) / 2)
        worse = value > median if study.direction == "minimize" else value < median
        return worse


class Study:
    def __init__(self, study_name: str, storage_dir: str = "reports/training_hpo",
                 direction: str = "minimize", pruner: MedianPruner | None = None,
                 load_if_exists: bool = True,
                 sampler: RandomSampler | None = None):
        self.study_name = study_name
        self.direction = direction
        self.pruner = pruner or MedianPruner()
        self.sampler = sampler or TPESampler()
        self.storage_path = os.path.join(storage_dir, f"{study_name}.json")
        os.makedirs(storage_dir, exist_ok=True)
        self.trials: list[TrialRecord] = []
        if load_if_exists and os.path.exists(self.storage_path):
            with open(self.storage_path) as f:
                data = json.load(f)
            self.trials = [TrialRecord(**t) for t in data.get("trials", [])]
            log.info(f"Resumed study '{study_name}' with {len(self.trials)} trials.")

    def _save(self) -> None:
        tmp = self.storage_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"study_name": self.study_name,
                       "direction": self.direction,
                       "trials": [asdict(t) for t in self.trials]}, f, indent=2)
        os.replace(tmp, self.storage_path)

    def enqueue_trial(self, params: dict[str, Any]) -> None:
        self._queue = getattr(self, "_queue", [])
        self._queue.append(params)

    def optimize(self, objective: Callable[[Trial], float], n_trials: int) -> None:
        # Re-enqueue failed trials (reference src/train.py:343-346).
        for t in self.trials:
            if t.state == FAIL:
                self.enqueue_trial(t.params)
        queue = list(getattr(self, "_queue", []))
        self._queue = []

        for _ in range(n_trials):
            number = len(self.trials)
            record = TrialRecord(number=number,
                                 params=queue.pop(0) if queue else {})
            self.trials.append(record)
            trial = Trial(self, record)
            try:
                value = objective(trial)
                record.state = COMPLETE
                record.value = float(value)
            except TrialPruned:
                record.state = PRUNED
                vals = record.intermediate.values()
                record.value = min(vals) if vals else None
                log.info(f"Trial {number} pruned.")
            except Exception as e:
                record.state = FAIL
                log.error(f"Trial {number} failed: {e!r}")
            self._save()

    @property
    def best_trial(self) -> TrialRecord:
        done = [t for t in self.trials if t.state == COMPLETE and t.value is not None]
        if not done:
            raise ValueError("No completed trials.")
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)


def create_study(study_name: str, storage_dir: str = "reports/training_hpo",
                 direction: str = "minimize", load_if_exists: bool = True,
                 pruner: MedianPruner | None = None,
                 sampler: RandomSampler | None = None) -> Study:
    return Study(study_name, storage_dir, direction, pruner, load_if_exists,
                 sampler=sampler)
