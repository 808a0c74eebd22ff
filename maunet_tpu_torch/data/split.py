"""Train/val/test split policy.

A copy of ``maunet_tpu/data/split.py`` (which imports JAX through its
package).  Capability parity with reference src/data/processing_10m/split.py:6-46:
a fraction of cities is held out entirely → test (generalization axis);
remaining samples split by target year (t2=2025 → test, t2=2024 → val,
t2≤2023 → train).  Unlike the reference — whose ``random.shuffle`` is
unseeded (SURVEY.md §7 quirks) — the city shuffle is seeded so splits are
reproducible.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Tuple

log = logging.getLogger(__name__)


def train_test_val_split(
    samples: List[Dict],
    holdout_ratio: float = 0.01,
    seed: int = 42,
    test_year: int = 2025,
    val_year: int = 2024,
) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    all_cities = sorted({s["city_id"] for s in samples})
    random.Random(seed).shuffle(all_cities)

    holdout_count = int(len(all_cities) * holdout_ratio)
    holdout = set(all_cities[:holdout_count])
    log.info(f"Holding out {len(holdout)} cities for the test set.")

    train, val, test = [], [], []
    for s in samples:
        if s["city_id"] in holdout:
            test.append(s)
        elif s["t2_year"] == test_year:
            test.append(s)
        elif s["t2_year"] == val_year:
            val.append(s)
        elif s["t2_year"] < val_year:
            train.append(s)

    log.info(f"Train samples: {len(train)} | Val: {len(val)} | Test: {len(test)}")
    return train, val, test
