"""Optuna-RDB interchange for the JSON HPO studies.

A copy of ``maunet_tpu/train/optuna_storage.py``, carried because ``maunet_tpu.train``
imports JAX; a study file written by either package is read by both.

The reference persists Optuna studies in SQLite
(``reports/training_optuna/<study>.db``, reference src/train.py:334-341) so
``optuna-dashboard`` can browse them.  optuna is not a dependency, so
both packages store studies as JSON (train/hpo.py) — this module writes those
studies into optuna's RDB schema with the stdlib ``sqlite3`` so a real
optuna / optuna-dashboard installation elsewhere can open them, and reads
such a DB back into the JSON format.

Schema: optuna 3.x RDBStorage (alembic head ``v3.0.0.c``).  If a newer
optuna refuses the version, ``optuna storage upgrade --storage
sqlite:///<db>`` migrates it in place.

Distributions are not stored in the JSON studies, so exported params carry
degenerate single-point distributions (low == high / one-element choices) —
enough for dashboards, not for resuming a *sampler* from the DB.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sqlite3
from typing import Any

log = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS alembic_version (
    version_num VARCHAR(32) NOT NULL PRIMARY KEY);
CREATE TABLE IF NOT EXISTS version_info (
    version_info_id INTEGER PRIMARY KEY CHECK (version_info_id=1),
    schema_version INTEGER, library_version VARCHAR(256));
CREATE TABLE IF NOT EXISTS studies (
    study_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_name VARCHAR(512) NOT NULL UNIQUE);
CREATE TABLE IF NOT EXISTS study_directions (
    study_direction_id INTEGER PRIMARY KEY AUTOINCREMENT,
    direction VARCHAR(8) NOT NULL,
    study_id INTEGER NOT NULL REFERENCES studies (study_id),
    objective INTEGER NOT NULL,
    UNIQUE (study_id, objective));
CREATE TABLE IF NOT EXISTS study_user_attributes (
    study_user_attribute_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_id INTEGER REFERENCES studies (study_id),
    key VARCHAR(512), value_json TEXT, UNIQUE (study_id, key));
CREATE TABLE IF NOT EXISTS study_system_attributes (
    study_system_attribute_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_id INTEGER REFERENCES studies (study_id),
    key VARCHAR(512), value_json TEXT, UNIQUE (study_id, key));
CREATE TABLE IF NOT EXISTS trials (
    trial_id INTEGER PRIMARY KEY AUTOINCREMENT,
    number INTEGER,
    study_id INTEGER REFERENCES studies (study_id),
    state VARCHAR(8) NOT NULL,
    datetime_start DATETIME, datetime_complete DATETIME);
CREATE TABLE IF NOT EXISTS trial_values (
    trial_value_id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id INTEGER NOT NULL REFERENCES trials (trial_id),
    objective INTEGER NOT NULL,
    value FLOAT,
    value_type VARCHAR(7) NOT NULL,
    UNIQUE (trial_id, objective));
CREATE TABLE IF NOT EXISTS trial_params (
    param_id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id INTEGER REFERENCES trials (trial_id),
    param_name VARCHAR(512),
    param_value FLOAT,
    distribution_json TEXT,
    UNIQUE (trial_id, param_name));
CREATE TABLE IF NOT EXISTS trial_intermediate_values (
    trial_intermediate_value_id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id INTEGER NOT NULL REFERENCES trials (trial_id),
    step INTEGER,
    intermediate_value FLOAT,
    intermediate_value_type VARCHAR(7) NOT NULL,
    UNIQUE (trial_id, step));
CREATE TABLE IF NOT EXISTS trial_user_attributes (
    trial_user_attribute_id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id INTEGER REFERENCES trials (trial_id),
    key VARCHAR(512), value_json TEXT, UNIQUE (trial_id, key));
CREATE TABLE IF NOT EXISTS trial_system_attributes (
    trial_system_attribute_id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id INTEGER REFERENCES trials (trial_id),
    key VARCHAR(512), value_json TEXT, UNIQUE (trial_id, key));
"""

_ALEMBIC_HEAD = "v3.0.0.c"
_SCHEMA_VERSION = 12
_LIBRARY_VERSION = "3.6.1"

# study state → optuna TrialState
_STATE = {"RUNNING": "RUNNING", "COMPLETE": "COMPLETE",
          "PRUNED": "PRUNED", "FAIL": "FAIL"}
_STATE_BACK = {v: k for k, v in _STATE.items()}


def _float_value(v: float) -> tuple[float | None, str]:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None, "NAN"
    if math.isinf(v):
        return None, "INF_POS" if v > 0 else "INF_NEG"
    return float(v), "FINITE"


def _param_row(name: str, value: Any) -> tuple[float, str]:
    """(internal float repr, distribution_json) — degenerate single-point
    distributions, since the JSON studies don't persist search spaces."""
    if isinstance(value, bool) or isinstance(value, str):
        dist = {"name": "CategoricalDistribution",
                "attributes": {"choices": [value]}}
        return 0.0, json.dumps(dist)
    if isinstance(value, int):
        dist = {"name": "IntDistribution",
                "attributes": {"log": False, "step": 1,
                               "low": value, "high": value}}
        return float(value), json.dumps(dist)
    dist = {"name": "FloatDistribution",
            "attributes": {"log": False, "step": None,
                           "low": float(value), "high": float(value)}}
    return float(value), json.dumps(dist)


def export_study_to_sqlite(json_path: str, db_path: str,
                           direction: str = "minimize") -> str:
    """Write a train/hpo.py JSON study into an optuna-3.x SQLite DB."""
    with open(json_path) as f:
        data = json.load(f)
    study_name = data.get("study_name") or os.path.splitext(
        os.path.basename(json_path))[0]
    direction = data.get("direction", direction)

    os.makedirs(os.path.dirname(os.path.abspath(db_path)), exist_ok=True)
    con = sqlite3.connect(db_path)
    try:
        con.executescript(_SCHEMA)
        con.execute("INSERT OR IGNORE INTO alembic_version VALUES (?)",
                    (_ALEMBIC_HEAD,))
        con.execute(
            "INSERT OR IGNORE INTO version_info VALUES (1, ?, ?)",
            (_SCHEMA_VERSION, _LIBRARY_VERSION))
        cur = con.execute(
            "INSERT OR IGNORE INTO studies (study_name) VALUES (?)",
            (study_name,))
        study_id = con.execute(
            "SELECT study_id FROM studies WHERE study_name=?",
            (study_name,)).fetchone()[0]
        con.execute(
            "INSERT OR IGNORE INTO study_directions "
            "(direction, study_id, objective) VALUES (?, ?, 0)",
            (direction.upper(), study_id))

        for t in data.get("trials", []):
            cur = con.execute(
                "INSERT INTO trials (number, study_id, state, "
                "datetime_start, datetime_complete) VALUES (?, ?, ?, "
                "datetime('now'), datetime('now'))",
                (t["number"], study_id, _STATE.get(t["state"], "FAIL")))
            trial_id = cur.lastrowid
            if t.get("value") is not None:
                value, vtype = _float_value(t["value"])
                con.execute(
                    "INSERT INTO trial_values (trial_id, objective, value, "
                    "value_type) VALUES (?, 0, ?, ?)",
                    (trial_id, value, vtype))
            for name, pv in (t.get("params") or {}).items():
                internal, dist = _param_row(name, pv)
                con.execute(
                    "INSERT INTO trial_params (trial_id, param_name, "
                    "param_value, distribution_json) VALUES (?, ?, ?, ?)",
                    (trial_id, name, internal, dist))
            for step, iv in (t.get("intermediate") or {}).items():
                value, vtype = _float_value(iv)
                con.execute(
                    "INSERT INTO trial_intermediate_values (trial_id, step, "
                    "intermediate_value, intermediate_value_type) "
                    "VALUES (?, ?, ?, ?)",
                    (trial_id, int(step), value, vtype))
        con.commit()
    finally:
        con.close()
    log.info(f"Exported study '{study_name}' → {db_path}")
    return db_path


def import_study_from_sqlite(db_path: str, json_path: str,
                             study_name: str | None = None) -> str:
    """Read an optuna SQLite DB back into the JSON study format (values,
    params as plain Python values, intermediate reports, states)."""
    con = sqlite3.connect(db_path)
    try:
        if study_name is None:
            study_name = con.execute(
                "SELECT study_name FROM studies LIMIT 1").fetchone()[0]
        study_id, = con.execute(
            "SELECT study_id FROM studies WHERE study_name=?",
            (study_name,)).fetchone()
        row = con.execute(
            "SELECT direction FROM study_directions WHERE study_id=?",
            (study_id,)).fetchone()
        direction = (row[0].lower() if row else "minimize")

        trials = []
        for trial_id, number, state in con.execute(
                "SELECT trial_id, number, state FROM trials "
                "WHERE study_id=? ORDER BY number", (study_id,)):
            value = None
            vrow = con.execute(
                "SELECT value, value_type FROM trial_values "
                "WHERE trial_id=? AND objective=0", (trial_id,)).fetchone()
            if vrow is not None:
                value = {"FINITE": vrow[0], "NAN": float("nan"),
                         "INF_POS": float("inf"),
                         "INF_NEG": float("-inf")}[vrow[1]]
            params = {}
            for name, internal, dist_json in con.execute(
                    "SELECT param_name, param_value, distribution_json "
                    "FROM trial_params WHERE trial_id=?", (trial_id,)):
                dist = json.loads(dist_json)
                if dist["name"] == "CategoricalDistribution":
                    params[name] = dist["attributes"]["choices"][int(internal)]
                elif dist["name"] == "IntDistribution":
                    params[name] = int(internal)
                else:
                    params[name] = float(internal)
            intermediate = {
                str(step): val for step, val in con.execute(
                    "SELECT step, intermediate_value FROM "
                    "trial_intermediate_values WHERE trial_id=?", (trial_id,))
            }
            trials.append({
                "number": number,
                "state": _STATE_BACK.get(state, "FAIL"),
                "value": value,
                "params": params,
                "intermediate": intermediate,
            })
    finally:
        con.close()

    out = {"study_name": study_name, "direction": direction, "trials": trials}
    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(out, f, indent=2)
    log.info(f"Imported study '{study_name}' ← {db_path} → {json_path}")
    return json_path
