"""The comparison that decides ``correct``: solves of the program (or of
a control in its place) against the plain reference
(``benchmark/reference/``), one number for each name in the traffic's
``check.limits``, read by ``benchmark/checks/<name>.py``, beside its
limit. A run and ``control.py`` judge by these functions alike."""

from __future__ import annotations

import importlib
import math

import numpy as np

from benchmark import files, traffic as traffic_module


def reference_solves(config, traffic, items, dtype=np.float64, storage=None):
    """The reference's frames ``(B, steps, ...)`` and counts
    (``{name: (B,) array}``) of the pool items ``items``, in ``dtype``;
    ``storage="bfloat16"`` rounds the state after every step."""
    reference = importlib.import_module(
        f"benchmark.reference.{config['reference']}"
    )
    values = traffic_module.initial_condition(traffic).values
    y_0 = reference.initial_states(config, values, items, dtype)
    return reference.trajectory(config, y_0, dtype, storage=storage)


def judge(traffic, solves, frames, info) -> dict:
    """``{name: {"value": v, "limit": l}}``: each number the largest over
    ``solves``, each ``(row, ys, counters)``: the row of the reference's
    ``frames`` and ``info`` it is held against, the solve's trajectory
    and its counters."""
    checks = {}
    for name, limit in traffic["check"]["limits"].items():
        gap = files.harness_module("checks", name).gap
        value = 0.0
        for row, ys, counters in solves:
            ref_counters = {key: counts[row] for key, counts in info.items()}
            reading = float(gap(ys, frames[row], counters, ref_counters))
            value = max(value, math.inf if math.isnan(reading) else reading)
        checks[name] = {"value": value, "limit": limit}
    return checks


def correct(checks: dict) -> bool:
    return all(check["value"] <= check["limit"] for check in checks.values())
