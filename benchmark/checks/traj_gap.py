"""Check ``traj_gap``: ``max|y - y_ref| / max|y_ref|`` over the solve's
whole trajectory. A trajectory of another shape, or with a value that is
not finite, reads infinite."""

import numpy as np


def gap(ys, ref, counters: dict, ref_counters: dict) -> float:
    if ys.shape != ref.shape or not np.isfinite(ys).all():
        return float("inf")
    return float(np.abs(ys - ref).max() / np.abs(ref).max())
