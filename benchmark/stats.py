"""Window statistics over the solves of one run."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def mean_ms(window_s: float, completed: int) -> Optional[float]:
    """The window's wall time over the solves it completed, in ms."""
    if completed <= 0:
        return None
    return 1e3 * window_s / completed


def percentile_ms(seconds: Sequence[float], q: int) -> Optional[float]:
    """The ``q``-th percentile of the solve times, in ms (linear
    interpolation between order statistics, over every solve)."""
    if len(seconds) < 2:
        return None
    cuts = statistics.quantiles(seconds, n=100, method="inclusive")
    return 1e3 * cuts[q - 1]

