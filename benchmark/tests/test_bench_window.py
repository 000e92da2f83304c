"""Window statistics: every solve of the window counts, so a stall inside
the window moves both the mean time a solve and its tail."""

import random
import time

import pytest

from benchmark import run, stats


class SleepingEntry:
    """Solves by sleeping ``delays[k]`` on its k-th call."""

    def __init__(self, delays):
        self.delays = list(delays)
        self.calls = 0

    def solve(self, ivp):
        time.sleep(self.delays[min(self.calls, len(self.delays) - 1)])
        self.calls += 1
        return ("solution", ivp)

    def counters(self):
        return {"calls": self.calls}


def window(delays, seconds):
    return run.measured_window(
        SleepingEntry(delays), [0, 1, 2], seconds, 2, random.Random(5), False
    )


def test_a_stall_moves_the_mean_and_the_tail():
    steady = [0.004] * 1000
    stalled = [0.004] * 10 + [0.004 if k % 10 else 0.08 for k in range(990)]
    results = {}
    for name, delays in (("steady", steady), ("stalled", stalled)):
        window_s, records, attempted, failed, kept = window(delays, 0.6)
        assert failed == 0 and attempted == len(records)
        assert len(kept) == 2
        results[name] = (
            stats.mean_ms(window_s, len(records)),
            stats.percentile_ms([r["seconds"] for r in records], 95),
        )
    assert results["stalled"][0] > 2.0 * results["steady"][0]
    assert results["stalled"][1] > 10.0 * results["steady"][1]


def test_the_window_runs_past_its_length_only_to_finish_a_solve():
    window_s, records, attempted, _, _ = window([0.05] * 100, 0.2)
    assert 0.2 <= window_s < 0.3
    assert attempted == len(records) >= 4


def test_percentile_and_mean():
    assert stats.percentile_ms([0.001 * k for k in range(1, 101)], 95) == (
        pytest.approx(95.05)
    )
    assert stats.mean_ms(2.0, 4) == 500.0
    assert stats.mean_ms(2.0, 0) is None
