"""The tiny horizons of configurations added after the benchmark's test
fixtures (``benchmark/tests/conftest.py``), which look each
configuration's horizon up by its name in ``TINY_T_END``: the wave
example's 20 steps, enough for a solve taking one step in ten to differ
from the fine solve."""

from benchmark.tests import conftest as fixtures

fixtures.TINY_T_END.setdefault("wave_2d_fdm", 0.2)
