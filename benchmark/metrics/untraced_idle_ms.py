"""``untraced_idle_ms``: the device's idle ms a solve inside the
benchmark's ``bench.solve`` span and outside every program span: the
host time of a solve that no layer of the program names. Nothing where
the program records no spans."""

from benchmark import spans


def read(run):
    found = spans.analysis(run)
    if found is None:
        return None
    return 1e3 * found.idle_s.get(spans.UNTRACED, 0.0) / found.solves
