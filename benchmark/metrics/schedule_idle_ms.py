"""``schedule_idle_ms``: the device's idle ms a solve while the innermost
program span is one of the Parareal schedule's (``parareal.*`` inside
the solve's trajectory: the coarse sweep, the iterations with their fine
ends, correction and termination, the expansion). Nothing where the
program records no such span."""

from benchmark import spans

ROOT = "parareal.solve"


def read(run):
    found = spans.analysis(run)
    if found is None:
        return None
    names = [
        name for name in found.idle_s
        if name.startswith("parareal.") and name != ROOT
    ]
    if not names:
        return None
    return 1e3 * sum(found.idle_s[name] for name in names) / found.solves
