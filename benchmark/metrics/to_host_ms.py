"""``to_host_ms``: the device-to-host copy time a solve, in ms: the
profiler's ``Memcpy DtoH`` events over the window, per completed solve.
The trajectory's trip to the host inside ``solve``."""

from benchmark import trace


def read(run):
    if run.trace is None or not run.solves:
        return None
    seconds = trace.copy_seconds(run.trace, "DtoH")
    if seconds <= 0.0:
        return None
    return 1e3 * seconds / len(run.solves)
