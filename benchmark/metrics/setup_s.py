"""``setup_s``: seconds from the process's start to the first timed
solve: imports, the library load (or its nvcc build in a fresh
checkout), the problem, the pool and the warm-up solves (host clock)."""


def read(run):
    return run.setup_s
