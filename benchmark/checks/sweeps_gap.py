"""Check ``sweeps_gap``: ``|sweeps - sweeps_ref| / sweeps_ref``, the
solve's Jacobi sweeps (the entry's counter) against the reference's. A
solve that reports no sweeps reads infinite."""


def gap(ys, ref, counters: dict, ref_counters: dict) -> float:
    if "sweeps" not in counters:
        return float("inf")
    expected = int(ref_counters["sweeps"])
    return abs(int(counters["sweeps"]) - expected) / expected
