"""The program's spans of a traced window, laid on the profile's timeline,
and the device's idle time of the window attributed to them.

The port records spans (``pararealml_tpu_torch.utils.tracing``) only while
the profiler records, so after a traced run its recorder holds the
window's spans: one root span a solve, with the solve's layers inside.
The k-th root is matched with the k-th ``bench.solve`` interval of the
trace, counted from the last (a process that ran earlier profiles keeps
their spans before them); where there are fewer roots than solves, or the
recorder dropped spans, there is nothing to read.

The spans' stamps are ``CLOCK_REALTIME`` ns, the profiler's are µs from
the start of its trace: the two differ by one constant. Each root opens
a little after its ``bench.solve`` does, so the constant is taken as the
smallest difference of the two starts over the solves; what each solve's
difference exceeds it by is its anchor residual.

Each idle gap of the window (``trace.merged`` of the device intervals) is
cut at the boundaries of the solves and spans and each piece goes to the
innermost span open over it: a piece inside a solve but inside no span is
``untraced``, one outside every solve ``outside``. The pieces add up to
the window's idle time.

Nothing here raises where the program has no recorder: the readers
return None.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from benchmark import trace as trace_module

UNTRACED = "untraced"
OUTSIDE = "outside"
COUNTER = "rk4_state_steps"

_CACHE: Dict[int, Tuple[object, Optional[SimpleNamespace]]] = {}


def window_spans():
    """The program's records, or None where it has no recorder or the
    recorder dropped spans."""
    try:
        from pararealml_tpu_torch.utils import tracing
    except ImportError:
        return None
    if tracing.dropped():
        return None
    return tracing.spans()


def align(records, solves) -> Optional[Tuple[List[int], int, List[float]]]:
    """``(roots, offset_ns, residuals_us)``: the indices of the roots
    matched with ``solves`` (the trace's ``bench.solve`` intervals, in
    order), the offset of the spans' clock over the trace's in ns, and
    each solve's anchor residual in µs; None where there are fewer roots
    than solves or no solve."""
    roots = [k for k, record in enumerate(records) if record.parent is None]
    if not solves or len(roots) < len(solves):
        return None
    roots = roots[len(roots) - len(solves):]
    deltas = [
        records[k].start_ns - round(1000.0 * solve.start_us)
        for k, solve in zip(roots, solves)
    ]
    offset = min(deltas)
    return roots, offset, [(d - offset) / 1000.0 for d in deltas]


def idle_pieces(device, window, labelled) -> Dict[str, float]:
    """The idle µs of ``window`` outside the ``device`` intervals, summed
    by the label of the innermost of ``labelled`` (``(start_us, end_us,
    depth, label)``) open over each piece; ``OUTSIDE`` where none is."""
    start, end = window
    gaps, cursor = [], start
    for s, e in trace_module.merged(device):
        if e <= start or s >= end:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        gaps.append((cursor, end))

    events = []
    for index, (s, e, _, _) in enumerate(labelled):
        s, e = max(s, start), min(e, end)
        if s < e:
            events.append((s, 1, index))
            events.append((e, 0, index))
    events.sort()
    bounds = [start] + [t for t, _, _ in events] + [end]

    totals: Dict[str, float] = {}
    active: Dict[int, int] = {}
    g = 0
    for k in range(len(bounds) - 1):
        if k > 0:
            _, opens, index = events[k - 1]
            if opens:
                active[index] = labelled[index][2]
            else:
                active.pop(index, None)
        a, b = bounds[k], bounds[k + 1]
        if b <= a:
            continue
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        idle, h = 0.0, g
        while h < len(gaps) and gaps[h][0] < b:
            idle += min(b, gaps[h][1]) - max(a, gaps[h][0])
            h += 1
        if idle <= 0.0:
            continue
        if active:
            innermost = max(active, key=lambda i: (active[i], i))
            label = labelled[innermost][3]
        else:
            label = OUTSIDE
        totals[label] = totals.get(label, 0.0) + idle
    return totals


def _analyse(run) -> Optional[SimpleNamespace]:
    if run.trace is None:
        return None
    records = window_spans()
    if not records:
        return None
    solves = sorted(
        (i for i in run.trace.host if i.name == trace_module.SOLVE_SPAN),
        key=lambda i: i.start_us,
    )
    aligned = align(records, solves)
    if aligned is None:
        return None
    roots, offset, residuals = aligned
    chosen = set(roots)
    spans = [
        (k, r) for k, r in enumerate(records)
        if r.root in chosen and r.end_ns is not None
    ]
    depth: Dict[int, int] = {}
    for k, record in spans:
        depth[k] = depth.get(record.parent, 0) + 1
    labelled = [(s.start_us, s.end_us, 0, UNTRACED) for s in solves]
    labelled += [
        (
            (record.start_ns - offset) / 1000.0,
            (record.end_ns - offset) / 1000.0,
            depth[k],
            record.name,
        )
        for k, record in spans
    ]
    idle_us = idle_pieces(run.trace.device, run.trace.window, labelled)

    def total_ns(name):
        return sum(
            record.end_ns - record.start_ns
            for _, record in spans
            if record.name == name
        )

    steps = [r.counts[COUNTER] for _, r in spans if COUNTER in r.counts]
    return SimpleNamespace(
        solves=len(solves),
        residuals_us=residuals,
        idle_s={name: us / 1e6 for name, us in idle_us.items()},
        total_ns=total_ns,
        steps=sum(steps) if steps else None,
    )


def analysis(run) -> Optional[SimpleNamespace]:
    """The window's spans against the trace of ``run``: ``solves``,
    ``residuals_us``, ``idle_s`` (idle seconds by innermost span name,
    ``UNTRACED`` and ``OUTSIDE``), ``total_ns(name)`` (the summed
    durations of the spans of that name) and ``steps`` (the summed
    ``rk4_state_steps``, None where no span counted any); None where
    there is nothing to read. Computed once a run."""
    key = id(run)
    if key not in _CACHE or _CACHE[key][0] is not run:
        _CACHE.clear()
        _CACHE[key] = (run, _analyse(run))
    return _CACHE[key][1]

