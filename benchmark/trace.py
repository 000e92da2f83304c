"""Reduction of a ``torch.profiler`` trace of the measured window: the
device intervals, their union (busy time), the device operations that
took the most time, and the idle gaps named by what the host was doing.

Device intervals come from the profiler's CUDA events (kernels, copies,
fills). Host operations are its CPU events, the benchmark's own spans
(``bench.window``, ``bench.solve``) among them; an idle gap is named by
the innermost host operation running at its midpoint.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

TOP = 10
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
SOLVE_SPAN = "bench.solve"


class Interval(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    device: List[Interval]
    host: List[Interval]
    window: Tuple[float, float]


def collect(prof) -> Trace:
    """The device and host intervals of a finished profile, and the
    bounds of the ``bench.window`` span (all in the profiler's µs)."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for event in prof.events():
        interval = Interval(
            event.name, event.time_range.start, event.time_range.end
        )
        if event.device_type == DeviceType.CUDA:
            # the benchmark's spans are mirrored on the device's timeline
            # as annotations: they are no device work
            if not event.name.startswith(SPAN_PREFIX):
                device.append(interval)
        elif event.device_type == DeviceType.CPU:
            if event.name == WINDOW_SPAN:
                window = (interval.start_us, interval.end_us)
            host.append(interval)
    if window is None:
        starts = [i.start_us for i in device + host]
        ends = [i.end_us for i in device + host]
        window = (min(starts), max(ends)) if starts else (0.0, 0.0)
    return Trace(device, host, window)


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint, sorted (start, end)."""
    out: List[Tuple[float, float]] = []
    for _, start, end in sorted(intervals, key=lambda i: i.start_us):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def busy_us(trace: Trace) -> float:
    """The microseconds in which some operation ran on the device."""
    return sum(end - start for start, end in merged(trace.device))


def device_ops(trace: Trace) -> List[List]:
    """The device operations of most time, ``[name, seconds]``."""
    totals: Dict[str, float] = {}
    for name, start, end in trace.device:
        totals[name] = totals.get(name, 0.0) + (end - start) / 1e6
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], seconds] for name, seconds in ranked]


def idle_gaps(trace: Trace) -> List[List]:
    """The idle time of the device within the window, summed by the
    innermost host operation running at each gap's midpoint,
    ``[name, seconds]``, the largest first."""
    start, end = trace.window
    busy = [
        (max(s, start), min(e, end))
        for s, e in merged(trace.device)
        if e > start and s < end
    ]
    gaps, cursor = [], start
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        gaps.append((cursor, end))
    host = sorted(
        (i for i in trace.host if i.name != WINDOW_SPAN),
        key=lambda i: i.start_us,
    )
    totals: Dict[str, float] = {}
    active: List[Interval] = []
    index = 0
    for gap_start, gap_end in sorted(gaps):
        middle = 0.5 * (gap_start + gap_end)
        while index < len(host) and host[index].start_us <= middle:
            active.append(host[index])
            index += 1
        active = [i for i in active if i.end_us >= middle]
        innermost: Optional[Interval] = max(
            active, key=lambda i: (i.start_us, -i.end_us), default=None
        )
        if innermost is None:
            name = "host, outside any solve"
        elif innermost.name == SOLVE_SPAN:
            name = "bench.solve: host code, no torch operation"
        else:
            name = innermost.name
        totals[name] = totals.get(name, 0.0) + (gap_end - gap_start) / 1e6
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], seconds] for name, seconds in ranked]


def device_seconds(trace: Trace, exclude=("memcpy", "memset", "copy")):
    """The device seconds of the operations whose names contain none of
    ``exclude`` (case-insensitive): the compute kernels."""
    total = 0.0
    for name, start, end in trace.device:
        lowered = name.lower()
        if not any(word in lowered for word in exclude):
            total += (end - start) / 1e6
    return total


def kernel_seconds(trace: Trace, name: str) -> float:
    """The device seconds of the kernels whose names contain ``name``."""
    return sum(
        (end - start) / 1e6
        for kernel, start, end in trace.device
        if name in kernel
    )


def copy_seconds(trace: Trace, direction: str) -> float:
    """The device seconds of the profiler's memory copies whose names
    contain ``direction`` (``"DtoH"``, ``"HtoD"``)."""
    return sum(
        (end - start) / 1e6
        for name, start, end in trace.device
        if name.startswith("Memcpy") and direction in name
    )
