"""Spans and counters of the port's solves.

A span names a layer of a solve (``fdm.solve``, ``solve.trajectory``,
``parareal.iteration``, ...) and holds its start and end stamps; a count
adds to the innermost open span (``rk4_state_steps``: the RK4 steps the
fused kernels ran, summed over their states). Records are kept only while
torch's profiler records (``torch.profiler.profile``); otherwise
:func:`span` returns one shared context that does nothing and
:func:`count` returns at once, so an untraced solve pays one flag check a
call.

Stamps are ``time.time_ns()``: ``CLOCK_REALTIME`` in ns, the clock the
profiler stamps its events with, so a span lies on the profiler's
timeline up to one constant offset a profile. Nothing is written into the
profiler's trace. Read the records with :func:`spans` after the profile
and drop them with :func:`clear`::

    with torch.profiler.profile():
        operator.solve(ivp)
    for record in tracing.spans():
        print(record.name, record.end_ns - record.start_ns, record.counts)

Spans nest by the order they are opened in; the recorder serves one
thread.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

# the most records kept; spans opened past it are dropped and counted
MAX_RECORDS = 1 << 20

_recording = torch._C._autograd._profiler_enabled


class SpanRecord:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (None while
    open), the indices of its ``parent`` (None for a root) and of its
    ``root`` (every span of one solve shares it), its ``attrs`` and the
    ``counts`` added while it was the innermost open span."""

    __slots__ = (
        "name", "start_ns", "end_ns", "parent", "root", "attrs", "counts",
    )

    def __init__(self, name, start_ns, parent, root, attrs):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.parent = parent
        self.root = root
        self.attrs = attrs
        self.counts: Dict[str, int] = {}


_records: List[SpanRecord] = []
# indices of the open spans, the innermost last
_open: List[int] = []
_dropped = 0


class _Span:
    __slots__ = ("_name", "_attrs", "_record")

    def __init__(self, name, attrs):
        self._name = name
        self._attrs = attrs
        self._record = None

    def __enter__(self):
        global _dropped
        if len(_records) >= MAX_RECORDS:
            _dropped += 1
            return self
        index = len(_records)
        parent = _open[-1] if _open else None
        root = index if parent is None else _records[parent].root
        self._record = SpanRecord(
            self._name, time.time_ns(), parent, root, self._attrs
        )
        _records.append(self._record)
        _open.append(index)
        return self

    def __exit__(self, *exc):
        record = self._record
        if record is not None:
            record.end_ns = time.time_ns()
            # a clear() while the span was open took it off the stack
            if _open and _records[_open[-1]] is record:
                _open.pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context that records a span named ``name`` with ``attrs`` while
    the profiler records, and does nothing otherwise."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the count ``name`` of the innermost open span (while
    the profiler records and a span is open)."""
    if not _open or not _recording():
        return
    counts = _records[_open[-1]].counts
    counts[name] = counts.get(name, 0) + int(n)


def spans() -> List[SpanRecord]:
    """The records kept since the last :func:`clear`, in the order their
    spans were opened."""
    return list(_records)


def dropped() -> int:
    """The spans dropped because :data:`MAX_RECORDS` were kept."""
    return _dropped


def clear() -> None:
    """Drops the records and the count of dropped spans."""
    global _dropped
    _records.clear()
    _open.clear()
    _dropped = 0
