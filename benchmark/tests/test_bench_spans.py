"""The program's spans laid on a synthetic trace: the alignment recovers
the clocks' offset, each idle piece goes to the innermost span open over
it (``untraced`` inside a solve but no span, ``outside`` beyond every
solve), the pieces add up to the window's idle time, and the readers
give nothing where the program records no spans."""

from types import SimpleNamespace

import pytest

from benchmark import files, spans
from benchmark.trace import Interval, Trace

OFFSET_NS = 1_792_316_153_826_000_000
READERS = ("solution_ms", "schedule_idle_ms", "untraced_idle_ms", "rk4_steps")


def record(name, start_us, end_us, parent, root, counts=None):
    return SimpleNamespace(
        name=name,
        start_ns=OFFSET_NS + round(1000 * start_us),
        end_ns=OFFSET_NS + round(1000 * end_us),
        parent=parent,
        root=root,
        attrs={},
        counts=counts or {},
    )


def synthetic():
    """A 100 µs window with two solves, [10, 50] and [60, 90], the device
    busy over [20, 30] and [70, 75], and a span tree in each solve; an
    earlier profile's root comes first."""
    records = [
        record("fdm.solve", -500, -400, None, 0),
        record("fdm.solve", 10, 49, None, 1, {"rk4_state_steps": 10}),
        record("solution.build", 35, 45, 1, 1),
        record("parareal.solve", 61, 89, None, 3),
        record("parareal.iteration", 62, 80, 3, 3),
        record("parareal.fine_ends", 63, 70, 4, 3, {"rk4_state_steps": 40}),
    ]
    trace = Trace(
        device=[Interval("k", 20.0, 30.0), Interval("k", 70.0, 75.0)],
        host=[
            Interval("bench.window", 0.0, 100.0),
            Interval("bench.solve", 60.0, 90.0),
            Interval("bench.solve", 10.0, 50.0),
        ],
        window=(0.0, 100.0),
    )
    return records, SimpleNamespace(trace=trace)


@pytest.fixture
def recorded(monkeypatch):
    records, run = synthetic()
    monkeypatch.setattr(spans, "window_spans", lambda: records)
    return records, run


def test_alignment_recovers_the_offset():
    records, run = synthetic()
    solves = sorted(
        (i for i in run.trace.host if i.name == "bench.solve"),
        key=lambda i: i.start_us,
    )
    roots, offset, residuals = spans.align(records, solves)
    assert roots == [1, 3]
    assert offset == OFFSET_NS
    assert residuals == [0.0, 1.0]
    assert spans.align(records[3:], solves) is None
    assert spans.align(records, []) is None


def test_idle_goes_to_the_innermost_span_and_adds_up(recorded):
    _, run = recorded
    found = spans.analysis(run)
    idle_us = {name: 1e6 * s for name, s in found.idle_s.items()}
    assert idle_us == pytest.approx({
        spans.OUTSIDE: 30.0,
        spans.UNTRACED: 3.0,
        "fdm.solve": 19.0,
        "solution.build": 10.0,
        "parareal.solve": 10.0,
        "parareal.iteration": 6.0,
        "parareal.fine_ends": 7.0,
    })
    # the window less the device's busy 15 µs
    assert sum(idle_us.values()) == pytest.approx(85.0)
    assert found.solves == 2 and found.steps == 50


def test_readers(recorded):
    _, run = recorded
    values = {
        name: files.harness_module("metrics", name).read(run)
        for name in READERS
    }
    assert values == pytest.approx({
        "solution_ms": 0.005,
        "schedule_idle_ms": 0.0065,
        "untraced_idle_ms": 0.0015,
        "rk4_steps": 25.0,
    })


def test_readers_give_nothing_without_spans(monkeypatch):
    _, run = synthetic()
    monkeypatch.setattr(spans, "window_spans", lambda: None)
    for name in READERS:
        assert files.harness_module("metrics", name).read(run) is None
    assert spans.analysis(SimpleNamespace(trace=None)) is None
