"""The port's spans and step counter (``utils/tracing.py``): nothing is
recorded without an active profiler; under a CPU-only
``torch.profiler.profile`` an FDM solve and a Parareal solve each give one
root span with the tree of their layers, every child within its parent
and every span sharing its root; the fused RK4 wrappers count states
times steps on their plain versions; and the profiler's own trace holds
no program span. Small problems: the flagship diffusion at d_x 1.0 (11 x
11), the 17 x 17 Navier-Stokes problem and the 17 x 33 wave problem of
tests/test_torch_cuda.py; and examples/wave_2d_fdm.py's 101 x 101 wave for
three steps, which takes the cluster-resident mode."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion
from pararealml_tpu_torch.ops import fused_navier_stokes as ns
from pararealml_tpu_torch.ops import fused_system
from pararealml_tpu_torch.utils import tracing
from tests.test_torch_cuda import navier_stokes_problem, system_problem

torch.set_num_threads(1)

T_END = 0.1
FINE_D_T = 0.005
COARSE_D_T = 0.025
SLICES = 4
ITERATIONS = 2
SOLVE_CHILDREN = [
    "solve.initial_state", "solve.trajectory", "solve.to_host",
    "solution.build",
]


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def _fdm(d_t, **kwargs):
    return FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        d_t,
        device="cpu",
        dtype=torch.float32,
        **kwargs,
    )


def _profiled(solve):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = solve()
    return result, prof, tracing.spans()


def _children(records, index):
    return [r for r in records if r.parent == index]


def _steps(records):
    return sum(r.counts.get("rk4_state_steps", 0) for r in records)


def _check_tree(records):
    """Exactly one root; every span closed, within its parent and sharing
    the root's identifier."""
    roots = [k for k, r in enumerate(records) if r.parent is None]
    assert roots == [0]
    for k, record in enumerate(records):
        assert record.root == 0
        assert record.start_ns <= record.end_ns
        if record.parent is not None:
            parent = records[record.parent]
            assert record.parent < k
            assert parent.start_ns <= record.start_ns
            assert record.end_ns <= parent.end_ns


def _check_no_program_event(prof, records):
    names = {event.name for event in prof.events()}
    assert not names & {r.name for r in records}


def test_nothing_is_recorded_without_a_profiler():
    ivp = build_problem(vars(torch_pkg), T_END, d_x=1.0)
    assert tracing.span("solve.trajectory") is tracing.span("fdm.solve")
    with tracing.span("fdm.solve"):
        tracing.count("rk4_state_steps", 5)
    _fdm(FINE_D_T).solve(ivp)
    assert tracing.spans() == []
    assert tracing.dropped() == 0


def test_fdm_solve_gives_one_root_with_its_layers():
    ivp = build_problem(vars(torch_pkg), T_END, d_x=1.0)
    operator = _fdm(FINE_D_T)
    solution, prof, records = _profiled(lambda: operator.solve(ivp))
    _check_tree(records)
    assert records[0].name == "fdm.solve"
    children = _children(records, 0)
    assert [r.name for r in children] == SOLVE_CHILDREN
    assert len(records) == 1 + len(SOLVE_CHILDREN)
    steps = round(T_END / FINE_D_T)
    assert children[2].attrs == {"bytes": solution.discrete_y().nbytes}
    # one K1 call (its plain version) of one state
    assert children[1].counts == {"rk4_state_steps": steps}
    _check_no_program_event(prof, records)


def test_a_cpu_solve_counts_no_page_locked_copy():
    """The CPU trajectory is copied into the ``Solution``: no
    ``to_host_pinned`` count anywhere in the solve."""
    ivp = build_problem(vars(torch_pkg), T_END, d_x=1.0)
    _, _, records = _profiled(lambda: _fdm(FINE_D_T).solve(ivp))
    assert [r.name for r in records if r.name == "solve.to_host"] == [
        "solve.to_host"
    ]
    assert not any("to_host_pinned" in r.counts for r in records)


def test_a_cpu_solve_counts_no_chunks():
    """A CPU solve's trajectory crosses to the host whole: no
    ``to_host_chunks`` count anywhere in the solve."""
    ivp = build_problem(vars(torch_pkg), T_END, d_x=1.0)
    _, _, records = _profiled(lambda: _fdm(FINE_D_T).solve(ivp))
    assert not any("to_host_chunks" in r.counts for r in records)


def test_parareal_solve_gives_one_root_with_the_schedule_inside():
    ivp = build_problem(vars(torch_pkg), T_END, d_x=1.0)
    operator = PararealOperator(
        _fdm(FINE_D_T, linear_propagator=False),
        _fdm(COARSE_D_T, linear_propagator=False),
        None,
        max_iterations=ITERATIONS,
        num_time_slices=SLICES,
    )
    _, _, records = _profiled(lambda: operator.solve(ivp))
    _check_tree(records)
    assert records[0].name == "parareal.solve"
    children = _children(records, 0)
    assert [r.name for r in children] == SOLVE_CHILDREN
    trajectory = records.index(children[1])
    schedule = _children(records, trajectory)
    iterations = operator.last_iterations
    assert iterations == ITERATIONS
    assert [r.name for r in schedule] == (
        ["parareal.coarse_sweep"]
        + ["parareal.iteration"] * iterations
        + ["parareal.expand"]
    )
    for i, record in enumerate(schedule[1:-1]):
        assert record.attrs == {"i": i}
        steps = _children(records, records.index(record))
        assert [r.name for r in steps] == [
            "parareal.fine_ends", "parareal.correction",
            "parareal.termination",
        ]
    # the coarse sweep over the whole domain, each iteration's fine ends
    # of every slice and coarse ends of the slices past it, the expansion
    fine = round(T_END / SLICES / FINE_D_T)
    coarse = round(T_END / SLICES / COARSE_D_T)
    expected = (
        SLICES * coarse
        + sum(SLICES * fine + (SLICES - 1 - i) * coarse
              for i in range(iterations))
        + SLICES * fine
    )
    assert _steps(records) == expected
    assert schedule[0].counts == {"rk4_state_steps": SLICES * coarse}


def test_wrappers_count_states_times_steps():
    ivp = build_problem(vars(torch_pkg), T_END, d_x=1.0)
    cfg = fused_diffusion._KernelConfig(ivp.constrained_problem, FINE_D_T)
    y = torch.ones((3, cfg.height, cfg.width))
    ns_cp = navier_stokes_problem(vars(torch_pkg))
    ns_cfg = ns._NavierStokesConfig(ns_cp, 0.05)
    ys = torch.zeros((2,) + ns_cfg.state_shape)
    calls = [
        (lambda: fused_diffusion.fused_diffusion_rk4_trajectory(y, cfg, 4),
         12),
        (lambda: fused_diffusion.fused_diffusion_rk4_end(y[0], cfg, 5), 5),
        (lambda: fused_diffusion.fused_diffusion_rk4_step(y, cfg), 3),
        (lambda: ns.fused_navier_stokes_rk4_trajectory(ys, ns_cfg, 2), 4),
        (lambda: ns.fused_navier_stokes_rk4_end(ys[0], ns_cfg, 3), 3),
        (lambda: ns.fused_navier_stokes_rk4_step(ys, ns_cfg), 2),
    ]

    def run():
        for k, (call, _) in enumerate(calls):
            with tracing.span("call", k=k):
                call()

    _, _, records = _profiled(run)
    assert [r.counts for r in records] == [
        {"rk4_state_steps": steps} for _, steps in calls
    ]


SYSTEM_WRAPPERS = {
    "k5_trajectory": (
        lambda y, cfg: fused_system.fused_system_rk4_trajectory(y, cfg, 4),
        4,
    ),
    "k5_end": (lambda y, cfg: fused_system.fused_system_rk4_end(y, cfg, 5), 5),
    "k5_step": (lambda y, cfg: fused_system.fused_system_rk4_step(y, cfg), 1),
    "mode_trajectory": (
        lambda y, cfg: fused_system.cluster_system_rk4_trajectory(y, cfg, 3),
        3,
    ),
    "mode_end": (
        lambda y, cfg: fused_system.cluster_system_rk4_end(y, cfg, 2), 2
    ),
}


@pytest.mark.parametrize("wrapper", sorted(SYSTEM_WRAPPERS))
def test_system_wrappers_count_states_times_steps(wrapper):
    """K5's and the cluster-resident mode's wrappers, plain versions: a
    batch of three states, then one state alone, each call counted under
    the innermost open span."""
    call, steps = SYSTEM_WRAPPERS[wrapper]
    cp = system_problem(vars(torch_pkg), "wave")
    cfg = fused_system._SystemKernelConfig(cp, FINE_D_T)
    ys = torch.ones((3,) + cfg.state_shape)

    def run():
        with tracing.span("outer"):
            with tracing.span("batch"):
                call(ys, cfg)
            with tracing.span("single"):
                call(ys[0], cfg)

    _, _, records = _profiled(run)
    assert [(r.name, r.counts) for r in records] == [
        ("outer", {}),
        ("batch", {"rk4_state_steps": 3 * steps}),
        ("single", {"rk4_state_steps": steps}),
    ]


def test_fdm_solve_of_the_wave_example_counts_the_modes_steps(monkeypatch):
    """examples/wave_2d_fdm.py's 101 x 101 problem, three steps: the solve
    takes the cluster-resident mode's trajectory once and counts its steps
    under ``solve.trajectory`` inside ``fdm.solve``."""
    zero = torch_pkg.DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = torch_pkg.ConstrainedProblem(
        torch_pkg.WaveEquation(2),
        torch_pkg.Mesh([(-5.0, 5.0), (-5.0, 5.0)], [0.1, 0.1]),
        [(zero, zero)] * 2,
    )
    ic = torch_pkg.GaussianInitialCondition(
        cp, [(np.array([0.0, 2.5]), 0.1 * np.eye(2))] * 2, [3.0, 0.0]
    )
    ivp = torch_pkg.InitialValueProblem(cp, (0.0, 0.03), ic)
    calls = []
    mode = fused_system.cluster_system_rk4_trajectory

    def counted(*args, **kwargs):
        calls.append(args[2])
        return mode(*args, **kwargs)

    monkeypatch.setattr(
        fused_system, "cluster_system_rk4_trajectory", counted
    )
    _, _, records = _profiled(lambda: _fdm(0.01).solve(ivp))
    _check_tree(records)
    assert records[0].name == "fdm.solve"
    children = _children(records, 0)
    assert [r.name for r in children] == SOLVE_CHILDREN
    assert calls == [3]
    assert children[1].counts == {"rk4_state_steps": 3}
    assert _steps(records) == 3


def test_a_failed_span_closes_and_a_full_recorder_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 2)

    def run():
        with pytest.raises(RuntimeError):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    raise RuntimeError("refused")
        with tracing.span("third"):
            tracing.count("rk4_state_steps", 1)

    _, _, records = _profiled(run)
    assert [r.name for r in records] == ["outer", "inner"]
    assert all(r.end_ns is not None for r in records)
    assert records[1].counts == {}
    assert tracing.dropped() == 1
    assert all(r.root == 0 for r in records)
