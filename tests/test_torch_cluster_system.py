"""The cluster-resident mode of the 2D system kernels (its CPU side): the
cluster plan with its sizes, slabs and refusals; the routing at the 2D
examples' real shapes, from their plans alone; and ``FDMOperator.solve``
and an 8-slice Parareal reaching the mode on a small grid (the one-CTA
limit patched down), held against one run of the JAX package's K5 in
interpret mode, which is what the JAX package runs on those grids. The
mode's plain version is K5's (it computes what K5 computes, in K5's
order); the CUDA kernel is held against it in tests/test_torch_cuda.py.

Tolerance: the port's float32 results agree with the JAX kernel's to
1e-5 relative to the largest value (the same float32 operations in the
same order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.operators.fdm import FDMOperator as JaxFDMOperator
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from pararealml_tpu.operators.fdm import (
    ThreePointCentralDifferenceMethod as JaxThreePoint,
)
from pararealml_tpu.ops import fused_system as jax_fused
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_system as torch_fused
from pararealml_tpu_torch.ops import packed_system as torch_packed
from pararealml_tpu_torch.ops import tiled_system as torch_tiled
from tests.test_torch_cuda import states_2d, system_problem

torch.set_num_threads(1)

F32_TOL = 1e-5


def _relative_error(actual, expected):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    return np.abs(actual - expected).max() / np.abs(expected).max()


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _examples(module):
    """The 2D examples' problems at their own sizes, by name
    (examples/cahn_hilliard_2d_fdm.py's: gamma 0.01 on [0, 10]^2 at 0.1,
    zero-flux faces)."""
    flux = module.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cahn_hilliard = module.ConstrainedProblem(
        module.CahnHilliardEquation(2, gamma=0.01),
        module.Mesh([(0.0, 10.0)] * 2, [0.1, 0.1]),
        [(flux, flux)] * 2,
    )
    return {
        "wave 101^2": chip_smoke.wave_example(module)[0].constrained_problem,
        "shallow water 101 x 51": chip_smoke.shallow_water_example(module)[
            0
        ].constrained_problem,
        "cahn-hilliard 101^2": cahn_hilliard,
        "polar wave 51 x 201": chip_smoke.wave_polar_example(module)[
            0
        ].constrained_problem,
    }


@pytest.mark.parametrize(
    "shape, n, polar, step, size, cells, rows",
    [
        # the examples' grids at the plans measured fastest: 16 blocks
        # of 7 rows (the first five) or 6, one cell a thread (the wave
        # and Cahn-Hilliard examples' blocks of 1,024 threads at most)
        ((101, 101), 2, False, "rk4", 16, 1, (7,) * 5 + (6,) * 11),
        ((101, 51), 3, False, "rk4", 16, 1, (7,) * 5 + (6,) * 11),
        ((101, 101), 2, False, "cahn-hilliard", 16, 1, (7,) * 5 + (6,) * 11),
        # the polar wave example's 51 rows: 3 blocks of 4, 13 of 3, two
        # cells a thread
        ((51, 201), 2, True, "rk4", 16, 2, (4,) * 3 + (3,) * 13),
        # a grid just past one CTA takes its kind's entry
        ((75, 75), 2, False, "rk4", 16, 1, (5,) * 11 + (4,) * 5),
        # a polar shallow-water grid takes the Cartesian entry of its kind
        ((60, 90), 3, True, "rk4", 16, 1, (4,) * 12 + (3,) * 4),
    ],
)
def test_cluster_plan(shape, n, polar, step, size, cells, rows):
    """The plan splits the rows as evenly as they divide, every block
    with a row, into the measured table's cluster size, each thread
    owning the table's cells (where they fit: at most 1,024 threads of
    one cell or 512 of two or four)."""
    plan = torch_fused.make_cluster_plan(*shape, n, polar, step)
    assert (plan.cluster_size, plan.cells) == (size, cells)
    assert plan.block_rows == rows
    assert sum(plan.block_rows) == shape[0]
    assert plan.slab_rows == max(rows)
    assert plan.block_cells == max(rows) * shape[1]
    assert plan.threads <= (1024 if cells == 1 else 512)
    assert plan.threads % 32 == 0
    assert plan.threads * plan.cells >= plan.block_cells
    assert plan.fits
    assert plan.shared_bytes <= torch_fused.MAX_SHARED_MEMORY_BYTES


def test_cluster_plan_batches_and_refusals():
    """A batch takes the largest size at which the card holds every
    state's cluster at once (the counts given, or the measured ones),
    else the smallest valid size; grids past the mode's range have no
    plan, and a plan the instances do not take is refused on any
    device before any launch."""
    def active(plan):
        if plan.cluster_size <= 8:
            return 16
        return 14 if plan.threads <= 256 else 7

    def plan_of(batch):
        return torch_fused.make_cluster_plan(
            101, 101, 2, batch=batch, active_clusters=active
        )

    assert (plan_of(7).cluster_size, plan_of(7).cells) == (16, 1)
    # 4 cells a thread: 192 threads a block, two blocks a multiprocessor
    assert (plan_of(8).cluster_size, plan_of(8).cells) == (16, 4)
    assert (plan_of(15).cluster_size, plan_of(15).cells) == (8, 4)
    # no size places 17 clusters: the smallest valid size (6 blocks of
    # at most 17 rows, 1,717 cells) runs them in waves
    assert (plan_of(17).cluster_size, plan_of(17).cells) == (6, 4)
    measured = torch_fused.make_cluster_plan(101, 101, 2, batch=8)
    assert torch_fused._measured_active_clusters(measured) >= 8
    # past the range: 12 rows of 177 columns exceed 2,048 cells a block
    assert torch_fused.make_cluster_plan(176, 176, 2) is not None
    assert torch_fused.make_cluster_plan(177, 177, 2) is None
    assert torch_fused.make_cluster_plan(641, 641, 2) is None
    assert torch_fused.make_cluster_plan(2, 9, 2) is None

    cp = system_problem(vars(torch_pkg), "wave", "dirichlet", (17, 33))
    cfg = torch_fused._SystemKernelConfig(cp, 1e-3)
    plan = torch_fused.cluster_plan(cfg)
    y = torch.as_tensor(states_2d((17, 33), 2))
    launches = torch_fused.cluster_system_rk4_trajectory.launches
    # a block takes at most 1,024 threads of one cell, 512 of two or four
    wide = torch_fused.ClusterPlan(101, 101, 2, False, 11, 1)
    assert wide.threads == 1024 and wide.fits
    assert not wide._replace(cluster_size=10).fits
    assert not wide._replace(cluster_size=8, cells=2).fits
    for bad in (
        plan._replace(cluster_size=17),
        plan._replace(cluster_size=18),
        plan._replace(cells=3),
        plan._replace(width=35),
        plan._replace(polar=True),
    ):
        with pytest.raises(ValueError, match="does not fit"):
            torch_fused.cluster_system_rk4_trajectory(y, cfg, 2, plan=bad)
        with pytest.raises(ValueError, match="does not fit"):
            torch_fused.cluster_system_rk4_end(y, cfg, 2, plan=bad)
    big = system_problem(vars(torch_pkg), "wave", "dirichlet", (201, 201))
    with pytest.raises(ValueError, match="range"):
        torch_fused.cluster_plan(torch_fused._SystemKernelConfig(big, 1e-3))
    with pytest.raises(ValueError, match="frame_dtype"):
        torch_fused.cluster_system_rk4_trajectory(
            y, cfg, 2, frame_dtype=torch.float16
        )
    # the CPU runs the plain version (K5's) and counts no launch
    np.testing.assert_array_equal(
        torch_fused.cluster_system_rk4_trajectory(
            y, cfg, 3, frame_dtype=torch.bfloat16
        )
        .float()
        .numpy(),
        torch_fused.fused_system_rk4_trajectory_reference(y, cfg, 3)
        .to(torch.bfloat16)
        .float()
        .numpy(),
    )
    assert torch_fused.cluster_system_rk4_trajectory.launches == launches


def test_routing_at_the_examples_shapes(monkeypatch, x64_off):
    """From their plans alone: the four 2D examples' grids and the wave
    example's 8-slice Parareal fine ends take the cluster-resident mode
    (the JAX package's K5 there), 641^2 Burgers (past the JAX package's
    VMEM cap) and a 201^2 wave grid (within it, past the mode's range)
    take per-step K8. Each example's one-step trajectory and end go
    through the mode's wrappers (their plain versions here)."""
    calls = []
    for name in ("cluster_system_rk4_trajectory", "cluster_system_rk4_end"):
        wrapper = getattr(torch_fused, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append((_name, tuple(y.shape[:-3])))
            return _wrapper(y, *args, **kwargs)

        monkeypatch.setattr(torch_fused, name, counting)
    jax_examples = _examples(jax_pkg)
    for name, cp in _examples(torch_pkg).items():
        jax_cp = jax_examples[name]
        assert jax_fused._fits_vmem(jax_cp), name
        assert jax_fused.fused_system_step_applicable(jax_cp, JaxRK4()), name
        assert not torch_fused.fits_one_block(cp), name
        assert torch_fused.cluster_system_applicable(cp), name
        assert not torch_tiled.tiled_system_applicable(cp), name
        assert torch_fused.fused_system_step_applicable(
            cp, RK4(), torch.float32
        ), name
        n = cp.differential_equation.y_dimension
        y = torch.zeros(tuple(cp.mesh.vertices_shape) + (n,))
        calls.clear()
        torch_fused.build_fused_system_rk4_trajectory(cp, 1e-3, 1)(y)
        torch_fused.build_fused_system_rk4_end(cp, 1e-3, 1)(y)
        assert calls == [
            ("cluster_system_rk4_trajectory", (1,)),
            ("cluster_system_rk4_end", (1,)),
        ], name
    wave = _examples(torch_pkg)["wave 101^2"]
    calls.clear()
    torch_fused.build_fused_system_rk4_end(wave, 1e-3, 1, batch=8)(
        torch.zeros((8, 101, 101, 2))
    )
    assert calls == [("cluster_system_rk4_end", (8,))]
    assert torch_fused.make_cluster_plan(101, 101, 2, batch=8) is not None

    past_cap = chip_smoke.burgers_641(torch_pkg).constrained_problem
    past_range = system_problem(vars(torch_pkg), "wave", "dirichlet", (201, 201))
    assert not torch_fused.fits_reference_vmem(past_cap)
    assert torch_fused.fits_reference_vmem(past_range)
    for cp in (past_cap, past_range):
        assert not torch_fused.cluster_system_applicable(cp)
        assert torch_tiled.tiled_system_applicable(cp)
        assert torch_fused.fused_system_step_applicable(cp, RK4())


def _small_wave_ivp(module):
    """A 17 x 33 wave problem (Dirichlet 0.1 on the axis-0 faces, Neumann
    0.05 on the axis-1 faces) from smooth states, to T = 0.4."""
    cp = system_problem(vars(module), "wave", "dirichlet")
    return module.InitialValueProblem(
        cp,
        (0.0, 0.4),
        module.DiscreteInitialCondition(
            cp, states_2d((17, 33), 2).astype(np.float64), True
        ),
    )


@functools.lru_cache(maxsize=None)
def _jax_k5_small_wave():
    """The JAX package's FDM solve of ``_small_wave_ivp`` at d_t 0.01 in
    float32: one interpret-mode run of its K5 (40 steps)."""
    jax.config.update("jax_enable_x64", False)
    try:
        ivp = _small_wave_ivp(jax_pkg)
        y0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True), jnp.float32)
        fn, _ = JaxFDMOperator(JaxRK4(), JaxThreePoint(), 0.01).trajectory_function(
            ivp.constrained_problem, ivp.t_interval
        )
        frames = fn(y0, 0.0)
        assert frames.dtype == jnp.float32
        return np.asarray(frames)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_solve_and_parareal_reach_the_mode(monkeypatch):
    """With the one-CTA limit patched down, a 17 x 33 wave problem counts
    as past one CTA and within the mode's range: ``FDMOperator.solve``
    takes the mode's trajectory (one call), and an 8-slice Parareal its
    batched end for the fine ends, its single-state end for the coarse
    sweeps and its batched trajectory for the expansion, with no K8, K5
    or K4; both match the JAX package's K5 (interpret mode) to 1e-5."""
    monkeypatch.setattr(torch_fused, "MAX_SHARED_MEMORY_BYTES", 1024)
    calls = []
    for module, name in (
        (torch_fused, "cluster_system_rk4_trajectory"),
        (torch_fused, "cluster_system_rk4_end"),
        (torch_fused, "fused_system_rk4_trajectory"),
        (torch_fused, "fused_system_rk4_end"),
        (torch_tiled, "tiled_system_rk4_trajectory"),
        (torch_tiled, "tiled_system_rk4_end"),
        (torch_packed, "packed_system_rk4_ends"),
    ):
        wrapper = getattr(module, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append((_name, tuple(y.shape[:-3])))
            return _wrapper(y, *args, **kwargs)

        monkeypatch.setattr(module, name, counting)

    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            device="cpu",
            dtype=torch.float32,
        )

    ivp = _small_wave_ivp(torch_pkg)
    assert torch_fused.cluster_system_applicable(ivp.constrained_problem)
    expected = _jax_k5_small_wave()
    solved = fdm(0.01).solve(ivp).discrete_y()
    assert calls == [("cluster_system_rk4_trajectory", (1,))]
    assert _relative_error(solved, expected) <= F32_TOL

    calls.clear()
    parareal = PararealOperator(fdm(0.01), fdm(0.05), None, num_time_slices=8)
    actual = parareal.solve(ivp).discrete_y()
    names = {name for name, _ in calls}
    assert names == {
        "cluster_system_rk4_trajectory",
        "cluster_system_rk4_end",
    }
    assert calls.count(("cluster_system_rk4_end", (8,))) == (
        parareal.last_iterations
    )
    assert ("cluster_system_rk4_end", (1,)) in calls
    assert calls.count(("cluster_system_rk4_trajectory", (8,))) == 1
    assert actual.shape == expected.shape == (40, 17, 33, 2)
    assert _relative_error(actual, expected) <= F32_TOL
    assert _relative_error(actual, solved) <= F32_TOL
