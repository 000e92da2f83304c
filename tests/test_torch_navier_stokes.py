"""The Navier-Stokes family of the port's fused system kernels (the CPU
side of ``csrc/fused_navier_stokes.cu``) and its path through the FDM
operator and Parareal.

The plain version runs in float32 against the JAX package's Pallas K5 in
interpret mode on tests/test_fused_system.py's 17 x 17 problem over 5
steps, to 1e-5 of the largest value (the two evaluate the same operations
in the same order; the norm that stops the Jacobi loop is summed in
another order and type, which could move a stopping point by one sweep),
and in float64 against the JAX package's generic path at an
anti-Laplacian tolerance of 1e-10, to 1e-10. The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py."""

import functools

import jax
import numpy as np
import pytest
import torch

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
from pararealml_tpu_torch.ops import fused_navier_stokes as ns
from pararealml_tpu_torch.ops import fused_system as torch_fused
from pararealml_tpu_torch.ops import packed_system as torch_packed
from tests.test_torch_cuda import INSTANCE_REGISTERS, navier_stokes_problem

torch.set_num_threads(1)

TOL = 1e-5
D_T = 0.05
STEPS = 5


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _problems(example=False):
    return tuple(
        navier_stokes_problem(vars(module), example)
        for module in (jax_pkg, torch_pkg)
    )


def _state(shape=(17, 17), batch=None, seed=0):
    """O(1) four-component states from a seed (velocities included, so
    that the advection terms act from the first stage)."""
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, lead + tuple(shape) + (4,)).astype(
        np.float32
    )


def _assert_close(actual, expected, tol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    scale = float(np.abs(expected).max())
    assert float(np.abs(actual - expected).max()) <= tol * scale


def test_plain_version_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems()
    y = _state()
    expected = jax_fused.build_fused_system_rk4_trajectory(
        jax_cp, D_T, STEPS, interpret=True
    )(y)
    cfg = ns._NavierStokesConfig(torch_cp, D_T)
    frames, sweeps = ns.fused_navier_stokes_rk4_trajectory_reference(
        torch.as_tensor(y), cfg, STEPS
    )
    _assert_close(frames.numpy(), np.asarray(expected), TOL)
    assert int(sweeps) >= STEPS
    # the end and the step are the same steps
    end, end_sweeps = ns.fused_navier_stokes_rk4_end_reference(
        torch.as_tensor(y), cfg, STEPS
    )
    np.testing.assert_array_equal(end.numpy(), frames[-1].numpy())
    assert int(end_sweeps) == int(sweeps)
    step, _ = ns.fused_navier_stokes_rk4_step_reference(
        torch.as_tensor(y), cfg
    )
    np.testing.assert_array_equal(step.numpy(), frames[0].numpy())


def test_plain_version_matches_jax_generic_path_in_float64():
    jax_cp, torch_cp = _problems()
    y = _state().astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(1e-10), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, STEPS * D_T))
    expected = np.asarray(generic(y, 0.0))
    cfg = ns._NavierStokesConfig(torch_cp, D_T, anti_laplacian_tol=1e-10)
    frames, _ = ns.fused_navier_stokes_rk4_trajectory_reference(
        torch.as_tensor(y), cfg, STEPS
    )
    assert frames.dtype == torch.float64
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(
        frames.numpy(), expected, rtol=1e-10, atol=1e-10 * scale
    )


def test_fdm_operator_dispatches_navier_stokes(monkeypatch):
    """In float32 with Jacobi the solve takes the Navier-Stokes kernel
    (its plain version on the CPU); with BiCGStab or in float64 the
    generic path (tests/operators/fdm/test_anti_laplacian_bicgstab.py's
    ``test_navier_stokes_bicgstab_stays_off_fused_kernel``). The fused
    float32 solve agrees with the generic one in float32."""
    _, cp = _problems()

    def fdm(method="jacobi", **kwargs):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(
                tol=1e-4, anti_laplacian_method=method
            ),
            D_T,
            device="cpu",
            **kwargs,
        )

    interval = (0.0, STEPS * D_T)
    fused, _ = fdm(dtype=torch.float32).trajectory_function(cp, interval)
    assert fused.fused
    bicgstab = fdm("bicgstab", dtype=torch.float32)
    assert not bicgstab._fused_anti_laplacian_compatible(cp)
    assert not bicgstab.trajectory_function(cp, interval)[0].fused
    assert bicgstab.ends_function(cp, interval, batch=2).fused is False
    assert not fdm(dtype=torch.float64).trajectory_function(cp, interval)[
        0
    ].fused
    # non-Y_LAPLACIAN problems stay fused under BiCGStab
    burgers = torch_pkg.ConstrainedProblem(
        torch_pkg.BurgersEquation(2, 100.0),
        torch_pkg.Mesh([(0.0, 2.0)] * 2, [0.25] * 2),
        [
            (
                torch_pkg.NeumannBoundaryCondition(
                    lambda x, t: np.zeros((len(x), 2)), is_static=True
                ),
            )
            * 2
        ]
        * 2,
    )
    assert bicgstab._fused_anti_laplacian_compatible(burgers)

    calls = []
    wrapper = ns.fused_navier_stokes_rk4_trajectory

    def counting(y, cfg, n_steps, cluster_size=None):
        calls.append((tuple(y.shape), n_steps, cfg.tol))
        return wrapper(y, cfg, n_steps, cluster_size)

    monkeypatch.setattr(ns, "fused_navier_stokes_rk4_trajectory", counting)
    ic = torch_pkg.DiscreteInitialCondition(cp, _state(), True)
    ivp = torch_pkg.InitialValueProblem(cp, interval, ic)
    solution = fdm(dtype=torch.float32).solve(ivp).discrete_y()
    assert calls == [((1, 17, 17, 4), STEPS, 1e-4)]
    generic = fdm(dtype=torch.float32, fused_kernels=False).solve(ivp)
    assert np.allclose(solution, generic.discrete_y(), atol=1e-3)
    assert np.isfinite(solution).all()


def test_cluster_cap_differs_from_the_jax_vmem_cap(x64_off):
    """A deliberate difference (ROADMAP.md, Queue 3): the JAX package runs
    its Navier-Stokes K5 wherever the grid fits its VMEM budget (93,750
    padded cells for four components); the port needs it to fit a
    cluster of at most 8 blocks (up to 193 x 193) and takes the
    generic path past that. The example's 101 x 81 takes the kernel in
    both; 201 x 201 (40,401 cells) only in the JAX package."""
    for example in (False, True):
        jax_cp, torch_cp = _problems(example)
        assert jax_fused.fused_navier_stokes_step_applicable(jax_cp, JaxRK4())
        assert torch_fused.fused_navier_stokes_step_applicable(
            torch_cp, RK4()
        )
    jax_cp, torch_cp = (
        module.ConstrainedProblem(
            module.NavierStokesEquation(500.0),
            module.Mesh([(0.0, 5.0)] * 2, [0.025] * 2),
            [
                (
                    module.DirichletBoundaryCondition(
                        lambda x, t: np.zeros((len(x), 4)), is_static=True
                    ),
                )
                * 2
            ]
            * 2,
        )
        for module in (jax_pkg, torch_pkg)
    )
    assert torch_cp.mesh.vertices_shape == (201, 201)
    assert jax_fused.fused_navier_stokes_step_applicable(jax_cp, JaxRK4())
    assert torch_fused.fits_reference_vmem(torch_cp)
    assert ns.make_cluster_plan_2d(201, 201) is None
    assert not torch_fused.fused_navier_stokes_step_applicable(
        torch_cp, RK4()
    )
    operator = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), D_T, device="cpu",
        dtype=torch.float32,
    )
    assert not operator.trajectory_function(torch_cp, (0.0, D_T))[0].fused
    assert operator.ends_function(torch_cp, (0.0, D_T)).fused is False


def test_cluster_plans():
    """Three stream-function buffers with their guard rows, w and a stage
    buffer with a row above and below, six planes of the slab, the Neumann
    faces of w and psi (20 bytes a row and a column), and 272 bytes of
    reduction scratch and 8 bytes a thread a sweep of a group; the
    measured plans where they fit, else the smallest cluster whose
    blocks' cells an instance covers with groups of one sweep, with the
    largest group up to 4 that fits there; a group is at most the fewest
    rows a block of a cluster holds, and a plan's threads and cells cover
    the most cells a block's sweeps reach."""
    assert ns.shared_memory_bytes_2d(51, 101, 81, 4, 2, 704) == (
        8 * (34 + 704) * 4
        + 4 * 81 * (3 * 59 + 2 * 53 + 6 * 51)
        + 20 * (101 + 81)
    )
    # one block keeps one guard row of zeros above and below its slab
    assert ns.shared_memory_bytes_2d(17, 17, 17, 8, 1, 320) == (
        8 * (34 + 320) * 8
        + 4 * 17 * (3 * 19 + 2 * 19 + 6 * 17)
        + 20 * (17 + 17)
    )
    for (height, width, batch), measured in ns._MEASURED_PLANS.items():
        size, group, threads, cells = measured
        plan = ns.make_cluster_plan_2d(height, width, batch)
        assert plan == (size, height, width, group, threads, cells)
        assert plan.fits
    # without the table the example would take 2 blocks of 51 rows, ten
    # cells a thread
    assert ns.cluster_plan_2d(101, 81, 2).fits
    assert ns.cluster_plan_2d(101, 81, 2).slab == 51
    assert ns.ClusterPlan2D(2, 101, 81).block_cells == 10
    assert ns.ClusterPlan2D(2, 101, 81).block_threads == 416
    assert ns.ClusterPlan2D(8, 17, 17).block_threads == 64
    # an interior block of 8 reaches 13 + 2 x 3 rows of 81 with groups of
    # 4: 1,539 cells, one more than 512 threads of three cells hold
    eight = ns.ClusterPlan2D(8, 101, 81, 4)
    assert eight.range_cells == 1539
    assert (eight.block_threads, eight.block_cells) == (544, 3)
    assert not eight._replace(threads=512, cells=3).covers
    assert eight._replace(threads=544, cells=3).fits
    # more threads than the instance takes, or no such instance
    assert not eight._replace(threads=800, cells=3).covers
    assert not eight._replace(threads=416, cells=4).covers
    # threads and cells that cover the blocks, slabs past a block's shared
    # memory
    deep = ns.ClusterPlan2D(2, 101, 81, 8, 512, 10)
    assert deep.covers and deep.admitted and not deep.fits
    # past the table: the range of groups of one sweep on 8 blocks, the
    # group shrinking towards its edge
    assert ns.make_cluster_plan_2d(186, 186)[:4] == (8, 186, 186, 2)
    assert ns.make_cluster_plan_2d(192, 192)[:4] == (8, 192, 192, 2)
    assert ns.make_cluster_plan_2d(193, 193)[:4] == (8, 193, 193, 1)
    assert ns.make_cluster_plan_2d(194, 194) is None
    assert ns.make_cluster_plan_2d(2, 50) is None
    assert not ns.cluster_plan_2d(101, 81, 1).fits
    assert ns.cluster_plan_2d(101, 81, 8).group == 4
    assert ns.cluster_plan_2d(17, 17, 4, group=8).admitted is False
    assert ns.cluster_plan_2d(17, 17, 1, group=8).fits
    assert ns.cluster_plan_2d(101, 81, 2, group=5).admitted is False
    with pytest.raises(ValueError, match="cluster_size"):
        ns.cluster_plan_2d(101, 81, 3)
    with pytest.raises(ValueError, match="cannot be split"):
        ns.cluster_plan_2d(5, 81, 8)
    cfg = ns._NavierStokesConfig(_problems()[1], D_T)
    with pytest.raises(ValueError, match="fewest rows"):
        ns._plan(cfg, 1, None, ns.ClusterPlan2D(4, 17, 17, 8))
    with pytest.raises(ValueError, match="does not fit"):
        ns._plan(cfg, 1, None, ns.ClusterPlan2D(2, 101, 81, 4))
    assert ns._plan(cfg, 1, 4, None) == ns.ClusterPlan2D(4, 17, 17, 4)


def _ownership_plans():
    """Every plan the kernel takes on 17 x 17, the example's 101 x 81 and
    the 192 x 192 edge: each cluster size, each group it admits and each
    instance's cells at the threads that cover a block, and the measured
    plans."""
    plans = [
        ns.cluster_plan_2d(*shape, size, group, cells=cells)
        for shape in ((17, 17), (101, 81), (192, 192))
        for size in ns.CLUSTER_SIZES
        if size <= shape[0]
        for group in ns.GROUP_SIZES
        for cells in ns.CELLS_INSTANCES
    ]
    plans += [
        ns.make_cluster_plan_2d(height, width, batch)
        for height, width, batch in ns._MEASURED_PLANS
    ]
    return [plan for plan in dict.fromkeys(plans) if plan.fits]


@pytest.mark.parametrize(
    "plan",
    _ownership_plans(),
    ids=lambda plan: (
        f"{plan.height}x{plan.width}-{plan.cluster_size}x"
        f"{plan.block_threads}x{plan.block_cells}-g{plan.group}"
    ),
)
def test_ownership_covers_every_cell_once(plan):
    """The plain model of the kernel's cell ownership: on every block of
    the plan, the cells whose reach is past t are sweep t's rows (the slab
    and group - 1 - t halo rows past each edge that has a neighbour), each
    owned once; the own-row cells, which the stages run, are the slab's,
    each once; interior cells come before face cells in the block's list,
    and no thread holds more cells than its instance."""
    height, width, k = plan.height, plan.width, plan.group
    threads, cells = plan.block_threads, plan.block_cells
    for rank in range(plan.cluster_size):
        owners = ns.ownership(plan, rank)
        begin, end = plan.rows(rank)
        above, below = plan.halo(rank)
        assert all(t < threads and s < cells for t, s in owners)
        for t in range(k):
            swept = [
                (i, j)
                for i, j, reach, _, _ in owners.values()
                if reach > t
            ]
            rows = range(begin - max(above - t, 0), end + max(below - t, 0))
            assert len(swept) == len(set(swept)), (rank, t)
            assert set(swept) == {
                (i, j) for i in rows for j in range(width)
            }, (rank, t)
        own = [(i, j) for i, j, _, mine, _ in owners.values() if mine]
        assert sorted(own) == [
            (i, j) for i in range(begin, end) for j in range(width)
        ], rank
        listed = sorted(
            owners.items(), key=lambda item: item[0][0] + item[0][1] * threads
        )
        interior = [cell[4] for _, cell in listed]
        assert interior == sorted(interior, reverse=True), rank
        for _, (i, j, _, _, inside) in listed:
            assert inside == (0 < i < height - 1 and 0 < j < width - 1)


def test_instances_hold_their_threads_without_a_spill():
    """Every instance the kernel's source builds (a group of sweeps and
    the cells a thread) holds its most threads (its launch bound) in the
    registers the card reports for it, without a spill
    (``INSTANCE_REGISTERS``, read on the card by
    tests/test_torch_cuda.py)."""
    keys = [
        ("navier_stokes", group, cells)
        for group in ns.GROUP_SIZES
        for cells in ns.CELLS_INSTANCES
    ]
    for key in keys:
        registers, spills = INSTANCE_REGISTERS[key]
        assert ns.CELLS_INSTANCES[key[2]] * registers <= 65_536, key
        assert spills == 0, key
    built = [key for key in INSTANCE_REGISTERS if key[0] == "navier_stokes"]
    assert sorted(built) == sorted(keys)


def _narrow_example_problem():
    """examples/navier_stokes_fdm.py's problem (Re 5000, d_x 0.05, its
    faces) on a strip of its width: [-0.5, 0.5] x [0, 4], 21 x 81."""
    def dirichlet(w, psi):
        return torch_pkg.DirichletBoundaryCondition(
            torch_pkg.vectorize_bc_function(
                lambda x, t: [w, psi, None, None]
            ),
            is_static=True,
        )

    return torch_pkg.ConstrainedProblem(
        torch_pkg.NavierStokesEquation(5000.0),
        torch_pkg.Mesh([(-0.5, 0.5), (0.0, 4.0)], [0.05, 0.05]),
        [
            (dirichlet(1.0, 0.1), dirichlet(0.0, 0.0)),
            (dirichlet(0.0, 0.0), dirichlet(0.0, 0.0)),
        ],
    )


@pytest.mark.parametrize(
    "shape, scenario, tol, max_iterations",
    [
        ((17, 17), "first sweep", 1e6, 100),
        ((17, 17), "mid-group", 0.1, 100),
        ((17, 17), "max_iterations", 0.0, 7),
        ((21, 81), "first sweep", 1e6, 100),
        ((21, 81), "mid-group", 1.0, 100),
        ((21, 81), "max_iterations", 0.0, 7),
    ],
)
def test_group_schedule_matches_plain_jacobi(
    shape, scenario, tol, max_iterations
):
    """The kernel's Jacobi schedule in groups (its plain model: slabs,
    halos shrinking a row a sweep, per-sweep partials over own rows, the
    stop found after the group, the replay) gives the plain whole-grid
    solve's psi bit for bit, with the same sweeps, for every group of
    GROUP_SIZES and 1, 2 or 4 slabs that the plan admits: a stop on the
    first sweep, one inside a group (17 x 17: 61 sweeps, 21 x 81: 67),
    and max_iterations 7, no multiple of a group past 1."""
    cp = (
        _problems()[1] if shape == (17, 17) else _narrow_example_problem()
    )
    cfg = ns._NavierStokesConfig(cp, D_T, tol, max_iterations)
    assert (cfg.height, cfg.width) == shape
    y = torch.as_tensor(_state(shape))
    expected, sweeps = torch_fused._navier_stokes_step_reference(
        y, cfg, cfg.constants(y.device)
    )
    expected_sweeps = {
        "first sweep": 1,
        "mid-group": 61 if shape == (17, 17) else 67,
        "max_iterations": 7,
    }[scenario]
    assert int(sweeps) == expected_sweeps
    replays = {}
    for group in ns.GROUP_SIZES:
        for blocks in (1, 2, 4):
            plan = ns.cluster_plan_2d(*shape, blocks, group=group)
            if not plan.admitted:
                assert blocks == 4 and group == 8
                continue
            psi, n, replayed = ns._group_schedule_reference(y, cfg, plan)
            assert n == expected_sweeps, (plan, n)
            assert torch.equal(psi, expected[..., 1]), plan
            replays[(group, blocks)] = replayed
    # the stopping sweep came from its work buffer and from a replay
    stopped_in_group = scenario != "max_iterations"
    assert any(replays.values()) == stopped_in_group
    if stopped_in_group:
        assert not all(replays[(group, 1)] for group in (2, 3, 4, 8))


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    """On the CPU the wrappers run the plain versions, keep their sweeps
    and launch nothing; they reject what the kernel does not take, and
    the packed kernels K4 take no Navier-Stokes problem."""
    _, cp = _problems()
    cfg = ns._NavierStokesConfig(cp, D_T)
    ys = torch.as_tensor(_state(batch=2))
    wrappers = (
        ns.fused_navier_stokes_rk4_trajectory,
        ns.fused_navier_stokes_rk4_end,
        ns.fused_navier_stokes_rk4_step,
    )
    launches = [wrapper.launches for wrapper in wrappers]
    frames = wrappers[0](ys, cfg, 3)
    expected, sweeps = ns.fused_navier_stokes_rk4_trajectory_reference(
        ys, cfg, 3
    )
    np.testing.assert_array_equal(frames.numpy(), expected.numpy())
    assert torch.equal(wrappers[0].sweeps, sweeps)
    assert sweeps.shape == (2,)
    np.testing.assert_array_equal(
        wrappers[1](ys, cfg, 3).numpy(), frames[:, -1].numpy()
    )
    np.testing.assert_array_equal(
        wrappers[2](ys[0], cfg).numpy(), frames[0, 0].numpy()
    )
    assert [wrapper.launches for wrapper in wrappers] == launches
    with pytest.raises(TypeError, match="float32"):
        wrappers[1](ys.double(), cfg, 1)
    with pytest.raises(ValueError, match="shape"):
        wrappers[1](ys[..., :2].contiguous(), cfg, 1)
    assert not torch_packed.packed_system_applicable(cp, RK4(), 4)
    polar = torch_pkg.ConstrainedProblem(
        torch_pkg.NavierStokesEquation(),
        torch_pkg.Mesh(
            [(1.0, 2.0), (0.0, 1.0)],
            [0.25] * 2,
            torch_pkg.CoordinateSystem.POLAR,
        ),
        [
            (
                torch_pkg.DirichletBoundaryCondition(
                    lambda x, t: np.zeros((len(x), 4)), is_static=True
                ),
            )
            * 2
        ]
        * 2,
    )
    assert not torch_fused.fused_system_step_applicable(polar, RK4())
    with pytest.raises(ValueError, match="Cartesian"):
        ns._NavierStokesConfig(polar, D_T)
    with pytest.raises(ValueError, match="non-negative"):
        ns._NavierStokesConfig(cp, D_T, anti_laplacian_max_iterations=-1)


def test_parareal_reaches_the_batched_end_function(monkeypatch):
    """A 2-slice Parareal over the 17 x 17 problem takes every iteration's
    fine ends through the batched end function (one state a cluster on
    the card) and matches the fine solve."""
    _, cp = _problems()
    ic = torch_pkg.DiscreteInitialCondition(cp, _state(), True)
    ivp = torch_pkg.InitialValueProblem(cp, (0.0, 0.5), ic)
    calls = []
    wrapper = ns.fused_navier_stokes_rk4_end

    def counting(y, cfg, n_steps, cluster_size=None):
        calls.append(tuple(y.shape))
        return wrapper(y, cfg, n_steps, cluster_size)

    monkeypatch.setattr(ns, "fused_navier_stokes_rk4_end", counting)
    fdm = functools.partial(
        FDMOperator,
        RK4(),
        ThreePointCentralDifferenceMethod(),
        device="cpu",
        dtype=torch.float32,
    )
    fine = fdm(D_T)
    parareal = PararealOperator(fine, fdm(0.125), 1e-4, num_time_slices=2)
    ys = parareal.solve(ivp).discrete_y()
    assert (2, 17, 17, 4) in calls
    expected = fine.solve(ivp).discrete_y()
    assert ys.shape == expected.shape
    assert float(np.abs(ys - expected).max()) <= 1e-4
