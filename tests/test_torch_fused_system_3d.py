"""The fused 3D kernels' plain PyTorch version (the CPU side of the CUDA
kernel K9) held against the JAX package: against its generic FDM path in
float64 to 1e-10 of the largest value for all five families and both face
setups, and against its Pallas kernel in interpret mode in float32 to
atol = rtol = 1e-5 (the two evaluate the same operations in the same
order; the tolerance covers float32 rounding of operations XLA contracts
or reorders). Plus the cluster plan, the applicability gate against the
JAX gate, the wrappers' CPU routing and the FDM operator's dispatch to K9.
The CUDA kernel itself is held against its plain version in
tests/test_torch_cuda.py."""

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
from pararealml_tpu.ops import fused_system_3d as jax_k9
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ForwardEulerMethod,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.ops import fused_system_3d as k9
from tests.test_torch_cuda import FAMILIES_3D, problem_3d, states_3d

torch.set_num_threads(1)

D_T = 1e-3
SHAPE = (7, 8, 9)


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _problems(family, dirichlet=False, shape=SHAPE, d_x=0.125):
    return tuple(
        problem_3d(vars(module), family, dirichlet, shape, d_x)
        for module in (jax_pkg, torch_pkg)
    )


@pytest.mark.parametrize("dirichlet", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES_3D))
def test_plain_version_matches_jax_generic_path(family, dirichlet):
    """float64 (the suite's x64 flag): 4 steps of the plain version
    against the JAX package's generic FDM path."""
    jax_cp, torch_cp = _problems(family, dirichlet)
    n = FAMILIES_3D[family][1]
    y = states_3d(SHAPE, n).astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, 4 * D_T))
    expected = np.asarray(generic(y, 0.0))
    cfg = k9._SystemKernelConfig3D(torch_cp, D_T)
    actual = k9.fused_system_3d_rk4_trajectory_reference(
        torch.as_tensor(y), cfg, 4
    ).numpy()
    assert actual.shape == expected.shape == (4,) + SHAPE + (n,)
    scale = float(np.abs(expected).max())
    assert float(np.abs(actual - expected).max()) <= 1e-10 * scale


# two interpret-mode runs of the Pallas kernel: each costs seconds of
# tracing on the CPU
@pytest.mark.parametrize(
    "family, dirichlet", [("burgers", True), ("cahn_hilliard", False)]
)
def test_plain_version_matches_pallas_kernel(family, dirichlet, x64_off):
    shape = (5, 6, 7)
    jax_cp, torch_cp = _problems(family, dirichlet, shape)
    y = states_3d(shape, FAMILIES_3D[family][1])
    expected = jax_k9.build_fused_system_3d_rk4_trajectory(
        jax_cp, D_T, 3, interpret=True
    )(y)
    actual = k9.build_fused_system_3d_rk4_trajectory(torch_cp, D_T, 3)(
        torch.as_tensor(y)
    )
    np.testing.assert_allclose(
        actual.numpy(), np.asarray(expected), atol=1e-5, rtol=1e-5
    )


def test_end_and_step_equal_the_trajectory_frames():
    """The end (single and batched) is the trajectory's last frame and
    the step its first, exactly; a leading batch axis advances each state
    as it advances alone."""
    _, cp = _problems("wave", dirichlet=True)
    ys = torch.as_tensor(states_3d(SHAPE, 2, batch=2))
    trajectory = k9.build_fused_system_3d_rk4_trajectory(cp, D_T, 3)
    frames = trajectory(ys)
    assert frames.shape == (2, 3) + SHAPE + (2,)
    np.testing.assert_array_equal(
        frames[1].numpy(), trajectory(ys[1]).numpy()
    )
    end = k9.build_fused_system_3d_rk4_end(cp, D_T, 3)
    np.testing.assert_array_equal(
        end(ys[0]).numpy(), frames[0, -1].numpy()
    )
    batched_end = k9.build_fused_system_3d_rk4_end(cp, D_T, 3, batch=2)
    np.testing.assert_array_equal(
        batched_end(ys).numpy(), frames[:, -1].numpy()
    )
    with pytest.raises(ValueError, match="leading shape"):
        batched_end(ys[0])
    step = k9.build_fused_system_3d_rk4_step(cp, D_T)
    np.testing.assert_array_equal(step(ys).numpy(), frames[:, 0].numpy())


def test_cluster_plan():
    # the two configurations of the main path take the measured table's
    # plans: 16 blocks, slabs of one and two planes
    bench = k9.make_cluster_plan_3d(21, 21, 21, 3)
    (*_, batch, size, cells) = k9._MEASURED_PLANS_3D[(3, "rk4")][0]
    assert batch == 1
    assert (bench.cluster_size, bench.cells) == (size, cells)
    assert bench.slab == -(-21 // size)
    # two sets of slabs, each with two halo planes (the RK4 families'
    # cells in registers), none for Cahn-Hilliard
    assert bench.halo
    assert bench.shared_bytes == 8 * (bench.slab + 2) * 21 * 21 * 3
    example = k9.make_cluster_plan_3d(31, 31, 31, 2, "cahn-hilliard")
    (*_, batch, size, cells) = k9._MEASURED_PLANS_3D[(2, "cahn-hilliard")][0]
    assert batch == 1
    assert (example.cluster_size, example.cells) == (size, cells)
    assert not example.halo
    assert example.shared_bytes == 8 * example.slab * 31 * 31 * 2
    # the range: every cube of the JAX package's cap, and no larger one,
    # fits 16 blocks at 8n bytes of shared memory a cell; past what the
    # threads hold in registers the cells go to device memory
    for edge, n in ((76, 1), (56, 2), (48, 3)):
        plan = k9.make_cluster_plan_3d(edge, edge, edge, n)
        assert plan.fits and plan.cells == 0
        # no halo planes with the cells in device memory
        assert plan.shared_bytes == 8 * plan.slab * edge * edge * n
        assert plan.shared_bytes <= k9.MAX_SHARED_MEMORY_BYTES
        assert plan.threads == 1024
        assert plan.threads * plan.cells_per_thread >= plan.block_cells
        assert plan.scratch_floats(2) == (
            2
            * plan.cluster_size
            * (2 + 6 * n)
            * plan.threads
            * plan.cells_per_thread
        )
    assert k9.make_cluster_plan_3d(77, 77, 77, 1) is None
    assert k9.make_cluster_plan_3d(40, 32, 128, 3) is None
    # no more blocks than planes: 3 planes of a wide grid cannot be split
    # among enough blocks
    assert k9.make_cluster_plan_3d(3, 200, 200, 1) is None
    assert k9.make_cluster_plan_3d(1, 9, 9, 1) is None
    for depth in range(1, 40):
        for size in k9.CLUSTER_SIZES:
            if size > depth:
                with pytest.raises(ValueError, match="depth"):
                    k9.cluster_plan_3d(depth, 5, 5, 1, size)
                continue
            plan = k9.cluster_plan_3d(depth, 5, 5, 1, size)
            slabs = plan.slabs
            # consecutive, non-empty, covering the depth exactly
            assert slabs[0][0] == 0 and slabs[-1][1] == depth
            assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
            sizes = [end - begin for begin, end in slabs]
            assert min(sizes) >= 1
            assert max(sizes) == plan.slab == -(-depth // size)
            # the fewest register cells a thread the instances take
            assert plan.cells == 1 and plan.fits == (depth >= 2)
    with pytest.raises(ValueError, match="cluster_size"):
        k9.cluster_plan_3d(21, 21, 21, 3, 17)
    # the instances: 1 or 2 cells a thread in registers, or device memory
    for cells in (3, 4):
        with pytest.raises(ValueError, match="cells"):
            k9.cluster_plan_3d(21, 21, 21, 3, 16, cells)


def test_batched_plan_holds_every_cluster_at_once():
    """On the CPU's table of active clusters, the plan for Parareal's 8
    fine ends at 21^3 x 3 puts all 8 clusters on the card at once rather
    than running 16-block clusters in two waves: the measured winner, 8
    blocks of 2 cells a thread (not the 9 blocks of the largest size held
    at once, which gives the same largest slab of 3 planes)."""
    single = k9.make_cluster_plan_3d(21, 21, 21, 3)
    batched = k9.make_cluster_plan_3d(21, 21, 21, 3, batch=8)
    assert k9._measured_active_clusters(single) < 8
    assert k9._measured_active_clusters(batched) >= 8
    assert (batched.cluster_size, batched.cells) == (8, 2)
    assert (21, 21, 21, 8, 8, 2) in k9._MEASURED_PLANS_3D[(3, "rk4")]
    assert batched.fits and batched.slab == 3
    # a small batch keeps the single state's entry; a batch the entry's
    # size cannot hold at once takes the largest size that can
    assert k9.make_cluster_plan_3d(21, 21, 21, 3, batch=2) == single
    larger = k9.make_cluster_plan_3d(21, 21, 21, 3, batch=16)
    assert larger.cluster_size == 6
    assert k9._measured_active_clusters(larger) >= 16
    # where no size is held at once, the smallest valid size (waves)
    waves = k9.make_cluster_plan_3d(
        21, 21, 21, 3, batch=8, active_clusters=lambda plan: 1
    )
    assert waves.cluster_size == 1 and waves.fits


def test_applicability_matches_jax_below_the_cluster_limit(x64_off):
    for family in FAMILIES_3D:
        for dirichlet in (False, True):
            jax_cp, torch_cp = _problems(family, dirichlet)
            assert jax_k9.fused_system_3d_step_applicable(jax_cp, JaxRK4())
            assert k9.fused_system_3d_step_applicable(
                torch_cp, RK4(), torch.float32
            )
            assert k9.fused_system_3d_step_applicable(torch_cp, RK4())
    _, torch_cp = _problems("burgers")
    # float32 and RK4 only
    assert not k9.fused_system_3d_step_applicable(
        torch_cp, RK4(), torch.float64
    )
    assert not k9.fused_system_3d_step_applicable(
        torch_cp, ForwardEulerMethod()
    )


@pytest.mark.parametrize(
    "family, shape, admitted",
    [
        # the largest cube the JAX package's cap admits, by components
        ("diffusion", (76, 76, 76), True),
        ("wave", (56, 56, 56), True),
        ("cahn_hilliard", (56, 56, 56), True),
        ("burgers", (48, 48, 48), True),
        # the next cubes, past the cap
        ("diffusion", (77, 77, 77), False),
        ("wave", (57, 57, 57), False),
        ("burgers", (49, 49, 49), False),
        # within the port's clusters, but past the cap (W pads to 128)
        ("burgers", (60, 60, 5), False),
    ],
)
def test_gates_agree_at_the_jax_cap(family, shape, admitted, x64_off):
    """The port's K9 gate mirrors the JAX package's VMEM cap: both admit
    the largest cube of each component count and both refuse the next
    one and 60 x 60 x 5 x 3, which a cluster would hold (gates only, no
    solve)."""
    jax_cp, torch_cp = _problems(family, shape=shape, d_x=0.25)
    assert jax_k9._fits_vmem_3d(jax_cp) == admitted
    assert k9.fits_reference_vmem_3d(torch_cp) == admitted
    assert jax_k9.fused_system_3d_step_applicable(jax_cp, JaxRK4()) == admitted
    assert k9.fused_system_3d_step_applicable(torch_cp, RK4()) == admitted
    if not admitted and shape == (60, 60, 5):
        assert k9.make_cluster_plan_3d(*shape, 3) is not None


def test_applicability_differs_from_jax_past_the_cluster_limit(x64_off):
    """A deliberate difference (ROADMAP.md, Queue 3): 40 x 32 x 128 x 3
    fits the JAX package's VMEM budget (W pads to no more than its 128
    lanes) but no cluster of 16 blocks (three planes a block of 32 x 128
    cells at 24 bytes a cell), so the port sends it to the generic path
    and no kernel is built for it."""
    shape = (40, 32, 128)
    jax_cp, torch_cp = _problems("burgers", shape=shape, d_x=0.25)
    assert jax_k9.fused_system_3d_step_applicable(jax_cp, JaxRK4())
    assert k9.fits_reference_vmem_3d(torch_cp)
    assert not k9.fused_system_3d_step_applicable(torch_cp, RK4())
    assert k9.build_fused_system_3d_rk4_end(torch_cp, D_T, 2) is None
    operator = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        D_T,
        device="cpu",
        dtype=torch.float32,
    )
    trajectory, _ = operator.trajectory_function(torch_cp, (0.0, 2 * D_T))
    assert not trajectory.fused
    assert not operator.ends_function(torch_cp, (0.0, 2 * D_T)).fused
    cfg = k9._SystemKernelConfig3D(torch_cp, D_T)
    assert cfg.plan is None
    # the launch path raises before it reaches the card rather than
    # picking another route
    with pytest.raises(ValueError, match="cluster"):
        k9.launch(torch.zeros((1,) + shape + (3,)), None, cfg, 1, False)


def test_applicability_rejects_what_the_kernel_does_not_cover(x64_off):
    m = vars(torch_pkg)
    neumann = m["NeumannBoundaryCondition"](
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    flat = m["ConstrainedProblem"](
        m["DiffusionEquation"](2, 0.3),
        m["Mesh"]([(0.0, 1.0)] * 2, [0.25] * 2),
        [(neumann, neumann)] * 2,
    )
    assert not k9.fused_system_3d_step_applicable(flat, RK4())
    curvilinear = m["ConstrainedProblem"](
        m["DiffusionEquation"](3, 0.3),
        m["Mesh"](
            [(1.0, 2.0), (0.0, 1.0), (0.0, 1.0)],
            [0.25] * 3,
            m["CoordinateSystem"].CYLINDRICAL,
        ),
        [(neumann, neumann)] * 3,
    )
    assert not k9.fused_system_3d_step_applicable(curvilinear, RK4())
    dynamic = m["NeumannBoundaryCondition"](
        lambda x, t: np.full((len(x), 1), t)
    )
    moving = m["ConstrainedProblem"](
        m["DiffusionEquation"](3, 0.3),
        m["Mesh"]([(0.0, 1.0)] * 3, [0.25] * 3),
        [(dynamic, dynamic)] * 3,
    )
    assert not k9.fused_system_3d_step_applicable(moving, RK4())


@pytest.mark.parametrize(
    "builder",
    [
        lambda cp: k9.build_fused_system_3d_rk4_trajectory(cp, 0.01, 2),
        lambda cp: k9.build_fused_system_3d_rk4_end(cp, 0.01, 2),
        lambda cp: k9.build_fused_system_3d_rk4_step(cp, 0.01),
    ],
)
def test_builders_reject_other_equations(builder):
    m = vars(torch_pkg)
    bc = m["NeumannBoundaryCondition"](
        lambda x, t: np.zeros((len(x), 3)), is_static=True
    )
    cp = m["ConstrainedProblem"](
        m["ShallowWaterEquation"](0.5),
        m["Mesh"]([(0.0, 1.0)] * 2, [0.25] * 2),
        [(bc, bc)] * 2,
    )
    with pytest.raises(ValueError, match="ShallowWaterEquation"):
        builder(cp)


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    _, cp = _problems("burgers", dirichlet=True)
    cfg = k9._SystemKernelConfig3D(cp, D_T)
    ys = torch.as_tensor(states_3d(SHAPE, 3, batch=2))
    wrappers = (
        k9.fused_system_3d_rk4_trajectory,
        k9.fused_system_3d_rk4_end,
        k9.fused_system_3d_rk4_step,
    )
    launches = [w.launches for w in wrappers]
    np.testing.assert_array_equal(
        k9.fused_system_3d_rk4_end(ys, cfg, 2).numpy(),
        k9.fused_system_3d_rk4_end_reference(ys, cfg, 2).numpy(),
    )
    np.testing.assert_array_equal(
        k9.fused_system_3d_rk4_trajectory(ys[0], cfg, 2).numpy(),
        k9.fused_system_3d_rk4_trajectory_reference(ys[0], cfg, 2).numpy(),
    )
    # no kernel ran, so no launch was counted
    assert [w.launches for w in wrappers] == launches
    with pytest.raises(TypeError, match="float32"):
        k9.fused_system_3d_rk4_end(ys.double(), cfg, 2)
    with pytest.raises(ValueError, match="shape"):
        k9.fused_system_3d_rk4_end(ys[:, :-1], cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k9.fused_system_3d_rk4_end(
            torch.zeros(SHAPE + (6,), dtype=torch.float32)[..., ::2], cfg, 2
        )


def test_fdm_operator_routes_3d_problems_to_k9(monkeypatch):
    """float32 3D Burgers solves, trajectories, ends and steps go through
    the K9 wrappers (their plain versions here); the solve agrees with
    the JAX package's FDMOperator.solve (its generic float64 path under
    the suite's x64 flag) to float32 rounding, 1e-5 of max|y| after 5
    steps; float64 stays generic."""
    jax_cp, cp = _problems("burgers", dirichlet=True)
    calls = []
    for name in (
        "fused_system_3d_rk4_trajectory",
        "fused_system_3d_rk4_end",
        "fused_system_3d_rk4_step",
    ):
        wrapper = getattr(k9, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append(_name)
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(k9, name, counting)

    def operator(dtype=torch.float32):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            D_T,
            device="cpu",
            dtype=dtype,
        )

    y_0 = states_3d(SHAPE, 3, seed=2)
    interval = (0.0, 5 * D_T)
    ivp = torch_pkg.InitialValueProblem(
        cp, interval, torch_pkg.DiscreteInitialCondition(cp, y_0, True)
    )
    solved = operator().solve(ivp).discrete_y()
    assert calls == ["fused_system_3d_rk4_trajectory"]
    jax_ivp = jax_pkg.InitialValueProblem(
        jax_cp,
        interval,
        jax_pkg.DiscreteInitialCondition(jax_cp, y_0.astype(np.float64), True),
    )
    expected = (
        JaxFDMOperator(JaxRK4(), JaxThreePoint(), D_T)
        .solve(jax_ivp)
        .discrete_y()
    )
    assert solved.shape == expected.shape == (5,) + SHAPE + (3,)
    scale = float(np.abs(expected).max())
    assert float(np.abs(solved - expected).max()) <= 1e-5 * scale

    # the initial condition with its Dirichlet faces applied
    y = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True), dtype=torch.float32
    )
    trajectory, _ = operator().trajectory_function(cp, interval)
    assert trajectory.fused and trajectory.vmappable
    frames = trajectory(y, 0.0)
    np.testing.assert_array_equal(frames.double().numpy(), solved)
    ends = operator().ends_function(cp, interval, batch=2)
    assert ends.fused and ends.batched
    np.testing.assert_array_equal(
        ends(torch.stack([y, y]), 0.0)[1].numpy(), frames[-1].numpy()
    )
    step = operator()._build_step_function(cp)
    np.testing.assert_array_equal(step(y, 0, 0.0).numpy(), frames[0].numpy())
    assert calls[1:] == [
        "fused_system_3d_rk4_trajectory",
        "fused_system_3d_rk4_end",
        "fused_system_3d_rk4_step",
    ]
    assert not operator(torch.float64).trajectory_function(cp, interval)[
        0
    ].fused
