"""The tiled diffusion kernel's plain PyTorch version (the CPU side of the
CUDA kernel K6) held against the JAX package's Pallas kernel in interpret
mode on that package's own small test problems, the planning helpers
against the JAX functions on tables of cases, the build function's errors, and
the ``FDMOperator`` dispatch to the resident and the tiled route on the
CPU. The CUDA kernel itself is held against its plain version in
tests/test_torch_cuda.py.

Tolerances: float32 results agree to 1e-5 relative to the largest value
(the two evaluate the same float32 operations in the same order; the
tolerance covers contraction and the one-ulp coefficient differences).
bfloat16 results agree to one bfloat16 step, 2**-7 of the largest value:
both round to nearest even at the same points, but a one-ulp float32
difference can tip a rounding to the neighbouring bfloat16 value."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.ops import tiled_diffusion as jax_tiled
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion as torch_fused
from pararealml_tpu_torch.ops import resident_diffusion as torch_resident
from pararealml_tpu_torch.ops import tiled_diffusion as torch_tiled
from tests.test_torch_cuda import LARGE_GRID_PROBLEMS, large_grid_problem

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_STEP = 2.0**-7
D_T = 0.005

SMALL_PROBLEMS = LARGE_GRID_PROBLEMS


def build_cp(module, h_extent, w_extent, d_x, convection=False, flux=0.0):
    """tests/test_tiled_diffusion.py's ``_build_cp`` through a package."""
    return large_grid_problem(
        vars(module), h_extent, w_extent, d_x, convection, flux
    )


def state(cp, seed=0):
    """A smooth O(1) state from a seed: Fourier modes over the Dirichlet
    value."""
    rng = np.random.default_rng(seed)
    height, width = cp.mesh.vertices_shape
    x = np.linspace(0.0, np.pi, height)[:, None]
    y = np.linspace(0.0, np.pi, width)[None, :]
    a, b = rng.uniform(0.5, 1.5, 2)
    k, m = rng.integers(1, 4, 2)
    grid = 1.5 + a * np.sin(k * x) * np.cos(m * y) + b * np.sin(x)
    return grid.astype(np.float32)[..., None]


def rel_err(actual, expected):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape
    return float(np.abs(actual - expected).max() / np.abs(expected).max())


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels run in float32 mode only; the suite
    enables x64, so turn it off inside the test."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def small_caps(monkeypatch):
    """Shrinks the port's one-CTA gate to 16 x 16 grids and the resident
    plan to four blocks of 16 KB, so that small grids take the large-grid
    routes: 33 x 33 still plans as resident, 81 x 81 only as tiled; and
    the JAX package's VMEM cap, past which alone the storage, frame and
    temporal-block knobs take effect (as there), to 16 x 16 grids too."""
    monkeypatch.setattr(
        torch_fused,
        "MAX_SHARED_MEMORY_BYTES",
        torch_fused.shared_memory_bytes(16, 16),
    )
    monkeypatch.setattr(
        torch_fused,
        "REFERENCE_MAX_VMEM_CELLS",
        torch_fused.padded_cells(16, 16),
    )
    monkeypatch.setattr(torch_resident, "_MAX_BLOCKS", 4)
    monkeypatch.setattr(torch_resident, "_MAX_SHARED_MEMORY_BYTES", 16 * 1024)


@pytest.mark.parametrize("problem", sorted(SMALL_PROBLEMS))
def test_tiled_reference_matches_pallas_kernel(problem, x64_off):
    args = SMALL_PROBLEMS[problem]
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    steps = 5
    expected = jax_tiled.build_tiled_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True
    )(y)
    actual = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(y))
    assert actual.dtype == torch.float32
    assert rel_err(actual, expected) <= F32_TOL


@pytest.mark.parametrize("temporal_block", [2, 4])
@pytest.mark.parametrize("convection", [False, True])
def test_temporal_block_equals_single_step_exactly(temporal_block, convection):
    cp = build_cp(torch_pkg, 10.0, 10.0, 10.0 / 63.0, convection, flux=0.1)
    y = torch.as_tensor(state(cp))
    single = torch_tiled.build_tiled_diffusion_rk4_trajectory(cp, D_T, 8)
    blocked = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        cp, D_T, 8, temporal_block=temporal_block
    )
    assert torch.equal(single(y), blocked(y))


def test_blocked_reference_matches_pallas_kernel(x64_off):
    args = (10.0, 10.0, 10.0 / 63.0, True, 0.1)
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    expected = jax_tiled.build_tiled_diffusion_rk4_trajectory(
        jax_cp, D_T, 8, interpret=True, temporal_block=4
    )(y)
    actual = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        torch_cp, D_T, 8, temporal_block=4
    )(torch.as_tensor(y))
    assert rel_err(actual, expected) <= F32_TOL


def test_bf16_state_matches_pallas_kernel(x64_off):
    # the state rounds to bfloat16 once per step at temporal_block=1
    args = SMALL_PROBLEMS["flux_81x81"]
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    expected = jax_tiled.build_tiled_diffusion_rk4_trajectory(
        jax_cp, D_T, 5, interpret=True, storage_dtype=jnp.bfloat16
    )(y)
    actual = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        torch_cp, D_T, 5, storage_dtype=torch.bfloat16
    )(torch.as_tensor(y))
    # the frames keep the stored dtype; the JAX package casts them back
    assert actual.dtype == torch.bfloat16
    assert rel_err(actual.float(), expected) <= BF16_STEP
    exact = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        torch_cp, D_T, 5
    )(torch.as_tensor(y))
    assert rel_err(actual.float(), exact) < 0.02


def test_bf16_snapshots_match_pallas_kernel_and_round_once(x64_off):
    args = (10.0, 10.0, 10.0 / 63.0, False, 0.0)
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    expected = jax_tiled.build_tiled_diffusion_rk4_trajectory(
        jax_cp,
        D_T,
        8,
        interpret=True,
        temporal_block=4,
        traj_dtype=jnp.bfloat16,
    )(y)
    actual = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        torch_cp, D_T, 8, temporal_block=4, traj_dtype=torch.bfloat16
    )(torch.as_tensor(y))
    assert actual.dtype == torch.bfloat16
    assert rel_err(actual.float(), expected) <= BF16_STEP
    # the state stays float32: every frame is ONE rounding of the exact
    # float32 frame
    exact = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        torch_cp, D_T, 8
    )(torch.as_tensor(y))
    assert torch.equal(actual, exact.to(torch.bfloat16))


def test_bf16_state_rounds_once_per_residency():
    cp = build_cp(torch_pkg, 10.0, 10.0, 10.0 / 63.0)
    cfg = torch_tiled._HornerConfig(cp, D_T)
    y = torch.as_tensor(state(cp)[..., 0])
    blocked = torch_tiled.tiled_diffusion_rk4_trajectory(
        y, cfg, 4, torch.bfloat16, torch.float32, 2
    )
    # two float32 steps from the rounded initial state, one rounding, two
    # more steps
    faces = cfg.faces(y.device)
    s = y.to(torch.bfloat16).float()
    frames = []
    for k in range(4):
        s = torch_tiled._horner_step_reference(s, cfg, faces)
        frames.append(s)
        if k == 1:
            s = s.to(torch.bfloat16).float()
    assert torch.equal(blocked, torch.stack(frames))


def _fake_cp(shape):
    """What the planning helpers of both packages read of a problem."""
    return types.SimpleNamespace(
        mesh=types.SimpleNamespace(vertices_shape=shape),
        static_y_vertex_constraints=None,
    )


@pytest.mark.parametrize(
    "n_steps,requested",
    [(500, 10), (500, 8), (512, 8), (7, 8), (100, 1), (192, 2), (6, 64)],
)
def test_pick_temporal_block_matches_jax(n_steps, requested):
    assert torch_tiled.pick_temporal_block(
        n_steps, requested
    ) == jax_tiled.pick_temporal_block(n_steps, requested)


@pytest.mark.parametrize(
    "shape,n_steps,requested",
    [
        # grids that do not stream keep the parity/divisibility pick
        ((64, 64), 512, 64),
        ((641, 641), 2000, 16),
        # the bench's streaming grid
        ((2049, 2049), 192, 1),
        ((2049, 2049), 192, 2),
        ((2049, 2049), 192, 4),
        ((2049, 2049), 190, 4),
        ((2049, 2049), 7, 4),
    ],
)
def test_resolve_temporal_block_matches_jax(shape, n_steps, requested):
    cp = _fake_cp(shape)
    assert torch_tiled.takes_streaming_path(
        cp
    ) == jax_tiled.takes_streaming_path(cp)
    assert torch_tiled.resolve_temporal_block(
        cp, n_steps, requested
    ) == jax_tiled.resolve_temporal_block(cp, n_steps, requested)


def test_tile_plan_is_the_ports_own():
    # deliberate differences from the JAX package's row-tile plan: 2D
    # tiles of one size, no cap on the grid, and a temporal block of at
    # most 4 (the halo of 4 K cells must leave a tile at least as large)
    plan = torch_tiled.make_tile_plan(2049, 2049)
    assert (plan.halo, plan.tile_h, plan.tile_w) == (4, 56, 120)
    assert plan.n_tiles_h * plan.tile_h >= 2049
    assert plan.n_tiles_w * plan.tile_w >= 2049
    assert plan.shared_bytes <= 113 * 1024  # two blocks an SM
    assert jax_tiled.make_tile_plan(10_000, 10_000) is None
    assert torch_tiled.make_tile_plan(10_000, 10_000) is not None
    assert torch_tiled.make_tile_plan(2049, 2049, 4) is not None
    assert torch_tiled.make_tile_plan(2049, 2049, 6) is None
    assert torch_tiled.make_tile_plan(2, 2049) is None
    big = _fake_cp((2049, 2049))
    assert jax_tiled.resolve_temporal_block(big, 512, 64) == 32
    assert torch_tiled.resolve_temporal_block(big, 512, 64) == 4


@pytest.mark.parametrize("case", ["faces", "none", "interior"])
def test_dirichlet_is_face_only_matches_jax(case):
    cps = []
    for module in (jax_pkg, torch_pkg):
        if case == "none":
            mesh = module.Mesh([(0.0, 2.0), (0.0, 2.0)], [0.25, 0.25])
            bc = module.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            )
            cp = module.ConstrainedProblem(
                module.DiffusionEquation(2), mesh, [(bc, bc)] * 2
            )
        else:
            cp = build_cp(module, 2.0, 4.0, 0.25)
        if case == "interior":
            _forge_interior_constraint(module, cp)
        cps.append(cp)
    expected = jax_tiled.dirichlet_is_face_only(cps[0])
    assert torch_tiled.dirichlet_is_face_only(cps[1]) == expected
    assert expected == (case != "interior")


def _forge_interior_constraint(module, cp):
    from pararealml_tpu.constraint import Constraint as JaxConstraint
    from pararealml_tpu_torch.constraint import Constraint as TorchConstraint

    shape = tuple(cp.mesh.vertices_shape) + (1,)
    mask = np.zeros(shape, bool)
    mask[shape[0] // 2, shape[1] // 2] = True
    values = np.where(mask, 1.0, 0.0)
    constraint = JaxConstraint if module is jax_pkg else TorchConstraint
    cp._y_vertex_constraints = constraint(
        np.asarray(values), np.asarray(mask)
    )


@pytest.mark.parametrize(
    "kwargs,n_steps,match",
    [
        (dict(temporal_block=3), 9, "even"),
        (dict(temporal_block=4), 9, "divide"),
        (dict(traj_dtype=torch.bfloat16), 8, "temporal_block"),
        (dict(temporal_block=0), 8, ">= 1"),
        (dict(storage_dtype=torch.float16), 8, "storage_dtype"),
        (dict(temporal_block=2, traj_dtype=torch.float64), 8, "traj_dtype"),
        (dict(temporal_block=6), 12, "range"),
    ],
)
def test_tiled_build_function_validation(kwargs, n_steps, match):
    cp = build_cp(torch_pkg, 10.0, 10.0, 10.0 / 63.0)
    with pytest.raises(ValueError, match=match):
        torch_tiled.build_tiled_diffusion_rk4_trajectory(
            cp, 0.01, n_steps, **kwargs
        )


def test_tiled_build_function_rejects_interior_dirichlet():
    cp = build_cp(torch_pkg, 10.0, 10.0, 0.125)
    _forge_interior_constraint(torch_pkg, cp)
    with pytest.raises(ValueError, match="face"):
        torch_tiled.build_tiled_diffusion_rk4_trajectory(cp, 0.01, 2)


def test_wrapper_takes_batches_and_counts_no_launch_on_the_cpu():
    cp = build_cp(torch_pkg, *SMALL_PROBLEMS["convection_33x17"])
    cfg = torch_tiled._HornerConfig(cp, D_T)
    ys = torch.as_tensor(
        np.stack([state(cp, seed)[..., 0] for seed in range(3)])
    )
    launches = torch_tiled.tiled_diffusion_rk4_trajectory.launches
    batched = torch_tiled.tiled_diffusion_rk4_trajectory(ys, cfg, 4)
    assert batched.shape == (3, 4, 33, 17)
    # one state of the batch advances exactly as it does alone
    assert torch.equal(
        batched[1], torch_tiled.tiled_diffusion_rk4_trajectory(ys[1], cfg, 4)
    )
    assert torch_tiled.tiled_diffusion_rk4_trajectory.launches == launches
    with pytest.raises(TypeError, match="float32"):
        torch_tiled.tiled_diffusion_rk4_trajectory(ys.double(), cfg, 4)
    with pytest.raises(ValueError, match="shape"):
        torch_tiled.tiled_diffusion_rk4_trajectory(ys[:, :-1], cfg, 4)


# -- FDMOperator dispatch through the plain versions ------------------------


def _operator(d_t, **kwargs):
    return FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        d_t,
        device="cpu",
        dtype=torch.float32,
        **kwargs,
    )


def _spy(monkeypatch, module, name):
    """Counts the calls of a kernel wrapper of ``module``."""
    wrapped = getattr(module, name)
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize(
    "route,args",
    [
        ("resident", (2.0, 2.0, 0.0625, True, 0.2)),  # 33 x 33
        ("tiled", (10.0, 10.0, 0.125, False, 0.1)),  # 81 x 81
    ],
)
def test_fdm_operator_takes_the_large_grid_routes(
    route, args, small_caps, monkeypatch
):
    cp = build_cp(torch_pkg, *args)
    shape = cp.mesh.vertices_shape
    assert not torch_fused.fits_one_block(*shape)
    assert (torch_resident.make_resident_plan(*shape) is not None) == (
        route == "resident"
    )
    assert torch_tiled.takes_streaming_path(cp) == (route == "tiled")
    assert torch_fused.fused_diffusion_step_applicable(cp, RK4())
    resident_calls = _spy(
        monkeypatch, torch_resident, "resident_diffusion_rk4_trajectory"
    )
    tiled_calls = _spy(
        monkeypatch, torch_tiled, "tiled_diffusion_rk4_trajectory"
    )
    y = torch.as_tensor(state(cp))
    steps = 6
    fused_fn, _ = _operator(D_T, kernel_temporal_block=2).trajectory_function(
        cp, (0.0, steps * D_T)
    )
    assert fused_fn.fused
    fused = fused_fn(y, 0.0)
    assert (len(resident_calls), len(tiled_calls)) == (
        (1, 0) if route == "resident" else (0, 1)
    )
    if route == "tiled":
        # the temporal block reached the kernel
        assert tiled_calls[0][0][-1] == 2
    generic_fn, _ = _operator(D_T, fused_kernels=False).trajectory_function(
        cp, (0.0, steps * D_T)
    )
    generic = generic_fn(y, 0.0)
    assert fused.shape == generic.shape == (steps,) + tuple(y.shape)
    np.testing.assert_allclose(
        fused.numpy(), generic.numpy(), atol=1e-4, rtol=1e-4
    )
    # ends on such a grid take the resident kernel's end mode where it
    # takes the trajectory, else the generic carry-only loop
    ends = _operator(D_T).ends_function(cp, (0.0, steps * D_T))
    assert ends.fused == (route == "resident")
    assert (
        torch_fused.build_fused_diffusion_rk4_end(cp, D_T, steps) is None
    ) == (route == "tiled")
    np.testing.assert_allclose(
        ends(y, 0.0).numpy(), generic[-1].numpy(), atol=1e-4, rtol=1e-4
    )
    # the fused step is the one-step trajectory
    step = torch_fused.build_fused_diffusion_rk4_step(cp, D_T)
    np.testing.assert_allclose(
        step(y).numpy(), generic[0].numpy(), atol=1e-4, rtol=1e-4
    )


def test_fdm_operator_passes_the_dtypes_to_the_tiled_kernel(small_caps):
    cp = build_cp(torch_pkg, 10.0, 10.0, 0.125, False, 0.1)
    y = torch.as_tensor(state(cp))
    exact, _ = _operator(D_T).trajectory_function(cp, (0.0, 4 * D_T))
    rounded, _ = _operator(
        D_T,
        kernel_temporal_block=2,
        kernel_traj_dtype=torch.bfloat16,
    ).trajectory_function(cp, (0.0, 4 * D_T))
    frames = rounded(y, 0.0)
    assert frames.dtype == torch.bfloat16
    assert torch.equal(frames, exact(y, 0.0).to(torch.bfloat16))
    solution = _operator(D_T, kernel_storage_dtype=torch.bfloat16).solve(
        torch_pkg.InitialValueProblem(
            cp,
            (0.0, 4 * D_T),
            torch_pkg.GaussianInitialCondition(
                cp, [(np.full(2, 5.0), np.eye(2))], [20.0]
            ),
        )
    )
    assert solution.discrete_y().dtype == np.float64
    assert np.isfinite(solution.discrete_y()).all()


def test_fdm_operator_warns_when_traj_dtype_dropped(small_caps):
    # a streaming-path grid and an odd step count: no even temporal block
    # divides it, so the requested bfloat16 frames are dropped, aloud
    cp = build_cp(torch_pkg, 10.0, 10.0, 0.125)
    op = _operator(
        1e-4, kernel_temporal_block=4, kernel_traj_dtype=torch.bfloat16
    )
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn, _ = op.trajectory_function(cp, (0.0, 7 * 1e-4))
    assert any("kernel_traj_dtype" in str(w.message) for w in caught)
    assert fn(torch.as_tensor(state(cp)), 0.0).dtype == torch.float32
    # a resident grid ignores the frame dtype without a warning
    resident_cp = build_cp(torch_pkg, 2.0, 2.0, 0.0625)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        op.trajectory_function(resident_cp, (0.0, 7 * 1e-4))
    assert not any("kernel_traj_dtype" in str(w.message) for w in caught)


def test_parareal_over_a_resident_fine_operator(small_caps, monkeypatch):
    # two slices as a leading axis through the resident route: the
    # wrapper takes the batch, so the trajectory stays tagged vmappable
    cp = build_cp(torch_pkg, 2.0, 2.0, 0.0625, False, 0.0)  # 33 x 33
    ivp = torch_pkg.InitialValueProblem(
        cp,
        (0.0, 0.04),
        torch_pkg.GaussianInitialCondition(
            cp, [(np.full(2, 1.0), 0.1 * np.eye(2))], [5.0]
        ),
    )
    calls = _spy(
        monkeypatch, torch_resident, "resident_diffusion_rk4_trajectory"
    )
    fine = _operator(1e-3, linear_propagator=False)
    coarse = _operator(2.5e-3, linear_propagator=False)
    fine_fn, _ = fine.trajectory_function(cp, (0.0, 0.02))
    assert fine_fn.vmappable and fine_fn.fused
    parareal = PararealOperator(fine, coarse, 1e-4, num_time_slices=2)
    ys = parareal.solve(ivp).discrete_y()
    assert any(c[0][0].ndim == 3 and c[0][0].shape[0] == 2 for c in calls)
    expected = fine.solve(ivp).discrete_y()
    assert ys.shape == expected.shape == (40, 33, 33, 1)
    # two slices converge in at most two iterations, after which Parareal
    # reproduces the fine solve up to float32 rounding of the corrections
    np.testing.assert_allclose(ys, expected, atol=1e-4, rtol=1e-4)
