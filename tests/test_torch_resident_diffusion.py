"""The resident diffusion kernel's plain PyTorch version (the CPU side of
the CUDA kernel K7) held against the JAX package's Pallas kernel in
interpret mode on that package's own small test problems, its tile plan,
and the build function's errors. The CUDA kernel itself is held against its
plain version in tests/test_torch_cuda.py.

Tolerances as in tests/test_torch_tiled_diffusion.py: float32 to 1e-5 of
the largest value, bfloat16 frames to one bfloat16 step (2**-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.ops import fused_diffusion as jax_fused_diffusion
from pararealml_tpu.ops import resident_diffusion as jax_resident
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion as torch_fused
from pararealml_tpu_torch.ops import resident_diffusion as torch_resident
from pararealml_tpu_torch.ops import tiled_diffusion as torch_tiled
from tests.test_torch_tiled_diffusion import (
    BF16_STEP,
    D_T,
    F32_TOL,
    SMALL_PROBLEMS,
    _forge_interior_constraint,
    build_cp,
    rel_err,
    small_caps,  # noqa: F401 (a fixture)
    state,
    x64_off,  # noqa: F401 (a fixture)
)

torch.set_num_threads(1)

# tests/test_resident_diffusion.py's problems: the tiled kernel's three
# and an 8 x 8 grid
PROBLEMS = dict(SMALL_PROBLEMS, tile_8x8=(2.0, 2.0, 2.0 / 7.0, False, 0.1))


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_resident_reference_matches_pallas_kernel(problem, x64_off):  # noqa
    args = PROBLEMS[problem]
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    steps = 5
    expected = jax_resident.build_resident_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True
    )(y)
    actual = torch_resident.build_resident_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(y))
    assert actual.dtype == torch.float32
    assert rel_err(actual, expected) <= F32_TOL


def test_bf16_snapshots_match_pallas_kernel_and_round_once(x64_off):  # noqa
    args = SMALL_PROBLEMS["flux_81x81"]
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    steps = 20
    expected = jax_resident.build_resident_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True, storage_dtype=jnp.bfloat16
    )(y)
    actual = torch_resident.build_resident_diffusion_rk4_trajectory(
        torch_cp, D_T, steps, storage_dtype=torch.bfloat16
    )(torch.as_tensor(y))
    assert actual.dtype == torch.bfloat16
    assert rel_err(actual.float(), expected) <= BF16_STEP
    # the resident state stays float32, so the last frame is one rounding
    # of the float32 frame, not twenty accumulated ones
    exact = torch_resident.build_resident_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(y))
    assert torch.equal(actual, exact.to(torch.bfloat16))
    assert rel_err(actual.float(), exact) < 3e-3


@pytest.mark.parametrize("problem", sorted(SMALL_PROBLEMS))
def test_resident_agrees_with_the_tiled_and_the_one_block_versions(problem):
    # the three kernels' plain versions on one grid all take: K6 and K7
    # share their arithmetic up to the rounding of the folded
    # coefficients, K1 is the classic four-stage form
    cp = build_cp(torch_pkg, *SMALL_PROBLEMS[problem])
    y = torch.as_tensor(state(cp))
    steps = 10
    resident = torch_resident.build_resident_diffusion_rk4_trajectory(
        cp, D_T, steps
    )(y)
    tiled = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        cp, D_T, steps
    )(y)
    assert torch_fused.fits_one_block(*cp.mesh.vertices_shape)
    one_block = torch_fused.build_fused_diffusion_rk4_trajectory(
        cp, D_T, steps
    )(y)
    assert rel_err(resident, tiled) <= F32_TOL
    assert rel_err(resident, one_block) <= F32_TOL


@pytest.mark.parametrize(
    "shape", [(8, 8), (17, 33), (130, 130), (641, 641), (1281, 1281),
              (700, 2000)]
)
def test_resident_plan_covers_the_grid_within_the_card(shape):
    plan = torch_resident.make_resident_plan(*shape)
    assert plan is not None
    assert plan.n_tiles_h * plan.n_tiles_w <= 132
    assert plan.shared_bytes <= 227 * 1024
    assert plan.n_tiles_h * plan.tile_h >= shape[0]
    assert plan.n_tiles_w * plan.tile_w >= shape[1]
    # no tile lies wholly outside the grid
    assert (plan.n_tiles_h - 1) * plan.tile_h < shape[0]
    assert (plan.n_tiles_w - 1) * plan.tile_w < shape[1]


def test_resident_range():
    # the bench's resident grid plans as in the JAX package, its streaming
    # grid does not; the port's range ends where 132 tiles outgrow 227 KB
    for shape in ((641, 641), (1281, 1281), (2049, 2049)):
        assert (torch_resident.make_resident_plan(*shape) is None) == (
            jax_resident.make_resident_plan(*shape) is None
        )
    # one barrier for two steps where the wider halo fits, else one a step
    assert torch_resident.make_resident_plan(641, 641) == (12, 11, 54, 59, 2)
    assert torch_resident.make_resident_plan(641, 641, 1) == (
        12, 11, 54, 59, 1
    )
    assert torch_resident.make_resident_plan(1281, 1281).steps_per_barrier == 2
    assert torch_resident.make_resident_plan(1500, 1500).steps_per_barrier == 1
    assert torch_resident.make_resident_plan(1600, 1600) is None
    assert torch_resident.make_resident_plan(2, 64) is None


def test_resident_build_function_errors(small_caps):  # noqa: F811
    cp = build_cp(torch_pkg, 10.0, 10.0, 0.125)  # 81 x 81
    with pytest.raises(ValueError, match="range"):
        torch_resident.build_resident_diffusion_rk4_trajectory(cp, 0.01, 2)
    cp = build_cp(torch_pkg, 2.0, 2.0, 0.0625)  # 33 x 33
    with pytest.raises(ValueError, match="storage_dtype"):
        torch_resident.build_resident_diffusion_rk4_trajectory(
            cp, 0.01, 2, storage_dtype=torch.float16
        )
    _forge_interior_constraint(torch_pkg, cp)
    # interior constraints: the resident kernel takes them (the JAX
    # package's K1 does below its VMEM cap), the tiled one raises
    torch_resident.build_resident_diffusion_rk4_trajectory(cp, 0.01, 2)
    with pytest.raises(ValueError, match="face"):
        torch_tiled.build_tiled_diffusion_rk4_trajectory(cp, 0.01, 2)
    assert not torch_tiled.takes_streaming_path(cp)
    assert torch_fused.fused_diffusion_step_applicable(cp, RK4())
    # past the resident range they take neither large-grid kernel
    cp = build_cp(torch_pkg, 10.0, 10.0, 0.125)  # 81 x 81
    _forge_interior_constraint(torch_pkg, cp)
    assert torch_tiled.takes_streaming_path(cp)
    assert not torch_fused.fused_diffusion_step_applicable(cp, RK4())


def test_wrapper_takes_batches_and_counts_no_launch_on_the_cpu():
    cp = build_cp(torch_pkg, *SMALL_PROBLEMS["folded_17x33"])
    cfg = torch_tiled._HornerConfig(cp, D_T, resident=True)
    ys = torch.as_tensor(
        np.stack([state(cp, seed)[..., 0] for seed in range(3)])
    )
    launches = torch_resident.resident_diffusion_rk4_trajectory.launches
    batched = torch_resident.resident_diffusion_rk4_trajectory(ys, cfg, 4)
    assert batched.shape == (3, 4, 17, 33)
    assert torch.equal(
        batched[2],
        torch_resident.resident_diffusion_rk4_trajectory(ys[2], cfg, 4),
    )
    assert (
        torch_resident.resident_diffusion_rk4_trajectory.launches == launches
    )
    with pytest.raises(TypeError, match="float32"):
        torch_resident.resident_diffusion_rk4_trajectory(ys.double(), cfg, 4)
    with pytest.raises(ValueError, match="contiguous"):
        torch_resident.resident_diffusion_rk4_trajectory(
            torch.zeros((3, 17, 66))[:, :, ::2], cfg, 4
        )


# -- the end mode and Dirichlet constraints inside the grid ------------------


def _add_interior_square(module, cp, value=2.0):
    """Adds a Dirichlet square of ``value`` over the middle ninth of
    ``cp``'s grid to its static y constraints (the face ones stay)."""
    from pararealml_tpu.constraint import Constraint as JaxConstraint
    from pararealml_tpu_torch.constraint import Constraint as TorchConstraint

    height, width = cp.mesh.vertices_shape
    old = cp.static_y_vertex_constraints
    mask = np.asarray(old.mask).reshape(height, width).copy()
    values = np.where(mask, np.asarray(old.values).reshape(height, width), 0.0)
    rows = slice(height // 3, 2 * height // 3)
    cols = slice(width // 3, 2 * width // 3)
    mask[rows, cols] = True
    values[rows, cols] = value
    constraint = JaxConstraint if module is jax_pkg else TorchConstraint
    cp._y_vertex_constraints = constraint(
        values.reshape(np.asarray(old.values).shape),
        mask.reshape(np.asarray(old.mask).shape),
    )
    return cp


def _constrained_state(cp, seed=0):
    """``state(cp)`` with the Dirichlet constraints applied, as an initial
    condition applies them (the Horner form is the classic RK4 step only
    for such a state)."""
    y = state(cp, seed)
    constraint = cp.static_y_vertex_constraints
    mask = np.asarray(constraint.mask).reshape(y.shape)
    return np.where(
        mask, np.asarray(constraint.values).reshape(y.shape), y
    ).astype(np.float32)


def _interior_problems(d_x=0.0625):
    """A 33 x 33 problem (tests/test_tiled_diffusion.py's Dirichlet rows
    and zero-flux columns) with a Dirichlet square of 2.0 inside, through
    both packages."""
    return tuple(
        _add_interior_square(module, build_cp(module, 2.0, 2.0, d_x))
        for module in (jax_pkg, torch_pkg)
    )


def test_end_mode_is_the_trajectorys_last_frame(small_caps):  # noqa: F811
    """The end mode's plain version advances each state of a batch as the
    trajectory does and keeps the last frame; on the CPU it counts no
    launch; a grid outside the resident range (81 x 81 under the patched
    caps) raises."""
    cp = build_cp(torch_pkg, *SMALL_PROBLEMS["folded_17x33"])
    cfg = torch_tiled._HornerConfig(cp, D_T, resident=True)
    ys = torch.as_tensor(
        np.stack([state(cp, seed)[..., 0] for seed in range(3)])
    )
    launches = torch_resident.resident_diffusion_rk4_end.launches
    end = torch_resident.resident_diffusion_rk4_end(ys, cfg, 4)
    assert end.shape == ys.shape and end.dtype == torch.float32
    assert torch.equal(
        end, torch_resident.resident_diffusion_rk4_trajectory(ys, cfg, 4)[:, -1]
    )
    assert torch.equal(
        end[1], torch_resident.resident_diffusion_rk4_end(ys[1], cfg, 4)
    )
    assert torch_resident.resident_diffusion_rk4_end.launches == launches
    builder = torch_resident.build_resident_diffusion_rk4_end
    batched = builder(cp, D_T, 4, batch=3)
    assert torch.equal(batched(ys[..., None])[..., 0], end)
    with pytest.raises(ValueError, match="leading shape"):
        batched(ys[0, ..., None])
    with pytest.raises(ValueError, match="range"):
        builder(build_cp(torch_pkg, 10.0, 10.0, 0.125), D_T, 4)


def test_interior_dirichlet_matches_pallas_k1(small_caps, x64_off):  # noqa
    """Diffusion with a Dirichlet square inside the grid, past the one-CTA
    gate (patched down): the trajectory and the end take the resident
    kernel (its plain version) through the fused diffusion builders, and
    both match the JAX package's whole-grid K1 in interpret mode, which
    the JAX package runs there, to 1e-5; the square holds its value."""
    jax_cp, torch_cp = _interior_problems()
    assert not torch_fused.fits_one_block(*torch_cp.mesh.vertices_shape)
    y = _constrained_state(torch_cp)
    steps = 8
    expected = np.asarray(
        jax_fused_diffusion.build_fused_diffusion_rk4_trajectory(
            jax_cp, D_T, steps, interpret=True
        )(y)
    )
    trajectory = torch_fused.build_fused_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(y))
    end = torch_fused.build_fused_diffusion_rk4_end(torch_cp, D_T, steps)(
        torch.as_tensor(y)
    )
    assert rel_err(trajectory, expected) <= F32_TOL
    assert rel_err(end, expected[-1]) <= F32_TOL
    assert torch.equal(end, trajectory[-1])
    assert bool((end[11:22, 11:22] == 2.0).all())


def _exact_horner_config(cp, d_t):
    """The resident configuration with the float64 Horner coefficients
    unrounded (the kernel's are rounded once to float32), to hold the
    plain version's arithmetic against the generic path in float64."""
    cfg = torch_tiled._HornerConfig(cp, d_t, resident=True)
    d = float(cp.differential_equation._d)
    d_x0, d_x1 = (float(d_x) for d_x in cp.mesh.d_x)
    stages = []
    for k in (4.0, 3.0, 2.0, 1.0):
        c = d_t / k
        stages.append(
            torch_tiled._StageCoefficients(
                a0=c * d / d_x0**2,
                a1=c * d / d_x1**2,
                a_center=-2.0 * c * d * (1.0 / d_x0**2 + 1.0 / d_x1**2),
                cv0=0.0,
                cv1=0.0,
                flux0=0.0,
                flux1=0.0,
            )
        )
    cfg.stages = tuple(stages)
    cfg.square = tuple(stage.a0 == stage.a1 for stage in stages)
    cfg.two_dx0, cfg.two_dx1 = 2.0 * d_x0, 2.0 * d_x1
    return cfg


def test_end_mode_and_interior_dirichlet_match_generic_path_in_float64():
    """The resident kernel's end mode with a Dirichlet square inside the
    grid, its plain version in float64 with unrounded coefficients,
    against the JAX package's generic path in float64 over 10 steps, to
    1e-10 of the largest value: the Horner form with the square applied
    after every stage is the classic RK4 step with its constraints."""
    jax_cp, torch_cp = _interior_problems()
    y = _constrained_state(torch_cp).astype(np.float64)
    steps = 10
    from pararealml_tpu.operators.fdm import FDMOperator as JaxFDMOperator
    from pararealml_tpu.operators.fdm import RK4 as JaxRK4
    from pararealml_tpu.operators.fdm import (
        ThreePointCentralDifferenceMethod as JaxThreePoint,
    )

    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, steps * D_T))
    expected = np.asarray(generic(y, 0.0))[-1, ..., 0]
    cfg = _exact_horner_config(torch_cp, D_T)
    actual = torch_resident.resident_diffusion_rk4_end_reference(
        torch.as_tensor(y[..., 0]), cfg, steps
    )
    assert actual.dtype == torch.float64
    scale = np.abs(expected).max()
    assert np.abs(actual.numpy() - expected).max() <= 1e-10 * scale


def test_fdm_operator_and_parareal_take_the_end_mode(
    small_caps, monkeypatch  # noqa: F811
):
    """Past the one-CTA gate (patched down), ``FDMOperator.ends_function``
    on a diffusion problem with a Dirichlet square inside runs the
    resident kernel's end mode (tagged ``fused``, single and batched), and
    a Parareal with the affine propagators off runs its fine ends there
    for all slices at once and its final expansion through the resident
    trajectory; the Parareal solution matches the fine solve."""
    _, cp = _interior_problems()
    calls = []
    for name in (
        "resident_diffusion_rk4_end",
        "resident_diffusion_rk4_trajectory",
    ):
        wrapper = getattr(torch_resident, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append((_name, tuple(y.shape[:-2])))
            return _wrapper(y, *args, **kwargs)

        monkeypatch.setattr(torch_resident, name, counting)

    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            linear_propagator=False,
            device="cpu",
            dtype=torch.float32,
        )

    y = torch.as_tensor(_constrained_state(cp))
    interval = (0.0, 4 * D_T)
    ends = fdm(D_T).ends_function(cp, interval, batch=2)
    assert ends.fused and ends.batched
    trajectory, _ = fdm(D_T).trajectory_function(cp, interval)
    assert torch.equal(ends(torch.stack([y, y]), 0.0)[1], trajectory(y)[-1])
    assert ("resident_diffusion_rk4_end", (2,)) in calls

    calls.clear()
    ivp = torch_pkg.InitialValueProblem(
        cp,
        (0.0, 0.08),
        torch_pkg.DiscreteInitialCondition(
            cp, _constrained_state(cp).astype(np.float64), True
        ),
    )
    parareal = PararealOperator(fdm(D_T), fdm(0.02), 1e-4, num_time_slices=4)
    actual = parareal.solve(ivp).discrete_y()
    fine = fdm(D_T).solve(ivp).discrete_y()
    assert calls.count(("resident_diffusion_rk4_end", (4,))) == (
        parareal.last_iterations
    )
    assert ("resident_diffusion_rk4_trajectory", (4,)) in calls
    assert np.abs(actual - fine).max() <= 1e-3 * np.abs(fine).max()
