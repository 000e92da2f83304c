"""The fused system kernels' plain PyTorch versions (the CPU side of the
CUDA kernels K5 and K4) held against the JAX package's Pallas kernels in
interpret mode, in float32 to atol = rtol = 1e-5 after at most 12 steps
on 9 x 9 Burgers problems and a 9 x 11 Cahn-Hilliard one (the two
evaluate the same operations in the same order; the tolerance covers
float32 rounding of contracted or reordered operations), the wave,
shallow-water and Cahn-Hilliard plain versions against the JAX package's
generic path in float64 to 1e-10, plus the applicability gates, the
wrappers' CPU routing and the FDM operator's dispatch to K5. The CUDA
kernels themselves are held against their plain versions in
tests/test_torch_cuda.py."""

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
from pararealml_tpu.ops import packed_system as jax_packed
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ForwardEulerMethod,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.ops import fused_system as torch_fused
from pararealml_tpu_torch.ops import packed_system as torch_packed
from pararealml_tpu_torch.ops import tiled_system as torch_tiled
from tests.test_torch_cuda import burgers_problem, states_2d, system_problem

torch.set_num_threads(1)

TOL = 1e-5
D_T = 1e-2
STEPS = 12


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _problems(kind):
    return tuple(
        burgers_problem(vars(module), kind, extent=2.0).constrained_problem
        for module in (jax_pkg, torch_pkg)
    )


def _states(batch=None, seed=0):
    """O(1) two-component 9 x 9 states from a seed."""
    rng = np.random.default_rng(seed)
    count = 1 if batch is None else batch
    states = rng.uniform(0.5, 1.5, (count, 9, 9, 2)).astype(np.float32)
    return states[0] if batch is None else states


def _assert_close(actual, expected):
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, atol=TOL, rtol=TOL)


# five interpret-mode runs of the Pallas kernels in all: each costs
# seconds of tracing on the CPU
@pytest.mark.parametrize(
    "kernel, kind",
    [
        ("trajectory", "bench"),
        ("end", "mixed"),
        ("step", "bench"),
        ("packed_ends", "bench"),
        ("packed_trajectory", "mixed"),
    ],
)
def test_plain_versions_match_pallas_kernels(kernel, kind, x64_off):
    jax_cp, torch_cp = _problems(kind)
    batched = kernel.startswith("packed")
    y = _states(batch=3 if batched else None)
    if kernel == "trajectory":
        expected = jax_fused.build_fused_system_rk4_trajectory(
            jax_cp, D_T, STEPS, interpret=True
        )(y)
        actual = torch_fused.build_fused_system_rk4_trajectory(
            torch_cp, D_T, STEPS
        )(torch.as_tensor(y))
    elif kernel == "end":
        expected = jax_fused.build_fused_system_rk4_end(
            jax_cp, D_T, STEPS, interpret=True
        )(y)
        actual = torch_fused.build_fused_system_rk4_end(
            torch_cp, D_T, STEPS
        )(torch.as_tensor(y))
    elif kernel == "step":
        expected = jax_fused.build_fused_system_rk4_step(
            jax_cp, D_T, interpret=True
        )(y)
        actual = torch_fused.build_fused_system_rk4_step(torch_cp, D_T)(
            torch.as_tensor(y)
        )
    elif kernel == "packed_ends":
        expected = jax_packed.build_packed_system_rk4_ends(
            jax_cp, D_T, STEPS, 3, interpret=True
        )(y)
        actual = torch_packed.build_packed_system_rk4_ends(
            torch_cp, D_T, STEPS, 3
        )(torch.as_tensor(y))
    else:
        expected = jax_packed.build_packed_system_rk4_trajectory(
            jax_cp, D_T, STEPS, 3, interpret=True
        )(y)
        actual = torch_packed.build_packed_system_rk4_trajectory(
            torch_cp, D_T, STEPS, 3
        )(torch.as_tensor(y))
    _assert_close(actual, expected)


def test_plain_versions_agree_with_each_other():
    """The batched plain versions advance each state as it advances
    alone, and the step is the one-step trajectory and end."""
    _, cp = _problems("mixed")
    cfg = torch_fused._SystemKernelConfig(cp, D_T)
    ys = torch.as_tensor(_states(batch=2))
    trajectory = torch_packed.packed_system_rk4_trajectory(ys, cfg, 3)
    np.testing.assert_array_equal(
        trajectory[1].numpy(),
        torch_fused.fused_system_rk4_trajectory(ys[1], cfg, 3).numpy(),
    )
    np.testing.assert_array_equal(
        trajectory[:, -1].numpy(),
        torch_packed.packed_system_rk4_ends(ys, cfg, 3).numpy(),
    )
    np.testing.assert_array_equal(
        torch_fused.fused_system_rk4_step(ys, cfg).numpy(),
        torch_fused.fused_system_rk4_end(ys, cfg, 1).numpy(),
    )


def _other_families(module):
    """Problems of the JAX kernels' families and meshes beyond the port's
    first Cartesian K5 families: Navier-Stokes on a 9 x 9 Cartesian mesh
    and on a 9 x 9 polar mesh away from the origin, and the wave system on
    that polar mesh."""
    bc = module.DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 4)), is_static=True
    )
    navier_stokes = module.ConstrainedProblem(
        module.NavierStokesEquation(500.0),
        module.Mesh([(0.0, 2.0)] * 2, [0.25] * 2),
        [(bc, bc)] * 2,
    )
    polar_mesh = module.Mesh(
        [(1.0, 3.0), (0.0, 2.0)],
        [0.25] * 2,
        module.CoordinateSystem.POLAR,
    )
    polar_navier_stokes = module.ConstrainedProblem(
        module.NavierStokesEquation(500.0), polar_mesh, [(bc, bc)] * 2
    )
    bc = module.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    polar = module.ConstrainedProblem(
        module.WaveEquation(2, 0.5), polar_mesh, [(bc, bc)] * 2
    )
    return {
        "navier_stokes": navier_stokes,
        "polar_navier_stokes": polar_navier_stokes,
        "polar_wave": polar,
    }


@pytest.mark.parametrize("kind", ["bench", "mixed"])
def test_applicability_matches_jax_on_burgers(kind, x64_off):
    jax_cp, torch_cp = _problems(kind)
    assert jax_fused.fused_system_step_applicable(jax_cp, JaxRK4())
    assert torch_fused.fused_system_step_applicable(
        torch_cp, RK4(), torch.float32
    )
    for batch in (1, 2, 100):
        assert torch_packed.packed_system_applicable(
            torch_cp, RK4(), batch, torch.float32
        ) == jax_packed.packed_system_applicable(jax_cp, JaxRK4(), batch)
    # the kernels take float32 states and RK4 only
    assert not torch_fused.fused_system_step_applicable(
        torch_cp, RK4(), torch.float64
    )
    assert not torch_fused.fused_system_step_applicable(
        torch_cp, ForwardEulerMethod()
    )
    assert not torch_packed.packed_system_applicable(
        torch_cp, RK4(), 4, torch.float64
    )


def test_families_not_ported_yet_take_the_generic_path(x64_off):
    """The port's gates agree with the JAX package's on the families and
    meshes its first kernels left to the generic path: Cartesian
    Navier-Stokes and the polar wave take the fused kernels in both
    packages, polar Navier-Stokes the generic path in both (the Jacobi
    sweep inside the JAX kernel is the Cartesian one), and the batched K4
    takes none of them in either (the JAX package's packed kernels are
    Cartesian and have no Navier-Stokes family)."""
    jax_problems = _other_families(jax_pkg)
    torch_problems = _other_families(torch_pkg)
    for name, torch_cp in torch_problems.items():
        admitted = name != "polar_navier_stokes"
        assert (
            jax_fused.fused_system_step_applicable(
                jax_problems[name], JaxRK4()
            )
            == admitted
        )
        assert (
            torch_fused.fused_system_step_applicable(torch_cp, RK4())
            == admitted
        )
        assert not torch_packed.packed_system_applicable(
            torch_cp, RK4(), 4
        )
        assert not jax_packed.packed_system_applicable(
            jax_problems[name], JaxRK4(), 4
        )


def test_both_gates_admit_navier_stokes(x64_off):
    """The Navier-Stokes family's own gate admits the Cartesian problem in
    both packages, and only in float32 with RK4 in the port."""
    jax_cp = _other_families(jax_pkg)["navier_stokes"]
    torch_cp = _other_families(torch_pkg)["navier_stokes"]
    assert jax_fused.fused_navier_stokes_step_applicable(jax_cp, JaxRK4())
    assert torch_fused.fused_navier_stokes_step_applicable(
        torch_cp, RK4(), torch.float32
    )
    assert not torch_fused.fused_navier_stokes_step_applicable(
        torch_cp, RK4(), torch.float64
    )
    assert not torch_fused.fused_navier_stokes_step_applicable(
        torch_cp, ForwardEulerMethod()
    )
    assert not torch_fused.fused_burgers_step_applicable(torch_cp, RK4())


def test_applicability_requires_the_grid_to_fit_shared_memory():
    """Past one CTA's shared memory (an 81 x 81 Burgers grid), the
    trajectory takes the tiled kernel K8 and the end its end mode; K4,
    which needs the whole grid in one CTA, has none."""
    assert torch_fused.shared_memory_bytes(64, 64, 2) <= (
        torch_fused.MAX_SHARED_MEMORY_BYTES
    )
    assert torch_fused.shared_memory_bytes(75, 75, 2) > (
        torch_fused.MAX_SHARED_MEMORY_BYTES
    )
    cp = burgers_problem(vars(torch_pkg), extent=20.0).constrained_problem
    assert cp.mesh.vertices_shape == (81, 81)
    assert not torch_fused.fits_one_block(cp)
    assert torch_fused.fused_system_step_applicable(cp, RK4())
    assert not torch_packed.packed_system_applicable(cp, RK4(), 4)
    y = torch.as_tensor(
        np.random.default_rng(0).uniform(0.5, 1.5, (81, 81, 2)),
        dtype=torch.float32,
    )
    launches = torch_tiled.tiled_system_rk4_trajectory.launches
    trajectory = torch_fused.build_fused_system_rk4_trajectory(cp, D_T, 2)(y)
    cfg = torch_tiled._TiledSystemConfig(cp, D_T)
    np.testing.assert_array_equal(
        trajectory.numpy(),
        torch_tiled.tiled_system_rk4_trajectory_reference(y, cfg, 2).numpy(),
    )
    end_launches = torch_tiled.tiled_system_rk4_end.launches
    end = torch_fused.build_fused_system_rk4_end(cp, D_T, 2)(y)
    np.testing.assert_array_equal(end.numpy(), trajectory[-1].numpy())
    # the CPU runs the plain version: no launch
    assert torch_tiled.tiled_system_rk4_trajectory.launches == launches
    assert torch_tiled.tiled_system_rk4_end.launches == end_launches


# the JAX package's generic path in float64 against the new families'
# plain versions (K5 trajectory, K4 ends) over 5 steps on 9 x 11 grids
@pytest.mark.parametrize(
    "family, faces",
    [
        ("wave", "neumann"),
        ("shallow_water", "partial"),
        ("cahn_hilliard", "dirichlet"),
    ],
)
def test_new_families_match_the_generic_path_in_float64(family, faces):
    jax_cp, torch_cp = (
        system_problem(vars(module), family, faces, (9, 11))
        for module in (jax_pkg, torch_pkg)
    )
    n = torch_cp.differential_equation.y_dimension
    ys = states_2d((9, 11), n, batch=2).astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, 5 * D_T))
    expected = np.stack([np.asarray(generic(y, 0.0)) for y in ys])
    cfg = torch_fused._SystemKernelConfig(torch_cp, D_T)
    batch = torch.as_tensor(ys)
    trajectory = torch_fused.fused_system_rk4_trajectory_reference(
        batch, cfg, 5
    )
    ends = torch_packed.packed_system_rk4_ends_reference(batch, cfg, 5)
    scale = np.abs(expected).max()
    assert np.abs(trajectory.numpy() - expected).max() <= 1e-10 * scale
    assert np.abs(ends.numpy() - expected[:, -1]).max() <= 1e-10 * scale


def _cahn_hilliard_problems():
    return tuple(
        system_problem(vars(module), "cahn_hilliard", "dirichlet", (9, 11))
        for module in (jax_pkg, torch_pkg)
    )


@functools.lru_cache(maxsize=None)
def _jax_cahn_hilliard_k5():
    """The JAX package's K5 trajectory on the 9 x 11 Cahn-Hilliard problem
    in interpret mode over ``STEPS`` steps: one interpret-mode run, shared
    by the two tests below."""
    jax_cp, _ = _cahn_hilliard_problems()
    y = states_2d((9, 11), 2)
    jax.config.update("jax_enable_x64", False)
    try:
        return y, np.asarray(
            jax_fused.build_fused_system_rk4_trajectory(
                jax_cp, D_T, STEPS, interpret=True
            )(y)
        )
    finally:
        jax.config.update("jax_enable_x64", True)


def test_cahn_hilliard_plain_version_matches_pallas_kernel():
    """Cahn-Hilliard's own step, in float32, against the JAX package's K5
    in interpret mode."""
    _, torch_cp = _cahn_hilliard_problems()
    y, expected = _jax_cahn_hilliard_k5()
    actual = torch_fused.build_fused_system_rk4_trajectory(
        torch_cp, D_T, STEPS
    )(torch.as_tensor(y))
    _assert_close(actual, expected)


def test_cahn_hilliard_k8_end_matches_pallas_k5():
    """K8's end mode for Cahn-Hilliard (its plain version, the tiled
    helpers' Laplacian), batched, against the last frame of the JAX
    package's K5 in interpret mode, which the JAX package's end computes
    on such a grid, to 1e-5."""
    _, torch_cp = _cahn_hilliard_problems()
    y, expected = _jax_cahn_hilliard_k5()
    cfg = torch_tiled._TiledSystemConfig(torch_cp, D_T)
    actual = torch_tiled.tiled_system_rk4_end(
        torch.as_tensor(np.stack([y, y])), cfg, STEPS
    )
    _assert_close(actual[0], expected[-1])


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    _, cp = _problems("bench")
    cfg = torch_fused._SystemKernelConfig(cp, D_T)
    ys = torch.as_tensor(_states(batch=2))
    wrappers = (
        torch_fused.fused_system_rk4_trajectory,
        torch_fused.fused_system_rk4_end,
        torch_fused.fused_system_rk4_step,
        torch_packed.packed_system_rk4_ends,
        torch_packed.packed_system_rk4_trajectory,
    )
    launches = [w.launches for w in wrappers]
    np.testing.assert_array_equal(
        torch_packed.packed_system_rk4_ends(ys, cfg, 2).numpy(),
        torch_packed.packed_system_rk4_ends_reference(ys, cfg, 2).numpy(),
    )
    np.testing.assert_array_equal(
        torch_fused.fused_system_rk4_trajectory(ys[0], cfg, 2).numpy(),
        torch_fused.fused_system_rk4_trajectory_reference(
            ys[0], cfg, 2
        ).numpy(),
    )
    # no kernel ran, so no launch was counted
    assert [w.launches for w in wrappers] == launches


def test_wrappers_reject_what_the_kernel_does_not_take():
    _, cp = _problems("bench")
    cfg = torch_fused._SystemKernelConfig(cp, D_T)
    y = torch.zeros((9, 9, 2), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        torch_fused.fused_system_rk4_end(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="shape"):
        torch_fused.fused_system_rk4_end(y[:-1], cfg, 2)
    with pytest.raises(ValueError, match="shape"):
        # K4 takes a batch only
        torch_packed.packed_system_rk4_ends(y, cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        torch_fused.fused_system_rk4_end(
            torch.zeros((9, 9, 4), dtype=torch.float32)[..., ::2], cfg, 2
        )


def test_fdm_operator_dispatches_burgers_to_k5():
    """float32 Burgers trajectories, end states and steps go through the
    K5 wrappers (their plain versions here) and agree with the generic
    path to float32 rounding (1e-5 of max|y| after 12 steps); float64
    stays generic."""
    ivp = burgers_problem(vars(torch_pkg), "mixed", extent=2.0)
    cp = ivp.constrained_problem
    y = torch.as_tensor(_states())

    def operator(fused, dtype=torch.float32):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            D_T,
            fused_kernels=fused,
            device="cpu",
            dtype=dtype,
        )

    interval = (0.0, STEPS * D_T)
    fused_fn, _ = operator(True).trajectory_function(cp, interval)
    generic_fn, _ = operator(False).trajectory_function(cp, interval)
    assert fused_fn.fused and not generic_fn.fused
    fused, generic = fused_fn(y, 0.0), generic_fn(y, 0.0)
    scale = float(generic.abs().max())
    assert float((fused - generic).abs().max()) <= TOL * scale
    # a leading batch axis is one launch over the batch
    batched = fused_fn(torch.stack([y, y]), 0.0)
    np.testing.assert_array_equal(batched[1].numpy(), fused.numpy())

    ends = operator(True).ends_function(cp, interval, batch=2)
    assert ends.fused and ends.batched
    np.testing.assert_array_equal(
        ends(torch.stack([y, y]), 0.0)[0].numpy(), fused[-1].numpy()
    )
    step = operator(True)._build_step_function(cp)
    np.testing.assert_array_equal(step(y, 0, 0.0).numpy(), fused[0].numpy())
    assert not operator(True, torch.float64).trajectory_function(
        cp, interval
    )[0].fused
