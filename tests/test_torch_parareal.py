"""The PyTorch port's slices as a whole, held against the JAX package.

- Parareal on a shrunken flagship diffusion_2d problem (11 x 11 grid,
  T = 1, 4 slices) in float64 to rtol 1e-8, both through the affine
  propagators (the default) and through the stencil sub-solves
  (``linear_propagator=False``); the float32 route through the fused end
  kernel's plain version held against the affine route.
- Parareal with a quadratic supervised-ML coarse operator on a shrunken
  2D Burgers problem (9 x 9 grid, T = 0.8, 4 slices, fine d_t 2.5e-3, a
  rank-6 model fitted in the test): in float64 against the JAX package's
  generic path to 1e-10 with the same iteration count, and in float32
  through the batched kernels' plain versions against the JAX package's
  float32 run.
- A fine operator's ``kernel_traj_dtype=bfloat16`` rounding the frames
  of the batched final expansion (K4) in both packages (8 slices on the
  9 x 9 Burgers problem; the JAX package's packed kernels in interpret
  mode).
- The fine operator choosing K4 for Parareal's fine ends and final
  expansion on the 9 x 9 Burgers and 9 x 11 Cahn-Hilliard problems: a
  fine operator that forwards only the public operator contract gets the
  same K4 launches and arrays as the bare FDM operator.
- The default device (the CUDA card), and the port solving both slices
  in a process where JAX, flax, scikit-learn and msgpack cannot be
  imported."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu.operators.fdm import FDMOperator as JaxFDMOperator
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from pararealml_tpu.operators.fdm import (
    ThreePointCentralDifferenceMethod as JaxThreePoint,
)
from pararealml_tpu.operators.parareal import (
    PararealOperator as JaxPararealOperator,
)
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu.operators.ml import supervised as jax_supervised
from pararealml_tpu_torch.operators.ml import supervised
from pararealml_tpu_torch.operator import TorchOperator
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion, fused_system
from pararealml_tpu_torch.ops import fused_system_3d, packed_system
from tests.test_torch_cuda import burgers_problem, problem_3d
from tests.test_torch_supervised_ml import fitted_quad_arrays

torch.set_num_threads(1)

T_END = 1.0
FINE_D_T = 1e-2
# one coarse step per slice: coarse enough that Parareal iterates
COARSE_D_T = 0.25
N_SLICES = 4
TOLERANCE = 2.5e-3


def _ivp(module):
    return build_problem(module, T_END, d_x=1.0)


def _torch_parareal(linear_propagator, dtype, tolerance=TOLERANCE):
    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            linear_propagator=linear_propagator,
            device="cpu",
            dtype=dtype,
        )

    return PararealOperator(
        fdm(FINE_D_T),
        fdm(COARSE_D_T),
        tolerance,
        num_time_slices=N_SLICES,
    )


@pytest.mark.parametrize("linear_propagator", [True, False])
def test_parareal_matches_jax(linear_propagator):
    def jax_fdm(d_t):
        return JaxFDMOperator(
            JaxRK4(),
            JaxThreePoint(),
            d_t,
            linear_propagator=linear_propagator,
        )

    expected = (
        JaxPararealOperator(
            jax_fdm(FINE_D_T),
            jax_fdm(COARSE_D_T),
            TOLERANCE,
            num_time_slices=N_SLICES,
        )
        .solve(_ivp(vars(jax_pkg)))
        .discrete_y()
    )
    parareal = _torch_parareal(linear_propagator, torch.float64)
    actual = parareal.solve(_ivp(vars(torch_pkg))).discrete_y()

    assert actual.shape == expected.shape == (100, 11, 11, 1)
    # the shrunken problem still takes more than one correction
    assert parareal.last_iterations > 1
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(actual, expected, rtol=1e-8, atol=1e-8 * scale)


def test_float32_fused_route_matches_affine_route(monkeypatch):
    """float32 states take the fused kernels where the propagator is off
    (their plain versions on the CPU): the batched end kernel for the fine
    ends, the single-state one for the coarse sweep and the trajectory
    kernel for the coarse start and the final expansion. The result
    agrees with the affine route to float32 accuracy."""
    ivp = _ivp(vars(torch_pkg))
    affine = _torch_parareal(True, torch.float32).solve(ivp).discrete_y()

    calls = []
    for name in ("fused_diffusion_rk4_end", "fused_diffusion_rk4_trajectory"):
        wrapper = getattr(fused_diffusion, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append(_name)
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(fused_diffusion, name, counting)
    fused = _torch_parareal(False, torch.float32).solve(ivp).discrete_y()

    assert set(calls) == {
        "fused_diffusion_rk4_end",
        "fused_diffusion_rk4_trajectory",
    }
    scale = float(np.abs(affine).max())
    # float32 rounding over 100 fine steps on two different routes
    assert float(np.abs(fused - affine).max()) <= 1e-5 * scale


# the Burgers slice: 4 coarse slices of 0.2 (80 fine steps each); the
# tolerance stops the rank-6 model's Parareal after 2 of 4 iterations
BURGERS_T_END = 0.8
BURGERS_SLICES = 4
BURGERS_FINE_D_T = 2.5e-3
BURGERS_TOLERANCE = 3e-3


def _burgers_parareal(module, fine, coarse, tolerance=BURGERS_TOLERANCE):
    ivp = burgers_problem(vars(module), extent=2.0, t_end=BURGERS_T_END)
    parareal_class = (
        PararealOperator if module is torch_pkg else JaxPararealOperator
    )
    parareal = parareal_class(
        fine, coarse, tolerance, num_time_slices=BURGERS_SLICES
    )
    return parareal, parareal.solve(ivp).discrete_y()


def _jax_quad_coarse(dtype):
    model = jax_supervised.ReducedQuadraticStateOperatorRegressor(
        162, rank=6, dtype=dtype
    )
    for name, value in fitted_quad_arrays().items():
        setattr(model, f"_{name}", jnp.asarray(value, dtype))
    model._expand_quad_weights()
    model._factor_operators()
    coarse = jax_supervised.SupervisedMLOperator(
        BURGERS_T_END / BURGERS_SLICES, True
    )
    coarse.model = model
    return coarse


def _torch_quad_coarse(dtype):
    coarse = supervised.SupervisedMLOperator(
        BURGERS_T_END / BURGERS_SLICES, True, device="cpu", dtype=dtype
    )
    coarse.model = supervised.from_arrays(fitted_quad_arrays(), dtype=dtype)
    return coarse


def _torch_fine(dtype):
    return FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        BURGERS_FINE_D_T,
        device="cpu",
        dtype=dtype,
    )


def test_burgers_ml_parareal_matches_jax():
    """float64: the generic fine path in both packages, the same coarse
    model. Agreement to 1e-10 also pins the iteration count: one more or
    one fewer correction moves the borders by about the tolerance."""
    _, expected = _burgers_parareal(
        jax_pkg,
        JaxFDMOperator(JaxRK4(), JaxThreePoint(), BURGERS_FINE_D_T),
        _jax_quad_coarse(jnp.float64),
    )
    parareal, actual = _burgers_parareal(
        torch_pkg,
        _torch_fine(torch.float64),
        _torch_quad_coarse(torch.float64),
    )
    assert actual.shape == expected.shape == (320, 9, 9, 2)
    # early termination: the corrections stopped before the slice count
    assert parareal.last_iterations == 2
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(
        actual, expected, rtol=1e-10, atol=1e-10 * scale
    )


def test_burgers_ml_parareal_float32_route_matches_jax(monkeypatch):
    """float32: the port's fine ends and final expansion go through the
    batched kernels (K4, their plain versions here); the JAX package's
    run is its generic float32 path. The tolerance, 1e-4 of max|y|,
    covers float32 rounding of the two fine formulations over 320 steps,
    carried through the nonlinear coarse corrections."""
    calls = []
    for name in ("packed_system_rk4_ends", "packed_system_rk4_trajectory"):
        wrapper = getattr(packed_system, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append(_name)
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(packed_system, name, counting)
    parareal, actual = _burgers_parareal(
        torch_pkg,
        _torch_fine(torch.float32),
        _torch_quad_coarse(torch.float32),
    )
    assert calls.count("packed_system_rk4_trajectory") == 1
    assert calls.count("packed_system_rk4_ends") == parareal.last_iterations

    jax.config.update("jax_enable_x64", False)
    try:
        _, expected = _burgers_parareal(
            jax_pkg,
            JaxFDMOperator(
                JaxRK4(),
                JaxThreePoint(),
                BURGERS_FINE_D_T,
                fused_kernels=False,
            ),
            _jax_quad_coarse(jnp.float32),
        )
    finally:
        jax.config.update("jax_enable_x64", True)
    scale = float(np.abs(expected).max())
    assert float(np.abs(actual - expected).max()) <= 1e-4 * scale


def test_kernel_traj_dtype_rounds_the_k4_frames_under_parareal(monkeypatch):
    """A fine operator's ``kernel_traj_dtype=bfloat16`` reaches the batched
    trajectory (K4) of Parareal's final expansion in both packages: each
    frame is rounded to bfloat16 over the float32 state the steps carry,
    then shifted onto its slice's corrected end border. 8 slices of 4 fine
    steps on the 9 x 9 Burgers problem, float32, the coarse operators on
    the generic path; the JAX package runs its packed kernels in interpret
    mode on one of the suite's eight devices (the port runs on one). The
    two agree to bfloat16 rounding (2^-8 of the largest value: a frame
    can round to either neighbour where the float32 states differ in
    their last bit), and the port's frames moved from its unrounded run.
    Before, the port dropped the knob and returned the unrounded frames,
    3e-3 of max|y| away."""
    import jax.numpy as jnp

    traj_dtypes = []
    wrapper = packed_system.packed_system_rk4_trajectory

    def spy(y, cfg, n_steps, traj_dtype=None):
        traj_dtypes.append(traj_dtype)
        return wrapper(y, cfg, n_steps, traj_dtype)

    monkeypatch.setattr(packed_system, "packed_system_rk4_trajectory", spy)
    ivp = burgers_problem(vars(torch_pkg), extent=2.0, t_end=0.08)

    def torch_solve(traj_dtype):
        def fdm(d_t, **kwargs):
            return FDMOperator(
                RK4(),
                ThreePointCentralDifferenceMethod(),
                d_t,
                device="cpu",
                dtype=torch.float32,
                **kwargs,
            )

        return (
            PararealOperator(
                fdm(2.5e-3, kernel_traj_dtype=traj_dtype),
                fdm(1e-2, fused_kernels=False),
                1e-4,
                num_time_slices=8,
            )
            .solve(ivp)
            .discrete_y()
        )

    def jax_solve(traj_dtype):
        def fdm(d_t, **kwargs):
            return JaxFDMOperator(JaxRK4(), JaxThreePoint(), d_t, **kwargs)

        return (
            JaxPararealOperator(
                fdm(2.5e-3, kernel_traj_dtype=traj_dtype),
                fdm(1e-2, fused_kernels=False),
                1e-4,
                num_time_slices=8,
                # one device, as the port: its 8 slices batch through the
                # packed kernels
                devices=jax.devices()[:1],
            )
            .solve(burgers_problem(vars(jax_pkg), extent=2.0, t_end=0.08))
            .discrete_y()
        )

    rounded, exact = torch_solve(torch.bfloat16), torch_solve(None)
    assert traj_dtypes == [torch.bfloat16, torch.float32]
    jax.config.update("jax_enable_x64", False)
    try:
        expected = jax_solve(jnp.bfloat16)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert rounded.shape == expected.shape == (32, 9, 9, 2)
    scale = float(np.abs(expected).max())
    difference = float(np.abs(rounded - expected).max())
    assert difference <= 2.0**-8 * scale
    # here no frame's float32 value straddles a bfloat16 rounding
    # boundary, so the two round alike and agree to float32 rounding,
    # while the rounding itself moved the frames by 3e-3 of max|y|
    assert difference <= 1e-5 * scale
    moved = float(np.abs(rounded - exact).max())
    assert 1e-3 * scale < moved <= 2.0**-8 * scale


# the 3D slice: Burgers (Re = 50) on a 7^3 grid, 4 slices of 0.2 over
# T = 0.8, fine d_t 0.01 (20 steps a slice), coarse d_t 0.1; the
# tolerance stops Parareal after 2 of 4 iterations
BURGERS_3D_T_END = 0.8
BURGERS_3D_TOLERANCE = 1e-4


def _burgers_3d_ivp(module):
    cp = problem_3d(vars(module), "burgers", shape=(7, 7, 7), d_x=0.25)
    ic = module.GaussianInitialCondition(
        cp, [(np.full(3, 0.75), 0.1 * np.eye(3))] * 3, [1.0, 0.5, 0.25]
    )
    return module.InitialValueProblem(cp, (0.0, BURGERS_3D_T_END), ic)


def test_burgers_3d_parareal_reaches_k9_and_matches_jax(monkeypatch):
    """float32: the port's fine ends (one cluster per slice), coarse
    sweeps (one state) and final expansion (the trajectory over the
    slices) go through the K9 wrappers, their plain versions here. The
    JAX package's run is its generic float64 path under the suite's x64
    flag; the tolerance, 1e-5 of max|y|, covers float32 rounding over 80
    fine steps."""
    calls = []
    for name in ("fused_system_3d_rk4_end", "fused_system_3d_rk4_trajectory"):
        wrapper = getattr(fused_system_3d, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            # the builders hand the wrappers a (B, D, H, W, n) batch
            calls.append((_name, y.shape[0]))
            return _wrapper(y, *args, **kwargs)

        monkeypatch.setattr(fused_system_3d, name, counting)

    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            device="cpu",
            dtype=torch.float32,
        )

    parareal = PararealOperator(
        fdm(0.01), fdm(0.1), BURGERS_3D_TOLERANCE, num_time_slices=4
    )
    actual = parareal.solve(_burgers_3d_ivp(torch_pkg)).discrete_y()
    assert parareal.last_iterations == 2
    # each iteration's fine ends for the 4 slices at once, the coarse
    # sweeps one slice at a time, the final expansion over the 4 slices
    assert calls.count(("fused_system_3d_rk4_end", 4)) == 2
    assert ("fused_system_3d_rk4_end", 1) in calls
    assert calls.count(("fused_system_3d_rk4_trajectory", 4)) == 1

    def jax_fdm(d_t):
        return JaxFDMOperator(JaxRK4(), JaxThreePoint(), d_t)

    expected = (
        JaxPararealOperator(
            jax_fdm(0.01),
            jax_fdm(0.1),
            BURGERS_3D_TOLERANCE,
            num_time_slices=4,
        )
        .solve(_burgers_3d_ivp(jax_pkg))
        .discrete_y()
    )
    assert actual.shape == expected.shape == (80, 7, 7, 7, 3)
    scale = float(np.abs(expected).max())
    assert float(np.abs(actual - expected).max()) <= 1e-5 * scale


# Cahn-Hilliard (the 2D example's gamma 0.01 and d_x 0.1, zero-flux
# faces) on a 9 x 11 grid over T = 0.02: 4 slices of 50 fine steps (d_t
# 1e-4) and 10 coarse steps (d_t 5e-4, the example's own). The coarse
# slice ends miss the fine ones by about 1.3e-2, and the tolerance stops
# Parareal after 3 of 4 iterations.
CAHN_HILLIARD_T_END = 0.02
CAHN_HILLIARD_TOLERANCE = 1e-4


def _cahn_hilliard_ivp(module):
    """The example's problem shrunk to 9 x 11, y0 a uniform perturbation
    of amplitude 0.05 from numpy seed 0 and y1 its chemical potential
    (computed once, with the port's differentiator, for both packages)."""
    from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
        slice_all_constraint_pairs,
    )

    gamma = 0.01

    def problem(pkg):
        bc = pkg.NeumannBoundaryCondition(
            lambda x, t: np.zeros((len(x), 2)), is_static=True
        )
        return pkg.ConstrainedProblem(
            pkg.CahnHilliardEquation(2, gamma=gamma),
            pkg.Mesh([(0.0, 0.8), (0.0, 1.0)], [0.1, 0.1]),
            [(bc, bc)] * 2,
        )

    cp = problem(torch_pkg)
    y_0_0 = 0.05 * np.random.default_rng(0).uniform(-1.0, 1.0, (9, 11, 1))
    laplacian = ThreePointCentralDifferenceMethod().laplacian(
        torch.as_tensor(y_0_0),
        cp.mesh,
        slice_all_constraint_pairs(
            cp.static_boundary_vertex_constraints.d_y, slice(0, 1)
        ),
    ).numpy()
    y_0 = np.concatenate(
        [y_0_0, y_0_0**3 - y_0_0 - gamma * laplacian], axis=-1
    )
    if module is not torch_pkg:
        cp = problem(module)
    ic = module.DiscreteInitialCondition(cp, y_0, True)
    return module.InitialValueProblem(cp, (0.0, CAHN_HILLIARD_T_END), ic)


def test_cahn_hilliard_parareal_reaches_k4_k5_and_matches_jax(monkeypatch):
    """float32: the port's fine ends and final expansion go through the
    batched kernels (K4), its initial coarse sweep through the K5
    trajectory and its coarse sweeps through the single-state K5 end,
    their plain versions here. The JAX package's run is its generic
    float64 path under the suite's x64 flag; the tolerance, 1e-5 of
    max|y|, covers float32 rounding over 200 fine steps."""
    calls = []
    for module, name in (
        (packed_system, "packed_system_rk4_ends"),
        (packed_system, "packed_system_rk4_trajectory"),
        (fused_system, "fused_system_rk4_end"),
        (fused_system, "fused_system_rk4_trajectory"),
    ):
        wrapper = getattr(module, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            # the builders hand the wrappers a (B, H, W, n) batch
            calls.append((_name, y.shape[0]))
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

    parareal = PararealOperator(
        fdm(1e-4), fdm(5e-4), CAHN_HILLIARD_TOLERANCE, num_time_slices=4
    )
    actual = parareal.solve(_cahn_hilliard_ivp(torch_pkg)).discrete_y()
    iterations = parareal.last_iterations
    assert iterations == 3
    assert calls.count(("packed_system_rk4_ends", 4)) == iterations
    assert calls.count(("packed_system_rk4_trajectory", 4)) == 1
    # one whole-domain coarse roll-out, then single-state coarse ends
    assert calls.count(("fused_system_rk4_trajectory", 1)) == 1
    assert ("fused_system_rk4_end", 1) in calls

    def jax_fdm(d_t):
        return JaxFDMOperator(JaxRK4(), JaxThreePoint(), d_t)

    expected = (
        JaxPararealOperator(
            jax_fdm(1e-4),
            jax_fdm(5e-4),
            CAHN_HILLIARD_TOLERANCE,
            num_time_slices=4,
        )
        .solve(_cahn_hilliard_ivp(jax_pkg))
        .discrete_y()
    )
    assert actual.shape == expected.shape == (200, 9, 11, 2)
    scale = float(np.abs(expected).max())
    assert float(np.abs(actual - expected).max()) <= 1e-5 * scale


class _Delegating(TorchOperator):
    """A fine operator that forwards only the public :class:`TorchOperator`
    contract to the operator it wraps: the Parareal schedule sees none
    of the wrapped operator's fields."""

    def __init__(self, inner):
        super().__init__(
            inner.d_t,
            inner.vertex_oriented,
            device=inner.device,
            dtype=inner.dtype,
        )
        self._inner = inner

    def trajectory_function(self, *args, **kwargs):
        return self._inner.trajectory_function(*args, **kwargs)

    def ends_function(self, *args, **kwargs):
        return self._inner.ends_function(*args, **kwargs)

    def solve(self, ivp, parallel_enabled=True):
        return self._inner.solve(ivp, parallel_enabled)


def _float32_fdm(d_t):
    return FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        d_t,
        device="cpu",
        dtype=torch.float32,
    )


# (initial value problem, fine d_t, coarse d_t, tolerance): the 9 x 9
# Burgers problem over 4 slices of 8 fine steps, all 4 iterations, and
# the 9 x 11 Cahn-Hilliard problem of the K4/K5 test above
K4_PARAREAL_CASES = {
    "burgers": (
        lambda: burgers_problem(vars(torch_pkg), extent=2.0, t_end=0.08),
        BURGERS_FINE_D_T,
        1e-2,
        None,
    ),
    "cahn_hilliard": (
        lambda: _cahn_hilliard_ivp(torch_pkg),
        1e-4,
        5e-4,
        CAHN_HILLIARD_TOLERANCE,
    ),
}


@pytest.mark.parametrize("problem", sorted(K4_PARAREAL_CASES))
def test_k4_reaches_a_fine_operator_behind_the_contract(problem, monkeypatch):
    """The fine operator chooses the batched kernels over the slices (K4)
    for the fine ends and the final expansion: a fine operator that only
    forwards the public contract to an FDMOperator gets the same K4
    launches and the same arrays as the bare FDMOperator (float32, K4's
    plain version)."""
    calls = []
    for name in ("packed_system_rk4_ends", "packed_system_rk4_trajectory"):
        wrapper = getattr(packed_system, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append(_name)
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(packed_system, name, counting)
    build_ivp, fine_d_t, coarse_d_t, tolerance = K4_PARAREAL_CASES[problem]
    ivp = build_ivp()
    results = []
    for wrap in (lambda f: f, _Delegating):
        calls.clear()
        parareal = PararealOperator(
            wrap(_float32_fdm(fine_d_t)),
            _float32_fdm(coarse_d_t),
            tolerance,
            num_time_slices=4,
        )
        results.append(parareal.solve(ivp).discrete_y())
        assert calls.count("packed_system_rk4_ends") == (
            parareal.last_iterations
        )
        assert calls.count("packed_system_rk4_trajectory") == 1
    np.testing.assert_array_equal(results[1], results[0])


def test_operators_default_to_the_cuda_card():
    """With no device argument the entry points run on the card; on a
    host without one, a solve fails rather than running on the CPU."""
    fine = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    coarse = supervised.SupervisedMLOperator(0.05, True)
    parareal = PararealOperator(fine, coarse, 1e-3, num_time_slices=2)
    for operator in (fine, coarse, parareal):
        assert operator.device == torch.device("cuda")
    # a device given to the fine operator carries over to Parareal
    cpu_fine = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.01, device="cpu"
    )
    assert PararealOperator(cpu_fine, coarse).device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fine.solve(build_problem(vars(torch_pkg), 0.02, d_x=1.0))


def test_port_runs_without_jax():
    """The port imports no JAX, flax, scikit-learn, msgpack or the JAX
    package: with those imports made to fail, the package imports, solves
    a 5-step diffusion problem, saves and loads a model, runs the
    Burgers slice's ML-coarse Parareal (9 x 9, two slices of 0.1) and
    solves a 2-step Navier-Stokes problem (17 x 17) through the fused and
    the generic path."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = textwrap.dedent(
        """
        import os, sys, tempfile
        BLOCKED = ("jax", "flax", "sklearn", "msgpack", "pararealml_tpu")
        for name in BLOCKED:
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import pararealml_tpu_torch as p
        from pararealml_tpu_torch.operators.fdm import (
            RK4, FDMOperator, ThreePointCentralDifferenceMethod,
        )
        from pararealml_tpu_torch.operators.ml.supervised import (
            ReducedQuadraticStateOperatorRegressor, SupervisedMLOperator,
            from_arrays,
        )
        from pararealml_tpu_torch.operators.parareal import PararealOperator
        from pararealml_tpu_torch.utils import SEEDS, set_random_seed
        from bench import build_problem
        from tests.test_torch_cuda import burgers_problem
        ivp = build_problem(vars(p), 0.05, d_x=1.0)
        solution = FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 0.01, device="cpu"
        ).solve(ivp)
        ys = solution.discrete_y()
        assert ys.shape == (5, 11, 11, 1), ys.shape
        assert np.isfinite(ys).all()

        set_random_seed(SEEDS[0])
        rank = 4
        model = from_arrays({
            "weights": np.eye(162), "quad_weights": np.zeros((162, 10)),
            "intercept": np.zeros(162), "basis": np.eye(162)[:, :rank],
            "mean": np.zeros(162), "z_low": -np.ones(rank),
            "z_high": np.ones(rank),
        })
        path = os.path.join(tempfile.mkdtemp(), "model.msgpack")
        model.save(path)
        loaded = ReducedQuadraticStateOperatorRegressor(162, rank=rank)
        loaded.load(path)
        coarse = SupervisedMLOperator(0.1, True, device="cpu")
        coarse.model = loaded
        fine = FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 2.5e-3, device="cpu"
        )
        ivp = burgers_problem(vars(p), extent=2.0, t_end=0.2)
        ys = PararealOperator(
            fine, coarse, 1e-3, num_time_slices=2
        ).solve(ivp).discrete_y()
        assert ys.shape == (80, 9, 9, 2), ys.shape
        assert np.isfinite(ys).all()

        # Navier-Stokes: the fused float32 solve (its kernel's plain
        # version on the CPU) and the generic float64 one, whose
        # stream function takes the anti-Laplacian
        from tests.test_torch_cuda import navier_stokes_problem
        cp = navier_stokes_problem(vars(p))
        ic = p.ContinuousInitialCondition(cp, lambda x: np.zeros((len(x), 4)))
        ivp = p.InitialValueProblem(cp, (0.0, 0.1), ic)
        for dtype in (torch.float32, torch.float64):
            ys = FDMOperator(
                RK4(), ThreePointCentralDifferenceMethod(), 0.05,
                device="cpu", dtype=dtype,
            ).solve(ivp).discrete_y()
            assert ys.shape == (2, 17, 17, 4), ys.shape
            assert np.isfinite(ys).all()
        assert not any(
            name.split(".")[0] in BLOCKED
            for name in sys.modules if sys.modules[name] is not None
        )
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=repo)
    result = subprocess.run(
        [sys.executable, "-c", script],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"
