"""The PyTorch port's FDM operator and affine propagators held against
the JAX package in float64: generic trajectories to rtol 1e-10 (the two
lambdified right-hand sides may order their sums differently), the
probed affine step map, the propagator's trajectory, end function and
composed slice map, and the static constraint tensors that cross between
the packages as arrays."""

import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu.operators.fdm as jax_fdm
import pararealml_tpu_torch as torch_pkg
import pararealml_tpu_torch.operators.fdm as torch_fdm
from bench import build_problem
from pararealml_tpu.ops import fused_diffusion as jax_fused
from pararealml_tpu.ops import linear_propagator as jax_propagator
from pararealml_tpu_torch.ops import fused_diffusion as torch_fused
from pararealml_tpu_torch.ops import linear_propagator as torch_propagator
from tests.parity_cases import equation_cases, solve_fdm_trajectory
from tests.test_torch_cuda import PROBLEMS

torch.set_num_threads(1)

RTOL = 1e-10


@pytest.fixture
def torch_float64():
    """float64 as torch's default dtype (the counterpart of the suite's
    jax_enable_x64), restored afterwards."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def _assert_close(actual, expected, rtol=RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


CASES = sorted(set(equation_cases()) - {"navier_stokes"})


@pytest.mark.parametrize("name", CASES)
def test_generic_trajectory_matches_jax(name, torch_float64):
    """tests/parity_cases.py runs unchanged on both packages."""
    case = equation_cases()[name]
    expected = solve_fdm_trajectory(vars(jax_pkg), vars(jax_fdm), case)
    actual = solve_fdm_trajectory(vars(torch_pkg), vars(torch_fdm), case)
    _assert_close(actual, expected)


def test_navier_stokes_needs_the_anti_laplacian(torch_float64):
    case = equation_cases()["navier_stokes"]
    with pytest.raises(NotImplementedError, match="slice 6"):
        solve_fdm_trajectory(vars(torch_pkg), vars(torch_fdm), case)


@pytest.mark.parametrize("problem", ["flagship", "convection"])
def test_generic_trajectory_matches_jax_on_main_path_problems(problem):
    jax_ivp = PROBLEMS[problem](vars(jax_pkg))
    torch_ivp = PROBLEMS[problem](vars(torch_pkg))
    d_t, steps = 1e-3, 50
    jax_fn, _ = jax_fdm.FDMOperator(
        jax_fdm.RK4(),
        jax_fdm.ThreePointCentralDifferenceMethod(),
        d_t,
        fused_kernels=False,
    ).trajectory_function(jax_ivp.constrained_problem, (0.0, steps * d_t))
    torch_fn, _ = torch_fdm.FDMOperator(
        torch_fdm.RK4(),
        torch_fdm.ThreePointCentralDifferenceMethod(),
        d_t,
        fused_kernels=False,
        dtype=torch.float64,
    ).trajectory_function(torch_ivp.constrained_problem, (0.0, steps * d_t))
    y_0 = jax_ivp.initial_condition.discrete_y_0(True)
    expected = np.asarray(jax_fn(y_0, 0.0))
    actual = torch_fn(torch.as_tensor(y_0), 0.0).numpy()
    _assert_close(actual, expected)

    # leading batch axes map elementwise
    batch = torch.stack([torch.as_tensor(y_0), 0.5 * torch.as_tensor(y_0)])
    batched = torch_fn(batch, 0.0).numpy()
    assert batched.shape == (2,) + expected.shape
    _assert_close(batched[0], actual, rtol=1e-14)


def _vector_field_problem(module):
    """A two-component field on a 9 x 9 grid with Dirichlet faces on axis
    0 and a constant, component-dependent flux on axis 1."""
    bcs = [
        (
            module["DirichletBoundaryCondition"](
                lambda x, t: np.full((len(x), 2), 1.0), is_static=True
            ),
        )
        * 2,
        (
            module["NeumannBoundaryCondition"](
                lambda x, t: np.tile([0.3, -0.2], (len(x), 1)),
                is_static=True,
            ),
        )
        * 2,
    ]
    return module["ConstrainedProblem"](
        module["BurgersEquation"](2),
        module["Mesh"]([(0.0, 1.0), (0.0, 1.0)], [0.125, 0.125]),
        bcs,
    )


OPERATORS = {
    "gradient_0": lambda d, y, mesh, bcs: d.gradient(y, mesh, 0, bcs),
    "gradient_1": lambda d, y, mesh, bcs: d.gradient(y, mesh, 1, bcs),
    "hessian_00": lambda d, y, mesh, bcs: d.hessian(y, mesh, 0, 0, bcs),
    "hessian_01": lambda d, y, mesh, bcs: d.hessian(y, mesh, 0, 1, bcs),
    "hessian_11": lambda d, y, mesh, bcs: d.hessian(y, mesh, 1, 1, bcs),
    "divergence": lambda d, y, mesh, bcs: d.divergence(y, mesh, bcs),
    "curl": lambda d, y, mesh, bcs: d.curl(y, mesh, 0, bcs),
    "laplacian": lambda d, y, mesh, bcs: d.laplacian(y, mesh, bcs),
    "vector_laplacian_1": lambda d, y, mesh, bcs: d.vector_laplacian(
        y, mesh, 1, bcs
    ),
}


@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_cartesian_differential_operators_match_jax(operator):
    jax_cp = _vector_field_problem(vars(jax_pkg))
    torch_cp = _vector_field_problem(vars(torch_pkg))
    y = np.random.default_rng(1).standard_normal((9, 9, 2))
    expected = OPERATORS[operator](
        jax_fdm.ThreePointCentralDifferenceMethod(),
        y,
        jax_cp.mesh,
        jax_cp.static_boundary_vertex_constraints.d_y,
    )
    torch_y = torch.as_tensor(y)
    differentiator = torch_fdm.ThreePointCentralDifferenceMethod()
    bcs = torch_cp.static_boundary_vertex_constraints.d_y
    actual = OPERATORS[operator](differentiator, torch_y, torch_cp.mesh, bcs)
    _assert_close(actual.numpy(), np.asarray(expected), rtol=1e-12)
    # a leading batch axis maps elementwise
    batched = OPERATORS[operator](
        differentiator, torch.stack([torch_y, torch_y]), torch_cp.mesh, bcs
    )
    np.testing.assert_array_equal(batched[1].numpy(), actual.numpy())


def _small_flagship(module):
    return build_problem(module, 1.0, d_x=1.0)


def test_probe_affine_step_matches_jax(torch_float64):
    jax_cp = _small_flagship(vars(jax_pkg)).constrained_problem
    torch_cp = _small_flagship(vars(torch_pkg)).constrained_problem
    y_shape = tuple(jax_cp.y_shape(True))
    jax_step = jax_fdm.FDMOperator(
        jax_fdm.RK4(), jax_fdm.ThreePointCentralDifferenceMethod(), 1e-2
    )._build_step_function(
        jax_cp, 0.0, 1, static_only=True, allow_fused=False
    )
    torch_step = torch_fdm.FDMOperator(
        torch_fdm.RK4(), torch_fdm.ThreePointCentralDifferenceMethod(), 1e-2
    )._build_step_function(torch_cp, allow_fused=False)
    jax_s, jax_q = jax_propagator.probe_affine_step(jax_step, y_shape)
    torch_s, torch_q = torch_propagator.probe_affine_step(
        torch_step, y_shape, torch.float64
    )
    _assert_close(torch_s.numpy(), np.asarray(jax_s))
    _assert_close(torch_q.numpy(), np.asarray(jax_q))


@pytest.mark.parametrize(
    "steps",
    [
        1,  # one matmul per step
        50,  # one chunk of interior powers
        400,  # 8 chunks of 50: the sequential chunk loop
        1024,  # 16 chunks: chunk starts from the doubling scan
    ],
)
def test_propagator_matches_jax(steps, torch_float64):
    jax_ivp = _small_flagship(vars(jax_pkg))
    torch_ivp = _small_flagship(vars(torch_pkg))
    d_t = 1e-2
    jax_fn, _ = jax_fdm.FDMOperator(
        jax_fdm.RK4(), jax_fdm.ThreePointCentralDifferenceMethod(), d_t
    ).trajectory_function(
        jax_ivp.constrained_problem, (0.0, steps * d_t), time_parallel=True
    )
    torch_fn, _ = torch_fdm.FDMOperator(
        torch_fdm.RK4(), torch_fdm.ThreePointCentralDifferenceMethod(), d_t
    ).trajectory_function(
        torch_ivp.constrained_problem,
        (0.0, steps * d_t),
        time_parallel=True,
    )
    assert torch_fn.vmappable
    y_0 = jax_ivp.initial_condition.discrete_y_0(True)
    torch_y_0 = torch.as_tensor(y_0)

    _assert_close(torch_fn(torch_y_0).numpy(), np.asarray(jax_fn(y_0)))
    _assert_close(
        torch_fn.end_function(torch_y_0).numpy(),
        np.asarray(jax_fn.end_function(y_0)),
    )
    for torch_part, jax_part in zip(
        torch_fn.affine_slice_map, jax_fn.affine_slice_map
    ):
        _assert_close(torch_part.numpy(), np.asarray(jax_part))

    # a batch of slices contracts as one matmul and matches slice by slice
    batch = torch.stack([torch_y_0, 2.0 * torch_y_0 - 1.0])
    ends = torch_fn.end_function(batch)
    _assert_close(ends[1].numpy(), torch_fn.end_function(batch[1]).numpy())


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_constraint_tensors_match_jax(problem):
    """The static constraint tensors the kernels take, derived by each
    package from its own problem objects, are the same arrays."""
    jax_cp = PROBLEMS[problem](vars(jax_pkg)).constrained_problem
    torch_cp = PROBLEMS[problem](vars(torch_pkg)).constrained_problem
    expected = jax_fused._constraint_tensors(jax_cp)
    actual = torch_fused._constraint_tensors(torch_cp)
    assert sorted(expected) == sorted(actual)
    for name, value in expected.items():
        value = np.asarray(value)
        assert actual[name].numpy().dtype == value.dtype, name
        np.testing.assert_array_equal(actual[name].numpy(), value)
