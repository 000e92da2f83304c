"""The PyTorch port's FDM operator and affine propagators held against
the JAX package in float64: generic trajectories to rtol 1e-10 (the two
lambdified right-hand sides may order their sums differently), the
probed affine step map, the propagator's trajectory, end function and
composed slice map, and the static constraint tensors that cross between
the packages as arrays; and the kernel the operator picks for a batch of
float32 states (K4, K5, K2 and K1, the polar K5)."""

import functools

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
from pararealml_tpu_torch.ops import fused_system as torch_system
from pararealml_tpu_torch.ops import linear_propagator as torch_propagator
from pararealml_tpu_torch.ops import packed_system as torch_packed
from tests.parity_cases import equation_cases, solve_fdm_trajectory
from tests.test_torch_cuda import PROBLEMS, polar_problem, system_problem

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


CASES = sorted(equation_cases())
# the port's FDM namespace with its operator on the CPU
CPU_FDM = dict(
    vars(torch_fdm),
    FDMOperator=functools.partial(torch_fdm.FDMOperator, device="cpu"),
)


@pytest.mark.parametrize("name", CASES)
def test_generic_trajectory_matches_jax(name, torch_float64):
    """tests/parity_cases.py runs unchanged on both packages (the port's
    operator asked for the CPU: its default device is the CUDA card),
    Navier-Stokes with its stream-function anti-Laplacian at tol 1e-10."""
    case = equation_cases()[name]
    expected = solve_fdm_trajectory(vars(jax_pkg), vars(jax_fdm), case)
    actual = solve_fdm_trajectory(vars(torch_pkg), CPU_FDM, case)
    _assert_close(actual, expected)


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
        device="cpu",
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


@functools.lru_cache(maxsize=None)
def _jax_operator_references():
    """Every entry of ``OPERATORS`` through the JAX package's
    differentiator on one seeded field, under one ``jax.jit`` compilation
    (eager JAX would compile each of their many small operations on its
    own), shared by the parametrised cases below: name -> array."""
    import jax

    jax_cp = _vector_field_problem(vars(jax_pkg))
    bcs = jax_cp.static_boundary_vertex_constraints.d_y
    names = sorted(OPERATORS)

    @jax.jit
    def evaluate(y):
        return tuple(
            OPERATORS[name](
                jax_fdm.ThreePointCentralDifferenceMethod(),
                y,
                jax_cp.mesh,
                bcs,
            )
            for name in names
        )

    y = np.random.default_rng(1).standard_normal((9, 9, 2))
    return dict(zip(names, (np.asarray(value) for value in evaluate(y))))


@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_cartesian_differential_operators_match_jax(operator):
    torch_cp = _vector_field_problem(vars(torch_pkg))
    y = np.random.default_rng(1).standard_normal((9, 9, 2))
    expected = _jax_operator_references()[operator]
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
        torch_fdm.RK4(),
        torch_fdm.ThreePointCentralDifferenceMethod(),
        1e-2,
        device="cpu",
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
        torch_fdm.RK4(),
        torch_fdm.ThreePointCentralDifferenceMethod(),
        d_t,
        device="cpu",
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


# (problem, batch, the wrapper the batched ends call, the wrapper the
# batched trajectory calls): K4 on a 2D system whose Cartesian grid fits
# one CTA for two or more states, K5 for one; the flagship's 21 x 21
# diffusion grid through K2 and K1; a polar grid through the K5 end and
# trajectory
BATCHED_ROUTES = {
    "k4": (
        lambda m: system_problem(m, "wave", shape=(9, 9)),
        4,
        "packed_system_rk4_ends",
        "packed_system_rk4_trajectory",
    ),
    "k5_one_state": (
        lambda m: system_problem(m, "wave", shape=(9, 9)),
        1,
        "fused_system_rk4_end",
        "fused_system_rk4_trajectory",
    ),
    "flagship": (
        lambda m: PROBLEMS["flagship"](m).constrained_problem,
        4,
        "fused_diffusion_rk4_end",
        "fused_diffusion_rk4_trajectory",
    ),
    "polar": (
        lambda m: polar_problem(m, "wave"),
        4,
        "fused_system_rk4_end",
        "fused_system_rk4_trajectory",
    ),
}


@pytest.mark.parametrize("route", sorted(BATCHED_ROUTES))
def test_the_operator_chooses_the_batched_route(route, monkeypatch):
    """``trajectory_function(batch=n)`` and ``ends_function(batch=n)``
    return the kernel the operator picks for a batch of ``n`` float32
    states (their plain versions here), each launched once on the
    batch."""
    calls = []
    for module, name in (
        (torch_packed, "packed_system_rk4_ends"),
        (torch_packed, "packed_system_rk4_trajectory"),
        (torch_fused, "fused_diffusion_rk4_end"),
        (torch_fused, "fused_diffusion_rk4_trajectory"),
        (torch_system, "fused_system_rk4_end"),
        (torch_system, "fused_system_rk4_trajectory"),
    ):
        wrapper = getattr(module, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append((_name, y.shape[0]))
            return _wrapper(y, *args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    build_cp, batch, end_kernel, trajectory_kernel = BATCHED_ROUTES[route]
    cp = build_cp(vars(torch_pkg))
    operator = torch_fdm.FDMOperator(
        torch_fdm.RK4(),
        torch_fdm.ThreePointCentralDifferenceMethod(),
        1e-3,
        device="cpu",
        dtype=torch.float32,
    )
    y_shape = tuple(cp.y_shape(True))
    y = torch.rand((batch,) + y_shape, dtype=torch.float32)
    ends = operator.ends_function(cp, (0.0, 3e-3), batch=batch)
    trajectory, _ = operator.trajectory_function(
        cp, (0.0, 3e-3), batch=batch
    )
    assert ends.fused and ends.batched
    assert ends(y, 0.0).shape == (batch,) + y_shape
    assert calls == [(end_kernel, batch)]
    calls.clear()
    assert trajectory.fused
    assert trajectory(y, 0.0).shape == (batch, 3) + y_shape
    assert calls == [(trajectory_kernel, batch)]
