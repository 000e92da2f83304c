"""The port's ``Solution`` constructors and
``operator.materialize_solution`` on the CPU: a CPU trajectory is copied
into the ``Solution``, so the operator's tensor and the solution share
no memory; the public constructor copies its input; ``Solution._adopt``
takes its array as it is, after the same checks. The card's path (the
page-locked copy the ``Solution`` adopts) is tested in
tests/test_torch_cuda.py. A small problem: the flagship diffusion at
d_x 1.0 (11 x 11), three frames."""

import numpy as np
import pytest
import torch

import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu_torch.operator import materialize_solution
from pararealml_tpu_torch.solution import Solution

D_T = 0.05
STEPS = 3
TIMES = D_T * np.arange(1, STEPS + 1)


@pytest.fixture(scope="module")
def ivp():
    return build_problem(vars(torch_pkg), STEPS * D_T, d_x=1.0)


def _trajectory(ivp, seed=0):
    shape = (STEPS,) + tuple(ivp.constrained_problem.y_shape(True))
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_materialize_on_the_cpu_shares_nothing_with_the_tensor(ivp, dtype):
    ys = torch.as_tensor(_trajectory(ivp), dtype=dtype)
    expected = ys.to(torch.float64).numpy().copy()
    solution = materialize_solution(ivp, TIMES, ys, True, D_T)
    ys.add_(1.0)
    trajectory = solution.discrete_y()
    assert trajectory.dtype == np.float64
    assert np.array_equal(trajectory, expected)


def test_the_constructor_copies_its_input(ivp):
    given = _trajectory(ivp)
    expected = given.copy()
    solution = Solution(ivp, TIMES, given, vertex_oriented=True, d_t=D_T)
    given += 1.0
    assert np.array_equal(solution.discrete_y(), expected)


def test_adopt_takes_the_array_without_a_copy(ivp):
    given = _trajectory(ivp)
    solution = Solution._adopt(
        ivp, TIMES, given, vertex_oriented=True, d_t=D_T
    )
    given += 1.0
    assert np.array_equal(solution.discrete_y(), given)
    assert solution.d_t == D_T
    assert np.array_equal(solution.t_coordinates, TIMES)


@pytest.mark.parametrize(
    "build", [Solution, Solution._adopt], ids=["constructor", "adopt"]
)
def test_both_ways_in_check_the_shape_and_orientation(ivp, build):
    given = _trajectory(ivp)
    with pytest.raises(ValueError, match="does not match"):
        build(ivp, TIMES, given[:, 1:], vertex_oriented=True, d_t=D_T)
    with pytest.raises(ValueError, match="does not match"):
        build(ivp, TIMES[1:], given, vertex_oriented=True, d_t=D_T)
    with pytest.raises(ValueError, match="vertex orientation"):
        build(ivp, TIMES, given, d_t=D_T)
