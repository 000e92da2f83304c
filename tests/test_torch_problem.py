"""The PyTorch port's problem-definition layer held against the JAX
package: mesh coordinates, static constraints, initial conditions and the
time grid, in float64 to 1e-12, on the flagship diffusion_2d problem and
on the all-Neumann problem of tests/test_fused_diffusion.py."""

import numpy as np
import pytest
import sympy as sp
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.operator import (
    discretize_time_domain as jax_discretize_time_domain,
)
from pararealml_tpu_torch.operator import (
    discretize_time_domain as torch_discretize_time_domain,
)
from tests.test_fused_diffusion import _neumann_cp
from tests.test_torch_cuda import PROBLEMS, _neumann_problem

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(params=sorted(PROBLEMS))
def ivps(request):
    build = PROBLEMS[request.param]
    return build(vars(jax_pkg)), build(vars(torch_pkg))


def _assert_constraint_equal(jax_constraint, torch_constraint):
    assert (jax_constraint is None) == (torch_constraint is None)
    if jax_constraint is None:
        return
    mask = np.asarray(jax_constraint.mask)
    np.testing.assert_array_equal(mask, torch_constraint.mask.numpy())
    np.testing.assert_allclose(
        np.where(mask, np.asarray(jax_constraint.values), 0.0),
        np.where(mask, torch_constraint.values.numpy(), 0.0),
        rtol=TOL,
        atol=TOL,
    )


def test_neumann_builder_matches_fused_diffusion_tests():
    jax_cp = _neumann_cp()
    torch_cp = _neumann_problem(vars(torch_pkg)).constrained_problem
    assert jax_cp.mesh.vertices_shape == torch_cp.mesh.vertices_shape
    assert jax_cp.mesh.d_x == torch_cp.mesh.d_x
    for axis in range(2):
        for side in range(2):
            _assert_constraint_equal(
                jax_cp.static_boundary_vertex_constraints.d_y[axis][side],
                torch_cp.static_boundary_vertex_constraints.d_y[axis][side],
            )


def test_mesh_coordinates(ivps):
    jax_mesh = ivps[0].constrained_problem.mesh
    torch_mesh = ivps[1].constrained_problem.mesh
    assert jax_mesh.vertices_shape == torch_mesh.vertices_shape
    assert jax_mesh.cells_shape == torch_mesh.cells_shape
    for vertex_oriented in (True, False):
        for a, b in zip(
            jax_mesh.coordinate_grids(vertex_oriented),
            torch_mesh.coordinate_grids(vertex_oriented),
        ):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        for a, b in zip(
            jax_mesh.device_coordinate_grids(vertex_oriented),
            torch_mesh.device_coordinate_grids(vertex_oriented),
        ):
            assert b.dtype == torch.float64
            np.testing.assert_allclose(
                np.asarray(a), b.numpy(), rtol=TOL, atol=TOL
            )
    assert jax_mesh.volume == pytest.approx(torch_mesh.volume, rel=TOL)


def test_static_y_vertex_constraints(ivps):
    _assert_constraint_equal(
        ivps[0].constrained_problem.static_y_vertex_constraints,
        ivps[1].constrained_problem.static_y_vertex_constraints,
    )


@pytest.mark.parametrize("vertex_oriented", [True, False])
def test_static_boundary_constraints(ivps, vertex_oriented):
    jax_bcs = ivps[0].constrained_problem.static_boundary_constraints(
        vertex_oriented
    )
    torch_bcs = ivps[1].constrained_problem.static_boundary_constraints(
        vertex_oriented
    )
    for kind in ("y", "d_y"):
        for axis in range(2):
            for side in range(2):
                _assert_constraint_equal(
                    getattr(jax_bcs, kind)[axis][side],
                    getattr(torch_bcs, kind)[axis][side],
                )


@pytest.mark.parametrize("vertex_oriented", [True, False])
def test_gaussian_discrete_y_0(ivps, vertex_oriented):
    jax_y_0 = ivps[0].initial_condition.discrete_y_0(vertex_oriented)
    torch_y_0 = ivps[1].initial_condition.discrete_y_0(vertex_oriented)
    assert jax_y_0.shape == torch_y_0.shape
    np.testing.assert_allclose(jax_y_0, torch_y_0, rtol=TOL, atol=TOL)


def test_discrete_initial_condition_resampling(ivps):
    """Orientation resampling goes through the multilinear interpolator
    and, onto vertices, the static y constraints."""
    rng = np.random.default_rng(0)
    cells = rng.standard_normal(
        ivps[0].constrained_problem.y_shape(False)
    )
    jax_ic = jax_pkg.DiscreteInitialCondition(
        ivps[0].constrained_problem, cells, False
    )
    torch_ic = torch_pkg.DiscreteInitialCondition(
        ivps[1].constrained_problem, cells, False
    )
    np.testing.assert_allclose(
        jax_ic.discrete_y_0(True),
        torch_ic.discrete_y_0(True),
        rtol=TOL,
        atol=TOL,
    )


@pytest.mark.parametrize(
    "t_interval, d_t",
    [((0.0, 40.0), 1e-3), ((0.0, 40.0), 1e-2), ((1.25, 6.25), 0.05)],
)
def test_discretize_time_domain(t_interval, d_t):
    np.testing.assert_allclose(
        jax_discretize_time_domain(t_interval, d_t),
        torch_discretize_time_domain(t_interval, d_t),
        rtol=TOL,
        atol=TOL,
    )


def test_symbolic_equation_systems_match():
    """All 13 built-in equations define the same symbolic systems."""
    factories = {
        "PopulationGrowthEquation": (),
        "LotkaVolterraEquation": (),
        "LorenzEquation": (),
        "SIREquation": (),
        "VanDerPolEquation": (),
        "NBodyGravitationalEquation": (2, [5.0, 7.0]),
        "DiffusionEquation": (2, 0.3),
        "ConvectionDiffusionEquation": (2, [0.4, -0.2], 0.3),
        "WaveEquation": (2,),
        "CahnHilliardEquation": (2,),
        "BurgersEquation": (2,),
        "ShallowWaterEquation": (0.5,),
        "NavierStokesEquation": (),
    }
    for name, args in factories.items():
        jax_eq = getattr(jax_pkg, name)(*args)
        torch_eq = getattr(torch_pkg, name)(*args)
        jax_sys = jax_eq.symbolic_equation_system
        torch_sys = torch_eq.symbolic_equation_system
        assert [t.name for t in jax_sys.lhs_types] == [
            t.name for t in torch_sys.lhs_types
        ], name
        for a, b in zip(jax_sys.rhs, torch_sys.rhs):
            assert sp.srepr(sp.sympify(a)) == sp.srepr(sp.sympify(b)), name
