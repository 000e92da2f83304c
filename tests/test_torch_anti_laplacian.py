"""The PyTorch port's anti-Laplacian held against the JAX package's in
float64: the Jacobi sweeps and the BiCGStab solve on Cartesian, polar and
spherical grids, with Dirichlet faces and with Neumann halos, to 1e-10
(tests/operators/fdm/test_anti_laplacian_bicgstab.py's cases, solved in
both packages), the ``max_iterations`` cap, and leading batch axes solved
independently.

The two packages evaluate the same sweep in the same order and differ in
the order of the sums of their norms and dot products. Jacobi solves at
tol 1e-10 agree to about 1e-13. BiCGStab's recurrences amplify that
rounding (two solves at tol 1e-10 agree to 1e-15 for ten iterations, then
drift as far as 1e-6 before both converge), so two BiCGStab solves agree
only to their own accuracy: they are run at tol 1e-12, where they agree to
about 2e-11."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.constrained_problem import (
    BoundaryConstraintPair as JaxPair,
)
from pararealml_tpu.constraint import Constraint as JaxConstraint
from pararealml_tpu.operators.fdm import (
    ThreePointCentralDifferenceMethod as JaxThreePoint,
)
from pararealml_tpu_torch.constrained_problem import BoundaryConstraintPair
from pararealml_tpu_torch.constraint import Constraint
from pararealml_tpu_torch.operators.fdm import (
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.fdm import numerical_differentiator

torch.set_num_threads(1)

TOL = 1e-10
METHODS = ("jacobi", "bicgstab")
# each method's solver tolerance (see the module's docstring)
SOLVER_TOL = {"jacobi": 1e-10, "bicgstab": 1e-12}


def _mesh(module, kind):
    """A small grid of each coordinate system the tests cover."""
    if kind == "cartesian":
        return module.Mesh([(0.0, 1.0), (0.0, 1.0)], [0.05, 0.05])
    if kind == "polar":
        return module.Mesh(
            [(1.0, 2.0), (0.0, np.pi)],
            [0.05, np.pi / 20.0],
            module.CoordinateSystem.POLAR,
        )
    return module.Mesh(
        [(1.0, 2.0), (0.0, 2.0 * np.pi), (0.25 * np.pi, 0.75 * np.pi)],
        [0.125, np.pi / 8.0, np.pi / 8.0],
        module.CoordinateSystem.SPHERICAL,
    )


def _field(kind, mesh):
    """A smooth field on the grid that vanishes on no face."""
    grids = [np.asarray(g)[..., None] for g in mesh.vertex_coordinate_grids]
    if kind == "cartesian":
        return np.sin(np.pi * grids[0]) * np.sin(np.pi * grids[1]) + 0.25
    if kind == "polar":
        return (grids[0] - 1.0) * (2.0 - grids[0]) * np.sin(grids[1]) + 0.1
    return np.cos(grids[1]) * np.sin(grids[2]) / grids[0]


def _dirichlet_mask(shape):
    """Every face of the grid."""
    mask = np.zeros(shape, bool)
    for axis in range(len(shape) - 1):
        index = [slice(None)] * len(shape)
        index[axis] = 0
        mask[tuple(index)] = True
        index[axis] = -1
        mask[tuple(index)] = True
    return mask


def _constraints(faces, shape):
    """(y constraint mask and values, per-axis Neumann pairs as arrays):
    ``"dirichlet"`` pins every face; ``"neumann"`` pins the axis-1 faces
    and sets a normal derivative of 0.3 (lower) and -0.2 (upper) on the
    axis-0 faces."""
    values = np.random.default_rng(3).uniform(-0.5, 0.5, shape)
    if faces == "dirichlet":
        return (_dirichlet_mask(shape), values), None
    mask = np.zeros(shape, bool)
    mask[:, 0] = mask[:, -1] = True
    face_shape = (1,) + shape[1:]
    neumann = [
        (np.full(face_shape, 0.3), np.full(face_shape, -0.2))
    ] + [None] * (len(shape) - 2)
    return (mask, values), neumann


def _solve(package, kind, faces, method, max_iterations=100_000, y_init=None):
    """The anti-Laplacian of the field's Laplacian through one package,
    as a float64 numpy array."""
    is_jax = package is jax_pkg
    mesh = _mesh(package, kind)
    y = _field(kind, mesh)
    (mask, values), neumann = _constraints(faces, y.shape)
    array = jnp.asarray if is_jax else torch.as_tensor
    constraint_cls = JaxConstraint if is_jax else Constraint
    pair_cls = JaxPair if is_jax else BoundaryConstraintPair
    y_constraint = constraint_cls(array(values), array(mask))
    bcs = None
    if neumann is not None:
        bcs = [
            None
            if pair is None
            else pair_cls(
                *(
                    constraint_cls(array(v), array(np.ones_like(v, bool)))
                    for v in pair
                )
            )
            for pair in neumann
        ]
    method_cls = JaxThreePoint if is_jax else ThreePointCentralDifferenceMethod
    differentiator = method_cls(
        tol=SOLVER_TOL[method],
        max_iterations=max_iterations,
        anti_laplacian_method=method,
    )
    laplacian = differentiator.laplacian(array(y), mesh, bcs)
    init = None if y_init is None else array(y_init(y.shape))
    result = differentiator.anti_laplacian(
        laplacian, mesh, y_constraint, bcs, y_init=init
    )
    return np.asarray(result, np.float64)


def _assert_close(actual, expected, tol=TOL):
    assert actual.shape == expected.shape
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "kind, faces",
    [
        ("cartesian", "dirichlet"),
        ("cartesian", "neumann"),
        ("polar", "dirichlet"),
        ("polar", "neumann"),
        ("spherical", "dirichlet"),
    ],
)
def test_anti_laplacian_matches_jax(kind, faces, method):
    expected = _solve(jax_pkg, kind, faces, method)
    actual = _solve(torch_pkg, kind, faces, method)
    _assert_close(actual, expected)


@pytest.mark.parametrize("method", METHODS)
def test_max_iterations_caps_the_solve(method):
    """Five Jacobi sweeps (or three BiCGStab iterations) from a warm
    start stop far from convergence, at the same state in both
    packages."""
    cap = 5 if method == "jacobi" else 3

    def y_init(shape):
        return np.random.default_rng(4).uniform(-1.0, 1.0, shape)

    expected = _solve(
        jax_pkg, "cartesian", "neumann", method, cap, y_init=y_init
    )
    actual = _solve(
        torch_pkg, "cartesian", "neumann", method, cap, y_init=y_init
    )
    _assert_close(actual, expected)
    converged = _solve(torch_pkg, "cartesian", "neumann", method)
    assert float(np.abs(actual - converged).max()) > 1e-3


@pytest.mark.parametrize("method", METHODS)
def test_batch_axes_are_solved_independently(method):
    """A batch of two right-hand sides takes each state's own stopping
    point: each solution equals that state's solve alone (the slower one
    does not drag the faster one along)."""
    mesh = _mesh(torch_pkg, "cartesian")
    y = torch.as_tensor(_field("cartesian", mesh))
    mask = torch.as_tensor(_dirichlet_mask(tuple(y.shape)))
    constraint = Constraint(torch.zeros_like(y), mask)
    differentiator = ThreePointCentralDifferenceMethod(
        tol=1e-6, anti_laplacian_method=method
    )
    laplacian = differentiator.laplacian(y, mesh)
    batch = torch.stack([laplacian, 40.0 * laplacian])
    solved = differentiator.anti_laplacian(batch, mesh, constraint)
    for index in range(2):
        alone = differentiator.anti_laplacian(batch[index], mesh, constraint)
        torch.testing.assert_close(solved[index], alone, rtol=0, atol=0)


def test_jacobi_freezes_a_converged_state_within_a_chunk(monkeypatch):
    """A chunk longer than the solve returns the while loop's state: the
    sweeps past the stopping point change nothing."""
    mesh = _mesh(torch_pkg, "cartesian")
    y = torch.as_tensor(_field("cartesian", mesh))
    constraint = Constraint(
        torch.zeros_like(y), torch.as_tensor(_dirichlet_mask(tuple(y.shape)))
    )
    differentiator = ThreePointCentralDifferenceMethod(tol=1e-3)
    laplacian = differentiator.laplacian(y, mesh)
    reference = differentiator.anti_laplacian(laplacian, mesh, constraint)
    monkeypatch.setattr(numerical_differentiator, "JACOBI_CHUNK", 1000)
    chunked = differentiator.anti_laplacian(laplacian, mesh, constraint)
    torch.testing.assert_close(chunked, reference, rtol=0, atol=0)


def test_anti_laplacian_validates_its_input():
    mesh = _mesh(torch_pkg, "cartesian")
    laplacian = torch.zeros(mesh.vertices_shape + (1,))
    differentiator = ThreePointCentralDifferenceMethod()
    with pytest.raises(ValueError, match="y_init shape"):
        differentiator.anti_laplacian(
            laplacian, mesh, None, y_init=torch.zeros(3, 3, 1)
        )
    with pytest.raises(ValueError, match="Laplacian shape"):
        differentiator.anti_laplacian(torch.zeros(3, 3, 1), mesh, None)
    with pytest.raises(ValueError, match="anti-Laplacian method"):
        ThreePointCentralDifferenceMethod(anti_laplacian_method="sor")
    assert (
        ThreePointCentralDifferenceMethod(
            anti_laplacian_method="bicgstab"
        ).anti_laplacian_method
        == "bicgstab"
    )
