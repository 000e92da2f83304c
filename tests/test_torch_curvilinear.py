"""The curvilinear FDM path of the PyTorch port held against the JAX
package: the polar, cylindrical and spherical differential operators of
the three-point differentiator (float64, to 1e-12 of the largest value),
generic ``FDMOperator`` solves on polar and spherical meshes (float64, to
1e-10), and the polar branch of the fused system kernels: polar K5's plain
versions against the JAX package's polar K5 in interpret mode (float32,
to 1e-5 relative: the same operations in the same order, the tolerance
covering XLA's contraction) and against its generic path (float64, to
1e-10: the same operations, the metric terms multiplied by 1 / r where
the generic path divides by r), polar K8's plain version (the port's
carrier of polar K5 past one CTA) bit for bit with polar K5's, the gates
against the JAX package's, and ``FDMOperator``'s dispatch. The CUDA
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
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_system as torch_fused
from pararealml_tpu_torch.ops import packed_system as torch_packed
from pararealml_tpu_torch.ops import tiled_system as torch_tiled
from tests.test_torch_cuda import polar_problem, states_2d

torch.set_num_threads(1)

OPERATOR_TOL = 1e-12
SOLVE_TOL = 1e-10
F32_TOL = 1e-5
D_T = 5e-4
STEPS = 6
FAMILIES = ("wave", "burgers", "shallow_water", "cahn_hilliard")


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _relative_error(actual, expected):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    return np.abs(actual - expected).max() / np.abs(expected).max()


# -- the differential operators ---------------------------------------------


def _field_problem(module, coordinate_system):
    """A vector field problem (y dimension = x dimension) on a small mesh
    of ``coordinate_system`` away from the origin (and from the poles),
    with Neumann faces of distinct component fluxes, so that the
    derivative constraints take part."""
    cs = module.CoordinateSystem
    if coordinate_system == "polar":
        mesh = module.Mesh(
            [(1.0, 3.0), (0.0, 2.0)], [0.4, 0.25], cs.POLAR
        )
    elif coordinate_system == "cylindrical":
        mesh = module.Mesh(
            [(1.0, 2.5), (0.0, 1.5), (0.0, 1.0)],
            [0.25, 0.25, 0.25],
            cs.CYLINDRICAL,
        )
    else:
        # the cylindrical mesh's 7 x 7 x 5 vertices: JAX compiles its
        # operations once for both
        mesh = module.Mesh(
            [(1.0, 2.5), (0.0, 1.5), (0.5, 2.5)],
            [0.25, 0.25, 0.5],
            cs.SPHERICAL,
        )
    n = mesh.dimensions
    flux = module.NeumannBoundaryCondition(
        lambda x, t: np.tile(0.1 * np.arange(1, n + 1), (len(x), 1)),
        is_static=True,
    )
    return module.ConstrainedProblem(
        module.BurgersEquation(n, 10.0), mesh, [(flux, flux)] * n
    )


def _operator_calls(name, dimensions):
    """(method, positional arguments after y and the mesh) of every
    component ``name`` has in ``dimensions`` dimensions."""
    axes = range(dimensions)
    if name == "gradient":
        return [("gradient", (axis,)) for axis in axes]
    if name == "hessian":
        return [("hessian", (a, b)) for a in axes for b in axes]
    if name == "curl":
        indices = (0,) if dimensions == 2 else axes
        return [("curl", (index,)) for index in indices]
    if name == "vector_laplacian":
        return [("vector_laplacian", (index,)) for index in axes]
    return [(name, ())]


OPERATORS = (
    "gradient",
    "hessian",
    "divergence",
    "curl",
    "laplacian",
    "vector_laplacian",
)


def _field(mesh):
    """One float64 field of ``mesh`` from a seed."""
    return np.random.default_rng(3).uniform(
        0.5, 1.5, tuple(mesh.vertices_shape) + (mesh.dimensions,)
    )


@functools.lru_cache(maxsize=None)
def _jax_operator_references(coordinate_system):
    """Every component of every operator of the JAX package's
    differentiator on ``_field`` of ``coordinate_system``'s mesh, with the
    Neumann faces' derivative constraints: (method, arguments) -> array.
    One ``jax.jit`` compilation for all of them (eager JAX would compile
    each of their many small operations on its own), shared by the
    parametrised cases below."""
    jax_cp = _field_problem(jax_pkg, coordinate_system)
    bcs = jax_cp.static_boundary_vertex_constraints.d_y
    calls = [
        call
        for name in OPERATORS
        for call in _operator_calls(name, jax_cp.mesh.dimensions)
    ]

    @jax.jit
    def components(y):
        return tuple(
            getattr(JaxThreePoint(), method)(y, jax_cp.mesh, *args, bcs)
            for method, args in calls
        )

    values = components(jax.numpy.asarray(_field(jax_cp.mesh)))
    return dict(zip(calls, (np.asarray(value) for value in values)))


@pytest.mark.parametrize("operator", OPERATORS)
@pytest.mark.parametrize(
    "coordinate_system", ["polar", "cylindrical", "spherical"]
)
def test_curvilinear_operators_match_jax(coordinate_system, operator):
    """Every component of each operator, with the Neumann faces' derivative
    constraints, on one float64 field from a seed, alone and in a batch;
    the metric terms divide by the mesh's vertex coordinate grids in both
    packages."""
    jax_cp, torch_cp = (
        _field_problem(module, coordinate_system)
        for module in (jax_pkg, torch_pkg)
    )
    mesh = torch_cp.mesh
    for jax_grid, torch_grid in zip(
        jax_cp.mesh.device_coordinate_grids(True),
        mesh.device_coordinate_grids(True),
    ):
        np.testing.assert_array_equal(np.asarray(jax_grid), torch_grid)
    y = _field(mesh)
    torch_bcs = torch_cp.static_boundary_vertex_constraints.d_y
    references = _jax_operator_references(coordinate_system)
    for method, args in _operator_calls(operator, mesh.dimensions):
        expected = references[(method, args)]
        torch_method = getattr(ThreePointCentralDifferenceMethod(), method)
        actual = torch_method(torch.as_tensor(y), mesh, *args, torch_bcs)
        assert actual.dtype == torch.float64
        assert _relative_error(actual, expected) <= OPERATOR_TOL, (
            method,
            args,
        )
        # a leading batch axis maps elementwise
        batched = torch_method(
            torch.as_tensor(np.stack([y, y])), mesh, *args, torch_bcs
        )
        assert torch.equal(batched[1], actual)


# -- generic solves -----------------------------------------------------------


def _polar_wave(module):
    mesh = module.Mesh(
        [(2.5, 7.5), (0.0, 2 * np.pi)],
        [0.5, np.pi / 8],
        module.CoordinateSystem.POLAR,
    )
    flux = module.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = module.ConstrainedProblem(
        module.WaveEquation(2), mesh, [(flux, flux)] * 2
    )
    ic = module.GaussianInitialCondition(
        cp, [(np.array([-5.0, 0.0]), np.eye(2))] * 2, [4.0, 0.0]
    )
    return module.InitialValueProblem(cp, (0.0, 0.05), ic), 0.01


def _polar_shallow_water(module):
    mesh = module.Mesh(
        [(4.0, 11.0), (0.5 * np.pi, 1.5 * np.pi)],
        [0.7, np.pi / 10],
        module.CoordinateSystem.POLAR,
    )
    flux = module.NeumannBoundaryCondition(
        module.vectorize_bc_function(lambda x, t: (0.0, None, None)),
        is_static=True,
    )
    cp = module.ConstrainedProblem(
        module.ShallowWaterEquation(0.5), mesh, [(flux, flux)] * 2
    )
    ic = module.GaussianInitialCondition(
        cp, [(np.array([-6.0, 6.0]), 0.25 * np.eye(2))] * 3, [1.0, 0.0, 0.0]
    )
    return module.InitialValueProblem(cp, (0.0, 0.05), ic), 0.01


def _spherical_burgers(module):
    """examples/burgers_3d_fdm.py's problem on a coarser mesh (5 x 9 x 5)
    over 4 of its steps."""
    mesh = module.Mesh(
        [(1.0, 5.0), (0.0, 2.0 * np.pi), (0.25 * np.pi, 0.75 * np.pi)],
        [1.0, np.pi / 4, np.pi / 8],
        module.CoordinateSystem.SPHERICAL,
    )
    flux = module.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 3)), is_static=True
    )
    cp = module.ConstrainedProblem(
        module.BurgersEquation(3, 100), mesh, [(flux, flux)] * 3
    )
    ic = module.ContinuousInitialCondition(
        cp,
        lambda x: np.stack(
            [
                1.0 / x[:, 0] ** 2,
                np.zeros_like(x[:, 1]),
                np.zeros_like(x[:, 1]),
            ],
            axis=-1,
        ),
    )
    return module.InitialValueProblem(cp, (0.0, 2.0), ic), 0.5


@pytest.mark.parametrize(
    "problem", [_polar_wave, _polar_shallow_water, _spherical_burgers]
)
def test_generic_solves_match_jax(problem):
    """``FDMOperator.solve`` on the generic path in float64 in both
    packages (the polar problems are the examples' on coarser meshes)."""
    (jax_ivp, d_t), (torch_ivp, _) = problem(jax_pkg), problem(torch_pkg)
    expected = (
        JaxFDMOperator(JaxRK4(), JaxThreePoint(), d_t, fused_kernels=False)
        .solve(jax_ivp)
        .discrete_y()
    )
    actual = (
        FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            device="cpu",
            dtype=torch.float64,
        )
        .solve(torch_ivp)
        .discrete_y()
    )
    assert actual.shape == expected.shape
    assert _relative_error(actual, expected) <= SOLVE_TOL


# -- the polar branch of the fused system kernels ----------------------------


def _polar_problems(family, faces="neumann"):
    return tuple(
        polar_problem(vars(module), family, faces)
        for module in (jax_pkg, torch_pkg)
    )


def _faces(family):
    # Dirichlet r faces for two families, Neumann everywhere for two
    return "dirichlet" if family in ("wave", "shallow_water") else "neumann"


@functools.lru_cache(maxsize=None)
def _jax_polar_k5(family):
    """The JAX package's polar K5 trajectory in interpret mode over
    ``STEPS`` steps from the family's seeded state on the JAX tests'
    polar mesh: one interpret-mode call per family, shared by the tests
    below."""
    jax_cp, _ = _polar_problems(family, _faces(family))
    y = states_2d(
        jax_cp.mesh.vertices_shape, jax_cp.differential_equation.y_dimension
    )
    jax.config.update("jax_enable_x64", False)
    try:
        return y, np.asarray(
            jax_fused.build_fused_system_rk4_trajectory(
                jax_cp, D_T, STEPS, interpret=True
            )(y)
        )
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("family", FAMILIES)
def test_polar_plain_version_matches_pallas_kernel(family):
    _, torch_cp = _polar_problems(family, _faces(family))
    y, expected = _jax_polar_k5(family)
    actual = torch_fused.build_fused_system_rk4_trajectory(
        torch_cp, D_T, STEPS
    )(torch.as_tensor(y))
    assert actual.dtype == torch.float32
    assert _relative_error(actual, expected) <= F32_TOL


def test_polar_k8_plain_version_matches_pallas_k5(monkeypatch):
    """The port's polar K8 (the one-CTA limit patched down, so the JAX
    tests' 21 x 41 grid counts as past it) against the JAX package's polar
    K5 in interpret mode, which is what the JAX package runs there."""
    monkeypatch.setattr(torch_fused, "MAX_SHARED_MEMORY_BYTES", 1024)
    # and the cluster-resident mode's range, so that K8 takes the grid
    monkeypatch.setattr(torch_fused, "CLUSTER_MAX_BLOCK_CELLS", 0)
    _, torch_cp = _polar_problems("wave", _faces("wave"))
    y, expected = _jax_polar_k5("wave")
    calls = []
    wrapper = torch_tiled.tiled_system_rk4_trajectory

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(torch_tiled, "tiled_system_rk4_trajectory", counting)
    actual = torch_fused.build_fused_system_rk4_trajectory(
        torch_cp, D_T, STEPS
    )(torch.as_tensor(y))
    assert len(calls) == 1
    assert _relative_error(actual, expected) <= F32_TOL


@pytest.mark.parametrize("family", FAMILIES)
def test_polar_plain_versions_match_the_generic_path_in_float64(family):
    """Polar K5's and polar K8's plain versions in float64 against the JAX
    package's generic path, and bit for bit with each other in float32
    and float64 (K8 keeps K5's order of operations)."""
    jax_cp, torch_cp = _polar_problems(family, _faces(family))
    n = torch_cp.differential_equation.y_dimension
    y = states_2d(torch_cp.mesh.vertices_shape, n).astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, STEPS * D_T))
    expected = np.asarray(generic(y, 0.0))
    k5_cfg = torch_fused._SystemKernelConfig(torch_cp, D_T)
    k8_cfg = torch_tiled._TiledSystemConfig(torch_cp, D_T)
    for dtype in (torch.float64, torch.float32):
        state = torch.as_tensor(y, dtype=dtype)
        k5 = torch_fused.fused_system_rk4_trajectory_reference(
            state, k5_cfg, STEPS
        )
        k8 = torch_tiled.tiled_system_rk4_trajectory_reference(
            state, k8_cfg, STEPS
        )
        assert torch.equal(k5, k8)
        if dtype == torch.float64:
            assert _relative_error(k5, expected) <= SOLVE_TOL


def test_polar_end_and_step_are_the_trajectory():
    """The polar K5 end equals the trajectory's last frame, and the step
    its first, bit for bit; a batch advances each state as alone."""
    _, torch_cp = _polar_problems("shallow_water", "dirichlet")
    cfg = torch_fused._SystemKernelConfig(torch_cp, D_T)
    ys = torch.as_tensor(states_2d(torch_cp.mesh.vertices_shape, 3, batch=2))
    trajectory = torch_fused.fused_system_rk4_trajectory(ys, cfg, STEPS)
    assert torch.equal(
        torch_fused.fused_system_rk4_end(ys, cfg, STEPS), trajectory[:, -1]
    )
    assert torch.equal(
        torch_fused.fused_system_rk4_step(ys, cfg), trajectory[:, 0]
    )
    assert torch.equal(
        torch_fused.fused_system_rk4_trajectory(ys[1], cfg, STEPS),
        trajectory[1],
    )


def test_polar_radii_follow_the_mesh_not_d_x():
    """d_x0 = 0.4 on r in [2.5, 7.5] gives 13 rows a linspace spacing of
    5 / 12: 1 / r comes from that spacing, as the JAX kernel computes it
    (tests/test_fused_system.py's
    ``test_fused_polar_uneven_spacing_matches_generic``), and the plain
    version holds the generic path in float64."""
    mesh = torch_pkg.Mesh(
        [(2.5, 7.5), (0.0, 2 * np.pi)],
        [0.4, np.pi / 20.0],
        torch_pkg.CoordinateSystem.POLAR,
    )
    jax_mesh = jax_pkg.Mesh(
        [(2.5, 7.5), (0.0, 2 * np.pi)],
        [0.4, np.pi / 20.0],
        jax_pkg.CoordinateSystem.POLAR,
    )
    jax_cp, torch_cp = (
        module.ConstrainedProblem(
            module.WaveEquation(2),
            m,
            [
                (
                    module.NeumannBoundaryCondition(
                        lambda x, t: np.zeros((len(x), 2)), is_static=True
                    ),
                )
                * 2
            ]
            * 2,
        )
        for module, m in ((jax_pkg, jax_mesh), (torch_pkg, mesh))
    )
    assert mesh.vertices_shape[0] == 13
    cfg = torch_fused._SystemKernelConfig(torch_cp, D_T)
    assert cfg.r_spacing == pytest.approx(5.0 / 12.0, rel=1e-15)
    radii = mesh.coordinate_grids(True)[0][:, 0]
    np.testing.assert_allclose(
        1.0 / cfg.inv_r(torch.float64).numpy(), radii, rtol=1e-15
    )
    y = states_2d(mesh.vertices_shape, 2).astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, STEPS * D_T))
    actual = torch_fused.fused_system_rk4_trajectory_reference(
        torch.as_tensor(y), cfg, STEPS
    )
    assert _relative_error(actual, np.asarray(generic(y, 0.0))) <= SOLVE_TOL


def _gate_cases(module):
    """The JAX package's polar gate cases (tests/test_fused_system.py
    ``test_polar_applicability_gates`` and
    ``test_polar_origin_inclusive_not_applicable``), and the polar wave
    example's 51 x 201 grid, which is past one CTA: name -> problem."""
    zero = {
        n: module.NeumannBoundaryCondition(
            lambda x, t, n=n: np.zeros((len(x), n)), is_static=True
        )
        for n in (2, 3, 4)
    }
    cs = module.CoordinateSystem
    polar = module.Mesh(
        [(2.5, 7.5), (0.0, 2 * np.pi)], [0.25, np.pi / 20.0], cs.POLAR
    )
    cases = {
        "wave": (module.WaveEquation(2), polar, 2),
        "burgers": (module.BurgersEquation(2, 100.0), polar, 2),
        "shallow_water": (module.ShallowWaterEquation(0.5), polar, 3),
        "cahn_hilliard": (module.CahnHilliardEquation(2), polar, 2),
        "navier_stokes": (module.NavierStokesEquation(), polar, 4),
        "past_the_vmem_cap": (
            module.ShallowWaterEquation(0.5),
            module.Mesh(
                [(2.5, 7.5), (0.0, 2 * np.pi)],
                [5.0 / 430, 2 * np.pi / 430],
                cs.POLAR,
            ),
            3,
        ),
        "cylindrical": (
            module.WaveEquation(3),
            module.Mesh(
                [(2.5, 7.5), (0.0, 2 * np.pi), (0.0, 4.0)],
                [0.25, np.pi / 20.0, 0.25],
                cs.CYLINDRICAL,
            ),
            2,
        ),
        "origin_inclusive": (
            module.WaveEquation(2),
            module.Mesh(
                [(0.0, 5.0), (0.0, 2 * np.pi)], [0.25, np.pi / 20.0], cs.POLAR
            ),
            2,
        ),
        "wave_polar_example": (
            module.WaveEquation(2),
            module.Mesh(
                [(2.5, 7.5), (0.0, 2 * np.pi)], [0.1, np.pi / 100.0], cs.POLAR
            ),
            2,
        ),
    }
    return {
        name: module.ConstrainedProblem(
            equation, mesh, [(zero[n], zero[n])] * mesh.dimensions
        )
        for name, (equation, mesh, n) in cases.items()
    }


def test_polar_gates_match_jax(x64_off):
    """Case for case: the four families on a polar mesh away from the
    origin are admitted, past one CTA too; Navier-Stokes, a polar grid
    past the JAX package's VMEM cap, a cylindrical mesh and an
    origin-inclusive polar mesh are refused. The batched K4 takes none of
    them (the JAX package's packed kernels are Cartesian)."""
    jax_cases, torch_cases = _gate_cases(jax_pkg), _gate_cases(torch_pkg)
    admitted = set(FAMILIES) | {"wave_polar_example"}
    for name, torch_cp in torch_cases.items():
        expected = jax_fused.fused_system_step_applicable(
            jax_cases[name], JaxRK4()
        )
        assert expected == (name in admitted), name
        assert torch_fused.fused_system_step_applicable(
            torch_cp, RK4(), torch.float32
        ) == expected, name
        assert not torch_packed.packed_system_applicable(torch_cp, RK4(), 4)
        assert not jax_packed.packed_system_applicable(
            jax_cases[name], JaxRK4(), 4
        )
    assert torch_fused.fits_one_block(torch_cases["shallow_water"])
    assert not torch_fused.fits_one_block(torch_cases["wave_polar_example"])
    # the builder refuses a polar grid past the cap, as the JAX one does
    with pytest.raises(ValueError, match="polar"):
        torch_fused.build_fused_system_rk4_trajectory(
            torch_cases["past_the_vmem_cap"], D_T, 2
        )
    with pytest.raises(ValueError, match="polar"):
        jax_fused.build_fused_system_rk4_trajectory(
            jax_cases["past_the_vmem_cap"], D_T, 2
        )


def test_fdm_operator_dispatches_polar_problems(monkeypatch):
    """float32 polar trajectories, ends and steps go through polar K5 (one
    CTA) and, with the one-CTA limit patched down, polar K8 (the
    trajectory and the step; the ends, single and batched, its end mode),
    their plain versions here, and agree with the generic path to float32
    rounding; past the JAX package's VMEM cap (patched down) the generic
    path solves them."""
    _, cp = _polar_problems("burgers", "dirichlet")
    y = torch.as_tensor(states_2d(cp.mesh.vertices_shape, 2))
    interval = (0.0, STEPS * D_T)

    def operator(fused):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            D_T,
            fused_kernels=fused,
            device="cpu",
            dtype=torch.float32,
        )

    calls = []
    for module, name in (
        (torch_fused, "fused_system_rk4_trajectory"),
        (torch_fused, "fused_system_rk4_end"),
        (torch_fused, "fused_system_rk4_step"),
        (torch_tiled, "tiled_system_rk4_trajectory"),
        (torch_tiled, "tiled_system_rk4_end"),
    ):
        wrapper = getattr(module, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append(_name)
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    generic_fn, _ = operator(False).trajectory_function(cp, interval)
    generic = generic_fn(y, 0.0)
    fused_fn, _ = operator(True).trajectory_function(cp, interval)
    assert fused_fn.fused
    fused = fused_fn(y, 0.0)
    assert _relative_error(fused, generic) <= F32_TOL
    ends = operator(True).ends_function(cp, interval, batch=2)
    assert ends.fused
    assert torch.equal(ends(torch.stack([y, y]), 0.0)[1], fused[-1])
    step = operator(True)._build_step_function(cp)
    assert torch.equal(step(y, 0, 0.0), fused[0])
    assert calls == [
        "fused_system_rk4_trajectory",
        "fused_system_rk4_end",
        "fused_system_rk4_step",
    ]

    calls.clear()
    monkeypatch.setattr(torch_fused, "MAX_SHARED_MEMORY_BYTES", 1024)
    # and the cluster-resident mode's range, so that K8 takes the grid
    monkeypatch.setattr(torch_fused, "CLUSTER_MAX_BLOCK_CELLS", 0)
    tiled_fn, _ = operator(True).trajectory_function(cp, interval)
    assert torch.equal(tiled_fn(y, 0.0), fused)
    step = operator(True)._build_step_function(cp)
    assert torch.equal(step(y, 0, 0.0), fused[0])
    ends = operator(True).ends_function(cp, interval)
    assert ends.fused and not ends.batched
    assert torch.equal(ends(y, 0.0), fused[-1])
    ends = operator(True).ends_function(cp, interval, batch=2)
    assert ends.fused and ends.batched
    assert torch.equal(ends(torch.stack([y, y]), 0.0)[1], fused[-1])
    assert calls == ["tiled_system_rk4_trajectory"] * 2 + [
        "tiled_system_rk4_end"
    ] * 2

    monkeypatch.setattr(torch_fused, "REFERENCE_VMEM_BUDGET_CELLS", 1024)
    assert not operator(True).trajectory_function(cp, interval)[0].fused


def test_polar_parareal_takes_no_k4(monkeypatch):
    """Parareal over a polar problem: the batched K4, which the JAX package
    keeps Cartesian, takes none of it (the fine ends run batched polar K5,
    one CTA per slice, and, with the one-CTA limit patched down, the
    batched end mode of polar K8, one z-slice of its grid per time slice);
    the solution matches the fine solve to the tolerance, and the polar K8
    run matches the polar K5 run to float32 rounding."""
    _, cp = _polar_problems("wave", "neumann")
    ivp = torch_pkg.InitialValueProblem(
        cp,
        (0.0, 0.04),
        torch_pkg.DiscreteInitialCondition(
            cp, states_2d(cp.mesh.vertices_shape, 2).astype(np.float64), True
        ),
    )
    calls = []
    for module, name in (
        (torch_packed, "packed_system_rk4_ends"),
        (torch_packed, "packed_system_rk4_trajectory"),
        (torch_tiled, "tiled_system_rk4_end"),
    ):
        wrapper = getattr(module, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append((_name, tuple(args[0].shape[:-3])))
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)

    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            device="cpu",
            dtype=torch.float32,
        )

    parareal = PararealOperator(fdm(1e-3), fdm(1e-2), 1e-5, num_time_slices=4)
    actual = parareal.solve(ivp).discrete_y()
    fine = fdm(1e-3).solve(ivp).discrete_y()
    assert not calls
    assert np.abs(actual - fine).max() <= 2e-5 * np.abs(fine).max()

    monkeypatch.setattr(torch_fused, "MAX_SHARED_MEMORY_BYTES", 1024)
    # and the cluster-resident mode's range, so that K8 takes the grid
    monkeypatch.setattr(torch_fused, "CLUSTER_MAX_BLOCK_CELLS", 0)
    parareal = PararealOperator(fdm(1e-3), fdm(1e-2), 1e-5, num_time_slices=4)
    tiled = parareal.solve(ivp).discrete_y()
    assert calls.count(("tiled_system_rk4_end", (4,))) == (
        parareal.last_iterations
    )
    assert all(name == "tiled_system_rk4_end" for name, _ in calls)
    # polar K8 keeps polar K5's order of operations
    assert np.abs(tiled - actual).max() <= 1e-5 * np.abs(fine).max()


@pytest.mark.parametrize("family", ["wave", "cahn_hilliard"])
def test_polar_k8_end_matches_pallas_k5(family):
    """Polar K8's end mode (its plain version), batched, against the last
    frame of the JAX package's polar K5 in interpret mode (the cached run
    of ``_jax_polar_k5``), to 1e-5 of the largest value."""
    _, torch_cp = _polar_problems(family, _faces(family))
    y, expected = _jax_polar_k5(family)
    cfg = torch_tiled._TiledSystemConfig(torch_cp, D_T)
    actual = torch_tiled.tiled_system_rk4_end(
        torch.as_tensor(np.stack([y, y])), cfg, STEPS
    )
    assert actual.dtype == torch.float32
    assert _relative_error(actual[1], expected[-1]) <= F32_TOL
