"""The PyTorch port's tests that need an NVIDIA GPU, and the problem
builders the port's tests share.

The tests here are marked ``cuda`` and skip where
``torch.cuda.is_available()`` is false: they hold each CUDA kernel
against its plain PyTorch version on the same CUDA tensors, the
slice's Parareal on the card against the same solve on the CPU, and the
trajectory's page-locked copy to the host that a ``Solution`` adopts,
whole or in the pieces a running kernel publishes. This file imports no
JAX, so it runs on a GPU machine without JAX or the JAX package (the
suite's conftest imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu_torch.operator import (
    FrameProgress,
    materialize_solution,
    trajectory_chunks,
)
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.ml.supervised import (
    SupervisedMLOperator,
    from_arrays,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion, fused_navier_stokes
from pararealml_tpu_torch.ops import fused_system
from pararealml_tpu_torch.ops import fused_system_3d, packed_system
from pararealml_tpu_torch.ops import resident_diffusion, tiled_diffusion
from pararealml_tpu_torch.ops import tiled_system
from pararealml_tpu_torch.utils import load_pytree, tracing

torch.set_num_threads(1)

# float32 kernels against float32 plain versions with the same
# evaluation order: only contraction-free rounding differences remain
KERNEL_TOL = 1e-5
# K1-K3: each built instance's registers and spill bytes a thread, by
# (layout, cells a thread, convection), and the Navier-Stokes kernel's
# (below), as the card reports them for the
# build (cudaFuncGetAttributes, the larger of the trajectory and end
# kernels: ptxas's counts; tools/k1_plan_sweep.py prints them; NVIDIA
# H100 80GB HBM3)
INSTANCE_REGISTERS = {
    ("cells", 1, False): (39, 0),
    ("cells", 1, True): (39, 0),
    ("cells", 2, False): (56, 0),
    ("cells", 2, True): (52, 0),
    ("cells", 4, False): (39, 0),
    ("cells", 4, True): (42, 0),
    ("cells", 8, False): (55, 0),
    ("cells", 8, True): (62, 0),
    ("cells", 11, False): (64, 0),
    ("cells", 11, True): (63, 0),
    ("strips", 0, False): (38, 0),
    ("strips", 0, True): (39, 0),
    # the Navier-Stokes kernel's, by (group of sweeps, cells a thread),
    # each at its most threads (ops/fused_navier_stokes.py
    # instance_attributes and CELLS_INSTANCES)
    ("navier_stokes", 1, 1): (72, 0),
    ("navier_stokes", 1, 3): (96, 0),
    ("navier_stokes", 1, 10): (113, 0),
    ("navier_stokes", 2, 1): (80, 0),
    ("navier_stokes", 2, 3): (78, 0),
    ("navier_stokes", 2, 10): (118, 0),
    ("navier_stokes", 3, 1): (80, 0),
    ("navier_stokes", 3, 3): (78, 0),
    ("navier_stokes", 3, 10): (114, 0),
    ("navier_stokes", 4, 1): (80, 0),
    ("navier_stokes", 4, 3): (76, 0),
    ("navier_stokes", 4, 10): (117, 0),
    ("navier_stokes", 8, 1): (80, 0),
    ("navier_stokes", 8, 3): (85, 0),
    ("navier_stokes", 8, 10): (124, 0),
}
# the fitted quadratic coarse model of the Burgers bench (rank 32)
QUAD_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bench_assets",
    "sml_quad_burgers_2d.msgpack",
)


def _neumann_problem(module, flux=0.5):
    """``_neumann_cp`` built through a package namespace, with a Gaussian
    initial condition."""
    mesh = module["Mesh"]([(0.0, 4.0), (0.0, 4.0)], [0.25, 0.25])
    bcs = [
        (
            module["NeumannBoundaryCondition"](
                lambda x, t: np.full((len(x), 1), flux), is_static=True
            ),
        )
        * 2
    ] * 2
    cp = module["ConstrainedProblem"](
        module["DiffusionEquation"](2, 0.3), mesh, bcs
    )
    ic = module["GaussianInitialCondition"](
        cp, [(np.array([1.5, 2.5]), 0.5 * np.eye(2))], [10.0]
    )
    return module["InitialValueProblem"](cp, (0.0, 1.0), ic)


def _convection_problem(module):
    """The convection-diffusion problem of
    tests/test_fused_diffusion.py: Dirichlet faces on axis 0, a constant
    flux on axis 1."""
    mesh = module["Mesh"]([(0.0, 4.0), (0.0, 4.0)], [0.25, 0.25])
    bcs = [
        (
            module["DirichletBoundaryCondition"](
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
        * 2,
        (
            module["NeumannBoundaryCondition"](
                lambda x, t: np.full((len(x), 1), 0.2), is_static=True
            ),
        )
        * 2,
    ]
    cp = module["ConstrainedProblem"](
        module["ConvectionDiffusionEquation"](2, [0.8, -0.4], 0.3), mesh, bcs
    )
    ic = module["GaussianInitialCondition"](
        cp, [(np.full(2, 2.0), 0.5 * np.eye(2))], [10.0]
    )
    return module["InitialValueProblem"](cp, (0.0, 1.0), ic)


# the flagship diffusion_2d problem, the all-Neumann problem and the
# convection-diffusion problem of tests/test_fused_diffusion.py
PROBLEMS = {
    "flagship": lambda module: build_problem(module, 40.0),
    "neumann": _neumann_problem,
    "convection": _convection_problem,
}


def large_grid_problem(
    module, h_extent, w_extent, d_x, convection=False, flux=0.0
):
    """The constrained problem of tests/test_tiled_diffusion.py:
    diffusion (or convection-diffusion) with coefficient 0.3, Dirichlet
    rows of value 1.5 and Neumann columns of the given flux."""
    if convection:
        diff_eq = module["ConvectionDiffusionEquation"](2, [0.8, -0.4], 0.3)
    else:
        diff_eq = module["DiffusionEquation"](2, 0.3)
    mesh = module["Mesh"]([(0.0, h_extent), (0.0, w_extent)], [d_x, d_x])
    bcs = [
        (
            module["DirichletBoundaryCondition"](
                lambda x, t: np.full((len(x), 1), 1.5), is_static=True
            ),
        )
        * 2,
        (
            module["NeumannBoundaryCondition"](
                lambda x, t: np.full((len(x), 1), flux), is_static=True
            ),
        )
        * 2,
    ]
    return module["ConstrainedProblem"](diff_eq, mesh, bcs)


# tests/test_tiled_diffusion.py's problems: Dirichlet rows with Neumann
# columns at flux 0 (the ghost columns fold into the taps), flux 0.2 with
# convection, flux 0.1
LARGE_GRID_PROBLEMS = {
    "folded_17x33": (4.0, 8.0, 0.25, False, 0.0),
    "convection_33x17": (8.0, 4.0, 0.25, True, 0.2),
    "flux_81x81": (10.0, 10.0, 0.125, False, 0.1),
}


def burgers_problem(module, kind="bench", extent=5.0, t_end=1.0):
    """2D viscous Burgers (Re = 100) on [0, extent]^2 with d_x = 0.25 and
    two Gaussian bumps of amplitudes 1.0 and 0.5 at the centre, of
    covariance 0.15 * extent * I. ``"bench"`` is the configuration of
    bench.py's ``build_burgers_problem`` (extent 5: a 21 x 21 grid,
    zero-flux Neumann faces); ``"mixed"`` has Dirichlet faces of value
    0.5 on axis 0 and the component fluxes (0.3, -0.2) on axis 1."""
    mesh = module["Mesh"]([(0.0, extent)] * 2, [0.25] * 2)
    if kind == "bench":
        bcs = [
            (
                module["NeumannBoundaryCondition"](
                    lambda x, t: np.zeros((len(x), 2)), is_static=True
                ),
            )
            * 2
        ] * 2
    else:
        bcs = [
            (
                module["DirichletBoundaryCondition"](
                    lambda x, t: np.full((len(x), 2), 0.5), is_static=True
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
    cp = module["ConstrainedProblem"](
        module["BurgersEquation"](2, 100.0), mesh, bcs
    )
    ic = module["GaussianInitialCondition"](
        cp,
        [(np.full(2, extent / 2.0), 0.15 * extent * np.eye(2))] * 2,
        [1.0, 0.5],
    )
    return module["InitialValueProblem"](cp, (0.0, t_end), ic)


# the five families of the fused 3D kernels (K9): (equation, components)
FAMILIES_3D = {
    "diffusion": (lambda m: m["DiffusionEquation"](3, 0.3), 1),
    "convection_diffusion": (
        lambda m: m["ConvectionDiffusionEquation"](3, [0.4, -0.3, 0.2], 0.2),
        1,
    ),
    "wave": (lambda m: m["WaveEquation"](3, 1.2), 2),
    "burgers": (lambda m: m["BurgersEquation"](3, 50.0), 3),
    "cahn_hilliard": (lambda m: m["CahnHilliardEquation"](3), 2),
}


def problem_3d(module, family, dirichlet=False, shape=(7, 8, 9), d_x=0.125):
    """A 3D problem of one of K9's families on a ``shape`` grid of
    spacing ``d_x`` with the faces of tests/test_fused_system_3d.py's
    ``_cp``: zero-flux Neumann everywhere, or (``dirichlet``) Dirichlet
    0.1 on the lower and Neumann 0.05 on the upper face of every axis."""
    equation, n = FAMILIES_3D[family]
    mesh = module["Mesh"]([(0.0, (s - 1) * d_x) for s in shape], [d_x] * 3)
    if dirichlet:
        bcs = [
            (
                module["DirichletBoundaryCondition"](
                    lambda x, t: np.full((len(x), n), 0.1), is_static=True
                ),
                module["NeumannBoundaryCondition"](
                    lambda x, t: np.full((len(x), n), 0.05), is_static=True
                ),
            )
        ] * 3
    else:
        bcs = [
            (
                module["NeumannBoundaryCondition"](
                    lambda x, t: np.zeros((len(x), n)), is_static=True
                ),
            )
            * 2
        ] * 3
    return module["ConstrainedProblem"](equation(module), mesh, bcs)


# the four families of the 2D system kernels (K4, K5, K8): (equation,
# components)
FAMILIES_2D = {
    "wave": (lambda m: m["WaveEquation"](2, 1.5), 2),
    "burgers": (lambda m: m["BurgersEquation"](2, 100.0), 2),
    "shallow_water": (lambda m: m["ShallowWaterEquation"](0.5), 3),
    "cahn_hilliard": (lambda m: m["CahnHilliardEquation"](2), 2),
}


def system_problem(
    module, family, faces="dirichlet", shape=(17, 33), d_x=0.25
):
    """A 2D Cartesian problem of one of the system kernels' families on a
    ``shape`` grid of spacing ``d_x``. ``faces``: ``"dirichlet"`` is
    Dirichlet 0.1 on the axis-0 faces and Neumann 0.05 on the axis-1
    faces (tests/test_tiled_system.py's ``_bcs``); ``"neumann"`` Neumann
    0.05 on every face; ``"partial"`` Neumann 0.05 on component 0 alone,
    the other components unconstrained (the shallow-water example's
    faces). The default (17, 33) grid is tests/test_tiled_system.py's."""
    equation, n = FAMILIES_2D[family]
    mesh = module["Mesh"](
        [(0.0, (s - 1) * d_x) for s in shape], [d_x, d_x]
    )

    def neumann(values):
        return module["NeumannBoundaryCondition"](
            lambda x, t: np.tile(values, (len(x), 1)), is_static=True
        )

    if faces == "dirichlet":
        dirichlet = module["DirichletBoundaryCondition"](
            lambda x, t: np.full((len(x), n), 0.1), is_static=True
        )
        bcs = [(dirichlet, dirichlet), (neumann([0.05] * n),) * 2]
    elif faces == "neumann":
        bcs = [(neumann([0.05] * n),) * 2] * 2
    else:
        bcs = [(neumann([0.05] + [np.nan] * (n - 1)),) * 2] * 2
    return module["ConstrainedProblem"](equation(module), mesh, bcs)


def polar_problem(module, family, faces="neumann"):
    """A problem of one of the system kernels' families on the JAX tests'
    polar mesh (tests/test_fused_system.py ``_polar_cp``: r in [2.5, 7.5]
    at 0.25, theta in [0, 2 pi] at pi / 20, 21 x 41). ``faces``:
    ``"neumann"`` is Neumann 0.05 on every face, ``"dirichlet"``
    Dirichlet 0.1 on the r faces and Neumann 0.05 on the theta faces."""
    equation, n = FAMILIES_2D[family]
    mesh = module["Mesh"](
        [(2.5, 7.5), (0.0, 2 * np.pi)],
        [0.25, np.pi / 20.0],
        module["CoordinateSystem"].POLAR,
    )
    neumann = module["NeumannBoundaryCondition"](
        lambda x, t: np.full((len(x), n), 0.05), is_static=True
    )
    if faces == "dirichlet":
        dirichlet = module["DirichletBoundaryCondition"](
            lambda x, t: np.full((len(x), n), 0.1), is_static=True
        )
        bcs = [(dirichlet, dirichlet), (neumann, neumann)]
    else:
        bcs = [(neumann, neumann)] * 2
    return module["ConstrainedProblem"](equation(module), mesh, bcs)


def navier_stokes_problem(module, example=False):
    """The lid-driven Navier-Stokes problem of tests/test_fused_system.py
    (``_navier_stokes_cp``: Re 500 on [-1, 1] x [0, 2] at 0.125, 17 x
    17), or with ``example`` that of examples/navier_stokes_fdm.py (Re
    5000 on [-2.5, 2.5] x [0, 4] at 0.05, 101 x 81): Dirichlet w = 1 and
    psi = 0.1 on the lower axis-0 face, zero on the others, velocities
    unconstrained."""
    vectorize = module["vectorize_bc_function"]

    def dirichlet(w, psi):
        return module["DirichletBoundaryCondition"](
            vectorize(lambda x, t: [w, psi, None, None]), is_static=True
        )

    if example:
        re, mesh = 5000.0, module["Mesh"](
            [(-2.5, 2.5), (0.0, 4.0)], [0.05, 0.05]
        )
    else:
        re, mesh = 500.0, module["Mesh"](
            [(-1.0, 1.0), (0.0, 2.0)], [0.125, 0.125]
        )
    bcs = [
        (dirichlet(1.0, 0.1), dirichlet(0.0, 0.0)),
        (dirichlet(0.0, 0.0), dirichlet(0.0, 0.0)),
    ]
    return module["ConstrainedProblem"](
        module["NavierStokesEquation"](re), mesh, bcs
    )


def states_2d(shape, n, batch=None, seed=0):
    """Smooth O(1) float32 states of a 2D grid from a seed: per state and
    component, an offset and one low Fourier mode (noise would make the
    shallow-water system blow up within the tests' horizons)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, np.pi, shape[0])[:, None]
    y = np.linspace(0.0, np.pi, shape[1])[None, :]
    count = 1 if batch is None else batch
    states = np.empty((count,) + tuple(shape) + (n,))
    for index in np.ndindex(count, n):
        offset, amplitude = rng.uniform(-0.3, 0.3), rng.uniform(0.2, 0.6)
        k, m = rng.integers(1, 4, 2)
        states[index[0], ..., index[1]] = offset + amplitude * np.sin(
            k * x
        ) * np.cos(m * y)
    states = states.astype(np.float32)
    return states[0] if batch is None else states


def states_3d(shape, n, batch=None, seed=0):
    """O(1) float32 states of a 3D grid from a seed."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return rng.uniform(-1.0, 1.0, lead + tuple(shape) + (n,)).astype(
        np.float32
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_cuda_kernels_match_plain_versions(problem, cuda_device):
    ivp = PROBLEMS[problem](vars(torch_pkg))
    cfg = fused_diffusion._KernelConfig(ivp.constrained_problem, 1e-3)
    y = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True)[..., 0],
        dtype=torch.float32,
        device=cuda_device,
    )
    ys = torch.stack([y * (0.5 + 0.25 * i) + 0.1 * i for i in range(4)])
    launches = fused_diffusion.fused_diffusion_rk4_end.launches
    checks = [
        (
            fused_diffusion.fused_diffusion_rk4_trajectory(ys, cfg, 200),
            fused_diffusion.fused_diffusion_rk4_trajectory_reference(
                ys, cfg, 200
            ),
        ),
        (
            fused_diffusion.fused_diffusion_rk4_end(y, cfg, 200),
            fused_diffusion.fused_diffusion_rk4_end_reference(y, cfg, 200),
        ),
        (
            fused_diffusion.fused_diffusion_rk4_step(ys, cfg),
            fused_diffusion.fused_diffusion_rk4_step_reference(ys, cfg),
        ),
    ]
    torch.cuda.synchronize()
    assert fused_diffusion.fused_diffusion_rk4_end.launches == launches + 1
    for kernel, plain in checks:
        assert kernel.shape == plain.shape
        scale = float(plain.abs().max())
        assert float((kernel - plain).abs().max()) <= KERNEL_TOL * scale


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    ivp = PROBLEMS["flagship"](vars(torch_pkg))
    cfg = fused_diffusion._KernelConfig(ivp.constrained_problem, 1e-3)
    y = torch.zeros((21, 21), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        fused_diffusion.fused_diffusion_rk4_end(y, cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_diffusion.fused_diffusion_rk4_end(
            torch.zeros(
                (21, 42), dtype=torch.float32, device=cuda_device
            )[:, ::2],
            cfg,
            2,
        )


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(fused_diffusion._MEASURED_PLANS))
@pytest.mark.parametrize("convection", [False, True])
def test_cuda_every_k1_table_plan_matches_plain_version(
    key, convection, cuda_device
):
    """Each plan of K1-K3's measured table on its own grid (Dirichlet
    rows, Neumann columns with a flux, with and without convection): the
    trajectory, the end (single and B = 3) and the step against the plain
    versions, to KERNEL_TOL of max|y| (0.0 is expected)."""
    height, width, _ = key
    plan = fused_diffusion._MEASURED_PLANS[key]
    cp = large_grid_problem(
        vars(torch_pkg),
        0.25 * (height - 1),
        0.25 * (width - 1),
        0.25,
        convection,
        0.2,
    )
    cfg = fused_diffusion._KernelConfig(cp, 1e-3)
    ys = torch.as_tensor(
        states_2d((height, width), 1, batch=3)[..., 0] + 1.0,
        device=cuda_device,
    ).contiguous()
    checks = [
        (
            fused_diffusion.fused_diffusion_rk4_trajectory(
                ys[0], cfg, 50, plan=plan
            ),
            fused_diffusion.fused_diffusion_rk4_trajectory_reference(
                ys[0], cfg, 50
            ),
        ),
        (
            fused_diffusion.fused_diffusion_rk4_end(ys, cfg, 50, plan=plan),
            fused_diffusion.fused_diffusion_rk4_end_reference(ys, cfg, 50),
        ),
        (
            fused_diffusion.fused_diffusion_rk4_step(ys, cfg, plan=plan),
            fused_diffusion.fused_diffusion_rk4_step_reference(ys, cfg),
        ),
    ]
    torch.cuda.synchronize()
    for kernel, plain in checks:
        assert kernel.shape == plain.shape
        scale = float(plain.abs().max())
        assert float((kernel - plain).abs().max()) <= KERNEL_TOL * scale


@pytest.mark.cuda
def test_cuda_k1_plan_the_card_cannot_place_raises_before_any_launch(
    cuda_device,
):
    """Plans the card cannot place (2,048 threads; strips on a grid wider
    than a warp; shared bytes that do not match the layout) are refused
    before any launch: by the wrappers, and by the CUDA side when handed
    to it directly (the output stays as it was, no count moves). Every
    built instance holds 1,024 threads without a spill, as
    tests/test_torch_fused_diffusion.py records, and the wrappers' own
    plan then runs."""
    cp = large_grid_problem(vars(torch_pkg), 12.5, 12.5, 0.25, True, 0.2)
    cfg = fused_diffusion._KernelConfig(cp, 1e-3)
    y = torch.ones((1, 51, 51), dtype=torch.float32, device=cuda_device)
    out = torch.full_like(y, 7.0)
    launches = fused_diffusion.fused_diffusion_rk4_end.launches
    for plan in (
        fused_diffusion.K1Plan("cells", 2048, cells=2),
        fused_diffusion.K1Plan("strips", 32 * 51),
    ):
        assert not plan.covers(51, 51)
        with pytest.raises(ValueError, match="does not cover"):
            fused_diffusion.fused_diffusion_rk4_end(y, cfg, 2, plan=plan)
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_diffusion._launch(y, out, cfg, 2, False, plan)
    # a plan that covers the grid, with the other layout's shared bytes
    cfg._arguments[fused_diffusion.K1Plan("cells", 1024, cells=4)] = (
        0, 1024, 4, 4 * 2 * 32 * 51
    )
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_diffusion._launch(
            y, out, cfg, 2, False, fused_diffusion.K1Plan("cells", 1024, 4)
        )
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert fused_diffusion.fused_diffusion_rk4_end.launches == launches
    for cells in fused_diffusion.CELLS_INSTANCES + (0,):
        layout = "cells" if cells else "strips"
        for convection in (False, True):
            registers, spills, most = fused_diffusion.instance_attributes(
                layout, cells, convection
            )
            assert (registers, spills) == INSTANCE_REGISTERS[
                (layout, cells, convection)
            ]
            assert most == 1024
    end = fused_diffusion.fused_diffusion_rk4_end(y, cfg, 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(end).all())


@pytest.mark.cuda
@pytest.mark.parametrize("linear_propagator", [True, False])
def test_parareal_on_cuda_matches_cpu(linear_propagator, cuda_device):
    """The shrunken flagship Parareal (11 x 11, T = 1, 4 slices) in
    float32 on the card (kernels, cuBLAS) and on the CPU (plain
    versions, CPU matmuls)."""
    ivp = build_problem(vars(torch_pkg), 1.0, d_x=1.0)

    def solve(device):
        def fdm(d_t):
            return FDMOperator(
                RK4(),
                ThreePointCentralDifferenceMethod(),
                d_t,
                linear_propagator=linear_propagator,
                device=device,
                dtype=torch.float32,
            )

        return (
            PararealOperator(fdm(1e-2), fdm(0.25), 2.5e-3, num_time_slices=4)
            .solve(ivp)
            .discrete_y()
        )

    launches = fused_diffusion.fused_diffusion_rk4_end.launches
    on_card = solve(cuda_device)
    if not linear_propagator:
        assert fused_diffusion.fused_diffusion_rk4_end.launches > launches
    on_cpu = solve(torch.device("cpu"))
    assert on_card.shape == on_cpu.shape == (100, 11, 11, 1)
    scale = float(np.abs(on_cpu).max())
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bench", "mixed"])
def test_cuda_system_kernels_match_plain_versions(kind, cuda_device):
    """K5 (trajectory, end, step) and K4 (ends, trajectory) against their
    plain versions on the bench's Burgers problem and a mixed-BC one."""
    ivp = burgers_problem(vars(torch_pkg), kind)
    cfg = fused_system._SystemKernelConfig(ivp.constrained_problem, 2.5e-3)
    y = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=cuda_device,
    )
    ys = torch.stack([y * (0.5 + 0.25 * i) + 0.05 * i for i in range(4)])
    wrappers = (
        fused_system.fused_system_rk4_trajectory,
        fused_system.fused_system_rk4_end,
        fused_system.fused_system_rk4_step,
        packed_system.packed_system_rk4_ends,
        packed_system.packed_system_rk4_trajectory,
    )
    launches = [wrapper.launches for wrapper in wrappers]
    plain_versions = (
        fused_system.fused_system_rk4_trajectory_reference,
        fused_system.fused_system_rk4_end_reference,
        fused_system.fused_system_rk4_step_reference,
        packed_system.packed_system_rk4_ends_reference,
        packed_system.packed_system_rk4_trajectory_reference,
    )
    arguments = ((y, cfg, 200), (ys, cfg, 200), (ys, cfg), (ys, cfg, 200),
                 (ys, cfg, 200))
    checks = [
        (wrapper(*args), plain(*args))
        for wrapper, plain, args in zip(wrappers, plain_versions, arguments)
    ]
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [n + 1 for n in launches]
    for kernel, plain in checks:
        assert kernel.shape == plain.shape
        scale = float(plain.abs().max())
        assert float((kernel - plain).abs().max()) <= KERNEL_TOL * scale


@pytest.mark.cuda
def test_burgers_ml_parareal_on_cuda_matches_cpu(cuda_device):
    """The bench's Burgers problem over two slices of the committed
    quadratic coarse model (T = 4, fine d_t 2.5e-3) on the card (K4, K5,
    cuBLAS) and on the CPU (plain versions, CPU matmuls), in float32.
    The tolerance, 1e-4 of max|y|, covers the two devices' matmul
    rounding carried through the nonlinear coarse sweeps."""
    ivp = burgers_problem(vars(torch_pkg), "bench", t_end=4.0)
    arrays = load_pytree(QUAD_ASSET)

    def solve(device):
        coarse = SupervisedMLOperator(2.0, True, device=device)
        coarse.model = from_arrays(arrays)
        fine = FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 2.5e-3, device=device
        )
        return (
            PararealOperator(fine, coarse, 2.5e-3, num_time_slices=2)
            .solve(ivp)
            .discrete_y()
        )

    launches = packed_system.packed_system_rk4_ends.launches
    on_card = solve(cuda_device)
    assert packed_system.packed_system_rk4_ends.launches > launches
    on_cpu = solve(torch.device("cpu"))
    assert on_card.shape == on_cpu.shape == (1600, 21, 21, 2)
    scale = float(np.abs(on_cpu).max())
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-4 * scale


def _large_grid_state(cp, device):
    height, width = cp.mesh.vertices_shape
    x = torch.linspace(0.0, 3.0, height, device=device)[:, None]
    y = torch.linspace(0.0, 2.0, width, device=device)[None, :]
    return (1.5 + torch.sin(2.0 * x) * torch.cos(3.0 * y)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("problem", sorted(LARGE_GRID_PROBLEMS))
def test_cuda_resident_kernel_matches_plain_version(problem, cuda_device):
    """K7 against its plain version, with float32 and bfloat16 frames, on
    its own tile plan and on 8 x 8 tiles with one barrier per step and
    per three steps, and for a batch."""
    cp = large_grid_problem(vars(torch_pkg), *LARGE_GRID_PROBLEMS[problem])
    cfg = tiled_diffusion._HornerConfig(cp, 0.005, resident=True)
    y = _large_grid_state(cp, cuda_device)
    height, width = cp.mesh.vertices_shape
    # 8 x 8 tiles with a barrier every step and every third step (23
    # steps: the last group is cut short)
    tiles = (-(-height // 8), -(-width // 8), 8, 8)
    plans = (
        None,
        resident_diffusion._ResidentPlan(*tiles, 1),
        resident_diffusion._ResidentPlan(*tiles, 3),
    )
    wrapper = resident_diffusion.resident_diffusion_rk4_trajectory
    launches = wrapper.launches
    for storage in (torch.float32, torch.bfloat16):
        plain = resident_diffusion.resident_diffusion_rk4_trajectory_reference(
            y, cfg, 23, storage
        )
        for plan in plans:
            kernel = wrapper(y, cfg, 23, storage, plan=plan)
            torch.cuda.synchronize()
            assert kernel.dtype == storage and kernel.shape == plain.shape
            # the same float32 operations in the same order, the same
            # roundings to bfloat16
            assert torch.equal(kernel, plain)
    ys = torch.stack([y, y * 0.5 + 1.0])
    assert torch.equal(
        wrapper(ys, cfg, 8),
        resident_diffusion.resident_diffusion_rk4_trajectory_reference(
            ys, cfg, 8
        ),
    )
    assert wrapper.launches == launches + 7


@pytest.mark.cuda
@pytest.mark.parametrize("temporal_block", [1, 2, 4])
@pytest.mark.parametrize("problem", sorted(LARGE_GRID_PROBLEMS))
def test_cuda_tiled_kernel_matches_plain_version(
    problem, temporal_block, cuda_device
):
    """K6 against its plain version at temporal blocks 1, 2 and 4, with
    float32 and bfloat16 states and frames, on its own tile plan (one or
    two tiles) and on small tiles (many, the last ones overhanging)."""
    cp = large_grid_problem(vars(torch_pkg), *LARGE_GRID_PROBLEMS[problem])
    cfg = tiled_diffusion._HornerConfig(cp, 0.005)
    y = _large_grid_state(cp, cuda_device)
    height, width = cp.mesh.vertices_shape
    # tiles of max(12, halo) x max(20, halo) cells
    small = tiled_diffusion.make_tile_plan(
        height,
        width,
        temporal_block,
        8 * temporal_block + max(12, 4 * temporal_block),
        8 * temporal_block + max(20, 4 * temporal_block),
    )
    assert small is not None
    dtypes = [(None, None), (torch.bfloat16, None)]
    if temporal_block > 1:
        dtypes += [(None, torch.bfloat16), (torch.bfloat16, torch.float32)]
    wrapper = tiled_diffusion.tiled_diffusion_rk4_trajectory
    launches = wrapper.launches
    for storage, traj in dtypes:
        plain = tiled_diffusion.tiled_diffusion_rk4_trajectory_reference(
            y, cfg, 16, storage, traj, temporal_block
        )
        for plan in (None, small):
            kernel = wrapper(
                y, cfg, 16, storage, traj, temporal_block, plan=plan
            )
            torch.cuda.synchronize()
            assert kernel.dtype == plain.dtype
            assert torch.equal(kernel, plain)
    assert wrapper.launches == launches + 2 * len(dtypes)


@pytest.mark.cuda
def test_cuda_large_grid_kernels_agree_and_raise(cuda_device):
    """K6 against K7 on one grid (they share the arithmetic up to the
    rounding of the folded coefficients: 1e-5 of the largest value after
    50 steps), the resident kernel's refusal of a grid of blocks the card
    cannot hold at once, and the wrappers' input checks."""
    cp = large_grid_problem(vars(torch_pkg), 10.0, 10.0, 10.0 / 160.0)
    y = _large_grid_state(cp, cuda_device)
    tiled = tiled_diffusion.tiled_diffusion_rk4_trajectory(
        y, tiled_diffusion._HornerConfig(cp, 2e-3), 50
    )
    cfg = tiled_diffusion._HornerConfig(cp, 2e-3, resident=True)
    resident = resident_diffusion.resident_diffusion_rk4_trajectory(y, cfg, 50)
    torch.cuda.synchronize()
    scale = float(resident.abs().max())
    assert float((tiled - resident).abs().max()) <= KERNEL_TOL * scale
    # 41 x 41 blocks of 384 threads: more than the card holds at once
    # (at most 2,048 threads an SM), so the cooperative launch is refused
    with pytest.raises(RuntimeError, match="resident diffusion kernel"):
        resident_diffusion.resident_diffusion_rk4_trajectory(
            y, cfg, 2, plan=resident_diffusion._ResidentPlan(41, 41, 4, 4)
        )
    with pytest.raises(TypeError, match="float32"):
        resident_diffusion.resident_diffusion_rk4_trajectory(
            y.double(), cfg, 2
        )
    with pytest.raises(ValueError, match="contiguous"):
        tiled_diffusion.tiled_diffusion_rk4_trajectory(
            torch.zeros((161, 322), device=cuda_device)[:, ::2], cfg, 2
        )


@pytest.mark.cuda
@pytest.mark.parametrize("dirichlet", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES_3D))
def test_cuda_3d_kernels_match_plain_versions(family, dirichlet, cuda_device):
    """K9 (trajectory, single and batched end, step) against its plain
    version on a 17 x 7 x 9 volume at every forced cluster size (1 to 16
    blocks: slabs of one and two planes at 16, so that both axis-0
    neighbours of a plane may lie in other blocks' shared memory), each
    with every cells-a-thread instance that takes it (in registers and in
    device memory)."""
    shape = (17, 7, 9)
    cp = problem_3d(vars(torch_pkg), family, dirichlet, shape)
    cfg = fused_system_3d._SystemKernelConfig3D(cp, 1e-3)
    n = cfg.n
    y = torch.as_tensor(states_3d(shape, n), device=cuda_device)
    ys = torch.as_tensor(
        states_3d(shape, n, batch=3, seed=1), device=cuda_device
    )
    wrappers = (
        fused_system_3d.fused_system_3d_rk4_trajectory,
        fused_system_3d.fused_system_3d_rk4_end,
        fused_system_3d.fused_system_3d_rk4_step,
    )
    launches = [wrapper.launches for wrapper in wrappers]
    plain = (
        fused_system_3d.fused_system_3d_rk4_trajectory_reference(y, cfg, 20),
        fused_system_3d.fused_system_3d_rk4_end_reference(y, cfg, 20),
        fused_system_3d.fused_system_3d_rk4_end_reference(ys, cfg, 20),
        fused_system_3d.fused_system_3d_rk4_step_reference(ys, cfg),
    )
    plans = [
        plan
        for size in fused_system_3d.CLUSTER_SIZES
        for plan in (
            fused_system_3d.cluster_plan_3d(
                *shape, n, size, cells, step=cfg.step_kind
            )
            for cells in fused_system_3d.CELLS
        )
        if plan.fits
    ]
    assert {plan.cluster_size for plan in plans} == set(
        fused_system_3d.CLUSTER_SIZES
    )
    assert {plan.cells for plan in plans} == set(fused_system_3d.CELLS)
    for plan in plans:
        kernels = (
            wrappers[0](y, cfg, 20, plan=plan),
            wrappers[1](y, cfg, 20, plan=plan),
            wrappers[1](ys, cfg, 20, plan=plan),
            wrappers[2](ys, cfg, plan=plan),
        )
        torch.cuda.synchronize()
        for kernel, expected in zip(kernels, plain):
            assert kernel.shape == expected.shape
            scale = float(expected.abs().max())
            assert float((kernel - expected).abs().max()) <= KERNEL_TOL * scale
    # the test-only cluster_size override takes the same route
    forced = wrappers[1](ys, cfg, 20, cluster_size=16)
    torch.cuda.synchronize()
    assert float((forced - plain[2]).abs().max()) <= KERNEL_TOL * float(
        plain[2].abs().max()
    )
    assert [w.launches for w in wrappers] == [
        launches[0] + len(plans),
        launches[1] + 2 * len(plans) + 1,
        launches[2] + len(plans),
    ]


@pytest.mark.cuda
def test_cuda_3d_kernel_at_the_largest_three_component_cube(cuda_device):
    """The largest cube of three components the JAX package's cap admits,
    48^3 (its cells in device memory on 16 blocks), over a few steps of
    the trajectory and the end against the plain version."""
    shape = (48, 48, 48)
    cp = problem_3d(vars(torch_pkg), "burgers", True, shape, d_x=0.25)
    assert fused_system_3d.fused_system_3d_step_applicable(cp, RK4())
    cfg = fused_system_3d._SystemKernelConfig3D(cp, 1e-3)
    assert cfg.plan.cells == 0
    y = torch.as_tensor(states_3d(shape, 3), device=cuda_device)
    expected = fused_system_3d.fused_system_3d_rk4_trajectory_reference(
        y, cfg, 3
    )
    for kernel, plain in (
        (fused_system_3d.fused_system_3d_rk4_trajectory(y, cfg, 3), expected),
        (fused_system_3d.fused_system_3d_rk4_end(y, cfg, 3), expected[-1]),
    ):
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape
        scale = float(plain.abs().max())
        assert float((kernel - plain).abs().max()) <= KERNEL_TOL * scale


@pytest.mark.cuda
def test_cuda_3d_kernel_raises_instead_of_falling_back(cuda_device):
    """A cluster whose blocks' slabs exceed a block's shared memory (one
    block for all 31 planes of 31^3 x 3) is refused by the host code
    before any launch, and the wrappers reject what the kernel does not
    take."""
    cp = problem_3d(vars(torch_pkg), "burgers", shape=(31, 31, 31), d_x=0.25)
    cfg = fused_system_3d._SystemKernelConfig3D(cp, 1e-2)
    assert cfg.plan.cluster_size > 1
    y = torch.as_tensor(states_3d((31, 31, 31), 3), device=cuda_device)
    launches = fused_system_3d.fused_system_3d_rk4_end.launches
    with pytest.raises(RuntimeError, match="fused 3D kernel launch failed"):
        fused_system_3d.fused_system_3d_rk4_end(y, cfg, 2, cluster_size=1)
    assert fused_system_3d.fused_system_3d_rk4_end.launches == launches
    with pytest.raises(TypeError, match="float32"):
        fused_system_3d.fused_system_3d_rk4_end(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_system_3d.fused_system_3d_rk4_end(
            torch.zeros((31, 31, 31, 6), device=cuda_device)[..., ::2],
            cfg,
            2,
        )
    # the plan's own cluster runs
    end = fused_system_3d.fused_system_3d_rk4_end(y, cfg, 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(end).all())


def _assert_matches(kernel, expected):
    torch.cuda.synchronize()
    assert kernel.shape == expected.shape and kernel.dtype == expected.dtype
    kernel, expected = kernel.float(), expected.float()
    scale = float(expected.abs().max())
    assert float((kernel - expected).abs().max()) <= KERNEL_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("faces", ["dirichlet", "partial"])
@pytest.mark.parametrize("family", sorted(FAMILIES_2D))
def test_cuda_tiled_system_kernel_matches_plain_version(
    family, faces, cuda_device
):
    """K8 against its plain version on a 17 x 33 grid, float32 and
    bfloat16 storage, a batch of two, on the plan's tiles (12 x 32, 8 x
    32 for Cahn-Hilliard; the last row and column of tiles clamped) and on tiles three by five
    cells inside their halo (many tiles, the last ones clamped)."""
    cp = system_problem(vars(torch_pkg), family, faces)
    cfg = tiled_system._TiledSystemConfig(cp, 2e-3)
    ys = torch.as_tensor(
        states_2d((17, 33), cfg.n, batch=2), device=cuda_device
    )
    small = cfg.plan._replace(rows=2 * cfg.halo + 3, cols=2 * cfg.halo + 5)
    launches = tiled_system.tiled_system_rk4_trajectory.launches
    for storage_dtype in (torch.float32, torch.bfloat16):
        expected = tiled_system.tiled_system_rk4_trajectory_reference(
            ys, cfg, 12, storage_dtype
        )
        for plan in (None, small):
            _assert_matches(
                tiled_system.tiled_system_rk4_trajectory(
                    ys, cfg, 12, storage_dtype, plan=plan
                ),
                expected,
            )
    assert tiled_system.tiled_system_rk4_trajectory.launches == launches + 4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "family, faces, shape",
    [
        ("wave", "dirichlet", (21, 23)),
        ("shallow_water", "partial", (21, 23)),
        ("cahn_hilliard", "neumann", (21, 23)),
        # past the block's 1,024 threads: most threads advance two cells
        ("cahn_hilliard", "neumann", (41, 41)),
        ("shallow_water", "partial", (31, 37)),
    ],
)
def test_cuda_new_system_families_match_plain_versions(
    family, faces, shape, cuda_device
):
    """K5 (trajectory, end, step) and K4 (B = 4 ends and trajectory) for
    the wave, shallow-water and Cahn-Hilliard functors against their plain
    versions over 200 steps, on a 21 x 23 grid (a thread a cell) and on
    grids of more cells than a block has threads."""
    cp = system_problem(vars(torch_pkg), family, faces, shape)
    cfg = fused_system._SystemKernelConfig(cp, 1e-3)
    y = torch.as_tensor(states_2d(shape, cfg.n), device=cuda_device)
    ys = torch.as_tensor(
        states_2d(shape, cfg.n, batch=4, seed=1), device=cuda_device
    )
    checks = (
        (fused_system.fused_system_rk4_trajectory, (y, cfg, 200)),
        (fused_system.fused_system_rk4_end, (ys, cfg, 200)),
        (fused_system.fused_system_rk4_step, (ys, cfg)),
        (packed_system.packed_system_rk4_ends, (ys, cfg, 200)),
        (packed_system.packed_system_rk4_trajectory, (ys, cfg, 200)),
    )
    for wrapper, args in checks:
        module = packed_system if wrapper.__name__.startswith("packed") else (
            fused_system
        )
        plain = getattr(module, f"{wrapper.__name__}_reference")
        _assert_matches(wrapper(*args), plain(*args))


@pytest.mark.cuda
def test_cuda_tiled_system_raises_instead_of_falling_back(cuda_device):
    """A tile plan whose halo is too narrow for RK4, or that belongs to
    another grid, is refused before any launch; so is a grid past one CTA
    with interior Dirichlet constraints, at build time."""
    cp = system_problem(vars(torch_pkg), "burgers", "dirichlet")
    cfg = tiled_system._TiledSystemConfig(cp, 1e-3)
    y = torch.as_tensor(states_2d((17, 33), 2), device=cuda_device)
    launches = tiled_system.tiled_system_rk4_trajectory.launches
    for plan in (
        cfg.plan._replace(halo=1),
        tiled_system.make_system_tile_plan(17, 35, 2),
    ):
        with pytest.raises(ValueError, match="tile plan"):
            tiled_system.tiled_system_rk4_trajectory(y, cfg, 2, plan=plan)
    assert tiled_system.tiled_system_rk4_trajectory.launches == launches
    with pytest.raises(TypeError, match="float32"):
        tiled_system.tiled_system_rk4_trajectory(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_system.tiled_system_rk4_trajectory(
            torch.zeros((17, 33, 4), device=cuda_device)[..., ::2], cfg, 2
        )


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES_2D))
def test_cuda_polar_system_kernels_match_plain_versions(family, cuda_device):
    """Polar K5 (trajectory, B = 4 end, step over 200 steps) and polar K8
    (a batch of two, float32 and bfloat16 storage, on its plan's tiles and
    on small ones) against their plain versions on the JAX tests' 21 x 41
    polar mesh, with Dirichlet r faces, and polar K8 against polar K5:
    the same operations in the same order, so the same frames."""
    cp = polar_problem(vars(torch_pkg), family, "dirichlet")
    shape = cp.mesh.vertices_shape
    cfg = fused_system._SystemKernelConfig(cp, 1e-3)
    y = torch.as_tensor(states_2d(shape, cfg.n), device=cuda_device)
    ys = torch.as_tensor(
        states_2d(shape, cfg.n, batch=4, seed=1), device=cuda_device
    )
    for wrapper, args in (
        (fused_system.fused_system_rk4_trajectory, (y, cfg, 200)),
        (fused_system.fused_system_rk4_end, (ys, cfg, 200)),
        (fused_system.fused_system_rk4_step, (ys, cfg)),
    ):
        plain = getattr(fused_system, f"{wrapper.__name__}_reference")
        _assert_matches(wrapper(*args), plain(*args))
    tcfg = tiled_system._TiledSystemConfig(cp, 1e-3)
    pair = ys[:2].contiguous()
    small = tcfg.plan._replace(
        rows=2 * tcfg.halo + 3, cols=2 * tcfg.halo + 5
    )
    for storage_dtype in (torch.float32, torch.bfloat16):
        expected = tiled_system.tiled_system_rk4_trajectory_reference(
            pair, tcfg, 12, storage_dtype
        )
        for plan in (None, small):
            _assert_matches(
                tiled_system.tiled_system_rk4_trajectory(
                    pair, tcfg, 12, storage_dtype, plan=plan
                ),
                expected,
            )
    k5 = fused_system.fused_system_rk4_trajectory(pair, cfg, 12)
    k8 = tiled_system.tiled_system_rk4_trajectory(pair, tcfg, 12)
    _assert_matches(k8, k5)


@pytest.mark.cuda
def test_cuda_k4_trajectory_rounds_frames_to_bfloat16(cuda_device):
    """K4's trajectory with bfloat16 frames against its plain version: each
    frame the float32 frame rounded once, returned in float32."""
    cp = system_problem(vars(torch_pkg), "burgers", "dirichlet", (21, 23))
    cfg = fused_system._SystemKernelConfig(cp, 1e-3)
    ys = torch.as_tensor(
        states_2d((21, 23), 2, batch=4, seed=2), device=cuda_device
    )
    rounded = packed_system.packed_system_rk4_trajectory(
        ys, cfg, 200, torch.bfloat16
    )
    _assert_matches(
        rounded,
        packed_system.packed_system_rk4_trajectory_reference(
            ys, cfg, 200, torch.bfloat16
        ),
    )
    exact = packed_system.packed_system_rk4_trajectory(ys, cfg, 200)
    assert torch.equal(rounded, exact.to(torch.bfloat16).float())


def _navier_stokes_states(shape, batch=None, seed=0):
    """O(1) four-component float32 states from a seed."""
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, lead + tuple(shape) + (4,)).astype(
        np.float32
    )


def _navier_stokes_plans(height, width):
    """Every plan the kernel takes on an H x W grid: each cluster size
    whose blocks an instance covers with groups of one sweep, at every
    group it admits and every instance's cells that cover its blocks and
    fit, and the measured plans."""
    ns = fused_navier_stokes
    plans = [
        ns.cluster_plan_2d(height, width, size, group=group, cells=cells)
        for size in ns.CLUSTER_SIZES
        if size <= height and ns.cluster_plan_2d(height, width, size, 1).fits
        for group in ns.GROUP_SIZES
        for cells in ns.CELLS_INSTANCES
    ]
    plans += [
        ns.make_cluster_plan_2d(height, width, batch)
        for (h, w, batch) in ns._MEASURED_PLANS
        if (h, w) == (height, width)
    ]
    return [plan for plan in dict.fromkeys(plans) if plan.fits]


@pytest.mark.cuda
@pytest.mark.parametrize("example", [False, True])
def test_cuda_navier_stokes_kernel_matches_plain_version(
    example, cuda_device
):
    """The Navier-Stokes kernel (trajectory, B = 4 end, step) against its
    plain version on the JAX tests' 17 x 17 problem and the example's
    101 x 81 on every plan it takes: every cluster size whose blocks an
    instance covers (1 to 8 blocks at 17 x 17, 2 to 8 at 101 x 81) at
    every group of sweeps it admits and fits (groups of one included),
    every instance's cells that cover its blocks (one, three or ten
    cells a thread; 101 x 81 has no block of at most 1,024 cells) and the
    measured plans, over 30 steps that include the first step's long
    solve; 0.0 apart, with the same Jacobi sweeps in both."""
    cp = navier_stokes_problem(vars(torch_pkg), example)
    ns = fused_navier_stokes
    cfg = ns._NavierStokesConfig(cp, 0.05)
    shape = (cfg.height, cfg.width)
    y = torch.as_tensor(_navier_stokes_states(shape), device=cuda_device)
    ys = torch.as_tensor(
        _navier_stokes_states(shape, batch=4, seed=1), device=cuda_device
    )
    steps = 30
    plain = (
        ns.fused_navier_stokes_rk4_trajectory_reference(y, cfg, steps),
        ns.fused_navier_stokes_rk4_end_reference(ys, cfg, steps),
        ns.fused_navier_stokes_rk4_step_reference(ys, cfg),
    )
    wrappers = (
        ns.fused_navier_stokes_rk4_trajectory,
        ns.fused_navier_stokes_rk4_end,
        ns.fused_navier_stokes_rk4_step,
    )
    plans = _navier_stokes_plans(*shape)
    sizes = sorted({plan.cluster_size for plan in plans})
    assert sizes == ([1, 2, 4, 8] if not example else [2, 4, 8])
    assert {plan.group for plan in plans} == set(ns.GROUP_SIZES)
    assert {plan.block_cells for plan in plans} == (
        set(ns.CELLS_INSTANCES) - ({1} if example else set())
    )
    for plan in plans:
        for wrapper, args, (expected, sweeps) in zip(
            wrappers, ((y, cfg, steps), (ys, cfg, steps), (ys, cfg)), plain
        ):
            launches = wrapper.launches
            kernel = wrapper(*args, plan=plan)
            torch.cuda.synchronize()
            assert kernel.shape == expected.shape, plan
            assert torch.equal(kernel, expected), plan
            assert wrapper.launches == launches + 1
            assert torch.equal(wrapper.sweeps, sweeps), plan


@pytest.mark.cuda
def test_cuda_navier_stokes_kernel_raises_instead_of_falling_back(
    cuda_device,
):
    """One block for the whole 101 x 81 grid (8,181 cells, more than any
    instance's threads and cells hold), 2,048 threads a block, a block's
    1,539 cells on 512 threads of three cells, more threads than the
    three-cell instance takes and four cells a thread (no instance) are
    launches the kernel does not take: its host code refuses each before
    any launch. Two blocks of 51 rows with groups of 8 on 512 threads of
    ten cells cover every block but need more shared memory than a block
    has: the card refuses them, before any launch too. A group of more sweeps than a block has rows is refused on
    the host. The wrappers reject what the kernel does not take. Every
    built instance holds its most threads without a spill, as
    ``INSTANCE_REGISTERS`` records."""
    ns = fused_navier_stokes
    cp = navier_stokes_problem(vars(torch_pkg), example=True)
    cfg = ns._NavierStokesConfig(cp, 0.05)
    assert cfg.plan == ns.make_cluster_plan_2d(101, 81)
    y = torch.as_tensor(
        _navier_stokes_states((101, 81)), device=cuda_device
    )
    launches = ns.fused_navier_stokes_rk4_end.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ns.fused_navier_stokes_rk4_end(y, cfg, 2, cluster_size=1)
    # one block with groups of 8
    with pytest.raises(RuntimeError, match="launch failed"):
        ns.fused_navier_stokes_rk4_end(
            y, cfg, 2, plan=ns.ClusterPlan2D(1, 101, 81, 8)
        )
    # and plans the kernel does not take, refused on the host
    with pytest.raises(ValueError, match="fewest rows"):
        ns.fused_navier_stokes_rk4_end(
            y, cfg, 2, plan=ns.ClusterPlan2D(8, 101, 81, 16)
        )
    for threads, cells in ((2048, 0), (512, 3), (800, 3), (416, 4)):
        plan = ns.ClusterPlan2D(8, 101, 81, 4, threads, cells)
        assert not plan.covers, plan
        with pytest.raises(RuntimeError, match="launch failed"):
            ns.fused_navier_stokes_rk4_end(y, cfg, 2, plan=plan)
    # threads and cells that cover the blocks, slabs that do not fit a
    # block's shared memory: refused by the card, not by the coverage check
    plan = ns.ClusterPlan2D(2, 101, 81, 8, 512, 10)
    assert plan.covers and plan.admitted, plan
    assert plan.shared_bytes > ns.MAX_SHARED_MEMORY_BYTES, plan
    with pytest.raises(RuntimeError, match="launch failed"):
        ns.fused_navier_stokes_rk4_end(y, cfg, 2, plan=plan)
    for group in ns.GROUP_SIZES:
        for cells, most in ns.CELLS_INSTANCES.items():
            registers, spills, threads = ns.instance_attributes(group, cells)
            assert (registers, spills) == INSTANCE_REGISTERS[
                ("navier_stokes", group, cells)
            ]
            assert threads == most
    assert ns.fused_navier_stokes_rk4_end.launches == launches
    with pytest.raises(TypeError, match="float32"):
        ns.fused_navier_stokes_rk4_end(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ns.fused_navier_stokes_rk4_end(
            torch.zeros((101, 81, 8), device=cuda_device)[..., ::2], cfg, 2
        )
    # the plan's own cluster runs
    end = ns.fused_navier_stokes_rk4_end(y, cfg, 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(end).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "family, faces, shape",
    [
        ("burgers", "dirichlet", (21, 21)),
        ("wave", "partial", (21, 23)),
        ("shallow_water", "partial", (36, 51)),
        ("cahn_hilliard", "neumann", (41, 41)),
        # past 2,048 cells: a cluster takes it
        ("shallow_water", "dirichlet", (60, 60)),
        ("burgers", "neumann", (64, 64)),
    ],
)
def test_cuda_k5_equals_its_plain_version_on_every_cluster(
    family, faces, shape, cuda_device
):
    """The redesigned K5 (cells owned by threads, kind by kind; the state
    in registers; two stage buffers) and K4, on one block (where the grid
    fits it) and on clusters of 2, 4 and 8 blocks, against their plain
    versions over 50 steps: equal, bit for bit (the same float32
    operations in the same order, built without contraction)."""
    cp = system_problem(vars(torch_pkg), family, faces, shape)
    cfg = fused_system._SystemKernelConfig(cp, 1e-3)
    ys = torch.as_tensor(
        states_2d(shape, cfg.n, batch=2), device=cuda_device
    )
    expected = fused_system.fused_system_rk4_trajectory_reference(ys, cfg, 50)
    sizes = [
        size
        for size in (1, 2, 4, 8)
        if (fused_system._block_cells(*shape, size) or 1 << 30) <= 2048
    ]
    assert fused_system.k5_cluster_size(cfg) in sizes
    for size in sizes:
        out = torch.empty_like(expected)
        fused_system.launch(ys, out, cfg, 50, True, cluster_size=size)
        torch.cuda.synchronize()
        assert torch.equal(out, expected), size
    assert torch.equal(
        fused_system.fused_system_rk4_end(ys, cfg, 50), expected[:, -1]
    )
    if cfg.polar or not fused_system.fits_one_block(cp):
        return
    assert torch.equal(
        packed_system.packed_system_rk4_ends(ys, cfg, 50), expected[:, -1]
    )


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES_2D))
def test_cuda_k8_end_matches_plain_version(family, cuda_device):
    """K8's end mode, Cartesian (a 101 x 101 grid past one CTA) and polar
    (the JAX tests' 21 x 41 mesh on small tiles), single and batched,
    against its plain version (1e-5 of the largest value) and equal to
    the K8 trajectory's last frame; a plan that does not fit is refused
    before any launch."""
    cp = system_problem(vars(torch_pkg), family, "dirichlet", (101, 101))
    cfg = tiled_system._TiledSystemConfig(cp, 1e-3)
    ys = torch.as_tensor(
        states_2d((101, 101), cfg.n, batch=3), device=cuda_device
    )
    launches = tiled_system.tiled_system_rk4_end.launches
    end = tiled_system.tiled_system_rk4_end(ys, cfg, 21)
    _assert_matches(
        end, tiled_system.tiled_system_rk4_end_reference(ys, cfg, 21)
    )
    assert torch.equal(
        end, tiled_system.tiled_system_rk4_trajectory(ys, cfg, 21)[:, -1]
    )
    assert torch.equal(tiled_system.tiled_system_rk4_end(ys[1], cfg, 21), end[1])
    assert tiled_system.tiled_system_rk4_end.launches == launches + 2
    with pytest.raises(ValueError, match="tile plan"):
        tiled_system.tiled_system_rk4_end(
            ys, cfg, 2, plan=cfg.plan._replace(halo=0)
        )
    assert tiled_system.tiled_system_rk4_end.launches == launches + 2
    polar = polar_problem(vars(torch_pkg), family, "dirichlet")
    cfg = tiled_system._TiledSystemConfig(polar, 1e-3)
    shape = polar.mesh.vertices_shape
    ys = torch.as_tensor(states_2d(shape, cfg.n, batch=2), device=cuda_device)
    small = cfg.plan._replace(rows=2 * cfg.halo + 3, cols=2 * cfg.halo + 5)
    _assert_matches(
        tiled_system.tiled_system_rk4_end(ys, cfg, 20, plan=small),
        tiled_system.tiled_system_rk4_end_reference(ys, cfg, 20),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("problem", sorted(LARGE_GRID_PROBLEMS))
def test_cuda_resident_end_and_interior_dirichlet_match_plain_version(
    problem, cuda_device
):
    """K7's end mode against its plain version (a batch of two, and equal
    to the trajectory's last frame), and K7 with a Dirichlet square inside
    the grid (trajectory and end) against its plain version, to 1e-5 of
    the largest value."""
    from pararealml_tpu_torch.constraint import Constraint

    cp = large_grid_problem(vars(torch_pkg), *LARGE_GRID_PROBLEMS[problem])
    cfg = tiled_diffusion._HornerConfig(cp, 1e-3, resident=True)
    y = _large_grid_state(cp, cuda_device)
    ys = torch.stack([y, 0.5 * y]).contiguous()
    end = resident_diffusion.resident_diffusion_rk4_end(ys, cfg, 9)
    _assert_matches(
        end, resident_diffusion.resident_diffusion_rk4_end_reference(ys, cfg, 9)
    )
    assert torch.equal(
        end[0], resident_diffusion.resident_diffusion_rk4_trajectory(y, cfg, 9)[-1]
    )
    height, width = cp.mesh.vertices_shape
    old = cp.static_y_vertex_constraints
    mask = np.asarray(old.mask).reshape(height, width).copy()
    values = np.where(mask, np.asarray(old.values).reshape(height, width), 0.0)
    mask[height // 3: 2 * height // 3, width // 3: 2 * width // 3] = True
    values[mask & ~np.asarray(old.mask).reshape(height, width)] = 2.0
    cp._y_vertex_constraints = Constraint(
        values.reshape(np.asarray(old.values).shape),
        mask.reshape(np.asarray(old.mask).shape),
    )
    cfg = tiled_diffusion._HornerConfig(cp, 1e-3, resident=True)
    assert cfg.interior_dirichlet
    _assert_matches(
        resident_diffusion.resident_diffusion_rk4_trajectory(y, cfg, 9),
        resident_diffusion.resident_diffusion_rk4_trajectory_reference(
            y, cfg, 9
        ),
    )
    _assert_matches(
        resident_diffusion.resident_diffusion_rk4_end(ys, cfg, 9),
        resident_diffusion.resident_diffusion_rk4_end_reference(ys, cfg, 9),
    )
    with pytest.raises(ValueError, match="face"):
        tiled_diffusion.tiled_diffusion_rk4_trajectory(y, cfg, 2)


def _cluster_examples():
    """The 2D examples' problems at their own sizes (the cluster-resident
    mode's main path), and the wave example with one Dirichlet vertex
    inside the grid (the mode reads K5's dense mask)."""
    import chip_smoke
    from pararealml_tpu_torch.constraint import Constraint

    wave = chip_smoke.wave_example(torch_pkg)[0].constrained_problem
    interior = chip_smoke.wave_example(torch_pkg)[0].constrained_problem
    old = interior.static_y_vertex_constraints
    mask = np.asarray(old.mask).reshape(101, 101, 2).copy()
    values = np.where(mask, np.asarray(old.values).reshape(101, 101, 2), 0.0)
    mask[50, 50] = True
    values[50, 50] = 1.0
    interior._y_vertex_constraints = Constraint(
        values.reshape(np.asarray(old.values).shape),
        mask.reshape(np.asarray(old.mask).shape),
    )
    return {
        "wave 101^2": wave,
        "wave 101^2 interior dirichlet": interior,
        "shallow water 101 x 51": chip_smoke.shallow_water_example(
            torch_pkg
        )[0].constrained_problem,
        "cahn-hilliard 101^2": chip_smoke.cahn_hilliard_2d(
            torch, torch_pkg, 101, 5.0
        ).constrained_problem,
        "polar wave 51 x 201": chip_smoke.wave_polar_example(torch_pkg)[
            0
        ].constrained_problem,
    }


@pytest.mark.cuda
@pytest.mark.parametrize(
    "example",
    [
        "wave 101^2",
        "wave 101^2 interior dirichlet",
        "shallow water 101 x 51",
        "cahn-hilliard 101^2",
        "polar wave 51 x 201",
    ],
)
def test_cuda_cluster_mode_matches_plain_version(example, cuda_device):
    """The cluster-resident mode at the 2D examples' shapes on every plan
    its instances take (clusters of 2 to 16 blocks, each with a row, 1, 2
    or 4 cells a thread), the plan's own single-state and B = 8 choices
    among them, against its plain version (K5's) over 10 steps: equal,
    bit for bit (the same float32 operations in the same order, built
    without contraction). The end, batched and single, and bfloat16
    frames (rounded once over the float32 state) likewise."""
    cp = _cluster_examples()[example]
    assert fused_system.cluster_system_applicable(cp)
    cfg = fused_system._SystemKernelConfig(cp, 1e-3)
    shape = cp.mesh.vertices_shape
    ys = torch.as_tensor(states_2d(shape, cfg.n, batch=2), device=cuda_device)
    expected = fused_system.fused_system_rk4_trajectory_reference(ys, cfg, 10)
    plans = [
        fused_system.ClusterPlan(*shape, cfg.n, cfg.polar, size, cells)
        for size in range(2, fused_system.MAX_CLUSTER_SIZE + 1)
        for cells in fused_system._CLUSTER_CELLS
    ]
    plans = [plan for plan in plans if plan.fits]
    active = fused_system.card_active_clusters(cfg, True)
    chosen = {
        fused_system.cluster_plan(cfg, batch, None, active)
        for batch in (1, 8)
    }
    assert chosen <= set(plans)
    assert 16 in {plan.cluster_size for plan in plans}
    launches = fused_system.cluster_system_rk4_trajectory.launches
    for plan in plans:
        assert active(plan) >= 1, plan
        out = fused_system.cluster_system_rk4_trajectory(
            ys, cfg, 10, plan=plan
        )
        torch.cuda.synchronize()
        assert torch.equal(out, expected), plan
    assert fused_system.cluster_system_rk4_trajectory.launches == (
        launches + len(plans)
    )
    end = fused_system.cluster_system_rk4_end(ys, cfg, 10)
    assert torch.equal(end, expected[:, -1])
    assert torch.equal(
        fused_system.cluster_system_rk4_end(ys[1], cfg, 10), expected[1, -1]
    )
    frames = fused_system.cluster_system_rk4_trajectory(
        ys, cfg, 10, frame_dtype=torch.bfloat16
    )
    assert frames.dtype == torch.bfloat16
    assert torch.equal(frames, expected.to(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_cluster_mode_refuses_and_never_falls_back(
    cuda_device, monkeypatch
):
    """A cluster of 17 blocks, past the 16 the card places, is refused by
    the kernel's host code before any launch (the output untouched, no
    launch counted); the wrappers refuse plans the instances do not take
    and what the kernel does not take; and a CUDA state never runs the
    plain version."""
    cp = _cluster_examples()["wave 101^2"]
    cfg = fused_system._SystemKernelConfig(cp, 1e-3)
    ys = torch.as_tensor(states_2d((101, 101), 2, batch=2), device=cuda_device)
    plan = fused_system.cluster_plan(cfg)
    out = torch.full((2, 3, 101, 101, 2), float("nan"), device=cuda_device)
    launches = fused_system.cluster_system_rk4_trajectory.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_system.launch_cluster(
            ys, out, cfg, 3, True, plan._replace(cluster_size=17)
        )
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all())
    with pytest.raises(ValueError, match="does not fit"):
        fused_system.cluster_system_rk4_trajectory(
            ys, cfg, 3, plan=plan._replace(cluster_size=17)
        )
    with pytest.raises(TypeError, match="float32"):
        fused_system.cluster_system_rk4_end(ys.double(), cfg, 3)
    assert fused_system.cluster_system_rk4_trajectory.launches == launches

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA state ran the plain version")

    for name in (
        "fused_system_rk4_trajectory_reference",
        "fused_system_rk4_end_reference",
        "cluster_system_rk4_trajectory_reference",
    ):
        monkeypatch.setattr(fused_system, name, plain)
    end = fused_system.build_fused_system_rk4_end(cp, 1e-3, 3, batch=2)(ys)
    frames = fused_system.build_fused_system_rk4_trajectory(cp, 1e-3, 3)(ys)
    torch.cuda.synchronize()
    assert torch.equal(end, frames[:, -1])
    assert fused_system.cluster_system_rk4_trajectory.launches == launches + 1


def _bits(array):
    """A float64 array's bit patterns, to compare bit for bit."""
    return np.ascontiguousarray(array).view(np.uint64)


def _to_host_counts(solve):
    """``solve()`` under a CPU-only profile, and the counts of its
    ``solve.to_host`` spans."""
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            result = solve()
        return result, [
            r.counts for r in tracing.spans() if r.name == "solve.to_host"
        ]
    finally:
        tracing.clear()


@pytest.mark.cuda
def test_cuda_solution_adopts_one_page_locked_copy(cuda_device):
    """A float32 trajectory on the card reaches the ``Solution`` as one
    page-locked float64 host array, C-contiguous and bit for bit
    ``ys.to(torch.float64).cpu().numpy()``, counted once in
    ``solve.to_host``; the array outlives the device trajectory, the
    device cache and a second trajectory of the same shape (which reuses
    no live block)."""
    ivp = build_problem(vars(torch_pkg), 1.0, d_x=1.0)
    times = 0.025 * np.arange(1, 41)
    shape = (40,) + tuple(ivp.constrained_problem.y_shape(True))
    rng = np.random.default_rng(0)
    ys = torch.as_tensor(
        rng.uniform(-1.0, 1.0, shape).astype(np.float32), device=cuda_device
    )
    expected = ys.to(torch.float64).cpu().numpy()
    solution, counts = _to_host_counts(
        lambda: materialize_solution(ivp, times, ys, True, 0.025)
    )
    assert counts == [{"to_host_pinned": 1}]
    array = solution._trajectory
    assert array.dtype == np.float64 and array.flags["C_CONTIGUOUS"]
    assert isinstance(array.base, torch.Tensor) and array.base.is_pinned()
    assert np.array_equal(_bits(array), _bits(expected))

    del ys
    torch.cuda.empty_cache()
    other = materialize_solution(
        ivp, times, torch.zeros(shape, device=cuda_device), True, 0.025
    )
    assert not np.shares_memory(other._trajectory, array)
    assert np.array_equal(_bits(solution.discrete_y()), _bits(expected))
    assert not other.discrete_y().any()


@pytest.mark.cuda
def test_cuda_navier_stokes_solve_equals_the_pageable_path(
    cuda_device, monkeypatch
):
    """The example's 101 x 81 Navier-Stokes problem, 20 steps on the
    card: the solve through the page-locked copy gives the same float64
    trajectory, bit for bit, before and after a solve of another IVP,
    and as the same solve when the host refuses to lock memory and the
    trajectory takes a pageable copy (the path before the page-locked
    one), which counts no ``to_host_pinned``."""
    cp = navier_stokes_problem(vars(torch_pkg), example=True)

    def ivp(seed):
        ic = torch_pkg.DiscreteInitialCondition(
            cp, _navier_stokes_states((101, 81), seed=seed), True
        )
        return torch_pkg.InitialValueProblem(cp, (0.0, 1.0), ic)

    operator = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.05, dtype=torch.float32
    )
    first, counts = _to_host_counts(lambda: operator.solve(ivp(0)))
    assert counts == [{"to_host_pinned": 1}]
    expected = first.discrete_y()
    assert expected.shape == (20, 101, 81, 4)
    assert np.isfinite(expected).all()
    operator.solve(ivp(1))
    again = operator.solve(ivp(0))
    assert np.array_equal(_bits(again.discrete_y()), _bits(expected))

    empty = torch.empty

    def no_page_locking(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("the host cannot lock more memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_page_locking)
    pageable, counts = _to_host_counts(lambda: operator.solve(ivp(0)))
    assert counts == [{}]
    base = pageable._trajectory.base
    assert not (isinstance(base, torch.Tensor) and base.is_pinned())
    assert np.array_equal(_bits(pageable.discrete_y()), _bits(expected))
    assert np.array_equal(_bits(first.discrete_y()), _bits(expected))


def _publishing_solves():
    """The three fused trajectory kernels that publish their frames, each
    through ``FDMOperator.solve`` at its cell's widths and at least three
    pieces long: the wave example on the cluster-resident mode (100
    steps), the Navier-Stokes example (100 steps) and the flagship
    diffusion on K1 (21 x 21, 5,000 steps), with the wrapper that
    launches each."""
    import chip_smoke

    wave, wave_d_t = chip_smoke.wave_example(torch_pkg)
    cp = navier_stokes_problem(vars(torch_pkg), example=True)
    vortices = torch_pkg.DiscreteInitialCondition(
        cp, _navier_stokes_states((101, 81)), True
    )
    return {
        "wave 101^2": (
            torch_pkg.InitialValueProblem(
                wave.constrained_problem, (0.0, 1.0), wave.initial_condition
            ),
            wave_d_t,
            fused_system.cluster_system_rk4_trajectory,
        ),
        "navier-stokes 101 x 81": (
            torch_pkg.InitialValueProblem(cp, (0.0, 5.0), vortices),
            0.05,
            fused_navier_stokes.fused_navier_stokes_rk4_trajectory,
        ),
        "diffusion 21^2": (
            build_problem(vars(torch_pkg), 5.0, d_x=0.5),
            1e-3,
            fused_diffusion.fused_diffusion_rk4_trajectory,
        ),
    }


@pytest.mark.cuda
@pytest.mark.parametrize(
    "example", ["wave 101^2", "navier-stokes 101 x 81", "diffusion 21^2"]
)
def test_cuda_published_pieces_equal_the_one_copy_path(
    example, cuda_device, monkeypatch
):
    """A solve whose kernel publishes its frames crosses to the host in
    the plan's pieces while the kernel runs (one launch, the progress word
    at the last step, ``to_host_chunks`` the plan's pieces beside one
    ``to_host_pinned``), and gives the same float64 trajectory, bit for
    bit, as the one copy after the kernel and as the pageable fallback,
    which counts neither."""
    ivp, d_t, wrapper = _publishing_solves()[example]
    operator = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), d_t, dtype=torch.float32
    )
    cp = ivp.constrained_problem
    steps = round(ivp.t_interval[1] / d_t)
    chunks = trajectory_chunks(int(np.prod(cp.y_shape(True))) * 8, steps)
    assert len(chunks) >= 3
    launches = wrapper.launches
    pieces, counts = _to_host_counts(lambda: operator.solve(ivp))
    assert wrapper.launches == launches + 1
    assert counts == [{"to_host_chunks": len(chunks), "to_host_pinned": 1}]
    assert int(operator._frame_drain.word) == steps
    expected = pieces.discrete_y()
    assert expected.shape == (steps,) + tuple(cp.y_shape(True))
    assert np.isfinite(expected).all()

    monkeypatch.setattr(operator, "_frame_progress", lambda *args: None)
    whole, counts = _to_host_counts(lambda: operator.solve(ivp))
    assert counts == [{"to_host_pinned": 1}]
    assert np.array_equal(_bits(whole.discrete_y()), _bits(expected))
    monkeypatch.undo()

    empty = torch.empty

    def no_page_locking(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("the host cannot lock more memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_page_locking)
    pageable, counts = _to_host_counts(lambda: operator.solve(ivp))
    assert counts == [{}]
    assert np.array_equal(_bits(pageable.discrete_y()), _bits(expected))
    assert wrapper.launches == launches + 3


@pytest.mark.cuda
def test_cuda_batches_and_uneven_pieces_publish_nothing(cuda_device):
    """Only a trajectory of one state publishes, in pieces of a power of
    two: the wrappers refuse a batch with a progress word, and the kernels
    refuse an uneven piece, before any launch; a Parareal solve (batched
    K1 expansion) counts no pieces."""
    cp = build_problem(vars(torch_pkg), 1.0, d_x=0.5).constrained_problem
    cfg = fused_diffusion._KernelConfig(cp, 1e-3, None)
    word = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    drain = SimpleNamespace(word=word)
    y = torch.ones((2, 21, 21), device=cuda_device)
    wrapper = fused_diffusion.fused_diffusion_rk4_trajectory
    launches = wrapper.launches
    with pytest.raises(ValueError, match="2 states publishes no progress"):
        wrapper(y, cfg, 8, progress=FrameProgress(drain, [(0, 4), (4, 8)]))
    uneven = FrameProgress(drain, [(0, 3), (3, 6), (6, 8)])
    with pytest.raises(RuntimeError, match="launch failed"):
        wrapper(y[0], cfg, 8, progress=uneven)
    assert wrapper.launches == launches
    mode = fused_system._SystemKernelConfig(
        _cluster_examples()["wave 101^2"], 0.01
    )
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_system.cluster_system_rk4_trajectory(
            torch.zeros((101, 101, 2), device=cuda_device),
            mode,
            8,
            progress=uneven,
        )
    torch.cuda.synchronize()
    assert int(word) == 0

    ivp = build_problem(vars(torch_pkg), 1.0, d_x=1.0)

    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            linear_propagator=False,
            dtype=torch.float32,
        )

    parareal = PararealOperator(
        fdm(1e-3), fdm(0.25), 2.5e-3, num_time_slices=4
    )
    _, counts = _to_host_counts(lambda: parareal.solve(ivp))
    assert counts == [{"to_host_pinned": 1}]
