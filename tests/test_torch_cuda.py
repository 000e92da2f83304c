"""The PyTorch port's tests that need an NVIDIA GPU, and the problem
builders the port's tests share.

The tests here are marked ``cuda`` and skip where
``torch.cuda.is_available()`` is false: they hold each CUDA kernel
against its plain PyTorch version on the same CUDA tensors, and the
slice's Parareal on the card against the same solve on the CPU. This
file imports no JAX, so it runs on a GPU machine without JAX or the JAX
package (the suite's conftest imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion

torch.set_num_threads(1)

# float32 kernels against float32 plain versions with the same
# evaluation order: only contraction-free rounding differences remain
KERNEL_TOL = 1e-5


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
