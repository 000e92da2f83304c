"""The fused diffusion kernels' plain PyTorch versions (the CPU side of
the CUDA kernels K1-K3) held against the JAX package's Pallas kernels in
interpret mode, in float32 to atol = rtol = 1e-5 after at most 20 steps
(the two evaluate the same operations in the same order; the tolerance
covers float32 rounding of contracted or reordered operations), plus the
applicability predicate and the wrappers' CPU routing. The CUDA kernels
themselves are held against their plain versions in
tests/test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.operators.fdm import ForwardEulerMethod as JaxEuler
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from pararealml_tpu.ops import fused_diffusion as jax_fused
from pararealml_tpu_torch.operators.fdm import ForwardEulerMethod, RK4
from pararealml_tpu_torch.ops import fused_diffusion as torch_fused
from tests.test_torch_cuda import PROBLEMS

torch.set_num_threads(1)

TOL = 1e-5
D_T = 1e-3


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _problems(name):
    return (
        PROBLEMS[name](vars(jax_pkg)).constrained_problem,
        PROBLEMS[name](vars(torch_pkg)).constrained_problem,
    )


def _states(cp, batch=None, seed=0):
    """Smooth O(1) states from a seed: the problem's own Dirichlet values
    plus random Fourier modes."""
    rng = np.random.default_rng(seed)
    height, width = cp.mesh.vertices_shape
    x = np.linspace(0.0, np.pi, height)[:, None]
    y = np.linspace(0.0, np.pi, width)[None, :]
    count = 1 if batch is None else batch
    states = []
    for _ in range(count):
        a, b, c = rng.uniform(0.5, 1.5, 3)
        k, m = rng.integers(1, 4, 2)
        states.append(a * np.sin(k * x) * np.cos(m * y) + b * x / np.pi + c)
    states = np.stack(states).astype(np.float32)[..., None]
    return states[0] if batch is None else states


def _assert_close(actual, expected):
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_trajectory_reference_matches_pallas_kernel(problem, x64_off):
    jax_cp, torch_cp = _problems(problem)
    y = _states(jax_cp)
    steps = 20
    expected = jax_fused.build_fused_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True
    )(y)
    trajectory = torch_fused.build_fused_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )
    _assert_close(trajectory(torch.as_tensor(y)), expected)


def test_end_reference_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems("neumann")
    steps = 20
    y = _states(jax_cp)
    expected = jax_fused.build_fused_diffusion_rk4_end(
        jax_cp, D_T, steps, interpret=True
    )(y)
    end = torch_fused.build_fused_diffusion_rk4_end(torch_cp, D_T, steps)
    _assert_close(end(torch.as_tensor(y)), expected)


def test_batched_end_reference_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems("flagship")
    steps, batch = 20, 3
    ys = _states(jax_cp, batch=batch)
    expected = jax_fused.build_fused_diffusion_rk4_end(
        jax_cp, D_T, steps, interpret=True, batch=batch
    )(ys)
    end = torch_fused.build_fused_diffusion_rk4_end(
        torch_cp, D_T, steps, batch=batch
    )
    actual = end(torch.as_tensor(ys))
    _assert_close(actual, expected)
    # one state of the batch advances exactly as it does alone
    single = torch_fused.build_fused_diffusion_rk4_end(torch_cp, D_T, steps)
    np.testing.assert_array_equal(
        actual[1].numpy(), single(torch.as_tensor(ys[1])).numpy()
    )


def test_step_reference_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems("convection")
    y = _states(jax_cp)
    jax_step = jax_fused.build_fused_diffusion_rk4_step(
        jax_cp, D_T, interpret=True
    )
    torch_step = torch_fused.build_fused_diffusion_rk4_step(torch_cp, D_T)
    expected, actual = y, torch.as_tensor(y)
    for _ in range(3):
        expected = jax_step(expected)
        actual = torch_step(actual)
    _assert_close(actual, expected)


@pytest.mark.parametrize(
    "case", ["flagship", "neumann", "convection", "wave", "euler"]
)
def test_applicability_matches_jax(case, x64_off):
    if case == "wave":
        cps = []
        for module in (jax_pkg, torch_pkg):
            mesh = module.Mesh([(0.0, 1.0)], [0.5])
            bc = module.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 2)), is_static=True
            )
            cps.append(
                module.ConstrainedProblem(
                    module.WaveEquation(1), mesh, [(bc, bc)]
                )
            )
        jax_cp, torch_cp = cps
    else:
        jax_cp, torch_cp = _problems(
            "flagship" if case == "euler" else case
        )
    jax_integrator, torch_integrator = (
        (JaxEuler(), ForwardEulerMethod())
        if case == "euler"
        else (JaxRK4(), RK4())
    )
    expected = jax_fused.fused_diffusion_step_applicable(
        jax_cp, jax_integrator
    )
    assert (
        torch_fused.fused_diffusion_step_applicable(
            torch_cp, torch_integrator
        )
        == expected
    )
    # the kernels take float32 states only
    assert not torch_fused.fused_diffusion_step_applicable(
        torch_cp, torch_integrator, torch.float64
    )


def test_applicability_requires_the_grid_to_fit_shared_memory():
    mesh = torch_pkg.Mesh([(0.0, 64.0), (0.0, 64.0)], [0.5, 0.5])
    bc = torch_pkg.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = torch_pkg.ConstrainedProblem(
        torch_pkg.DiffusionEquation(2), mesh, [(bc, bc)] * 2
    )
    assert torch_fused.shared_memory_bytes(129, 129) > (
        torch_fused.MAX_SHARED_MEMORY_BYTES
    )
    assert not torch_fused.fused_diffusion_step_applicable(cp, RK4())
    assert torch_fused.build_fused_diffusion_rk4_end(cp, D_T, 3) is None


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    _, cp = _problems("flagship")
    cfg = torch_fused._KernelConfig(cp, D_T)
    y = torch.as_tensor(_states(cp, batch=2)[..., 0])
    wrappers = (
        torch_fused.fused_diffusion_rk4_trajectory,
        torch_fused.fused_diffusion_rk4_end,
        torch_fused.fused_diffusion_rk4_step,
    )
    launches = [w.launches for w in wrappers]
    np.testing.assert_array_equal(
        torch_fused.fused_diffusion_rk4_trajectory(y, cfg, 4).numpy(),
        torch_fused.fused_diffusion_rk4_trajectory_reference(
            y, cfg, 4
        ).numpy(),
    )
    np.testing.assert_array_equal(
        torch_fused.fused_diffusion_rk4_end(y[0], cfg, 4).numpy(),
        torch_fused.fused_diffusion_rk4_trajectory_reference(
            y[0], cfg, 4
        )[-1].numpy(),
    )
    np.testing.assert_array_equal(
        torch_fused.fused_diffusion_rk4_step(y, cfg).numpy(),
        torch_fused.fused_diffusion_rk4_end_reference(y, cfg, 1).numpy(),
    )
    # no kernel ran, so no launch was counted
    assert [w.launches for w in wrappers] == launches


def test_wrappers_reject_what_the_kernel_does_not_take():
    _, cp = _problems("flagship")
    cfg = torch_fused._KernelConfig(cp, D_T)
    y = torch.zeros(cp.mesh.vertices_shape, dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        torch_fused.fused_diffusion_rk4_end(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="shape"):
        torch_fused.fused_diffusion_rk4_end(y[:-1], cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        torch_fused.fused_diffusion_rk4_end(
            torch.zeros((21, 42), dtype=torch.float32)[:, ::2], cfg, 2
        )


@pytest.mark.parametrize("builder", ["trajectory", "end", "step"])
def test_built_functions_reject_float64_states(builder):
    # a float64 state is refused, never silently run in float32
    _, cp = _problems("flagship")
    built = {
        "trajectory": lambda: torch_fused.build_fused_diffusion_rk4_trajectory(
            cp, D_T, 2
        ),
        "end": lambda: torch_fused.build_fused_diffusion_rk4_end(cp, D_T, 2),
        "step": lambda: torch_fused.build_fused_diffusion_rk4_step(cp, D_T),
    }[builder]()
    y = torch.as_tensor(_states(cp), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        built(y)
