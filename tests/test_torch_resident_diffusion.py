"""The resident diffusion kernel's plain PyTorch version (the CPU side of
the CUDA kernel K7) held against the JAX package's Pallas kernel in
interpret mode on that package's own small test problems, its tile plan,
and the build function's errors. The CUDA kernel itself is held against its
plain version in tests/test_torch_cuda.py.

Tolerances as in tests/test_torch_tiled_diffusion.py: float32 to 1e-5 of
the largest value, bfloat16 frames to one bfloat16 step (2**-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.ops import resident_diffusion as jax_resident
from pararealml_tpu_torch.ops import fused_diffusion as torch_fused
from pararealml_tpu_torch.ops import resident_diffusion as torch_resident
from pararealml_tpu_torch.ops import tiled_diffusion as torch_tiled
from tests.test_torch_tiled_diffusion import (
    BF16_STEP,
    D_T,
    F32_TOL,
    SMALL_PROBLEMS,
    _forge_interior_constraint,
    build_cp,
    rel_err,
    small_caps,  # noqa: F401 (a fixture)
    state,
    x64_off,  # noqa: F401 (a fixture)
)

torch.set_num_threads(1)

# tests/test_resident_diffusion.py's problems: the tiled kernel's three
# and an 8 x 8 grid
PROBLEMS = dict(SMALL_PROBLEMS, tile_8x8=(2.0, 2.0, 2.0 / 7.0, False, 0.1))


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_resident_reference_matches_pallas_kernel(problem, x64_off):  # noqa
    args = PROBLEMS[problem]
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    steps = 5
    expected = jax_resident.build_resident_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True
    )(y)
    actual = torch_resident.build_resident_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(y))
    assert actual.dtype == torch.float32
    assert rel_err(actual, expected) <= F32_TOL


def test_bf16_snapshots_match_pallas_kernel_and_round_once(x64_off):  # noqa
    args = SMALL_PROBLEMS["flux_81x81"]
    jax_cp, torch_cp = build_cp(jax_pkg, *args), build_cp(torch_pkg, *args)
    y = state(jax_cp)
    steps = 20
    expected = jax_resident.build_resident_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True, storage_dtype=jnp.bfloat16
    )(y)
    actual = torch_resident.build_resident_diffusion_rk4_trajectory(
        torch_cp, D_T, steps, storage_dtype=torch.bfloat16
    )(torch.as_tensor(y))
    assert actual.dtype == torch.bfloat16
    assert rel_err(actual.float(), expected) <= BF16_STEP
    # the resident state stays float32, so the last frame is one rounding
    # of the float32 frame, not twenty accumulated ones
    exact = torch_resident.build_resident_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(y))
    assert torch.equal(actual, exact.to(torch.bfloat16))
    assert rel_err(actual.float(), exact) < 3e-3


@pytest.mark.parametrize("problem", sorted(SMALL_PROBLEMS))
def test_resident_agrees_with_the_tiled_and_the_one_block_versions(problem):
    # the three kernels' plain versions on one grid all take: K6 and K7
    # share their arithmetic up to the rounding of the folded
    # coefficients, K1 is the classic four-stage form
    cp = build_cp(torch_pkg, *SMALL_PROBLEMS[problem])
    y = torch.as_tensor(state(cp))
    steps = 10
    resident = torch_resident.build_resident_diffusion_rk4_trajectory(
        cp, D_T, steps
    )(y)
    tiled = torch_tiled.build_tiled_diffusion_rk4_trajectory(
        cp, D_T, steps
    )(y)
    assert torch_fused.fits_one_block(*cp.mesh.vertices_shape)
    one_block = torch_fused.build_fused_diffusion_rk4_trajectory(
        cp, D_T, steps
    )(y)
    assert rel_err(resident, tiled) <= F32_TOL
    assert rel_err(resident, one_block) <= F32_TOL


@pytest.mark.parametrize(
    "shape", [(8, 8), (17, 33), (130, 130), (641, 641), (1281, 1281),
              (700, 2000)]
)
def test_resident_plan_covers_the_grid_within_the_card(shape):
    plan = torch_resident.make_resident_plan(*shape)
    assert plan is not None
    assert plan.n_tiles_h * plan.n_tiles_w <= 132
    assert plan.shared_bytes <= 227 * 1024
    assert plan.n_tiles_h * plan.tile_h >= shape[0]
    assert plan.n_tiles_w * plan.tile_w >= shape[1]
    # no tile lies wholly outside the grid
    assert (plan.n_tiles_h - 1) * plan.tile_h < shape[0]
    assert (plan.n_tiles_w - 1) * plan.tile_w < shape[1]


def test_resident_range():
    # the bench's resident grid plans as in the JAX package, its streaming
    # grid does not; the port's range ends where 132 tiles outgrow 227 KB
    for shape in ((641, 641), (1281, 1281), (2049, 2049)):
        assert (torch_resident.make_resident_plan(*shape) is None) == (
            jax_resident.make_resident_plan(*shape) is None
        )
    # one barrier for two steps where the wider halo fits, else one a step
    assert torch_resident.make_resident_plan(641, 641) == (12, 11, 54, 59, 2)
    assert torch_resident.make_resident_plan(641, 641, 1) == (
        12, 11, 54, 59, 1
    )
    assert torch_resident.make_resident_plan(1281, 1281).steps_per_barrier == 2
    assert torch_resident.make_resident_plan(1500, 1500).steps_per_barrier == 1
    assert torch_resident.make_resident_plan(1600, 1600) is None
    assert torch_resident.make_resident_plan(2, 64) is None


def test_resident_build_function_errors(small_caps):  # noqa: F811
    cp = build_cp(torch_pkg, 10.0, 10.0, 0.125)  # 81 x 81
    with pytest.raises(ValueError, match="range"):
        torch_resident.build_resident_diffusion_rk4_trajectory(cp, 0.01, 2)
    cp = build_cp(torch_pkg, 2.0, 2.0, 0.0625)  # 33 x 33
    with pytest.raises(ValueError, match="storage_dtype"):
        torch_resident.build_resident_diffusion_rk4_trajectory(
            cp, 0.01, 2, storage_dtype=torch.float16
        )
    _forge_interior_constraint(torch_pkg, cp)
    with pytest.raises(ValueError, match="face"):
        torch_resident.build_resident_diffusion_rk4_trajectory(cp, 0.01, 2)
    # with interior constraints the dispatch takes neither large-grid
    # kernel
    assert torch_tiled.takes_streaming_path(cp)
    from pararealml_tpu_torch.operators.fdm import RK4

    assert not torch_fused.fused_diffusion_step_applicable(cp, RK4())


def test_wrapper_takes_batches_and_counts_no_launch_on_the_cpu():
    cp = build_cp(torch_pkg, *SMALL_PROBLEMS["folded_17x33"])
    cfg = torch_tiled._HornerConfig(cp, D_T, resident=True)
    ys = torch.as_tensor(
        np.stack([state(cp, seed)[..., 0] for seed in range(3)])
    )
    launches = torch_resident.resident_diffusion_rk4_trajectory.launches
    batched = torch_resident.resident_diffusion_rk4_trajectory(ys, cfg, 4)
    assert batched.shape == (3, 4, 17, 33)
    assert torch.equal(
        batched[2],
        torch_resident.resident_diffusion_rk4_trajectory(ys[2], cfg, 4),
    )
    assert (
        torch_resident.resident_diffusion_rk4_trajectory.launches == launches
    )
    with pytest.raises(TypeError, match="float32"):
        torch_resident.resident_diffusion_rk4_trajectory(ys.double(), cfg, 4)
    with pytest.raises(ValueError, match="contiguous"):
        torch_resident.resident_diffusion_rk4_trajectory(
            torch.zeros((3, 17, 66))[:, :, ::2], cfg, 4
        )
