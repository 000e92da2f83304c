"""The port's ``Solution`` constructors and
``operator.materialize_solution`` on the CPU: a CPU trajectory is copied
into the ``Solution``, so the operator's tensor and the solution share
no memory; the public constructor copies its input; ``Solution._adopt``
takes its array as it is, after the same checks. The card's path (the
page-locked copy the ``Solution`` adopts) is tested in
tests/test_torch_cuda.py; here only its plan of pieces
(``trajectory_chunks``) and the plain versions' side of the frames a
kernel publishes. A small problem: the flagship diffusion at d_x 1.0
(11 x 11), three frames."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu_torch.operator import (
    CHUNK_BYTES,
    FrameProgress,
    materialize_solution,
    trajectory_chunks,
)
from pararealml_tpu_torch.ops.fused_diffusion import (
    build_fused_diffusion_rk4_trajectory,
)
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


# (float64 bytes a frame, frames, pieces): the three FDM cells' solves
# (wave 101 x 101 x 2, Navier-Stokes 101 x 81 x 4, diffusion 21 x 21),
# a short solve, exactly two pieces, an uneven end, a frame past the
# target
@pytest.mark.parametrize(
    "frame_bytes, steps, pieces",
    [
        (101 * 101 * 2 * 8, 2000, 63),
        (101 * 81 * 4 * 8, 2000, 63),
        (21 * 21 * 8, 40000, 20),
        (101 * 81 * 4 * 8, 20, 1),
        (CHUNK_BYTES // 8, 16, 2),
        (21 * 21 * 8, 5000, 3),
        (CHUNK_BYTES + 8, 10, 1),
    ],
)
def test_trajectory_chunks_cover_every_frame_once(frame_bytes, steps, pieces):
    chunks = trajectory_chunks(frame_bytes, steps)
    assert len(chunks) == pieces
    # every frame once, in order, the last piece ending at the last frame
    assert chunks[0][0] == 0 and chunks[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(start < end for start, end in chunks)
    frames = chunks[0][1]
    if pieces > 1:
        # equal pieces of a power of two but the last, within the target
        assert frames & (frames - 1) == 0
        assert all(end - start == frames for start, end in chunks[:-1])
        assert frames * frame_bytes <= CHUNK_BYTES
        assert 2 * frames * frame_bytes > CHUNK_BYTES
    else:
        # one piece: under two pieces of the target, or a frame past it
        largest = 1
        while 2 * largest * frame_bytes <= CHUNK_BYTES:
            largest *= 2
        assert steps < 2 * largest or frame_bytes > CHUNK_BYTES


def test_plain_versions_publish_every_frame_of_one_state(ivp):
    """A kernel's plain version (the CPU) returns every frame at once, so
    it publishes them all; a batch publishes nothing and raises."""
    cp = ivp.constrained_problem
    trajectory = build_fused_diffusion_rk4_trajectory(cp, D_T, STEPS)
    assert trajectory.publishes
    word = torch.zeros(1, dtype=torch.int32)
    progress = FrameProgress(SimpleNamespace(word=word), [(0, 2), (2, STEPS)])
    y = torch.zeros(tuple(cp.y_shape(True)), dtype=torch.float32)
    assert trajectory(y, progress=progress).shape == (STEPS,) + y.shape
    assert int(word) == STEPS
    with pytest.raises(ValueError, match="2 states publishes no progress"):
        trajectory(torch.stack([y, y]), progress=progress)
