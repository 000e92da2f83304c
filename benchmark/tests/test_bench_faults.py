"""A run whose timed path is broken underneath comes out not correct: for
each cell, a step that returns its state unchanged, an answer altered
where it is produced, and the answer of a solve that took one step in
ten. (The cells run on one chip and train nothing: no exchange between
chips or batch mean to leave out.)"""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import cell_names
from pararealml_tpu_torch import solution
from pararealml_tpu_torch.operators.fdm import numerical_integrator
from pararealml_tpu_torch.ops import fused_diffusion, fused_navier_stokes


def unchanged_steps(monkeypatch):
    """Every step of every path the cells take on the CPU returns the
    state it was given."""
    monkeypatch.setattr(
        numerical_integrator.RK4,
        "integral",
        lambda self, y, d_t, d_y_over_d_t, y_constraint_function: y,
    )
    monkeypatch.setattr(
        fused_diffusion,
        "fused_diffusion_rk4_trajectory_reference",
        lambda y, cfg, n_steps: torch.stack([y] * n_steps, dim=-3),
    )
    monkeypatch.setattr(
        fused_diffusion,
        "fused_diffusion_rk4_end_reference",
        lambda y, cfg, n_steps: y.clone(),
    )
    monkeypatch.setattr(
        fused_navier_stokes,
        "_navier_stokes_step_reference",
        lambda state, cfg, constants: (
            state.clone(),
            torch.ones(state.shape[:-3], dtype=torch.int64),
        ),
    )


def altered_answer(monkeypatch):
    """One value of every trajectory moved by a hundredth of its largest
    value as the solution is made."""
    original = solution.Solution.__init__

    def init(self, ivp, t_coordinates, discrete_y, *args, **kwargs):
        y = np.array(discrete_y, dtype=float)
        y[len(y) // 2].flat[y[0].size // 2] += 0.01 * np.abs(y).max()
        original(self, ivp, t_coordinates, y, *args, **kwargs)

    monkeypatch.setattr(solution.Solution, "__init__", init)


def one_step_in_ten(monkeypatch):
    """Every trajectory as a solve that took one step in ten would give
    it: each tenth frame (from the initial state) kept, the nine between
    two such frames linearly interpolated. At the diffusion cells' full
    size, RK4 with ten times the step lands on the fine solve's frames to
    6e-9 of max|y|, so only the frames in between tell the two apart."""
    original = solution.Solution.__init__

    def init(self, ivp, t_coordinates, discrete_y, *args, **kwargs):
        y_0 = ivp.initial_condition.discrete_y_0(True)
        y = np.concatenate([y_0[None], np.asarray(discrete_y, float)])
        for start in range(0, len(y) - 10, 10):
            weights = np.arange(1, 10).reshape((9,) + (1,) * (y.ndim - 1))
            y[start + 1: start + 10] = y[start] + weights / 10.0 * (
                y[start + 10] - y[start]
            )
        original(self, ivp, t_coordinates, y[1:], *args, **kwargs)

    monkeypatch.setattr(solution.Solution, "__init__", init)


@pytest.mark.parametrize("cell", cell_names())
@pytest.mark.parametrize(
    "fault", [unchanged_steps, altered_answer, one_step_in_ten]
)
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    args = run.parse_args(
        ["--workload", cell, "--seed", str(2**31 + 21), "--seconds", "0.1"]
    )
    sound = run.run(args, root=tiny_root, device="cpu")
    assert sound["correct"], sound["checks"]
    fault(monkeypatch)
    broken = run.run(args, root=tiny_root, device="cpu")
    assert broken["correct"] is False, broken["checks"]
    assert broken["checks"]["traj_gap"]["value"] > (
        broken["checks"]["traj_gap"]["limit"]
    )
