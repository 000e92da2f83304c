"""The wave configuration's pieces: the plain reference agrees with the
port's CPU path over a few steps of the real configuration, in float64
(the port's generic path) to rounding and in float32 (the cluster-resident
mode's plain version, K5's) to float32 rounding; the
``gaussian_components`` pool items give the port and the reference the
same initial state; ``cluster_roofline`` reads a synthetic run and
nothing where the mode did not run; a wave solve whose steps return their
state is not correct; and on the card, the mode's full-size trajectories
of two pool items lie within the cell's limit."""

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pararealml_tpu_torch as prml
from benchmark import compare, files, problem, run, spans
from benchmark import traffic as traffic_module
from benchmark.tests.conftest import HARNESS_DIR, load
from benchmark.trace import Interval, Trace
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.ops import fused_system

CELL = "wave_2d.pulse"
BIG_SEED = 2**31 + 5
MODE = "pararealml_tpu_torch.ops.fused_system.cluster_system_rk4_trajectory"
ONE_CTA = "pararealml_tpu_torch.ops.fused_system.fused_system_rk4_trajectory"


def wave_files():
    config = load(os.path.join(HARNESS_DIR, "configs", "wave_2d_fdm.json"))
    traffic = load(os.path.join(HARNESS_DIR, "traffic", "pulse.json"))
    return config, traffic


def operator(config, dtype, device="cpu"):
    return FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        config["fine"]["d_t"],
        device=device,
        dtype=dtype,
    )


# float64: the generic path evaluates the same stencil and stages as the
# reference in another order, so the two differ by float64 rounding grown
# over five steps; float32: the mode's plain version rounds the state and
# every operation to float32 (2^-24 relative), and the Laplacian divides
# the rounding of its differences by d_x^2 = 0.01, so v gains about 3e-7
# of max|y| a step (1.7e-6 after five steps on these items; the reference
# run in float32 is as far from the float64 one): 1e-5 leaves six times
# that, and a wrong term or step moves the frames by 1e-3 or more
@pytest.mark.parametrize(
    "dtype,limit", [(torch.float64, 1e-12), (torch.float32, 1e-5)]
)
def test_reference_matches_the_port(dtype, limit):
    config, traffic = wave_files()
    config["t_interval"] = [0.0, 0.05]
    pool = traffic_module.make_pool(traffic, config, BIG_SEED)[:2]
    cp = problem.constrained_problem(prml, config)
    ivps = [
        problem.initial_value_problem(prml, config, traffic, cp, item)
        for item in pool
    ]
    solver = operator(config, dtype)
    port = np.stack([solver.solve(ivp).discrete_y() for ivp in ivps])
    reference = importlib.import_module("benchmark.reference.wave")
    values = traffic_module.initial_condition(traffic).values
    y_0 = reference.initial_states(config, values, pool)
    frames, info = reference.trajectory(config, y_0)
    assert info == {}
    assert frames.shape == port.shape == (2, 5, 101, 101, 2)
    assert np.abs(port - frames).max() <= limit * np.abs(frames).max()


def test_port_and_values_give_the_same_initial_state():
    config, traffic = wave_files()
    pool = traffic_module.make_pool(traffic, config, BIG_SEED)[:3]
    cp = problem.constrained_problem(prml, config)
    port_y_0 = np.stack(
        [
            problem.initial_value_problem(prml, config, traffic, cp, item)
            .initial_condition.discrete_y_0(True)
            for item in pool
        ]
    )
    reference = importlib.import_module("benchmark.reference.wave")
    values = traffic_module.initial_condition(traffic).values
    y_0 = reference.initial_states(config, values, pool)
    np.testing.assert_allclose(y_0, port_y_0, rtol=1e-12, atol=1e-12)
    assert np.abs(y_0[..., 1]).max() == 0.0
    assert np.abs(y_0[..., 0]).max() > 4.0


def test_pool_keeps_the_pulse_off_the_faces():
    config, traffic = wave_files()
    pool = traffic_module.make_pool(traffic, config, BIG_SEED)
    assert pool == traffic_module.make_pool(traffic, config, BIG_SEED)
    assert len(pool) == traffic["pool"]["size"] == 16
    sigma = np.sqrt(config["initial_condition"]["cov"][0][0])
    for item in pool:
        centre = np.asarray(item["centre"])
        assert -1.0 <= centre[0] <= 1.0 and 1.5 <= centre[1] <= 3.5
        assert (5.0 - np.abs(centre)).min() >= 4.7 * sigma
        assert 2.7 <= item["weights"][0] <= 3.3
        assert item["weights"][1] == 0.0


def synthetic_run(launches, counts=(2_000, 2_000), kernel="fused_system"):
    """Two solves of the wave cell, each with a 9 ms kernel event named
    after ``kernel`` and a root span that counted ``counts`` steps."""
    config, traffic = wave_files()
    offset = 1_792_316_153_826_000_000
    records, device, host = [], [], [Interval("bench.window", 0.0, 1e5)]
    for k, steps in enumerate(counts):
        start = 1e4 + k * 3e4
        records.append(
            SimpleNamespace(
                name="fdm.solve",
                start_ns=offset + round(1000 * (start + 1.0)),
                end_ns=offset + round(1000 * (start + 2e4)),
                parent=None,
                root=k,
                attrs={},
                counts={"rk4_state_steps": steps} if steps else {},
            )
        )
        host.append(Interval("bench.solve", start, start + 2.1e4))
        device.append(
            Interval(
                f"void resident2d::{kernel}_rk4_kernel<system2d::Wave2D, "
                "system2d::WholeGrid, 1, 1024, true>(resident2d::Args)",
                start + 5.0,
                start + 9005.0,
            )
        )
        device.append(
            Interval("Memcpy DtoH (Device -> Pinned)", start + 9100.0,
                     start + 15000.0)
        )
    return records, SimpleNamespace(
        cell={"name": CELL},
        config=config,
        traffic=traffic,
        launches=launches,
        trace=Trace(device, host, (0.0, 1e5)),
    )


def cluster_roofline(monkeypatch, records, synthetic):
    monkeypatch.setattr(spans, "window_spans", lambda: records)
    return files.harness_module("metrics", "cluster_roofline").read(synthetic)


def test_cluster_roofline_reads_the_mode(monkeypatch):
    records, synthetic = synthetic_run({MODE: 2, ONE_CTA: 0})
    share = cluster_roofline(monkeypatch, records, synthetic)
    # 48.776 us of trajectory bytes a solve over 9 ms of kernel a solve
    assert share == pytest.approx(100.0 * 48.776e-6 / 9e-3, rel=1e-4)


@pytest.mark.parametrize(
    "launches,counts,kernel",
    [
        ({MODE: 0, ONE_CTA: 0}, (2_000, 2_000), "fused_system"),
        ({MODE: 2, ONE_CTA: 1}, (2_000, 2_000), "fused_system"),
        ({MODE: 2}, (2_000, 2_000), "fused_system"),
        ({MODE: 2, ONE_CTA: 0}, (0, 0), "fused_system"),
        ({MODE: 2, ONE_CTA: 0}, (2_000, 2_000), "fused_navier_stokes"),
    ],
    ids=["no_launch", "k5_launched", "k5_unknown", "no_count", "no_kernel"],
)
def test_cluster_roofline_reads_nothing_without_the_mode(
    monkeypatch, launches, counts, kernel
):
    records, synthetic = synthetic_run(launches, counts, kernel)
    assert cluster_roofline(monkeypatch, records, synthetic) is None
    synthetic.trace = None
    assert cluster_roofline(monkeypatch, records, synthetic) is None


def test_a_wave_solve_whose_steps_return_their_state_is_not_correct(
    tiny_root, monkeypatch
):
    args = run.parse_args(
        ["--workload", CELL, "--seed", str(2**31 + 21), "--seconds", "0.1"]
    )
    sound = run.run(args, root=tiny_root, device="cpu")
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(
        fused_system,
        "fused_system_rk4_trajectory_reference",
        lambda y, cfg, n_steps: torch.stack([y] * n_steps, dim=-4),
    )
    broken = run.run(args, root=tiny_root, device="cpu")
    assert broken["checks"]["traj_gap"]["value"] > (
        broken["checks"]["traj_gap"]["limit"]
    )
    assert broken["correct"] is False


@pytest.mark.cuda
def test_the_modes_trajectories_lie_within_the_cells_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config, traffic = wave_files()
    pool = traffic_module.make_pool(traffic, config, BIG_SEED)[:2]
    cp = problem.constrained_problem(prml, config)
    solver = operator(config, torch.float32, "cuda")
    before = (
        fused_system.cluster_system_rk4_trajectory.launches,
        fused_system.fused_system_rk4_trajectory.launches,
    )
    solves = []
    for row, item in enumerate(pool):
        ivp = problem.initial_value_problem(prml, config, traffic, cp, item)
        solves.append((row, solver.solve(ivp).discrete_y(), {}))
    assert (
        fused_system.cluster_system_rk4_trajectory.launches - before[0],
        fused_system.fused_system_rk4_trajectory.launches - before[1],
    ) == (2, 0)
    frames, info = compare.reference_solves(config, traffic, pool)
    checks = compare.judge(traffic, solves, frames, info)
    assert compare.correct(checks), checks
    assert checks["traj_gap"]["value"] > 0.0
