"""The plain reference agrees with the port's CPU path over a few steps of
both configurations: in float64 (the port's generic path) to rounding,
and in float32 (the kernels' plain versions) to float32 rounding."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import pararealml_tpu_torch as prml
from benchmark import problem, traffic as traffic_module
from benchmark.tests.conftest import HARNESS_DIR, load
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)

CASES = [
    ("diffusion_2d_parareal", "fine", 0.03),
    ("navier_stokes_fdm", "solve", 0.25),
]


@pytest.mark.parametrize("config_name,traffic_name,t_end", CASES)
@pytest.mark.parametrize(
    "dtype,limit", [(torch.float64, 1e-12), (torch.float32, 1e-6)]
)
def test_reference_matches_the_port(
    config_name, traffic_name, t_end, dtype, limit
):
    config = load(
        os.path.join(HARNESS_DIR, "configs", f"{config_name}.json")
    )
    config["t_interval"] = [0.0, t_end]
    traffic = load(
        os.path.join(HARNESS_DIR, "traffic", f"{traffic_name}.json")
    )
    pool = traffic_module.make_pool(traffic, config, 2**31 + 3)[:2]
    cp = problem.constrained_problem(prml, config)
    operator = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        config["fine"]["d_t"],
        device="cpu",
        dtype=dtype,
    )
    ivps = [
        problem.initial_value_problem(prml, config, traffic, cp, item)
        for item in pool
    ]
    port = np.stack([operator.solve(ivp).discrete_y() for ivp in ivps])
    reference = importlib.import_module(
        f"benchmark.reference.{config['reference']}"
    )
    values = traffic_module.initial_condition(traffic).values
    y_0 = reference.initial_states(config, values, pool)
    port_y_0 = np.stack(
        [ivp.initial_condition.discrete_y_0(True) for ivp in ivps]
    )
    np.testing.assert_allclose(y_0, port_y_0, rtol=1e-12, atol=1e-12)
    frames, info = reference.trajectory(config, y_0)
    assert frames.shape == port.shape
    assert np.abs(port - frames).max() <= limit * np.abs(frames).max()


def test_pool_is_drawn_from_the_seed():
    config = load(
        os.path.join(HARNESS_DIR, "configs", "diffusion_2d_parareal.json")
    )
    traffic = load(os.path.join(HARNESS_DIR, "traffic", "fine.json"))
    big = 2**31 + 12345
    first = traffic_module.make_pool(traffic, config, big)
    assert first == traffic_module.make_pool(traffic, config, big)
    assert first != traffic_module.make_pool(traffic, config, big + 1)
    assert len(first) == traffic["pool"]["size"]
    for item in first:
        assert all(4.0 <= c <= 6.0 for c in item["centre"])
        assert 900.0 <= item["weight"] <= 1100.0
    json.dumps(first)
