"""Fixtures of the benchmark's tests: a checkout-like root whose
configurations keep every width and boundary condition of the real ones
but solve a short horizon, so that a run fits a CPU test."""

import json
import os
import shutil

import pytest

HARNESS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HARNESS_DIR)

# the tiny horizons: 400 fine diffusion steps (50 a slice), 10 Navier-Stokes
# steps
TINY_T_END = {"diffusion_2d_parareal": 0.4, "navier_stokes_fdm": 0.5}


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench():
    return load(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory, bench):
    """A root with ``BENCHMARK.json``, the traffic files and the
    configurations cut to ``TINY_T_END``."""
    root = tmp_path_factory.mktemp("tiny_root")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(
        os.path.join(HARNESS_DIR, "traffic"), root / "benchmark" / "traffic"
    )
    for spec in bench["configs"]:
        config = load(os.path.join(ROOT, spec["file"]))
        config["t_interval"] = [0.0, TINY_T_END[spec["name"]]]
        target = root / spec["file"]
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(json.dumps(config))
    return str(root)


def cell_names(bench_json=None):
    bench_json = bench_json or load(os.path.join(ROOT, "BENCHMARK.json"))
    return [cell["name"] for cell in bench_json["workloads"]]
