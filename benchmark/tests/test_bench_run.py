"""A run's result line, and the runs that must print none."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import HARNESS_DIR, ROOT, cell_names

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def check_result(result, bench, cell, trace):
    assert list(result)[:5] == [
        "correct", "attempted", "failed", "metrics", "device"
    ]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert DEVICE_KEYS <= set(result["device"])
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    expected = {
        m["name"] for m in run.cell_metrics(bench, {"name": cell}, trace)
    }
    assert set(result["metrics"]) <= expected
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
    else:
        assert set(result["metrics"]) == expected
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
        assert check["value"] <= check["limit"]
    json.dumps(result)


@pytest.mark.parametrize("cell", cell_names())
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_on_the_cpu(tiny_root, bench, cell, trace):
    # long enough for two solves: a percentile needs two
    seconds = "0.1" if trace else "1.5"
    args = run.parse_args(
        ["--workload", cell, "--seed", str(2**31 + 7), "--seconds", seconds,
         "--trace", str(trace)]
    )
    check_result(run.run(args, root=tiny_root, device="cpu"), bench, cell,
                 trace)


def command(cell, seconds="0.1", trace="0"):
    return [sys.executable, "benchmark/run.py", "--workload", cell,
            "--seed", str(2**31 + 11), "--seconds", seconds, "--trace", trace]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    done = subprocess.run(
        command("diffusion_2d.fine"), capture_output=True, text=True,
        cwd=ROOT,
    )
    assert done.returncode != 0
    assert done.stdout == ""
    assert "cuda" in done.stderr.lower()


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(
        HARNESS_DIR, tmp_path / "benchmark",
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    done = subprocess.run(
        command("diffusion_2d.fine"), capture_output=True, text=True,
        cwd=tmp_path, env=env,
    )
    assert done.returncode != 0
    assert done.stdout == ""


@pytest.mark.cuda
def test_result_line_on_the_card(tiny_root, bench):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copytree(
        HARNESS_DIR, os.path.join(tiny_root, "benchmark"), dirs_exist_ok=True,
        ignore=shutil.ignore_patterns("__pycache__", "configs", "traffic"),
    )
    shutil.copytree(
        os.path.join(ROOT, "pararealml_tpu_torch"),
        os.path.join(tiny_root, "pararealml_tpu_torch"), dirs_exist_ok=True,
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    for cell in cell_names():
        for trace in ("0", "1"):
            done = subprocess.run(
                command(cell, "1", trace), capture_output=True, text=True,
                cwd=tiny_root,
            )
            assert done.returncode == 0, done.stderr[-3000:]
            result = json.loads(done.stdout.strip().splitlines()[-1])
            check_result(result, bench, cell, int(trace))
            assert result["device"]["memory_peak_bytes"] > 0
