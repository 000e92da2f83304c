"""The benchmark finds every configuration, traffic mix, entry and metric
by the names in ``BENCHMARK.json``, and the file keeps to its contract."""

import json
import os
import re

import pytest

from benchmark import files, run
from benchmark.tests.conftest import HARNESS_DIR, ROOT, cell_names, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {
    "command", "paths", "run_seconds", "configs", "workloads",
    "end_to_end", "per_layer",
}


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", cell_names())
def test_cell_files_are_found_by_name(cell):
    bench, spec, config, traffic = run.cell_files(ROOT, cell)
    assert spec["chips"] == 1
    assert config["name"] == spec["config"]
    entry = os.path.join(HARNESS_DIR, "entries", f"{traffic['entry']}.py")
    assert os.path.exists(entry)
    assert os.path.exists(
        os.path.join(HARNESS_DIR, "reference", f"{config['reference']}.py")
    )
    assert set(traffic["check"]) == {"sample", "control", "limits"}
    kind = traffic["pool"]["initial_condition"]["kind"]
    initial_condition = files.harness_module("initial_conditions", kind)
    for function in ("draw", "port", "values"):
        assert callable(getattr(initial_condition, function)), kind
    control = traffic["check"]["control"]
    assert callable(files.harness_module("controls", control).solves)
    for name in traffic["check"]["limits"]:
        assert callable(files.harness_module("checks", name).gap), name


def test_every_metric_has_a_reader(bench):
    for spec in bench["end_to_end"] + bench["per_layer"]:
        module = files.harness_module("metrics", spec["name"])
        assert callable(module.read), spec["name"]


def test_a_missing_file_is_named():
    with pytest.raises(files.BenchmarkError, match="no file"):
        files.harness_module("checks", "no_such_check")


def test_names_units_and_references(bench):
    cells = {cell["name"] for cell in bench["workloads"]}
    configs = {config["name"] for config in bench["configs"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for name in list(cells) + list(configs) + names:
        assert NAME.match(name), name
    for metric in metrics:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert set(metric.get("workloads", cells)) <= cells
    for metric in bench["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in bench["per_layer"]:
        assert metric["moves"] in {m["name"] for m in bench["end_to_end"]}
        assert metric["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock"
        )
    texts = [c["why"] for c in bench["workloads"] + bench["configs"]]
    texts += [c["source"] for c in bench["configs"]]
    texts += [m["layer"] for m in bench["per_layer"]] + bench["command"]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text, text
        assert "\t" not in text, text
    pairs = [(c["config"], c["traffic"]) for c in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["config"] for c in bench["workloads"]} == configs


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for cell in cell_names(bench):
        ends = [
            m["name"] for m in run.cell_metrics(bench, {"name": cell}, False)
        ]
        layers = run.cell_metrics(bench, {"name": cell}, True)
        assert "setup_s" in ends and len(ends) >= 2, cell
        assert layers, cell


def test_configs_keep_the_upstream_sizes(bench):
    for spec in bench["configs"]:
        config = load(os.path.join(ROOT, spec["file"]))
        assert spec["reduced"] == config["reduced"] == []
        assert spec["source"] == config["source"]
    diffusion = load(
        os.path.join(HARNESS_DIR, "configs", "diffusion_2d_parareal.json")
    )
    assert diffusion["mesh"]["d_x"] == [0.5, 0.5]
    assert diffusion["t_interval"] == [0.0, 40.0]
    assert diffusion["fine"]["d_t"] == 0.001
    ns = load(os.path.join(HARNESS_DIR, "configs", "navier_stokes_fdm.json"))
    assert ns["mesh"]["d_x"] == [0.05, 0.05]
    assert ns["t_interval"] == [0.0, 100.0]
