#!/usr/bin/env python3
"""The benchmark of ``pararealml_tpu_torch``, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout, on a machine with the CUDA cards the
cell asks for. A cell (``BENCHMARK.json``, ``workloads``) names a
configuration (``benchmark/configs/<config>.json``) and a traffic file
(``benchmark/traffic/<traffic>.json``) that names the entry
(``benchmark/entries/<entry>.py``), the operator options, the pool of
initial conditions drawn from the seed
(``benchmark/initial_conditions/<kind>.py``), the path the solve must
take, and the comparison's sample, control and limits
(``benchmark/checks/<name>.py``).

A run builds the problem and the pool, warms up with two solves (the
first builds the kernels and the operators' caches), then solves the
pool's IVPs one after another, in a closed loop, for ``--seconds``: each
solve timed from the call of ``Operator.solve`` to the returned
``Solution``. With ``--trace 1`` the window runs under ``torch.profiler``
and the cell's per-layer metrics (``benchmark/metrics/<name>.py``) are
read from it; otherwise its end-to-end metrics. After the window it
compares a sample of the window's solutions, drawn from the seed, with
the plain reference (``benchmark/compare.py``), prints each compared
number beside its limit on standard error, and prints the result as one
JSON line, the last line of standard output.
"""

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HARNESS_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.files import (  # noqa: E402
    BenchmarkError,
    harness_module,
    load_json,
)

# top-level module names no run may load: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pararealml_tpu")
PROGRAM = "pararealml_tpu_torch"
WARMUP_SOLVES = 2


def cell_files(root: str, workload: str):
    """The benchmark, the cell, its configuration and its traffic."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {cell["name"]: cell for cell in bench["workloads"]}
    if workload not in cells:
        raise BenchmarkError(
            f"no workload {workload!r} in BENCHMARK.json "
            f"(has: {', '.join(sorted(cells))})"
        )
    cell = cells[workload]
    configs = {config["name"]: config for config in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(
        os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")
    )
    return bench, cell, config, traffic


def loaded_forbidden_modules():
    """The top-level names of loaded modules that no run may load,
    compared whole (``pararealml_tpu_torch`` is not
    ``pararealml_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def set_cache_directories(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its CUDA libraries into ``build/`` itself."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        build, "torch_extensions"
    )
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def launch_counts(path_spec) -> dict:
    """The launch counters the traffic's ``path`` names, by
    ``module.function``."""
    counts = {}
    for item in path_spec:
        module = importlib.import_module(item["module"])
        function = getattr(module, item["function"])
        counts[f"{item['module']}.{item['function']}"] = int(function.launches)
    return counts


def path_faults(path_spec, before: dict, after: dict):
    """The launch counts of one solve that the traffic's ``path`` rules
    out, as messages."""
    faults = []
    for item in path_spec:
        key = f"{item['module']}.{item['function']}"
        launched = after[key] - before[key]
        if "exactly" in item and launched != item["exactly"]:
            faults.append(f"{key}: {launched} launches, {item['exactly']} due")
        if "at_least" in item and launched < item["at_least"]:
            faults.append(
                f"{key}: {launched} launches, at least {item['at_least']} due"
            )
    return faults


def measured_window(entry, ivps, seconds: float, sample: int, rng, trace):
    """Solves ``ivps`` in turn for ``seconds``; returns the window's wall
    seconds, each solve's record, the number attempted and failed, and a
    reservoir sample of ``sample`` solves drawn with ``rng``, each
    ``(pool index, solution, record)``."""
    records, kept, failed = [], [], 0
    span = None
    if trace:
        from torch.profiler import record_function

        span = record_function
    start = time.perf_counter()
    deadline = start + seconds
    number = 0
    while True:
        index = number % len(ivps)
        begin = time.perf_counter()
        try:
            if span is None:
                solution = entry.solve(ivps[index])
            else:
                with span("bench.solve"):
                    solution = entry.solve(ivps[index])
        except Exception as error:  # noqa: BLE001 - counted and reported
            failed += 1
            print(f"solve {number} failed: {error!r}", file=sys.stderr)
            solution = None
        end = time.perf_counter()
        if solution is not None:
            record = dict(index=index, seconds=end - begin, **entry.counters())
            records.append(record)
            if len(kept) < sample:
                kept.append((index, solution, record))
            else:
                slot = rng.randrange(len(records))
                if slot < sample:
                    kept[slot] = (index, solution, record)
        solution = None
        number += 1
        if end >= deadline:
            break
    return end - start, records, number, failed, kept


def compare(config, traffic, pool, kept):
    """The sampled solves against the plain reference, each number beside
    its limit (``benchmark/compare.py``)."""
    from benchmark import compare as compare_module

    indices = sorted({index for index, _, _ in kept})
    frames, info = compare_module.reference_solves(
        config, traffic, [pool[i] for i in indices]
    )
    solves = [
        (indices.index(index), solution.discrete_y(), record)
        for index, solution, record in kept
    ]
    return compare_module.judge(traffic, solves, frames, info)


def metric_values(names, run):
    """The values the metric readers give, ``{name: {"value", "unit"}}``;
    a reader that finds nothing to read returns None and is left out."""
    metrics = {}
    for spec in names:
        value = harness_module("metrics", spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return metrics


def cell_metrics(bench, cell, trace: bool):
    """The cell's metrics of one kind: end-to-end with ``trace`` off,
    per-layer with it on."""
    kind = "per_layer" if trace else "end_to_end"
    return [
        spec
        for spec in bench[kind]
        if cell["name"] in spec.get("workloads", [cell["name"]])
    ]


def run(args, root: str = ROOT, device=None) -> dict:
    """One run of a cell; returns the result line's object. ``device``
    None means the CUDA card, checked first; the tests pass ``"cpu"`` to
    drive the rest of a run without one."""
    bench, cell, config, traffic = cell_files(root, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise BenchmarkError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise BenchmarkError(
                f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell['chips']}"
            )
        device = "cuda"
    if importlib.util.find_spec(PROGRAM) is None:
        raise BenchmarkError(f"the program {PROGRAM} is not in the checkout")
    set_cache_directories(root)
    prml = importlib.import_module(PROGRAM)
    from benchmark import compare as compare_module
    from benchmark import problem, traffic as traffic_module

    on_card = torch.device(device).type == "cuda"

    def synchronize():
        if on_card:
            torch.cuda.synchronize()

    entry = harness_module("entries", traffic["entry"]).build(
        prml, config, traffic, device
    )
    pool = traffic_module.make_pool(traffic, config, args.seed)
    cp = problem.constrained_problem(prml, config)
    ivps = [
        problem.initial_value_problem(prml, config, traffic, cp, item)
        for item in pool
    ]

    # the launch counters count CUDA launches: on the CPU the kernels'
    # plain versions run uncounted, and the path is not checked
    path_spec = traffic.get("path", []) if on_card else []
    before = launch_counts(path_spec)
    entry.solve(ivps[0])
    synchronize()
    faults = path_faults(path_spec, before, launch_counts(path_spec))
    for number in range(1, WARMUP_SOLVES):
        entry.solve(ivps[number % len(ivps)])
    synchronize()
    setup_s = time.perf_counter() - _PROCESS_START

    rng = random.Random(args.seed)
    sample = int(traffic["check"]["sample"])
    prof = None
    before = launch_counts(path_spec)
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        with record_function("bench.window"):
            window_s, records, attempted, failed, kept = measured_window(
                entry, ivps, args.seconds, sample, rng, True
            )
            synchronize()
        prof.__exit__(None, None, None)
    else:
        window_s, records, attempted, failed, kept = measured_window(
            entry, ivps, args.seconds, sample, rng, False
        )
    synchronize()
    after = launch_counts(path_spec)
    window_launches = {key: after[key] - before[key] for key in after}
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    from benchmark import trace as trace_module

    run_state = SimpleNamespace(
        cell=cell,
        config=config,
        traffic=traffic,
        seed=args.seed,
        setup_s=setup_s,
        window_s=window_s,
        solves=records,
        launches=window_launches,
        trace=None,
    )
    breakdown = None
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    if prof is not None:
        trace = trace_module.collect(prof)
        run_state.trace = trace
        busy_s = trace_module.busy_us(trace) / 1e6
        run_state.busy_s = busy_s / int(cell["chips"])
        device_info["busy_s"] = run_state.busy_s
        device_info["window_s"] = window_s
        breakdown = {
            "device_ops": trace_module.device_ops(trace),
            "idle_gaps": trace_module.idle_gaps(trace),
        }
    metrics = metric_values(
        cell_metrics(bench, cell, bool(args.trace)), run_state
    )

    # the program's state goes before the reference runs
    entry.release()
    entry, prof, ivps = None, None, None
    if on_card:
        torch.cuda.empty_cache()
    checks = compare(config, traffic, pool, kept)
    checks["path_faults"] = {"value": len(faults), "limit": 0}
    checks["failed_solves"] = {"value": failed, "limit": 0}
    for fault in faults:
        print(f"path fault: {fault}", file=sys.stderr)
    correct = compare_module.correct(checks)

    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
    except BenchmarkError as error:
        print(f"benchmark: {error}", file=sys.stderr)
        return 2
    forbidden = loaded_forbidden_modules()
    if forbidden:
        print(
            f"benchmark: the run loaded {', '.join(forbidden)}, which the "
            "port must not load",
            file=sys.stderr,
        )
        return 3
    for name, check in result["checks"].items():
        print(
            f"check {name}: {check['value']!r} (limit {check['limit']!r})",
            file=sys.stderr,
        )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
