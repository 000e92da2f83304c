"""Reports the port's spans (``pararealml_tpu_torch/utils/tracing.py``):
what they cost, and where a benchmark cell's idle device time goes.

``python3 tools/span_report.py cost [results.json]`` times a span and a
count with the profiler off (one flag check each), and 10^5 spans inside
an active CPU-only ``torch.profiler.profile``, in µs a call (host clock,
the best of three passes).

``python3 tools/span_report.py cell <workload> <seed> [seconds]
[results.json]`` runs the benchmark's traced run of the cell
(``benchmark/run.py --trace 1``, on the CUDA card) and prints its metrics
beside the idle device time by innermost program span (seconds over the
window and ms a solve), the spans a solve, the median and 99th percentile
of the anchor residuals (how much later than its ``bench.solve`` each
solve's root span opened, after the clocks' offset is taken out), the
idle time the pieces add up to against ``window_s - busy_s``, each
span's median duration, the ``to_host_pinned`` count a solve
(trajectories that reached the host in page-locked memory), the
``to_host_chunks`` count a solve (the pieces copied out while their
kernel ran) and torch's page-locked host memory statistics after the
window
(``torch.cuda.host_memory_stats()``).

Run it from the repository root; ``results.json`` gets the same object
the last line prints.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pararealml_tpu_torch.utils import tracing  # noqa: E402

OFF_CALLS = 10**6
ON_CALLS = 10**5


def _best_us(body, calls, passes=3):
    best = float("inf")
    for _ in range(passes):
        start = time.perf_counter()
        body(calls)
        best = min(best, time.perf_counter() - start)
    return 1e6 * best / calls


def cost() -> dict:
    span, count = tracing.span, tracing.count

    def spans(calls):
        for _ in range(calls):
            with span("solve.trajectory"):
                pass

    def counts(calls):
        for _ in range(calls):
            count("rk4_state_steps", 1)

    def loop(calls):
        for _ in range(calls):
            pass

    result = {
        "loop_us": _best_us(loop, OFF_CALLS),
        "span_off_us": _best_us(spans, OFF_CALLS),
        "count_off_us": _best_us(counts, OFF_CALLS),
    }
    with profile(activities=[ProfilerActivity.CPU]):
        result["span_on_us"] = _best_us(spans, ON_CALLS)

        def counted(calls):
            with span("solve.trajectory"):
                counts(calls)

        result["count_on_us"] = _best_us(counted, ON_CALLS)
        tracing.clear()
    result["torch"] = torch.__version__
    return result


def cell(workload: str, seed: int, seconds: float) -> dict:
    from benchmark import run, spans

    captured = {}
    metric_values = run.metric_values

    def capture(names, state):
        captured["run"] = state
        # the page-locked host memory after the window, the sampled
        # solutions still held
        captured["host_memory"] = torch.cuda.host_memory_stats()
        return metric_values(names, state)

    run.metric_values = capture
    args = run.parse_args(
        ["--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", "1"]
    )
    result = run.run(args)
    state = captured["run"]
    found = spans.analysis(state)
    report = {
        "workload": workload,
        "seed": seed,
        "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "device": result["device"],
        "breakdown": result.get("breakdown"),
        "host_memory": captured["host_memory"],
    }
    if found is None:
        report["spans"] = None
        return report
    residuals = sorted(found.residuals_us)
    p99 = (
        statistics.quantiles(residuals, n=100, method="inclusive")[98]
        if len(residuals) > 1 else residuals[0]
    )
    idle = sorted(found.idle_s.items(), key=lambda kv: -kv[1])
    pieces_s = sum(found.idle_s.values())
    expected_s = state.window_s - state.busy_s
    records = tracing.spans()
    report["spans"] = {
        "solves": found.solves,
        "spans_a_solve": len(records) / found.solves,
        "idle_s": dict(idle),
        "idle_ms_a_solve": {
            name: 1e3 * s / found.solves for name, s in idle
        },
        "residual_us_median": statistics.median(residuals),
        "residual_us_p99": p99,
        "residual_us_max": residuals[-1],
        "idle_pieces_s": pieces_s,
        "window_less_busy_s": expected_s,
        "closure": pieces_s / expected_s - 1.0 if expected_s else None,
        "steps": found.steps,
        "span_us_median": {
            name: statistics.median(
                (r.end_ns - r.start_ns) / 1e3
                for r in records
                if r.name == name and r.end_ns is not None
            )
            for name in sorted({r.name for r in records})
        },
        "to_host_pinned_a_solve": sum(
            r.counts.get("to_host_pinned", 0) for r in records
        ) / found.solves,
        "to_host_chunks_a_solve": sum(
            r.counts.get("to_host_chunks", 0) for r in records
        ) / found.solves,
    }
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="what", required=True)
    costs = sub.add_parser("cost")
    costs.add_argument("out", nargs="?")
    cells = sub.add_parser("cell")
    cells.add_argument("workload")
    cells.add_argument("seed", type=int)
    cells.add_argument("seconds", type=float, nargs="?", default=51.0)
    cells.add_argument("out", nargs="?")
    args = parser.parse_args(argv)
    if args.what == "cost":
        report = cost()
    else:
        report = cell(args.workload, args.seed, args.seconds)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
