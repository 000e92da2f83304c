"""Times the trajectory's crossing to the host in pieces against its one
copy after the kernel, on the card, at the benchmark's FDM cells.

``python3 tools/chunk_sweep.py [out.json]`` builds each cell's problem and
pool from ``benchmark/`` (``diffusion_2d.fine``, ``navier_stokes.solve``,
``wave_2d.pulse``, seed 7), warms up, then solves the pool in turns: the
one copy after the kernel (``FrameDrain.progress`` patched to give none) and
pieces of at most each of ``TARGETS`` bytes (``operator.CHUNK_BYTES``
patched), ``SOLVES`` solves a turn, ``TURNS`` turns, the order reversed
every other turn. It prints, a line a cell, the median ms a solve of each
setting, the pieces a solve, and the peak of allocated device memory over
one solve of each; the last line is the card's name and power limit.
Run it from the repository root on the machine with the card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch import operator as operator_module  # noqa: E402

CELLS = ("wave_2d.pulse", "diffusion_2d.fine", "navier_stokes.solve")
TARGETS = (2 << 20, 4 << 20, 8 << 20, 16 << 20, 32 << 20)
SOLVES = 16
TURNS = 3
SEED = 7
DEVICE = "cuda"
_CHUNK_BYTES = operator_module.CHUNK_BYTES
_PROGRESS = operator_module.FrameDrain.progress


def _setting(name):
    """Patches the program for a setting: ``whole`` or a byte target."""
    if name == "whole":
        operator_module.FrameDrain.progress = lambda *args: None
    else:
        operator_module.FrameDrain.progress = _PROGRESS
        operator_module.CHUNK_BYTES = name


def _synchronize():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _cell(workload):
    from benchmark import problem, traffic as traffic_module
    from benchmark.files import harness_module
    from benchmark.run import ROOT, cell_files

    _, _, config, traffic = cell_files(ROOT, workload)
    entry = harness_module("entries", traffic["entry"]).build(
        prml, config, traffic, DEVICE
    )
    cp = problem.constrained_problem(prml, config)
    ivps = [
        problem.initial_value_problem(prml, config, traffic, cp, item)
        for item in traffic_module.make_pool(traffic, config, SEED)
    ]
    return entry, ivps


def sweep(workload):
    entry, ivps = _cell(workload)
    settings = ["whole", *TARGETS]
    times = {name: [] for name in settings}
    peaks = {}
    pieces = {}
    try:
        for name in settings:
            _setting(name)
            for ivp in ivps[:2]:
                entry.solve(ivp)
            _synchronize()
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            solution = entry.solve(ivps[0])
            _synchronize()
            if DEVICE == "cuda":
                peaks[str(name)] = torch.cuda.max_memory_allocated() - base
            frames = solution.discrete_y()
            pieces[str(name)] = (
                1
                if name == "whole"
                else len(
                    operator_module.trajectory_chunks(
                        frames[0].nbytes, frames.shape[0]
                    )
                )
            )
        for turn in range(TURNS):
            order = settings if turn % 2 == 0 else settings[::-1]
            for name in order:
                _setting(name)
                _synchronize()
                for k in range(SOLVES):
                    start = time.perf_counter()
                    entry.solve(ivps[k % len(ivps)])
                    times[name].append(1e3 * (time.perf_counter() - start))
    finally:
        operator_module.FrameDrain.progress = _PROGRESS
        operator_module.CHUNK_BYTES = _CHUNK_BYTES
    return {
        "workload": workload,
        "ms_median": {str(n): statistics.median(t) for n, t in times.items()},
        "pieces": pieces,
        "peak_bytes_over_one_solve": peaks,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for workload in CELLS:
        result = sweep(workload)
        print(json.dumps(result), flush=True)
        results.append(result)
    card = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump({"cells": results, "card": card}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
