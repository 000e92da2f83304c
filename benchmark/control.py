#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9

For each of ``--seeds`` it solves the first IVP of the seed's pool with
the program, on the timed path (the cell's entry, on the card), and
judges it against the plain reference by the comparison a run makes
(``benchmark/compare.py``): the lower readings. For each of
``--control-seeds`` it puts the cell's control
(``benchmark/controls/<control>.py``, named by the traffic file's
``check.control``) in the program's place and judges it the same way:
the upper readings. Each reading carries ``correct``, as a run would
print it. Prints one JSON line. The benchmark's runs do not run this.
"""

import argparse
import importlib
import json
import os
import sys

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HARNESS_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import compare, files, problem  # noqa: E402
from benchmark import traffic as traffic_module  # noqa: E402
from benchmark.run import PROGRAM, cell_files  # noqa: E402


def readings(workload, seeds, control_seeds, root=ROOT, device="cuda"):
    """``{"program": [...], "controls": [...]}``: each seed's numbers and
    whether they are correct."""
    bench, cell, config, traffic = cell_files(root, workload)
    prml = importlib.import_module(PROGRAM)
    entry = files.harness_module("entries", traffic["entry"]).build(
        prml, config, traffic, device
    )
    cp = problem.constrained_problem(prml, config)
    control = traffic["check"]["control"]
    items = [
        traffic_module.make_pool(traffic, config, seed)[0]
        for seed in seeds + control_seeds
    ]

    def program_solve(item):
        ivp = problem.initial_value_problem(prml, config, traffic, cp, item)
        ys = entry.solve(ivp).discrete_y()
        return ys, entry.counters()

    solved = [program_solve(item) for item in items[: len(seeds)]]
    solved += files.harness_module("controls", control).solves(
        config, traffic, items[len(seeds):], program_solve
    )
    entry.release()
    frames, info = compare.reference_solves(config, traffic, items)

    def reading(seed, row):
        ys, counters = solved[row]
        checks = compare.judge(traffic, [(row, ys, counters)], frames, info)
        values = {name: check["value"] for name, check in checks.items()}
        return dict(seed=seed, correct=compare.correct(checks), **values)

    return {
        "workload": workload,
        "control": control,
        "program": [reading(seed, row) for row, seed in enumerate(seeds)],
        "controls": [
            reading(seed, len(seeds) + k)
            for k, seed in enumerate(control_seeds)
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    print(json.dumps(readings(args.workload, seeds, control_seeds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
