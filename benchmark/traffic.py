"""The general traffic generator: a pool of initial-condition parameters
drawn from ``--seed`` by the rules of a traffic file
(``benchmark/traffic/<name>.json``, its ``pool``). Every seed gives the
same number of items and the same work per item; only the values drawn
change. The pool's ``initial_condition`` names its kind, a module
``benchmark/initial_conditions/<kind>.py`` that draws an item
(``draw``), builds the port's initial condition of it (``port``) and
gives the reference its values (``values``)."""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark import files


def initial_condition(traffic: dict):
    """The module of the traffic's kind of initial condition."""
    kind = traffic["pool"]["initial_condition"]["kind"]
    return files.harness_module("initial_conditions", kind)


def make_pool(traffic: dict, config: dict, seed: int) -> List[dict]:
    """The pool's parameters, one dictionary per item."""
    spec = traffic["pool"]["initial_condition"]
    draw = initial_condition(traffic).draw
    rng = np.random.default_rng(int(seed))
    size = int(traffic["pool"]["size"])
    return [draw(rng, spec, config) for _ in range(size)]
