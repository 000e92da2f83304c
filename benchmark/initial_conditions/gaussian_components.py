"""Initial condition ``gaussian_components``: the configuration's Gaussian
density (its ``initial_condition``: ``cov``) on every state component,
each times its weight (``weights``, one a component), centred at one point
drawn uniformly from ``centre_low`` .. ``centre_high``, every weight times
one factor drawn uniformly from ``weight_scale``. The port builds it as
the upstream example does, as a ``GaussianInitialCondition`` of one (mean,
covariance) pair a component."""

from __future__ import annotations

import numpy as np

from benchmark import files


def draw(rng, spec: dict, config: dict) -> dict:
    """One pool item's parameters, drawn with ``rng``."""
    centre = rng.uniform(spec["centre_low"], spec["centre_high"])
    factor = rng.uniform(*spec["weight_scale"])
    return {
        "centre": [float(c) for c in centre],
        "weights": [
            float(weight * factor)
            for weight in config["initial_condition"]["weights"]
        ],
    }


def port(prml, cp, config: dict, item: dict):
    """The port's initial condition of the item."""
    cov = np.asarray(config["initial_condition"]["cov"])
    pairs = [(np.asarray(item["centre"]), cov)] * len(item["weights"])
    return prml.GaussianInitialCondition(cp, pairs, list(item["weights"]))


def values(config: dict, item: dict, x: np.ndarray) -> np.ndarray:
    """The item's state ``(N, components)`` at the points ``x`` ``(N, d)``,
    before any boundary condition, in float64: the reference's input (the
    density of ``gaussian_centre_weight`` times each component's
    weight)."""
    density = files.harness_module(
        "initial_conditions", "gaussian_centre_weight"
    ).values(config, {"centre": item["centre"], "weight": 1.0}, x)
    return density * np.asarray(item["weights"], dtype=np.float64)
