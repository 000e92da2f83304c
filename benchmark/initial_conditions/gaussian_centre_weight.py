"""Initial condition ``gaussian_centre_weight``: the configuration's
Gaussian density (its ``initial_condition``: ``cov`` and ``weight``) on
the one state component, centred at a point drawn uniformly from
``centre_low`` .. ``centre_high``, its weight times a factor drawn
uniformly from ``weight_scale``. The port builds it as the upstream
example does, as a ``GaussianInitialCondition``."""

from __future__ import annotations

import numpy as np


def draw(rng, spec: dict, config: dict) -> dict:
    """One pool item's parameters, drawn with ``rng``."""
    centre = rng.uniform(spec["centre_low"], spec["centre_high"])
    factor = rng.uniform(*spec["weight_scale"])
    return {
        "centre": [float(c) for c in centre],
        "weight": float(config["initial_condition"]["weight"] * factor),
    }


def port(prml, cp, config: dict, item: dict):
    """The port's initial condition of the item."""
    cov = np.asarray(config["initial_condition"]["cov"])
    return prml.GaussianInitialCondition(
        cp, [(np.asarray(item["centre"]), cov)], [item["weight"]]
    )


def values(config: dict, item: dict, x: np.ndarray) -> np.ndarray:
    """The item's state ``(N, 1)`` at the points ``x`` ``(N, d)``, before
    any boundary condition, in float64: the reference's input."""
    cov = np.asarray(config["initial_condition"]["cov"], dtype=np.float64)
    offset = x - np.asarray(item["centre"], dtype=np.float64)
    quadratic = np.einsum("ni,ij,nj->n", offset, np.linalg.inv(cov), offset)
    norm = np.sqrt((2.0 * np.pi) ** cov.shape[0] * np.linalg.det(cov))
    return (item["weight"] / norm * np.exp(-0.5 * quadratic))[:, None]
