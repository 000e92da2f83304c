"""Initial condition ``vortices``: the configuration's fluid at rest plus
``count`` Gaussian vortices in the vorticity (the first state component),
each of an amplitude drawn uniformly from ``amplitude``, of width
``width``, centred uniformly in the domain shrunk by ``margin`` on every
face; the other components zero. The port builds it as a
``ContinuousInitialCondition`` of :func:`values`."""

from __future__ import annotations

import numpy as np


def draw(rng, spec: dict, config: dict) -> dict:
    """One pool item's parameters, drawn with ``rng``."""
    margin = float(spec["margin"])
    low = [lo + margin for lo, _ in config["mesh"]["x_intervals"]]
    high = [hi - margin for _, hi in config["mesh"]["x_intervals"]]
    vortices = []
    for _ in range(int(spec["count"])):
        vortices.append(
            {
                "centre": [float(c) for c in rng.uniform(low, high)],
                "amplitude": float(rng.uniform(*spec["amplitude"])),
                "width": float(spec["width"]),
            }
        )
    return {"vortices": vortices}


def port(prml, cp, config: dict, item: dict):
    """The port's initial condition of the item."""
    return prml.ContinuousInitialCondition(
        cp, lambda x: values(config, item, x)
    )


def values(config: dict, item: dict, x: np.ndarray) -> np.ndarray:
    """The item's state ``(N, components)`` at the points ``x`` ``(N, d)``,
    before any boundary condition, in float64."""
    components = len(config["boundary_conditions"][0][0]["values"])
    out = np.zeros((len(x), components))
    for vortex in item["vortices"]:
        distance = np.sum((x - np.asarray(vortex["centre"])) ** 2, -1)
        out[:, 0] += vortex["amplitude"] * np.exp(
            -distance / (2.0 * vortex["width"] ** 2)
        )
    return out
