"""Builds the port's problem objects from a configuration file: the
``ConstrainedProblem`` (equation, mesh, boundary conditions as data) and
one ``InitialValueProblem`` per pool item, through the port's public
classes as a user of the library writes them."""

from __future__ import annotations

from benchmark import traffic as traffic_module


def constrained_problem(prml, config: dict):
    """The configuration's ``ConstrainedProblem`` in the port ``prml``: a
    boundary condition of kind ``k`` is the port's
    ``<K>BoundaryCondition`` of its static values."""
    pde = dict(config["pde"])
    equation = getattr(prml, pde.pop("equation"))(**pde)
    mesh = prml.Mesh(
        [tuple(interval) for interval in config["mesh"]["x_intervals"]],
        list(config["mesh"]["d_x"]),
    )

    def condition(spec):
        values = list(spec["values"])
        kind = getattr(prml, f"{spec['kind'].capitalize()}BoundaryCondition")
        return kind(
            prml.vectorize_bc_function(lambda x, t: values), is_static=True
        )

    bcs = [
        tuple(condition(side) for side in pair)
        for pair in config["boundary_conditions"]
    ]
    return prml.ConstrainedProblem(equation, mesh, bcs)


def initial_value_problem(prml, config: dict, traffic: dict, cp, item: dict):
    """The IVP of one pool item (see ``benchmark/traffic.py``)."""
    condition = traffic_module.initial_condition(traffic).port(
        prml, cp, config, item
    )
    return prml.InitialValueProblem(cp, tuple(config["t_interval"]), condition)
