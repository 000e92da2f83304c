"""Entry ``parareal_solve``: ``PararealOperator.solve(ivp)`` over the
configuration's fine and coarse FDM operators (RK4, three-point
differences) with its termination tolerance and slices, to the returned
``Solution``. The traffic's ``operator`` options go to both FDM
operators (``linear_propagator``). Per solve it reports the iterations
the schedule ran."""

from __future__ import annotations


class Entry:
    def __init__(self, prml, config: dict, traffic: dict, device):
        import torch
        from pararealml_tpu_torch.operators.fdm import (
            FDMOperator,
            ThreePointCentralDifferenceMethod,
        )
        from pararealml_tpu_torch.operators.fdm import numerical_integrator
        from pararealml_tpu_torch.operators.parareal import PararealOperator

        dtype = getattr(torch, config["precision"]["dtype"])

        def fdm(spec):
            return FDMOperator(
                getattr(numerical_integrator, spec["integrator"])(),
                ThreePointCentralDifferenceMethod(),
                spec["d_t"],
                device=device,
                dtype=dtype,
                **traffic.get("operator", {}),
            )

        parareal = config["parareal"]
        self.operator = PararealOperator(
            fdm(config["fine"]),
            fdm(config["coarse"]),
            parareal["termination_condition"],
            num_time_slices=parareal["num_time_slices"],
        )

    def solve(self, ivp):
        return self.operator.solve(ivp)

    def counters(self) -> dict:
        """The last solve's Parareal iterations."""
        return {"iterations": int(self.operator.last_iterations)}

    def release(self):
        self.operator = None


def build(prml, config: dict, traffic: dict, device) -> Entry:
    return Entry(prml, config, traffic, device)
