"""Entry ``fdm_solve``: ``FDMOperator.solve(ivp)`` of the configuration's
fine operator (RK4, three-point differences), to the returned
``Solution``.

Per solve it reports the Navier-Stokes kernel's Jacobi sweeps where that
kernel ran.
"""

from __future__ import annotations


class Entry:
    def __init__(self, prml, config: dict, traffic: dict, device):
        import torch
        from pararealml_tpu_torch.operators.fdm import (
            FDMOperator,
            ThreePointCentralDifferenceMethod,
        )
        from pararealml_tpu_torch.operators.fdm import numerical_integrator
        from pararealml_tpu_torch.ops import fused_navier_stokes

        fine = config["fine"]
        solver = config.get("anti_laplacian", {})
        differentiator = ThreePointCentralDifferenceMethod(
            **{
                key: solver[key]
                for key in ("tol", "max_iterations")
                if key in solver
            }
        )
        self.operator = FDMOperator(
            getattr(numerical_integrator, fine["integrator"])(),
            differentiator,
            fine["d_t"],
            device=device,
            dtype=getattr(torch, config["precision"]["dtype"]),
            **traffic.get("operator", {}),
        )
        self._ns = fused_navier_stokes.fused_navier_stokes_rk4_trajectory
        self._ns_ran = False

    def solve(self, ivp):
        sweeps = self._ns.sweeps
        solution = self.operator.solve(ivp)
        # the kernel (or its plain version, on the CPU) leaves a new
        # tensor of sweeps each call
        self._ns_ran = self._ns.sweeps is not sweeps
        return solution

    def counters(self) -> dict:
        """The last solve's counts: its Jacobi sweeps where the
        Navier-Stokes kernel (or, on the CPU, its plain version) ran."""
        if not self._ns_ran:
            return {}
        return {"sweeps": int(self._ns.sweeps.sum())}

    def release(self):
        self.operator = None


def build(prml, config: dict, traffic: dict, device) -> Entry:
    return Entry(prml, config, traffic, device)
