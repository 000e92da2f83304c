from pararealml_tpu_torch.operators.fdm.fdm_operator import FDMOperator
from pararealml_tpu_torch.operators.fdm.fdm_symbol_mapper import (
    FDMSymbolMapArg,
    FDMSymbolMapper,
)
from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
    FivePointCentralDifferenceMethod,
    NumericalDifferentiator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.fdm.numerical_integrator import (
    RK4,
    BackwardEulerMethod,
    CrankNicolsonMethod,
    ExplicitMidpointMethod,
    ForwardEulerMethod,
    ImplicitMethod,
    NumericalIntegrator,
)

__all__ = [
    "FDMOperator",
    "FDMSymbolMapArg",
    "FDMSymbolMapper",
    "NumericalDifferentiator",
    "ThreePointCentralDifferenceMethod",
    "FivePointCentralDifferenceMethod",
    "NumericalIntegrator",
    "ForwardEulerMethod",
    "ExplicitMidpointMethod",
    "RK4",
    "ImplicitMethod",
    "BackwardEulerMethod",
    "CrankNicolsonMethod",
]
