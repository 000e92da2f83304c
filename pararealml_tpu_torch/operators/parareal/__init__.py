from pararealml_tpu_torch.operators.parareal.parareal_operator import (
    PararealOperator,
    make_rms_termination,
)

__all__ = ["PararealOperator", "make_rms_termination"]
