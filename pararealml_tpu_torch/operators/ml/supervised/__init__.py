from pararealml_tpu_torch.operators.ml.supervised.state_operator_regressor import (  # noqa: E501
    ReducedQuadraticStateOperatorRegressor,
    StateOperatorRidgeRegressor,
    from_arrays,
)
from pararealml_tpu_torch.operators.ml.supervised.supervised_ml_operator import (  # noqa: E501
    SupervisedMLOperator,
    mean_squared_error,
)

__all__ = [
    "ReducedQuadraticStateOperatorRegressor",
    "StateOperatorRidgeRegressor",
    "SupervisedMLOperator",
    "from_arrays",
    "mean_squared_error",
]
