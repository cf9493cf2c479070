"""L2-regularized binary logistic regression (labels in {-1, +1})."""

from distributed_optimization_tpu_torch.models.base import Problem, register_problem
from distributed_optimization_tpu_torch.ops import losses

LOGISTIC = register_problem(
    Problem(
        name="logistic",
        objective_weighted=losses.logistic_objective_weighted,
        gradient_weighted=losses.logistic_gradient_weighted,
    )
)
