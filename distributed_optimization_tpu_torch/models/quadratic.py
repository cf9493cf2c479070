"""L2-regularized least squares ("quadratic", strongly convex)."""

from distributed_optimization_tpu_torch.models.base import Problem, register_problem
from distributed_optimization_tpu_torch.ops import losses

QUADRATIC = register_problem(
    Problem(
        name="quadratic",
        objective_weighted=losses.quadratic_objective_weighted,
        gradient_weighted=losses.quadratic_gradient_weighted,
    )
)
