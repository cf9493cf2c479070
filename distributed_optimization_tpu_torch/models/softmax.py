"""L2-regularized multinomial (softmax) logistic regression: the
compute-bound family, whose [d, K] parameter makes each worker's gradient
two real matrix products (2·b·d·K operations each). The parameter travels
flat ([d·K]) through the mixing and algorithm layers; ``param_dim`` gives
its length."""

import functools

from distributed_optimization_tpu_torch.models.base import Problem, register_problem
from distributed_optimization_tpu_torch.ops import losses

DEFAULT_N_CLASSES = 10


@functools.lru_cache(maxsize=None)
def make_softmax_problem(n_classes: int) -> Problem:
    """The softmax Problem with the class count bound to ``n_classes``."""
    if n_classes < 2:
        raise ValueError(f"softmax needs n_classes >= 2, got {n_classes}")
    return Problem(
        name="softmax",
        objective_weighted=losses.softmax_objective_weighted,
        gradient_weighted=losses.softmax_gradient_weighted,
        param_dim=lambda d: d * n_classes,
    )


SOFTMAX = register_problem(make_softmax_problem(DEFAULT_N_CLASSES))
