"""L2-regularized Huber regression (convex, robust): the quadratic
family's regression data with the per-sample gradient capped at δ‖x‖."""

import functools

from distributed_optimization_tpu_torch.config import DEFAULT_HUBER_DELTA
from distributed_optimization_tpu_torch.models.base import Problem, register_problem
from distributed_optimization_tpu_torch.ops import losses


@functools.lru_cache(maxsize=None)
def make_huber_problem(delta: float) -> Problem:
    """The Huber Problem with its transition point bound to ``delta``."""
    return Problem(
        name="huber",
        objective_weighted=functools.partial(losses.huber_objective_weighted, delta=delta),
        gradient_weighted=functools.partial(losses.huber_gradient_weighted, delta=delta),
    )


HUBER = register_problem(make_huber_problem(DEFAULT_HUBER_DELTA))
