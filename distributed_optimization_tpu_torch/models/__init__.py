"""Problem families the port can optimize."""

from distributed_optimization_tpu_torch.models.base import Problem, get_problem  # noqa: F401
