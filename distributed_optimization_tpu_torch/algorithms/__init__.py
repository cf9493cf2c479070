"""Optimization algorithms: centralized SGD, D-SGD, gradient tracking, EXTRA
and decentralized ADMM, as step rules."""

from distributed_optimization_tpu_torch.algorithms.base import Algorithm, get_algorithm  # noqa: F401
