"""Optimization algorithms: centralized SGD, D-SGD, gradient tracking, EXTRA,
decentralized ADMM, CHOCO-SGD and push-sum, as step rules."""

from distributed_optimization_tpu_torch.algorithms.base import Algorithm, get_algorithm  # noqa: F401
