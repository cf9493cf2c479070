"""Typed experiment configuration for the PyTorch/CUDA port.

A cut-down copy of ``distributed_optimization_tpu/config.py``: the same
field names and defaults for every field this slice reads, so a config
written for the JAX package carries across unchanged. Values the port does
not implement yet raise ``ValueError`` naming what is missing, instead of
being accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# What this slice of the port implements. The JAX package accepts more;
# each value outside these lists is refused below.
ALGORITHMS = ("centralized", "dsgd")
TOPOLOGIES = ("ring", "fully_connected")
PROBLEM_TYPES = ("logistic", "quadratic")
MIXING_IMPLS = ("auto", "stencil", "dense", "pallas")
SAMPLING_IMPLS = ("auto", "dense", "gather")
DTYPES = ("float32", "float64")
LR_SCHEDULES = ("auto", "sqrt_decay", "constant")


def _not_yet(field: str, value: Any, allowed: tuple) -> ValueError:
    return ValueError(
        f"{field}={value!r}: the PyTorch port does not have it yet "
        f"(this slice implements {allowed})"
    )


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Hyperparameters of one experiment (the fields this slice reads)."""

    n_workers: int = 25
    local_batch_size: int = 16
    n_iterations: int = 10_000
    learning_rate_eta0: float = 0.05
    l2_regularization_lambda: float = 1e-4
    strong_convexity_mu: float = 1e-4
    problem_type: str = "quadratic"
    n_samples: int = 12_500
    n_features: int = 80
    n_informative_features: int = 50
    classification_sep: float = 0.7
    suboptimality_threshold: float = 0.08

    algorithm: str = "dsgd"
    topology: str = "ring"
    lr_schedule: str = "auto"
    seed: int = 203
    data_seed: int = -1
    eval_every: int = 1
    local_steps: int = 1
    # 'pallas' keeps its name so configs carry across; in the port it
    # selects the hand-written CUDA ring kernels (ops/ring_kernels.py).
    mixing_impl: str = "auto"
    sampling_impl: str = "auto"
    dtype: str = "float32"
    record_consensus: bool = True

    def __post_init__(self) -> None:
        for field, allowed in (
            ("algorithm", ALGORITHMS),
            ("topology", TOPOLOGIES),
            ("problem_type", PROBLEM_TYPES),
            ("mixing_impl", MIXING_IMPLS),
            ("sampling_impl", SAMPLING_IMPLS),
            ("dtype", DTYPES),
            ("lr_schedule", LR_SCHEDULES),
            ("local_steps", (1,)),
        ):
            value = getattr(self, field)
            if value not in allowed:
                raise _not_yet(field, value, allowed)
        if self.n_workers <= 0:
            raise ValueError("n_workers must be positive")
        if self.n_informative_features > self.n_features:
            raise ValueError(
                "n_informative_features cannot exceed n_features"
            )
        if self.local_batch_size <= 0:
            raise ValueError("local_batch_size must be positive")
        if self.eval_every <= 0:
            raise ValueError("eval_every must be positive")
        if self.n_iterations % self.eval_every != 0:
            raise ValueError(
                f"eval_every ({self.eval_every}) must divide n_iterations "
                f"({self.n_iterations})"
            )

    def resolved_data_seed(self) -> int:
        """``data_seed`` when pinned (>= 0), else ``seed``."""
        return self.data_seed if self.data_seed >= 0 else self.seed

    def resolved_sampling_impl(self, platform: str, n_local: int) -> str:
        """Resolve sampling_impl='auto' as the JAX package does: dense
        weights on an accelerator when the padded shard has at most 64
        rows, gather otherwise and always on the CPU."""
        if self.sampling_impl != "auto":
            return self.sampling_impl
        if platform != "cpu" and n_local <= 64:
            return "dense"
        return "gather"

    def resolved_lr_schedule(self) -> str:
        if self.lr_schedule != "auto":
            return self.lr_schedule
        return "sqrt_decay"  # both algorithms of this slice are SGD-family

    @property
    def reg_param(self) -> float:
        """mu for the quadratic problem, lambda otherwise."""
        return (
            self.strong_convexity_mu
            if self.problem_type == "quadratic"
            else self.l2_regularization_lambda
        )

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)
