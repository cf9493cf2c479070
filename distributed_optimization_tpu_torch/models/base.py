"""Problem abstraction: one convex objective family, as plain functions.

The port of ``distributed_optimization_tpu/models/base.py``: a
:class:`Problem` bundles the batched weighted objective and gradient of
``ops/losses.py`` under a name, and ``get_problem`` looks one up.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Problem:
    """f(w) = data_term(w; X, y) + (reg/2)‖w‖².

    ``objective_weighted(w, X, y, weights, reg)`` -> ``[N]`` and
    ``gradient_weighted(w, X, y, weights, reg)`` -> ``[N, d]``, batched over
    the worker axis (see ``ops/losses.py`` for the shapes).
    """

    name: str
    objective_weighted: Callable[..., torch.Tensor]
    gradient_weighted: Callable[..., torch.Tensor]


_REGISTRY: dict[str, Problem] = {}


def register_problem(problem: Problem) -> Problem:
    _REGISTRY[problem.name] = problem
    return problem


def get_problem(name: str) -> Problem:
    from distributed_optimization_tpu_torch.models import (  # noqa: F401
        logistic,
        quadratic,
    )

    if name not in _REGISTRY:
        raise ValueError(
            f"problem_type={name!r}: the PyTorch port does not have it yet "
            f"(known: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[name]
