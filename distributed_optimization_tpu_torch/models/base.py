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
    ``gradient_weighted(w, X, y, weights, reg)`` -> ``[N, d_model]``,
    batched over the worker axis (see ``ops/losses.py`` for the shapes).
    ``param_dim(d)`` is ``d_model``, the flat parameter's length for a
    d-feature dataset: d for the scalar-output families, d·K for softmax.
    """

    name: str
    objective_weighted: Callable[..., torch.Tensor]
    gradient_weighted: Callable[..., torch.Tensor]
    param_dim: Callable[[int], int] = lambda d: d


_REGISTRY: dict[str, Problem] = {}


def register_problem(problem: Problem) -> Problem:
    _REGISTRY[problem.name] = problem
    return problem


def get_problem(
    name: str,
    *,
    huber_delta: float | None = None,
    n_classes: int | None = None,
) -> Problem:
    """The family ``name``; ``huber_delta`` binds Huber's transition point
    and ``n_classes`` softmax's class count (each ignored by the other
    families; None is the registered default). One Problem is cached per
    parameter value."""
    from distributed_optimization_tpu_torch.models import (  # noqa: F401
        huber,
        logistic,
        quadratic,
        softmax,
    )

    if name not in _REGISTRY:
        raise ValueError(
            f"problem_type={name!r}: the PyTorch port does not have it yet "
            f"(known: {sorted(_REGISTRY)})"
        )
    if name == "huber" and huber_delta is not None:
        return huber.make_huber_problem(float(huber_delta))
    if name == "softmax" and n_classes is not None:
        return softmax.make_softmax_problem(int(n_classes))
    return _REGISTRY[name]
