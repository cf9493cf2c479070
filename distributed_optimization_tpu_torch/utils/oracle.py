"""Reference optimum f(x*), computed with numpy and scipy alone.

The JAX package fits scikit-learn's saga solvers for logistic and
quadratic (``distributed_optimization_tpu/utils/oracle.py``). The port
needs no scikit-learn:

- logistic: scipy's L-BFGS-B on the float64 objective, with the bias
  penalised like every other coordinate, as the objective states it;
- quadratic: the ridge normal equations ``(XᵀX/n + μI') w = Xᵀy/n`` with
  the bias column left unpenalised in I' (scikit-learn's
  ``fit_intercept``), so ``f_opt`` is exact up to the solve's rounding;
- huber and softmax: scipy's L-BFGS-B on the float64 objective, as the JAX
  package solves them too (same options, same start), so ``f_opt`` agrees
  with its to rounding.

Each returns ``(w_opt, f_opt)`` in the space the trained models live in:
[d] with the bias column included, or the flat [d·K] for softmax.
"""

from __future__ import annotations

import functools

import numpy as np

from distributed_optimization_tpu_torch.config import DEFAULT_HUBER_DELTA
from distributed_optimization_tpu_torch.ops import losses_np
from distributed_optimization_tpu_torch.utils.data import HostDataset


def compute_reference_optimum(
    dataset: HostDataset,
    reg_param: float,
    *,
    max_iter: int = 50_000,
    tol: float = 1e-9,
    huber_delta: float | None = None,
    n_classes: int | None = None,
) -> tuple[np.ndarray, float]:
    """``huber_delta``: Huber's δ (None is ``DEFAULT_HUBER_DELTA``);
    ``n_classes``: softmax's K (None infers max(y) + 1)."""
    X = dataset.X_full
    y = dataset.y_full
    kind = dataset.problem_type
    if kind == "quadratic":
        n, d = X.shape
        A = X.T @ X / n
        # The last column is the bias: ridge leaves the intercept free.
        A[np.arange(d - 1), np.arange(d - 1)] += reg_param
        w_opt = np.linalg.solve(A, X.T @ y / n)
        return w_opt, losses_np.quadratic_objective(w_opt, X, y, reg_param)
    dim = X.shape[1]
    if kind == "huber":
        delta = DEFAULT_HUBER_DELTA if huber_delta is None else float(huber_delta)
        objective = functools.partial(losses_np.huber_objective, delta=delta)
        gradient = functools.partial(losses_np.huber_gradient, delta=delta)
    elif kind == "softmax":
        dim *= int(n_classes) if n_classes is not None else int(y.max()) + 1
        objective, gradient = losses_np.softmax_objective, losses_np.softmax_gradient
    elif kind == "logistic":
        objective, gradient = losses_np.logistic_objective, losses_np.logistic_gradient
    else:
        raise ValueError(
            f"problem_type={kind!r}: the PyTorch port does not have it yet"
        )
    from scipy.optimize import minimize

    res = minimize(
        lambda w: objective(w, X, y, reg_param),
        np.zeros(dim),
        jac=lambda w: gradient(w, X, y, reg_param),
        method="L-BFGS-B",
        options={"maxiter": max_iter, "ftol": tol * 1e-2, "gtol": 1e-10},
    )
    return res.x, objective(res.x, X, y, reg_param)
