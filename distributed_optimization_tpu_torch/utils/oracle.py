"""Reference optimum f(x*), computed with numpy and scipy alone.

The JAX package fits scikit-learn's saga solvers
(``distributed_optimization_tpu/utils/oracle.py``). The port needs no
scikit-learn:

- logistic: scipy's L-BFGS-B on the float64 objective, with the bias
  penalised like every other coordinate, as the objective states it;
- quadratic: the ridge normal equations ``(XᵀX/n + μI') w = Xᵀy/n`` with
  the bias column left unpenalised in I' (scikit-learn's
  ``fit_intercept``), so ``f_opt`` is exact up to the solve's rounding.

Both return ``(w_opt [d], f_opt)`` in the (d+1)-dimensional space the
trained models live in (bias column included).
"""

from __future__ import annotations

import numpy as np

from distributed_optimization_tpu_torch.ops import losses_np
from distributed_optimization_tpu_torch.utils.data import HostDataset


def compute_reference_optimum(
    dataset: HostDataset,
    reg_param: float,
    *,
    max_iter: int = 50_000,
    tol: float = 1e-9,
) -> tuple[np.ndarray, float]:
    X = dataset.X_full
    y = dataset.y_full
    if dataset.problem_type == "logistic":
        from scipy.optimize import minimize

        res = minimize(
            lambda w: losses_np.logistic_objective(w, X, y, reg_param),
            np.zeros(X.shape[1]),
            jac=lambda w: losses_np.logistic_gradient(w, X, y, reg_param),
            method="L-BFGS-B",
            options={"maxiter": max_iter, "ftol": tol * 1e-2, "gtol": 1e-10},
        )
        w_opt = res.x
        return w_opt, losses_np.logistic_objective(w_opt, X, y, reg_param)
    if dataset.problem_type == "quadratic":
        n, d = X.shape
        A = X.T @ X / n
        # The last column is the bias: ridge leaves the intercept free.
        A[np.arange(d - 1), np.arange(d - 1)] += reg_param
        w_opt = np.linalg.solve(A, X.T @ y / n)
        return w_opt, losses_np.quadratic_objective(w_opt, X, y, reg_param)
    raise ValueError(
        f"problem_type={dataset.problem_type!r}: the PyTorch port does not "
        "have it yet"
    )
