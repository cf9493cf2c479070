"""Host-side float64 numpy objectives and gradients, for the optimum oracle.

The port's own copy of the logistic and quadratic parts of
``distributed_optimization_tpu/ops/losses_np.py``, with the same
empty-batch guards (0.0 and zeros for a batch of no rows).
"""

from __future__ import annotations

import numpy as np


def _softplus_neg(z: np.ndarray) -> np.ndarray:
    """log(1 + exp(-z)), computed stably."""
    return np.maximum(0.0, -z) + np.log1p(np.exp(-np.abs(z)))


def _sigmoid(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def logistic_objective(w, X, y, lam):
    if X.shape[0] == 0:
        return 0.0
    margins = y * (X @ w)
    return float(np.mean(_softplus_neg(margins)) + 0.5 * lam * np.dot(w, w))


def logistic_gradient(w, X, y, lam):
    if X.shape[0] == 0:
        return np.zeros_like(w)
    margins = y * (X @ w)
    coeff = -y * _sigmoid(-margins)
    return X.T @ coeff / X.shape[0] + lam * w


def quadratic_objective(w, X, y, mu):
    if X.shape[0] == 0:
        return 0.0
    r = X @ w - y
    return float(0.5 * np.mean(r**2) + 0.5 * mu * np.dot(w, w))


def quadratic_gradient(w, X, y, mu):
    if X.shape[0] == 0:
        return np.zeros_like(w)
    r = X @ w - y
    return X.T @ r / X.shape[0] + mu * w


OBJECTIVES = {"logistic": logistic_objective, "quadratic": quadratic_objective}
GRADIENTS = {"logistic": logistic_gradient, "quadratic": quadratic_gradient}
