"""Host-side float64 numpy objectives and gradients, for the optimum oracle.

The port's own copy of ``distributed_optimization_tpu/ops/losses_np.py``,
with the same empty-batch guards (0.0 and zeros for a batch of no rows).
Softmax's ``w`` is the flat [d·K] parameter, K inferred from its size.
"""

from __future__ import annotations

import numpy as np

from distributed_optimization_tpu_torch.config import DEFAULT_HUBER_DELTA


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


def huber_objective(w, X, y, lam, delta=DEFAULT_HUBER_DELTA):
    if X.shape[0] == 0:
        return 0.0
    r = X @ w - y
    a = np.abs(r)
    h = np.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return float(np.mean(h) + 0.5 * lam * np.dot(w, w))


def huber_gradient(w, X, y, lam, delta=DEFAULT_HUBER_DELTA):
    if X.shape[0] == 0:
        return np.zeros_like(w)
    r = X @ w - y
    coeff = np.clip(r, -delta, delta)
    return X.T @ coeff / X.shape[0] + lam * w


def softmax_objective(w, X, y, lam):
    """Mean cross-entropy of the [d, K] matrix ``w.reshape(d, -1)``."""
    if X.shape[0] == 0:
        return 0.0
    logits = X @ w.reshape(X.shape[1], -1)
    m = logits.max(axis=1, keepdims=True)
    lse = m[:, 0] + np.log(np.exp(logits - m).sum(axis=1))
    true = logits[np.arange(X.shape[0]), y.astype(np.int64)]
    return float(np.mean(lse - true) + 0.5 * lam * np.dot(w, w))


def softmax_gradient(w, X, y, lam):
    if X.shape[0] == 0:
        return np.zeros_like(w)
    W = w.reshape(X.shape[1], -1)
    logits = X @ W
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    P = e / e.sum(axis=1, keepdims=True)
    P[np.arange(X.shape[0]), y.astype(np.int64)] -= 1.0
    return (X.T @ P / X.shape[0] + lam * W).reshape(-1)


OBJECTIVES = {"logistic": logistic_objective, "quadratic": quadratic_objective,
              "huber": huber_objective, "softmax": softmax_objective}
GRADIENTS = {"logistic": logistic_gradient, "quadratic": quadratic_gradient,
             "huber": huber_gradient, "softmax": softmax_gradient}
