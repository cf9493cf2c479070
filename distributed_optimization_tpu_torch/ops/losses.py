"""Objectives and closed-form gradients in torch, batched over workers.

The port of the logistic and quadratic parts of
``distributed_optimization_tpu/ops/losses.py``. The weighted forms take the
whole worker stack at once: ``X [N, L, d]``, ``y [N, L]``, ``w [N, d]``,
``weights [N, L]``, and return ``[N]`` objectives or ``[N, d]`` gradients.
No autograd: every gradient is written out.
"""

from __future__ import annotations

import torch


def _softplus_neg(z: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(-z)) computed stably as max(0, -z) + log1p(exp(-|z|))."""
    return torch.clamp_min(-z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def _predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Per-row linear predictions X_i w_i: [N, L, d] × [N, d] -> [N, L]."""
    return torch.matmul(X, w.unsqueeze(-1)).squeeze(-1)


def _data_gradient(X: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """X_iᵀ coeff_i for each worker: [N, L, d] × [N, L] -> [N, d]."""
    return torch.matmul(coeff.unsqueeze(-2), X).squeeze(-2)


def _sq_norm(w: torch.Tensor) -> torch.Tensor:
    return torch.sum(w * w, dim=-1)


def logistic_objective_weighted(w, X, y, weights, lam):
    """Σ_l weights_l · log(1 + exp(−y_l x_lᵀw)) + (λ/2)‖w‖², per worker."""
    margins = y * _predict(w, X)
    return torch.sum(weights * _softplus_neg(margins), dim=-1) + 0.5 * lam * _sq_norm(w)


def logistic_gradient_weighted(w, X, y, weights, lam):
    margins = y * _predict(w, X)
    coeff = weights * (-y) * torch.sigmoid(-margins)
    return _data_gradient(X, coeff) + lam * w


def quadratic_objective_weighted(w, X, y, weights, mu):
    """½ Σ_l weights_l (x_lᵀw − y_l)² + (μ/2)‖w‖², per worker."""
    residuals = _predict(w, X) - y
    return 0.5 * torch.sum(weights * residuals**2, dim=-1) + 0.5 * mu * _sq_norm(w)


def quadratic_gradient_weighted(w, X, y, weights, mu):
    residuals = _predict(w, X) - y
    return _data_gradient(X, weights * residuals) + mu * w
