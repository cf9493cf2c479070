"""Objectives and closed-form gradients in torch, batched over workers.

The port of the weighted forms of
``distributed_optimization_tpu/ops/losses.py``. They take the whole worker
stack at once: ``X [N, L, d]``, ``y [N, L]``, ``w [N, d_model]``,
``weights [N, L]``, and return ``[N]`` objectives or contiguous ``[N,
d_model]`` gradients. ``d_model`` is d for the scalar-output families and
d·K for softmax. No autograd: every gradient is written out.

The replica axis: ``w [R, N, d_model]`` with ``weights [R, N, L]`` against
the shared shards ``X [N, L, d]``, ``y [N, L]`` gives ``[R, N]`` /
``[R, N, d_model]``. X is not broadcast R times: each worker's R models
are the rows of one skinny product a worker, ``bmm(w.transpose(0, 1),
X.transpose(1, 2))`` → ``[N, R, L]`` (softmax: ``[N, L, d] × [N, d,
R·K]``). Per-replica batches
(``X [R, N, b, d]``, the gather form's) take the broadcasting product.

bfloat16 runs round as the JAX package's bfloat16 runs do on the CPU:
every elementwise operation rounds to bfloat16, reductions and products
accumulate in float32 and round once, the last operation before a sum
is summed unrounded (XLA fuses it into the reduction: ``sum_of``), and
every Python scalar is rounded to bfloat16 before it is applied
(``ops/rounding.py``). Where PyTorch's
fused bfloat16 functions compute wider than that (sigmoid, softmax,
logsumexp), the bfloat16 path spells out the JAX package's operations.
In float32 and float64 nothing changes.
"""

from __future__ import annotations

import torch

from distributed_optimization_tpu_torch.ops.rounding import scalar, sum_of

_BF16 = torch.bfloat16


def _softplus_neg(z: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(-z)) computed stably as max(0, -z) + log1p(exp(-|z|))."""
    return torch.clamp_min(-z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def _shared(w: torch.Tensor, X: torch.Tensor) -> bool:
    """R replicas' parameters ``[R, N, ...]`` against shared shards ``[N, L, d]``."""
    return w.dim() == X.dim()


def _predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Per-row linear predictions X_i w_i: [N, L, d] × [N, d] -> [N, L]
    (× [R, N, d] -> [R, N, L], one skinny product a worker)."""
    if _shared(w, X):
        return torch.bmm(w.transpose(0, 1), X.transpose(1, 2)).transpose(0, 1)
    return torch.matmul(X, w.unsqueeze(-1)).squeeze(-1)


def _data_gradient(X: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """X_iᵀ coeff_i for each worker: [N, L, d] × [N, L] -> [N, d] (× [R, N,
    L] -> [R, N, d], one skinny product a worker)."""
    if _shared(coeff, X):
        return torch.bmm(coeff.transpose(0, 1), X).transpose(0, 1).contiguous()
    return torch.matmul(coeff.unsqueeze(-2), X).squeeze(-2)


def sq_norm(w: torch.Tensor) -> torch.Tensor:
    """‖w‖² over the last axis. In bfloat16 as the JAX package's ``dot(w,
    w)``: the products exact in float32, summed there, rounded once."""
    if w.dtype == _BF16:
        wf = w.float()
        return torch.sum(wf * wf, dim=-1).to(_BF16)
    return torch.sum(w * w, dim=-1)


def _reg(lam: float, w: torch.Tensor) -> torch.Tensor:
    """(λ/2)‖w‖², the scalar rounded to the run dtype first."""
    return scalar(0.5 * lam, w.dtype) * sq_norm(w)


def _plus_reg(data_grad: torch.Tensor, lam: float, w: torch.Tensor,
              unrounded: bool) -> torch.Tensor:
    """The gradient's last operation, data term + λw. ``unrounded`` (for a
    caller that reduces the gradient over the workers): in bfloat16 the
    addition's float32 value, unrounded, as XLA fuses it into the
    reduction."""
    reg = scalar(lam, w.dtype) * w
    if unrounded and w.dtype == _BF16:
        return data_grad.float() + reg.float()
    return data_grad + reg


def _sigmoid_neg(m: torch.Tensor) -> torch.Tensor:
    """σ(−m); in bfloat16 ``jax.nn.sigmoid``'s 1 / (1 + exp(−z)) at z = −m,
    each operation rounded (``torch.sigmoid`` rounds once; −(−m) is m
    exactly, so exp takes m)."""
    if m.dtype == _BF16:
        return 1 / (1 + torch.exp(m))
    return torch.sigmoid(-m)


def logistic_objective_weighted(w, X, y, weights, lam):
    """Σ_l weights_l · log(1 + exp(−y_l x_lᵀw)) + (λ/2)‖w‖², per worker."""
    margins = y * _predict(w, X)
    return sum_of(torch.mul, weights, _softplus_neg(margins), dim=-1) + _reg(lam, w)


def logistic_gradient_weighted(w, X, y, weights, lam, unrounded=False):
    margins = y * _predict(w, X)
    coeff = weights * (-y) * _sigmoid_neg(margins)
    return _plus_reg(_data_gradient(X, coeff), lam, w, unrounded)


def quadratic_objective_weighted(w, X, y, weights, mu):
    """½ Σ_l weights_l (x_lᵀw − y_l)² + (μ/2)‖w‖², per worker."""
    residuals = _predict(w, X) - y
    return 0.5 * sum_of(torch.mul, weights, residuals**2, dim=-1) + _reg(mu, w)


def quadratic_gradient_weighted(w, X, y, weights, mu, unrounded=False):
    residuals = _predict(w, X) - y
    return _plus_reg(_data_gradient(X, weights * residuals), mu, w, unrounded)


# Huber regression: H_δ(r) = ½r² for |r| ≤ δ, else δ(|r| − ½δ). The
# gradient's coefficient is clip(r, −δ, δ), so H_δ is C¹ (not C²).


def _huber(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    half = scalar(0.5 * delta, r.dtype)
    delta = scalar(delta, r.dtype)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - half))


def huber_objective_weighted(w, X, y, weights, lam, delta):
    """Σ_l weights_l · H_δ(x_lᵀw − y_l) + (λ/2)‖w‖², per worker."""
    r = _predict(w, X) - y
    return sum_of(torch.mul, weights, _huber(r, delta), dim=-1) + _reg(lam, w)


def huber_gradient_weighted(w, X, y, weights, lam, delta, unrounded=False):
    r = _predict(w, X) - y
    delta = scalar(delta, r.dtype)
    return _plus_reg(_data_gradient(X, weights * torch.clamp(r, -delta, delta)), lam, w,
                     unrounded)


# Multinomial (softmax) logistic regression over K classes, labels in
# {0, …, K−1} stored as int32 in every run dtype (bfloat16 would round
# every odd label above 256), as the JAX package stores them. The
# parameter of worker i is the [d, K] matrix W_i, carried flat as
# w_i = W_i.reshape(-1) (row-major, d-major: the JAX package's
# ``w.reshape(d, -1)``), so gossip stays elementwise; K is inferred from
# w's width. The forward X W and backward Xᵀ(P − Y) are real products of
# 2·L·d·K operations each a worker.


def _class_logits(w: torch.Tensor, X: torch.Tensor):
    """(W [N, d, K] as a view of w [N, d·K], logits X W [N, L, K]); with R
    replicas against shared shards, W [R, N, d, K] and logits [R, N, L,
    K] from one [N, L, d] × [N, d, R·K] product."""
    W = w.reshape(*w.shape[:-1], X.shape[-1], -1)
    if _shared(w, X):
        r, n, d, k = W.shape
        flat = torch.bmm(X, W.permute(1, 2, 0, 3).reshape(n, d, r * k))
        return W, flat.reshape(n, -1, r, k).permute(2, 0, 1, 3)
    return W, torch.matmul(X, W)


def _labels(y: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Class indices [..., N, L, 1] of the int32 labels, as many as the
    logits' rows."""
    labels = y.to(torch.int64).unsqueeze(-1)
    return labels.expand(*logits.shape[:-1], 1)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the classes; in bfloat16 the JAX package's operations
    (max, a non-finite max taken as 0, exp of the difference, a float32 sum
    rounded once, log, + max), each rounded."""
    if logits.dtype != _BF16:
        return torch.logsumexp(logits, dim=-1)
    m = torch.amax(logits, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sumexp = sum_of(torch.exp, logits - m, dim=-1)
    return torch.log(torch.abs(sumexp)) + m.squeeze(-1)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Class probabilities; in bfloat16 ``jax.nn.softmax``'s operations
    (exp of the difference from the max, rounded, over the float32 sum of
    the unrounded exps, rounded once), each rounded (``torch.softmax``
    rounds once)."""
    if logits.dtype != _BF16:
        return torch.softmax(logits, dim=-1)
    shifted = logits - torch.amax(logits, dim=-1, keepdim=True)
    return torch.exp(shifted) / sum_of(torch.exp, shifted, dim=-1, keepdim=True)


def softmax_objective_weighted(w, X, y, weights, lam):
    """Σ_l weights_l · (logsumexp(x_lᵀW) − (x_lᵀW)_{y_l}) + (λ/2)‖w‖²."""
    _, logits = _class_logits(w, X)
    ce = _logsumexp(logits) - torch.gather(logits, -1, _labels(y, logits)).squeeze(-1)
    return sum_of(torch.mul, weights, ce, dim=-1) + _reg(lam, w)


def softmax_gradient_weighted(w, X, y, weights, lam, unrounded=False):
    W, logits = _class_logits(w, X)
    P = _softmax(logits)
    # The one-hot by scatter: no host check of the labels' range, so the
    # gradient captures in a CUDA graph.
    Y = torch.zeros_like(P).scatter_(-1, _labels(y, logits), 1.0)
    coeff = weights.unsqueeze(-1) * (P - Y)
    if _shared(w, X):
        r, n, d, k = W.shape
        flat = torch.bmm(X.transpose(1, 2), coeff.permute(1, 2, 0, 3).reshape(n, -1, r * k))
        return (flat.reshape(n, d, r, k).permute(2, 0, 1, 3) + lam * W).reshape(*w.shape)
    G = _plus_reg(torch.matmul(X.transpose(-1, -2), coeff), lam, W, unrounded)
    return G.reshape(w.shape)
