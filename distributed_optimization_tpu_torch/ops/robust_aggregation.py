"""Robust neighbour aggregation: Byzantine-tolerant replacements for W x.

The port of the dense and gather forms of
``distributed_optimization_tpu/ops/robust_aggregation.py``. Each honest
worker screens the models it receives before combining them:

- **trimmed_mean**: per coordinate, sort the closed neighbourhood, drop the
  b largest and b smallest values and average the rest;
- **median**: the per-coordinate midpoint of the closed neighbourhood;
- **clipped_gossip**: x_i + Σ_j W_ij · clip_τᵢ(x_j − x_i) with the MH
  weights of the realized graph, τᵢ fixed or adaptive (the (deg−b)-th
  smallest neighbour-difference norm).

The dense form (``make_robust_aggregator``, ``robust_impl='dense'``) sorts
the closed neighbourhood over the node axis, ``[N, N, d]``, for a realized
0/1 adjacency A_t; the JAX package computes it in XLA with no Pallas kernel,
and ``torch.sort`` does here. The gather form works over the static
``[N, k_max]`` neighbour table
(``parallel/topology.py::neighbor_table``) and per-slot liveness bits, in
torch ops (``torch.sort``, ``take_along_dim``; sums over the slot axis in
slot order): ``robust_impl='gather'``.
The single-kernel form is ``ops/robust_kernels.py``. The per-node numpy
oracle ``robust_aggregate_np`` is a copy of the JAX package's, for the
tests. Math runs in promote(float32, dtype); only the output is cast back.

The replica axis (``torch_backend.run_batch``): both forms take a leading
[R] on the stack and the liveness (``x [R, N, d]``, ``live [R, N, k]``,
``A_t [R, N, N]``) and screen each replica as the single run does; a fixed
clipping radius may be a tensor of R (a swept ``clip_tau``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distributed_optimization_tpu_torch.backends.base import resolve_device

ROBUST_RULES = ("trimmed_mean", "median", "clipped_gossip")

RobustAggregator = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def check_rule(name: str, budget: int) -> None:
    if name not in ROBUST_RULES:
        raise ValueError(
            f"no robust aggregator named {name!r}; plain gossip is built by "
            "ops/mixing.py"
        )
    if budget < 1:
        raise ValueError(f"{name} needs a positive attack budget, got {budget}")


def slot_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the slot axis ``[..., N, k, d]`` (dim −2) as a loop in slot
    order, so that every form of a rule adds the same values in the same
    order."""
    out = torch.zeros_like(t[..., 0, :])
    for col in t.unbind(-2):
        out = out + col
    return out


def validate_budget(min_degree: int, budget: int, aggregation: str) -> None:
    """Reject budgets the topology cannot support: trimming b from each
    tail needs 2·b ≤ the smallest degree."""
    if aggregation not in ("gossip", *ROBUST_RULES):
        raise ValueError(f"Unknown aggregation: {aggregation}")
    if 2 * budget > min_degree:
        raise ValueError(
            f"robust_b={budget} exceeds what the topology supports: "
            f"trimming {budget} from each tail needs 2*b <= min degree "
            f"({min_degree}), or the weakest node's screened neighborhood "
            "is empty — lower robust_b or use a better-connected topology"
        )


def _fixed_tau(clip_tau, shape, acc, device) -> torch.Tensor:
    """The fixed radius of every node: ``[N]`` for a float, ``[R, N]`` for
    a tensor of R radii (one a replica), in ``acc``."""
    if isinstance(clip_tau, torch.Tensor):
        return clip_tau.to(device=device, dtype=acc)[:, None].expand(-1, shape[-2])
    return torch.full((shape[-2],), float(clip_tau), dtype=acc, device=device)


def is_adaptive(name: str, clip_tau) -> bool:
    """Clipping takes the adaptive radius for a concrete ``clip_tau <= 0``."""
    return name == "clipped_gossip" and isinstance(clip_tau, (int, float)) and clip_tau <= 0.0


def _adaptive_clip_tau(mask: torch.Tensor, norms: torch.Tensor, budget: int,
                       k_cap: int) -> torch.Tensor:
    """The (deg−b)-th smallest realized neighbour-difference norm per node;
    τ = 0 (the identity row) where deg ≤ b."""
    deg = torch.sum(mask, dim=-1).to(torch.int64)
    masked = torch.where(mask > 0, norms, torch.inf)
    ranked = torch.sort(masked, dim=-1).values
    k = torch.clamp(deg - budget - 1, 0, k_cap - 1)
    kth = torch.take_along_dim(ranked, k[..., None], dim=-1)[..., 0]
    return torch.where(deg - budget >= 1, kth, torch.zeros_like(kth))


def make_robust_aggregator(name: str, budget: int, clip_tau: float = 0.0) -> RobustAggregator:
    """``aggregate(A_t, x) -> x_new`` over the node axis (the dense form).

    ``A_t``: realized 0/1 adjacency, zero diagonal, ``A[i, j] = 1`` iff j's
    message reaches i this round. ``x``: the [N, d] stack as transmitted.
    """
    check_rule(name, budget)
    adaptive = is_adaptive(name, clip_tau)

    def closed_sorted(A, x):
        """The closed neighbourhood sorted over the node axis ([N, N, d],
        +inf beyond each row's count) and the counts."""
        closed = A + torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        vals = torch.where((closed > 0)[..., None], x[..., None, :, :], torch.inf)
        return torch.sort(vals, dim=-2).values, torch.sum(closed, dim=-1)

    def aggregate(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(torch.float32, x.dtype)
        xa = x.to(acc)
        Aa = A.to(acc)
        n = A.shape[-1]
        if name == "trimmed_mean":
            s, counts = closed_sorted(Aa, xa)
            pos = torch.arange(n, dtype=acc, device=x.device)
            keep = (pos >= budget) & (pos < (counts - budget)[..., None])
            kept = torch.clamp(counts - 2 * budget, min=0.0)
            total = torch.sum(torch.where(keep[..., None], s, 0.0), dim=-2)
            mean = total / torch.clamp(kept, min=1.0)[..., None]
            return torch.where((kept >= 1.0)[..., None], mean, xa).to(x.dtype)
        if name == "median":
            s, counts = closed_sorted(Aa, xa)
            c = counts.to(torch.int64)
            lo = torch.clamp((c - 1) // 2, min=0)[..., None, None]
            hi = torch.clamp(c // 2, min=0)[..., None, None]
            med = 0.5 * (torch.take_along_dim(s, lo, dim=-2) + torch.take_along_dim(s, hi, dim=-2))
            return med[..., 0, :].to(x.dtype)
        from distributed_optimization_tpu_torch.parallel.faults import (
            metropolis_hastings_weights,
        )

        W = metropolis_hastings_weights(Aa)
        diffs = xa[..., None, :, :] - xa[..., :, None, :]  # [receiver i, sender j, d]
        norms = torch.sqrt(torch.sum(diffs * diffs, dim=-1))
        if adaptive:
            tau = _adaptive_clip_tau(Aa, norms, budget, n)
        else:
            tau = _fixed_tau(clip_tau, x.shape, acc, x.device)
        factor = torch.minimum(
            torch.ones((), dtype=acc, device=x.device),
            tau[..., None] / torch.clamp(norms, min=torch.finfo(acc).tiny),
        )
        moved = torch.sum(W[..., None] * diffs * factor[..., None], dim=-2)
        return (xa + moved).to(x.dtype)

    return aggregate


def make_gather_robust_aggregator(
    name: str,
    budget: int,
    nbr_idx,
    clip_tau: float = 0.0,
    *,
    device: torch.device | str = "cuda",
) -> RobustAggregator:
    """``aggregate(live, x) -> x_new`` over the neighbour table.

    ``nbr_idx``: the [N, k_max] table (padded slots point at self).
    ``live``: [N, k_max] 0/1 liveness of each slot. ``x``: the [N, d] stack
    as transmitted (corrupted upstream).
    """
    check_rule(name, budget)
    nbr = torch.as_tensor(np.asarray(nbr_idx), dtype=torch.int64, device=resolve_device(device))
    k_max = nbr.shape[1]
    adaptive = is_adaptive(name, clip_tau)

    def closed_sorted(live, x):
        """The closed neighbourhood sorted over the slot axis
        ([N, k_max+1, d], +inf beyond each row's count) and the counts."""
        vals = torch.where(live[..., None] > 0, x[..., nbr, :], torch.inf)
        closed = torch.cat([x[..., None, :], vals], dim=-2)
        return torch.sort(closed, dim=-2).values, torch.sum(live, dim=-1) + 1.0

    def aggregate(live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(torch.float32, x.dtype)
        xa = x.to(acc)
        lv = live.to(acc)
        if name == "trimmed_mean":
            s, counts = closed_sorted(lv, xa)
            pos = torch.arange(k_max + 1, dtype=acc, device=x.device)
            keep = (pos >= budget) & (pos < (counts - budget)[..., None])
            kept = torch.clamp(counts - 2 * budget, min=0.0)
            total = slot_sum(torch.where(keep[..., None], s, 0.0))
            mean = total / torch.clamp(kept, min=1.0)[..., None]
            return torch.where((kept >= 1.0)[..., None], mean, xa).to(x.dtype)
        if name == "median":
            s, counts = closed_sorted(lv, xa)
            c = counts.to(torch.int64)
            lo = torch.clamp((c - 1) // 2, min=0)[..., None, None]
            hi = torch.clamp(c // 2, min=0)[..., None, None]
            med = 0.5 * (torch.take_along_dim(s, lo, dim=-2) + torch.take_along_dim(s, hi, dim=-2))
            return med[..., 0, :].to(x.dtype)
        deg = torch.sum(lv, dim=-1)
        diffs = xa[..., nbr, :] - xa[..., None, :]
        norms = torch.sqrt(torch.sum(diffs * diffs, dim=-1))
        if adaptive:
            tau = _adaptive_clip_tau(lv, norms, budget, k_max)
        else:
            tau = _fixed_tau(clip_tau, x.shape, acc, x.device)
        w = lv / (1.0 + torch.maximum(deg[..., None], deg[..., nbr]))
        factor = torch.minimum(
            torch.ones((), dtype=acc, device=x.device),
            tau[..., None] / torch.clamp(norms, min=torch.finfo(acc).tiny),
        )
        moved = slot_sum(w[..., None] * diffs * factor[..., None])
        return (xa + moved).to(x.dtype)

    return aggregate


def robust_aggregate_np(
    name: str, A: np.ndarray, x: np.ndarray, budget: int, clip_tau: float = 0.0
) -> np.ndarray:
    """Per-node float64 numpy oracle of the rules, written as explicit
    loops from the definitions (a copy of the JAX package's)."""
    n = x.shape[0]
    degs = A.sum(axis=1)
    out = np.empty_like(x, dtype=np.float64)
    for i in range(n):
        nbrs = np.nonzero(A[i])[0]
        if name in ("trimmed_mean", "median"):
            vals = np.concatenate([x[nbrs], x[i : i + 1]], axis=0)
            s = np.sort(vals, axis=0)
            c = vals.shape[0]
            if name == "median":
                out[i] = 0.5 * (s[(c - 1) // 2] + s[c // 2])
            elif c - 2 * budget >= 1:
                out[i] = s[budget : c - budget].mean(axis=0)
            else:
                out[i] = x[i]
        elif name == "clipped_gossip":
            diffs = x[nbrs] - x[i]
            norms = np.linalg.norm(diffs, axis=1)
            if clip_tau > 0.0:
                tau = clip_tau
            else:
                k = len(nbrs) - budget
                tau = float(np.sort(norms)[k - 1]) if k >= 1 else 0.0
            w = 1.0 / (1.0 + np.maximum(degs[i], degs[nbrs]))
            fac = np.minimum(1.0, tau / np.maximum(norms, np.finfo(np.float64).tiny))
            out[i] = x[i] + (w[:, None] * diffs * fac[:, None]).sum(axis=0)
        else:
            raise ValueError(f"no robust aggregator named {name!r}")
    return out
