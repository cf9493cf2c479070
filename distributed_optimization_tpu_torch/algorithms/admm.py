"""Decentralized linearized ADMM (DLM; Ling-Shi-Wu-Ribeiro 2015).

The port of ``distributed_optimization_tpu/algorithms/admm.py``. With
zero-initialized duals the edge variables eliminate to the edge midpoints
and, linearizing f_i at x_i^k with proximal weight ρ, the node updates are

    x_i^{k+1} = [ρ x_i^k + (c/2)(d_i x_i^k + Σ_{j∈N_i} x_j^k)
                 − g_i(x_i^k) − α_i^k] / (ρ + c d_i)
    α_i^{k+1} = α_i^k + (c/2)(d_i x_i^{k+1} − Σ_{j∈N_i} x_j^{k+1})

One model-sized exchange an iteration, ``ctx.neighbor_sum`` (A x): the
x-update reuses the neighbour sum the previous dual update carried. With
``mixing_impl='pallas'`` that is the ring or fc neighbour-sum kernel, as
in the JAX package; the rest of the step is elementwise torch ops, which
the JAX package fuses into no kernel either.

``init`` computes A x_0 once, through the backend's ``neighbor_sum``, so a
warm start with x_0 ≠ 0 needs no guard in the loop.
"""

from __future__ import annotations

import torch

from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    register_algorithm,
)
from distributed_optimization_tpu_torch.ops.rounding import scalar


def _init(x0, config, *, neighbor_sum=None) -> State:
    zeros = torch.zeros_like(x0)
    nbr_x = neighbor_sum(x0) if neighbor_sum is not None else zeros
    return {"x": x0, "alpha": zeros, "nbr_x": nbr_x}


def _step(state: State, ctx: StepContext) -> State:
    x, alpha, nbr_x = state["x"], state["alpha"], state["nbr_x"]
    # The constants rounded to the run dtype first, as the JAX package's
    # weak-typed Python floats are (ops/rounding.py).
    c = scalar(ctx.config.admm_c, x.dtype)
    half_c = scalar(0.5 * ctx.config.admm_c, x.dtype)
    rho = scalar(ctx.config.admm_rho, x.dtype)
    deg = ctx.degrees  # [N, 1]
    g = ctx.grad(x, 0)
    x_new = (rho * x + half_c * (deg * x + nbr_x) - g - alpha) / (rho + c * deg)
    nbr_new = ctx.neighbor_sum(x_new)
    alpha_new = alpha + half_c * (deg * x_new - nbr_new)
    return {"x": x_new, "alpha": alpha_new, "nbr_x": nbr_new}


# Byzantine injection is refused: the dual update pairs neighbor_sum with
# the static degree d_i, so it does not go through ctx.mix alone.
ADMM = register_algorithm(
    Algorithm(name="admm", init=_init, step=_step, gossip_rounds=1, supports_byzantine=False,
              supports_edge_faults=False)
)
