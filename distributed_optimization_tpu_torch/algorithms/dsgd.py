"""Decentralized SGD (the D-PSGD form of Lian et al. 2017).

The port of ``distributed_optimization_tpu/algorithms/dsgd.py`` without
compression (not ported yet): each worker takes its stochastic gradient at its own pre-mix
model, gossips, and steps,

    x_{i,t+1} = Σ_j W_ij x_{j,t} − η_t g_i(x_{i,t}),

through ``ctx.fused_mix_step`` (one kernel) when the backend offers it: the
fused ring step, or under Byzantine screening the fused robust step.
"""

from __future__ import annotations

from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    local_descent_loop,
    register_algorithm,
)


def _init(x0, config, *, neighbor_sum=None) -> State:
    return {"x": x0}


def _step(state: State, ctx: StepContext) -> State:
    x = state["x"]
    grads = ctx.grad(x, 0)  # at the local pre-mix models (D-PSGD ordering)
    if ctx.fused_mix_step is not None:
        x_new = ctx.fused_mix_step(x, grads, ctx.eta)
    else:
        x_new = ctx.mix(x) - ctx.eta * grads
    x_new = local_descent_loop(x_new, ctx, lambda v, s: ctx.grad(v, s))
    return {"x": x_new}


DSGD = register_algorithm(
    Algorithm(name="dsgd", init=_init, step=_step, gossip_rounds=1, supports_byzantine=True)
)
