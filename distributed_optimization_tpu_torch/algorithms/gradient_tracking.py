"""Gradient tracking (DIGing; Nedić-Olshevsky-Shi 2017, Koloskova et al. 2020).

The port of ``distributed_optimization_tpu/algorithms/gradient_tracking.py``
without compression (not ported yet). Each worker keeps a tracker y_i of
the network-average gradient beside its model:

    x_{t+1} = W x_t − η y_t
    y_{t+1} = W y_t + g(x_{t+1}) − g_prev

which keeps mean(y_t) = mean(g_t). y_0 = g_prev = 0, so iteration 0 is a
pure gossip step and y_1 = g_1. Two gossip rounds an iteration (x and y),
``gossip_rounds=2`` for the floats-transmitted metric; with
``mixing_impl='pallas'`` each is the ring or fc mixing kernel, and under
Byzantine screening each goes through the corrupt → screen → mix
composition (the fused robust aggregator twice an iteration).

With ``config.local_steps`` = τ > 1, τ−1 local descents follow along the
tracker-corrected direction y_{t+1} + (g(v, s) − g(x_{t+1})), each on its
own batch draw (slot s); the tracker recursion is untouched.
"""

from __future__ import annotations

import torch

from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    local_descent_loop,
    register_algorithm,
)


def _init(x0, config, *, neighbor_sum=None) -> State:
    zeros = torch.zeros_like(x0)
    return {"x": x0, "y": zeros, "g_prev": zeros}


def _step(state: State, ctx: StepContext) -> State:
    x, y, g_prev = state["x"], state["y"], state["g_prev"]
    x_new = ctx.mix(x) - ctx.eta * y
    g_new = ctx.grad(x_new, 0)
    y_new = ctx.mix(y) + g_new - g_prev
    v = local_descent_loop(x_new, ctx, lambda vv, s: y_new + ctx.grad(vv, s) - g_new)
    return {"x": v, "y": y_new, "g_prev": g_new}


GRADIENT_TRACKING = register_algorithm(
    Algorithm(name="gradient_tracking", init=_init, step=_step, gossip_rounds=2,
              supports_byzantine=True)
)
