"""Gradient tracking (DIGing; Nedić-Olshevsky-Shi 2017, Koloskova et al. 2020).

The port of ``distributed_optimization_tpu/algorithms/gradient_tracking.py``.
Each worker keeps a tracker y_i of
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

With ``config.compression != 'none'`` both gossip rounds go through the
error-feedback exchange (``ops/compression.py``), each over its own
estimate (x̂ for x, ŷ for y) and with its own draw (rounds 0 and 1):

    x_{t+1} = x_t + γ (W − I) X̂⁺ − η y_t
    y_{t+1} = (y_t + γ (W − I) Ŷ⁺ + g(x_{t+1})) − g_prev,

and an edge carries twice the compressor's payload.
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
from distributed_optimization_tpu_torch.algorithms.choco import error_feedback
from distributed_optimization_tpu_torch.ops.compression import make_compressor


def _init(x0, config, *, neighbor_sum=None) -> State:
    zeros = torch.zeros_like(x0)
    state = {"x": x0, "y": zeros, "g_prev": zeros}
    if config.compression != "none":
        ef = error_feedback(config, x0.shape[-1])
        state["xhat"] = ef.init(x0)
        state["yhat"] = ef.init(x0)
    return state


def _step(state: State, ctx: StepContext) -> State:
    x, y, g_prev = state["x"], state["y"], state["g_prev"]
    if "xhat" in state:
        ef = error_feedback(ctx.config, x.shape[-1])
        x_mixed, xhat_new = ef.exchange(ctx.draw(0), x, state["xhat"], ctx.mix)
        x_new = x_mixed - ctx.eta * y
        g_new = ctx.grad(x_new, 0)
        y_mixed, yhat_new = ef.exchange(ctx.draw(1), y, state["yhat"], ctx.mix)
        return {"x": x_new, "y": y_mixed + g_new - g_prev, "g_prev": g_new,
                "xhat": xhat_new, "yhat": yhat_new}
    x_new = ctx.mix(x) - ctx.eta * y
    g_new = ctx.grad(x_new, 0)
    y_new = ctx.mix(y) + g_new - g_prev
    v = local_descent_loop(x_new, ctx, lambda vv, s: y_new + ctx.grad(vv, s) - g_new)
    return {"x": v, "y": y_new, "g_prev": g_new}


def _comm_payload(config, d: int) -> float:
    """Two exchanges an iteration: 2 × the compressor's floats (2d
    uncompressed)."""
    return 2.0 * make_compressor(config.compression, d, config.compression_k).floats_per_edge


GRADIENT_TRACKING = register_algorithm(
    Algorithm(name="gradient_tracking", init=_init, step=_step, gossip_rounds=2,
              supports_byzantine=True, supports_churn=True,
              comm_payload=_comm_payload)
)
