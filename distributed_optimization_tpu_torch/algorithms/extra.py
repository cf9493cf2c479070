"""EXTRA (Shi, Ling, Wu, Yin 2015): an exact first-order decentralized method.

The port of ``distributed_optimization_tpu/algorithms/extra.py``. EXTRA
corrects D-SGD's constant-step bias with a one-step memory:

    x_1     = W x_0 − η g(x_0)
    x_{t+1} = (I + W) x_t − W̃ x_{t−1} − η (g(x_t) − g(x_{t−1})),  W̃ = (I + W)/2

One gossip an iteration: W̃ x_{t−1} reuses the previous iteration's mix,
carried as ``mix_x_prev``. The t = 0 step is chosen by ``torch.where`` on
the device counter ``ctx.t``, so one captured graph serves every
iteration. Byzantine screening is refused: the fixed point needs the
static linear W.
"""

from __future__ import annotations

import torch

from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    register_algorithm,
)


def _init(x0, config, *, neighbor_sum=None) -> State:
    zeros = torch.zeros_like(x0)
    return {"x": x0, "x_prev": x0, "mix_x_prev": zeros, "g_prev": zeros}


def _step(state: State, ctx: StepContext) -> State:
    x, x_prev = state["x"], state["x_prev"]
    g = ctx.grad(x, 0)
    mix_x = ctx.mix(x)
    # W̃ x_{t−1} = (x_{t−1} + W x_{t−1}) / 2, reusing last iteration's mix.
    w_tilde_x_prev = 0.5 * (x_prev + state["mix_x_prev"])
    general = x + mix_x - w_tilde_x_prev - ctx.eta * (g - state["g_prev"])
    first = mix_x - ctx.eta * g  # the t = 0 step
    x_new = torch.where(ctx.t == 0, first, general)
    return {"x": x_new, "x_prev": x, "mix_x_prev": mix_x, "g_prev": g}


EXTRA = register_algorithm(Algorithm(name="extra", init=_init, step=_step, gossip_rounds=1,
                                           supports_edge_faults=False))
