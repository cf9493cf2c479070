"""Push-sum stochastic gradient (SGP) over directed graphs.

The port of ``distributed_optimization_tpu/algorithms/push_sum.py``
(Kempe-Dobra-Gehrke 2003; Nedić-Olshevsky 2016; Assran et al. 2019,
Algorithm 1). With only a column-stochastic mixing matrix A (each node
splits its mass over its out-neighbours), plain gossip converges to the
graph's Perron-weighted average; push-sum carries a scalar mass per node
and divides it back out:

    num_{t+1} = A (num_t − η_t ∇F(z_t))
    w_{t+1}   = A w_t,                       w_0 = 1
    z_{t+1}   = num_{t+1} / w_{t+1}

Columns of A sum to 1, so Σ_i num_i and Σ_i w_i = N are conserved by every
mix. The gradient is taken at the de-biased z.

State: ``x`` holds z, the per-worker estimates, so the metrics and
``final_models`` read the model as for every other rule; ``num`` [N, d]
and ``w`` [N, 1] carry the recursion. On a doubly stochastic W (the
undirected graphs) w stays 1 and the rule is adapt-then-combine D-SGD.

It mixes num − η g, so it never takes ``ctx.fused_mix_step`` (that
kernel computes W x − η g). Each gossip round sends d + 1 floats an edge:
the numerator and the mass. Byzantine injection and robust screening do
not compose with it (``supports_byzantine=False``): screening breaks the
mass conservation the debiasing needs.
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
    w0 = torch.ones((*x0.shape[:-1], 1), dtype=x0.dtype, device=x0.device)
    return {"x": x0, "num": x0, "w": w0}


def _step(state: State, ctx: StepContext) -> State:
    z, num, w = state["x"], state["num"], state["w"]
    g = ctx.grad(z, 0)  # at the de-biased estimate
    num_new = ctx.mix(num - ctx.eta * g)
    w_new = ctx.mix(w)
    return {"x": num_new / w_new, "num": num_new, "w": w_new}


PUSH_SUM = register_algorithm(
    Algorithm(name="push_sum", init=_init, step=_step, gossip_rounds=1,
              comm_payload=lambda config, d: float(d + 1))
)
