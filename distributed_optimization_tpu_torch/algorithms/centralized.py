"""Centralized synchronous mini-batch SGD (the parameter-server pattern).

The port of ``distributed_optimization_tpu/algorithms/centralized.py``:
every worker takes its stochastic gradient at the shared model, the server
averages them and steps; all N rows of the state stay identical.
"""

from __future__ import annotations

from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    register_algorithm,
)


def _init(x0, config, *, neighbor_sum=None) -> State:
    return {"x": x0}


def _step(state: State, ctx: StepContext) -> State:
    x = state["x"]
    # In bfloat16 the gradients' last addition goes into the mean
    # unrounded, as the JAX package's XLA fuses it into the reduction.
    grads = ctx.grad(x, 0, unrounded=True)
    avg_grad = grads.mean(dim=-2, keepdim=True).to(x.dtype)
    return {"x": x - ctx.eta * avg_grad}


CENTRALIZED = register_algorithm(
    Algorithm(
        name="centralized", init=_init, step=_step, gossip_rounds=0,
        is_decentralized=False,
    )
)
