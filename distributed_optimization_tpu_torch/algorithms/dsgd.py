"""Decentralized SGD (the D-PSGD form of Lian et al. 2017).

The port of ``distributed_optimization_tpu/algorithms/dsgd.py``: each
worker takes its stochastic gradient at its own pre-mix model, gossips, and
steps,

    x_{i,t+1} = Σ_j W_ij x_{j,t} − η_t g_i(x_{i,t}),

through ``ctx.fused_mix_step`` (one kernel) when the backend offers it: the
fused ring step, or under Byzantine screening the fused robust step.

With ``config.compression != 'none'`` the exchange goes through the shared
error-feedback machinery (``ops/compression.py``): the state carries an
estimate x̂ and each round transmits only Q(x_{t+1/2} − x̂),

    x_{t+1/2} = x_t − η g(x_t);   x̂⁺ = x̂ + Q(x_{t+1/2} − x̂)
    x_{t+1}   = x_{t+1/2} + γ (W − I) X̂⁺,

CHOCO-SGD under the D-SGD registration: the branch is CHOCO's step, so
with ``lr_schedule='constant'`` the run is CHOCO's op for op. It comes
before the fused step, so a compressed run launches the compression kernel
and ``ctx.mix`` instead.
``comm_payload`` is the compressor's floats an edge (d uncompressed).
"""

from __future__ import annotations

from distributed_optimization_tpu_torch.algorithms import choco
from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    local_descent_loop,
    register_algorithm,
)


def _init(x0, config, *, neighbor_sum=None) -> State:
    if config.compression != "none":
        return choco.init(x0, config)
    return {"x": x0}


def _step(state: State, ctx: StepContext) -> State:
    if "xhat" in state:
        return choco.step(state, ctx)
    x = state["x"]
    grads = ctx.grad(x, 0)  # at the local pre-mix models (D-PSGD ordering)
    if ctx.fused_mix_step is not None:
        x_new = ctx.fused_mix_step(x, grads, ctx.eta)
    else:
        x_new = ctx.mix(x) - ctx.eta * grads
    x_new = local_descent_loop(x_new, ctx, lambda v, s: ctx.grad(v, s))
    return {"x": x_new}


DSGD = register_algorithm(
    Algorithm(name="dsgd", init=_init, step=_step, gossip_rounds=1, supports_byzantine=True, supports_churn=True,
              comm_payload=choco.comm_payload)
)
