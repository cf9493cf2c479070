"""CHOCO-SGD: decentralized SGD with compressed gossip (Koloskova, Stich &
Jaggi '19).

The port of ``distributed_optimization_tpu/algorithms/choco.py``:

    x_i^{t+1/2} = x_i^t − η_t g_i(x_i^t)
    x̂_i^{t+1}   = x̂_i^t + Q(x_i^{t+1/2} − x̂_i^t)     ← the only bits sent
    x_i^{t+1}   = x_i^{t+1/2} + γ [(W − I) X̂^{t+1}]_i

through the shared error-feedback exchange (``ops/compression.py``): on a
card the estimate update is one launch of the compression kernel, and W X̂
goes through ``ctx.mix`` (``ring_mix`` or ``fc_mix`` under ``pallas``).
With identity compression and γ = 1 it is D-SGD in its adapt-then-combine
form, x^{t+1} = W (x^t − η g). Each edge carries the compressor's payload
(``comm_payload``). Byzantine screening does not compose with it.
"""

from __future__ import annotations

from distributed_optimization_tpu_torch.algorithms.base import (
    Algorithm,
    State,
    StepContext,
    register_algorithm,
)
from distributed_optimization_tpu_torch.ops.compression import (
    make_compressor,
    make_error_feedback,
)


def error_feedback(config, d: int):
    """The run's error-feedback exchange for d-dimensional rows."""
    return make_error_feedback(config.compression, d, config.compression_k, config.choco_gamma)


def init(x0, config, *, neighbor_sum=None) -> State:
    return {"x": x0, "xhat": error_feedback(config, x0.shape[-1]).init(x0)}


def step(state: State, ctx: StepContext) -> State:
    """One CHOCO iteration; compressed D-SGD takes it as its own."""
    x, xhat = state["x"], state["xhat"]
    ef = error_feedback(ctx.config, x.shape[-1])
    g = ctx.grad(x, 0)
    x_half = x - ctx.eta * g
    x_new, xhat_new = ef.exchange(ctx.draw(0), x_half, xhat, ctx.mix)
    return {"x": x_new, "xhat": xhat_new}


def comm_payload(config, d: int) -> float:
    """The compressor's floats an edge (d for compression='none')."""
    return make_compressor(config.compression, d, config.compression_k).floats_per_edge


CHOCO = register_algorithm(
    Algorithm(name="choco", init=init, step=step, gossip_rounds=1,
              comm_payload=comm_payload, supports_edge_faults=False)
)
