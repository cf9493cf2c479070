"""Algorithm abstraction: a pure init/step pair over an [N, d] model stack.

The port of ``distributed_optimization_tpu/algorithms/base.py``. State is a
dict of ``[N, d]`` tensors (push-sum's mass ``w`` is ``[N, 1]``) with an
``x`` entry (the per-worker models); a step rule reads what it needs from
a :class:`StepContext` the backend builds for each iteration. Under
``torch_backend.run_batch`` every leaf has a leading replica axis, ``[R, N,
d]``: the rules act on the worker axis at −2, ``degrees [N, 1]`` and a
step size of shape ``[R, 1, 1]`` broadcast against it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepContext:
    """What a step rule may touch.

    ``grad(params, slot)``: stochastic gradient at ``params`` ([N, d] ->
    [N, d]) for batch draw ``slot``; ``grad(params, slot, unrounded=True)``
    gives a bfloat16 run's gradient as float32, its last addition
    unrounded, for a rule that reduces it over the workers. ``mix``: x -> W x. ``neighbor_sum``:
    x -> A x. ``eta``: this iteration's step size, a one-element tensor in
    the run dtype on the run device. ``config``: the ExperimentConfig.
    ``degrees``: [N, 1] node degrees in the run dtype on the run device
    (zeros for the centralized pattern); the backend always passes it, and
    only a rule that reads it (ADMM) needs it. ``fused_mix_step``:
    optional (x, g, eta) -> W x − eta g in one kernel. ``t``: the iteration
    counter, an int64 tensor of one element on the run device (EXTRA
    branches on t == 0 with it, so one captured graph serves every
    iteration). ``draw(round)``: the ``ops/compression.Draw`` of this
    iteration's compressed exchange ``round`` (the tag key of the run's seed,
    ``t`` and the round), which the compressed rules hand to the
    error-feedback exchange.
    """

    grad: Callable[[torch.Tensor, int], torch.Tensor]
    mix: Callable[[torch.Tensor], torch.Tensor]
    neighbor_sum: Callable[[torch.Tensor], torch.Tensor]
    eta: torch.Tensor
    config: Any
    degrees: Optional[torch.Tensor] = None
    fused_mix_step: Any = None
    t: Optional[torch.Tensor] = None
    draw: Optional[Callable[[int], Any]] = None


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A named step rule: ``init(x0, config, *, neighbor_sum=None) ->
    state`` and ``step(state, ctx) -> state``. ``neighbor_sum`` (x -> A x),
    when the backend passes it, lets a rule that carries a neighbour
    aggregate (ADMM) compute it for any x0, once, before the loop.
    ``gossip_rounds``: model-sized exchanges per iteration;
    ``is_decentralized``: False for the parameter server;
    ``supports_byzantine``: the rule's update goes through ``ctx.mix``
    alone, so Byzantine injection and robust screening compose with it.
    ``comm_payload(config, d)``: floats a gossip edge carries an iteration
    (the compressor's payload under compression), in place of
    ``d · gossip_rounds`` in the floats-transmitted metric; None keeps
    that. ``supports_edge_faults``: the rule stays faithful over per-round
    realized graphs (faults, matching schedules, participation);
    ``supports_churn``: it also survives multi-round outages and the warm
    restart on rejoin (the JAX package's flags and values)."""

    name: str
    init: Callable[..., State]
    step: Callable[[State, StepContext], State]
    gossip_rounds: int = 1
    is_decentralized: bool = True
    supports_byzantine: bool = False
    comm_payload: Optional[Callable[[Any, int], float]] = None
    supports_edge_faults: bool = True
    supports_churn: bool = False


def local_descent_loop(v: torch.Tensor, ctx: StepContext, direction) -> torch.Tensor:
    """The round's τ−1 extra local descents (``config.local_steps`` = τ):
    ``v ← v − η · direction(v, s)`` for the slots s = 1 … τ−1, unrolled in
    Python as the JAX package's numpy-polymorphic form is. ``s`` reaches
    ``ctx.grad`` as a Python int, so each slot's key is made on the host and
    the whole round lies in one captured chunk. τ = 1 returns ``v``
    untouched."""
    for s in range(1, ctx.config.local_steps):
        v = v - ctx.eta * direction(v, s)
    return v


_REGISTRY: dict[str, Algorithm] = {}


def register_algorithm(algo: Algorithm) -> Algorithm:
    _REGISTRY[algo.name] = algo
    return algo


def get_algorithm(name: str) -> Algorithm:
    from distributed_optimization_tpu_torch.algorithms import (  # noqa: F401
        admm,
        centralized,
        choco,
        dsgd,
        extra,
        gradient_tracking,
        push_sum,
    )

    if name not in _REGISTRY:
        raise ValueError(
            f"algorithm={name!r}: the PyTorch port does not have it yet "
            f"(known: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[name]
