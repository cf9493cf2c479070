"""The PyTorch execution backend: one run of one algorithm on one device.

The port of the unsharded run loop of
``distributed_optimization_tpu/backends/jax_backend.py`` (``_run``,
``_make_step_eval``, ``make_chunk``, ``_build_faulty`` and
``_bind_byzantine``). One iteration is: per-worker mini-batch sampling (the
JAX package's batches: one sampling kernel launch on a card, the twin of
``jax.random`` on the CPU) → per-worker closed-form gradients → gossip (or
the fused ring kernel; under Byzantine injection the corrupt → screen → mix
composition, or the fused robust kernel) → step; gradient tracking gossips
twice, ADMM exchanges the neighbour sum A x instead of W x, push-sum mixes
its numerators and their [N, 1] mass, and τ > 1 local steps add τ − 1
sampled descents. Under faults or a matching schedule the round's graph is
realized first (``parallel/faults.py``: one draw kernel launch on a card,
which also gives W_t and adds the realized degrees to the device total
behind the floats transmitted), its W_t takes the place of the mixing
operator (and the fused ring step is off), a rejoining node's warm restart
precedes the step, and inactive nodes' rows of every state leaf are frozen
after it. The graph is built as the config's ``resolved_topology_impl()``
and ``resolved_topology_sampler()`` say: a matrix-free graph (the [N,
k_max] neighbour table alone) mixes in gather form, screens on its own
table and realizes a faulted round as the slot round (one launch pair a
step, ``draw_kernels.realize_slot_round``), with no [N, N] object.

The run is a sequence of chunks, the counterpart of the JAX package's scan
over eval chunks: one chunk runs ``eval_every`` iterations and then writes
the suboptimality gap and consensus error into preallocated device
tensors. The iteration counter ``t`` and the eval slot ``k`` are int64
device tensors of one element that the chunk advances in place, so a
chunk's work does not depend on the host: the same function runs every
chunk. The host fetches the histories once, after the last chunk.

- On the CPU, the run calls the chunk function chunk after chunk.
- On a card, the first chunk runs eagerly on a side stream as the warm-up
  (it builds the CUDA kernels and any lazy state). Then one chunk is
  captured on that stream as a CUDA graph, and the chunks left run only as
  its replays, one a chunk. Every chunk does the same work, so one graph
  serves them all. The state lives in static buffers that the graph's
  last operations write back into, so replays chain. A capture that fails
  raises; nothing falls back to an eager loop. (Graphs of 64 iterations
  replayed as often, with a smaller graph for the rest, ran the main path
  no faster at eval every iteration and took 0.3–0.4 s longer to capture;
  PERF.md §6.)
- ``measure_timestamps=True`` drives the same chunk function from the host
  with no graph, synchronising after each chunk, and records a real
  ``perf_counter`` time per eval (the JAX package's measured chunk loop).
  It is the bitwise reference of the graph run.

The kernels count their own launches on the card (``LAUNCHES`` of
``ops/*_kernels.py``), so each replay counts each launch it holds, and the
run loop keeps no count of its own.

The replica axis (``run_batch``, the port of ``jax_backend.run_batch``): R
seeds of one config, and per-replica values of ``SWEEPABLE_FIELDS``, run
as the same program over a leading [R] axis on every state leaf: the same
``_Program``, chunk and capture, one CUDA graph for all R. Each step's
sampling, round and noise draws are one launch for all R (the kernels take
the replicas' keys from device memory); the graph, the mixing operator
and the shards are shared, each replica's streams, Byzantine set, timeline
and swept scalars are its own. Replica r is the sequential run of
``config.replace(seed=seeds[r], topology_seed=<base>, **sweep[r])``. The
single run has no replica axis: its shapes, kernels and bits are as
before.

bfloat16 (``dtype='bfloat16'``, the synchronous single run: every
algorithm, compression, attack and robust rule, the dense and the
matrix-free graphs; not the event clock or the replica axis): every
operation rounds as the JAX package's bfloat16 run rounds it on the CPU.
Elementwise operations round to bfloat16 one by one; reductions and
products accumulate in float32 and round once (cuBLAS
bfloat16 with float32 accumulation, its reduced-precision reduction off),
the last elementwise operation before a sum summed unrounded (XLA fuses
it: the objective's weighted sums, the consensus, centralized's mean of the
gradients' last addition); every Python scalar is rounded to bfloat16 before it is applied
(``ops/rounding.py``), the step sizes are computed in float32 and cast,
f* is cast to bfloat16 before the subtraction, and the keys are the
float32 run's. The fault layer keeps W_t, the active mask and the degree
count in float32 and mixes in float32, those products in full FP32 (no
TF32); the matrix-free mix contracts its slot sum into fused multiply-adds,
as XLA's jitted mix does. The robust screens run in float32 and round the
aggregate once; the compressors draw float32 uniforms, and qsgd sums its
norm's squares in float32 and rounds the sum once. The histories and final
models come back as float64.

Timing: ``compile_seconds`` covers the algorithm's init, the warm-up chunk
and the capture, synchronised. ``iters_per_second`` counts the
iterations after the warm-up chunk (the replays, or the eager chunks)
between two ``torch.cuda.synchronize()`` calls. A run releases its graph
and its memory pool when it returns.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.profiler

from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.algorithms.base import Algorithm, StepContext
from distributed_optimization_tpu_torch.backends.base import (
    BackendRunResult,
    resolve_device,
)
from distributed_optimization_tpu_torch.config import SWEEPABLE_FIELDS
from distributed_optimization_tpu_torch.metrics import (
    RunHistory,
    centralized_floats_per_iteration,
    decentralized_floats_per_iteration,
)
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import compression, prng, ring_kernels, sampling_kernels
from distributed_optimization_tpu_torch.ops.losses import sq_norm
from distributed_optimization_tpu_torch.ops.mixing import MixingOp, make_mixing_op
from distributed_optimization_tpu_torch.ops.robust_aggregation import (
    make_gather_robust_aggregator,
    make_robust_aggregator,
    validate_budget,
)
from distributed_optimization_tpu_torch.ops.robust_kernels import (
    fused_robust_supported,
    make_fused_robust_aggregator,
    make_fused_robust_dsgd_step,
)
from distributed_optimization_tpu_torch.ops.rounding import scalar, sum_of
from distributed_optimization_tpu_torch.ops.sampling import gather_batches
from distributed_optimization_tpu_torch.parallel.adversary import (
    Adversary,
    make_adversary,
    make_byzantine_mixing,
)
from distributed_optimization_tpu_torch.parallel.faults import (
    FaultyMixing,
    make_faulty_mixing,
    make_round_robin_mixing,
)
from distributed_optimization_tpu_torch.parallel.topology import (
    Topology,
    build_topology,
    neighbor_tables_for,
)
from distributed_optimization_tpu_torch.utils.data import HostDataset, stack_shards

_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}

# The profiler range around the iterations after the warm-up chunk.
STEADY_LOOP = "torch_backend.steady_loop"
# Forcing sampling_impl='dense' past this padded shard length warns, as the
# JAX package does: the dense form weighs all L rows of every shard each
# iteration, and its measured crossover to gather is near L = 250.
DENSE_SAMPLING_WARN_ROWS = 256


def tf32_for(config, dev: torch.device) -> Optional[bool]:
    """Whether a run's float32 products use TF32 on the card: off under
    ``matmul_precision='highest'`` (full FP32), on under 'high' and
    'default' (what XLA does with those precisions on an NVIDIA GPU); off
    in a bfloat16 run, whose float32 products (the fault layer's W_t x)
    run in full FP32. None where the setting does not apply: float64, or
    the CPU."""
    if dev.type != "cuda" or config.dtype == "float64":
        return None
    if config.dtype == "bfloat16":
        return False
    return config.matmul_precision != "highest"


def make_full_objective_fn(problem, reg: float):
    """Full-dataset objective of one model ``w [d_model]`` over the stacked
    shards: padding rows weigh 0 and every real row 1/total, so the sum
    over workers is the mean over the concatenated dataset. R replicas'
    models ``w [R, d_model]`` give ``[R]`` objectives from one product a
    worker (``ops/losses.py``'s shared-shard form)."""

    def full_objective(w, X, y, n_valid):
        n, L = X.shape[0], X.shape[1]
        mask = (
            torch.arange(L, device=X.device)[None, :] < n_valid[:, None]
        ).to(X.dtype)
        total = torch.clamp(n_valid.sum().to(X.dtype), min=1.0)
        if w.dim() == 2:
            per_worker = problem.objective_weighted(
                w[:, None, :].expand(-1, n, -1), X, y, mask / total, 0.0
            )
            return per_worker.sum(dim=-1) + 0.5 * reg * torch.sum(w * w, dim=-1)
        per_worker = problem.objective_weighted(
            w.expand(n, -1), X, y, mask / total, 0.0
        )
        # bfloat16: ‖w‖² as the JAX package's dot (float32, rounded once).
        norm = sq_norm(w) if w.dtype == torch.bfloat16 else torch.dot(w, w)
        return per_worker.sum() + scalar(0.5 * reg, w.dtype) * norm

    return full_objective


def make_eta_schedule(config, T: int, device, dtype, eta0=None) -> torch.Tensor:
    """``[T]`` step sizes in the run dtype: η₀/√(t+1) or constant η₀. With
    ``eta0`` a list of R (the replica axis), ``[T, R]``: column r replica
    r's schedule, each entry the single run's. A bfloat16 schedule is the
    float32 one cast (the JAX package computes ``eta0 / sqrt(t + 1.0)`` in
    float32 and casts it; bfloat16 would round t + 1 past 256)."""
    if dtype == torch.bfloat16:
        return make_eta_schedule(config, T, device, torch.float32, eta0).to(dtype)
    if eta0 is None:
        eta0 = torch.full((T,), config.learning_rate_eta0, dtype=dtype, device=device)
        t1 = torch.arange(T, dtype=dtype, device=device) + 1.0
    else:
        eta0 = torch.tensor(eta0, dtype=dtype, device=device).expand(T, -1)
        t1 = (torch.arange(T, dtype=dtype, device=device) + 1.0)[:, None]
    if config.resolved_lr_schedule() == "sqrt_decay":
        return torch.div(eta0, torch.sqrt(t1))
    return eta0.contiguous()


@dataclasses.dataclass
class _Program:
    """The bound pieces of one run: the step and the per-eval metrics."""

    algo: Algorithm
    config: object
    grad_for: Callable[[torch.Tensor], Callable]
    mix_op: Optional[MixingOp]
    fused_mix_step: Optional[Callable]
    eta: torch.Tensor  # [T], or [T, R] on the replica axis
    degrees: torch.Tensor  # [N, 1]
    full_objective: Callable
    data: tuple
    byz: Optional["Byzantine"] = None
    faulty: Optional[FaultyMixing] = None
    # Σ realized degrees over the iterations run (a float64 device scalar,
    # [R] on the replica axis; whole numbers, so exact), under a
    # time-varying graph.
    degree_total: Optional[torch.Tensor] = None
    # R on the replica axis (every state leaf [R, N, ...]), else None.
    replicas: Optional[int] = None

    @functools.cached_property
    def tag_key(self) -> tuple:
        """The compressor's stream: ``compression.tag_key`` of the run's seed
        (the seed's high word in float64 runs, as under ``enable_x64``)."""
        return compression.tag_key(self.config.seed, x64=self.eta.dtype == torch.float64)

    def step(self, state, t: torch.Tensor):
        """One iteration at the counter ``t`` (an int64 tensor of one
        element on the run's device). Under a time-varying graph the round
        is realized first (``FaultyMixing.realize``, which adds its degree
        count to ``degree_total``); a rejoining node's warm restart runs
        before the step, and the inactive nodes' rows of every state leaf
        are frozen after it. On the replica axis the step size is ``[R, 1,
        1]``, the round's operands and the frozen mask are each replica's."""
        rnd = self.faulty.realize(t, self.degree_total) if self.faulty is not None else None
        if rnd is not None and rnd.rejoin is not None:
            state = {**state, "x": rnd.restart(state["x"])}
        fused_mix_step = self.fused_mix_step
        if self.byz is not None:
            mix, nbr, fused_mix_step = self.byz.at(t, rnd)
        elif rnd is not None:
            mix, nbr = rnd.mix, rnd.neighbor_sum
        elif self.mix_op is not None:
            mix, nbr = self.mix_op.apply, self.mix_op.neighbor_sum
        else:
            mix, nbr = (lambda v: v), (lambda v: v * 0)
        eta = self.eta.index_select(0, t)
        if self.replicas is not None:
            eta = eta.reshape(-1, 1, 1)
        ctx = StepContext(
            grad=self.grad_for(t), mix=mix, neighbor_sum=nbr,
            eta=eta, degrees=self.degrees, config=self.config,
            fused_mix_step=fused_mix_step, t=t,
            draw=functools.partial(compression.Draw, self.tag_key, t),
        )
        new_state = self.algo.step(state, ctx)
        if rnd is not None:
            if self.faulty.freezes:
                m = rnd.active
                new_state = {
                    key: torch.where(m.reshape(m.shape + (1,) * (new.dim() - m.dim())) > 0,
                                     new, state[key])
                    for key, new in new_state.items()
                }
        return new_state

    def metrics(self, x: torch.Tensor, f_opt: float, with_consensus: bool):
        """f(x̄) − f* and, if asked for, (1/N) Σ_i ‖x_i − x̄‖² (else None);
        over the honest rows alone under an attack, since the Byzantine
        rows are the adversary's. Each ``[R]`` on the replica axis."""
        hw = self.byz.honest_w if self.byz is not None else None
        if hw is None:
            xbar = x.mean(dim=-2)
        else:
            nh = torch.sum(hw, dim=-1)
            xbar = torch.sum(x * hw[..., None], dim=-2) / nh[..., None]
        gap = self.full_objective(xbar, *self.data) - f_opt
        if not with_consensus:
            return gap, None
        sq = sum_of(torch.square, x - xbar.unsqueeze(-2), dim=-1)
        return gap, (torch.mean(sq, dim=-1) if hw is None else torch.sum(hw * sq, dim=-1) / nh)


@dataclasses.dataclass
class Byzantine:
    """The bound Byzantine layer of a run (``_bind_byzantine``).

    ``at(t, rnd)``: iteration t's ``(mix, neighbor_sum, fused_step)`` over
    the round ``rnd`` (a ``faults.Round``, or None on the static graph).
    ``mix``: corrupt → screen (or plain gossip) → mix, with Byzantine rows on
    the benign mix of the true stack. ``neighbor_sum``: A x of the corrupted
    stack. ``fused_step``: the robust D-SGD update in one kernel launch, or
    None. ``honest_w``: the [N] 0/1 honest mask on the device when there is
    an attack ([R, N] on the replica axis), else None. ``at(None, None)``
    gives those of the static graph for an attack that draws nothing.
    """

    adversary: Optional[Adversary]
    at: Callable
    honest_w: Optional[torch.Tensor]


def resolve_robust_impl(config, topo: Topology) -> str:
    """The robust rule's execution form, as ``_bind_byzantine`` resolves it
    on an unsharded run without telemetry: 'auto' takes dense on the
    fully-connected graph, else promotes to 'fused' where the kernel takes
    the rule at this k_max, the graph is static and the round is one
    descent (under a time-varying graph or τ > 1 local steps 'auto' stays on
    gather; an explicit 'fused' runs the kernel on the round's liveness,
    as the round's first descent)."""
    k_max = int(topo.degrees.max())
    eligible = (not config.time_varying and config.local_steps == 1
                # A matrix-free graph runs the gather form only.
                and not topo.is_matrix_free
                and fused_robust_supported(config.aggregation, k_max, config.clip_tau))
    return config.resolved_robust_impl(k_max, fused_eligible=eligible)


def bind_byzantine(config, algo: Algorithm, topo: Topology, mix_op: MixingOp, *,
                   device: torch.device, dtype: torch.dtype, seeds=None,
                   clip_tau: Optional[list] = None,
                   faulty: Optional[FaultyMixing] = None) -> Optional[Byzantine]:
    """The Byzantine adversary and robust aggregation of a config, or None
    when it is benign (no attack and no robust rule with a budget). Under a
    time-varying graph each round's screen runs over its realized graph:
    the gather and fused forms on the liveness gathered from A_t, the dense
    form on A_t, and the benign mix is the round's. ``seeds`` (a list of R)
    binds the replica axis: each replica's Byzantine set and noise key from
    its seed, ``clip_tau`` a radius a replica where swept, and 'auto' never
    takes the fused form, as in the JAX package's batch. ``faulty``: the
    run's fault process, whose rounds give a matrix-free graph's liveness
    over its own table."""
    if not config.byzantine_active:
        return None
    if not algo.supports_byzantine:
        raise ValueError(
            f"Byzantine injection / robust aggregation is "
            f"unsupported for {algo.name!r}: only step rules whose "
            "updates go through the gossip mix alone compose with "
            "screened aggregation (EXTRA's fixed point needs the "
            "static linear W; ADMM pairs neighbor sums with static "
            "degrees; CHOCO's shared estimates cannot represent "
            "screened-out updates; push-sum's debiasing needs the "
            "column-stochastic mass conservation screening breaks) "
            "— use 'dsgd' or 'gradient_tracking'"
        )
    adversary = make_adversary(
        config.n_workers, config.attack, config.n_byzantine, config.attack_scale,
        config.seed if seeds is None else list(seeds), device=device, dtype=dtype,
    )
    # The replica axis's leading shape, for the static graph's operands.
    lead = () if seeds is None else (len(seeds),)
    screen = kernel = None
    if config.robust_active:
        validate_budget(int(topo.degrees.min()), config.robust_b, config.aggregation)
        if seeds is None:
            robust_impl = resolve_robust_impl(config, topo)
        else:
            robust_impl = config.resolved_robust_impl(int(topo.degrees.max()))
        if topo.is_matrix_free and robust_impl != "gather":
            raise ValueError(
                f"matrix-free robust aggregation runs in gather form; "
                f"resolved robust_impl={robust_impl!r} needs the dense "
                "[N, N] adjacency"
            )
        rule = (config.aggregation, config.robust_b)
        tau = (config.clip_tau if clip_tau is None
               else torch.tensor(clip_tau, dtype=torch.float64, device=device))
        if robust_impl == "dense":
            agg = make_robust_aggregator(*rule, tau)
            static_a = torch.as_tensor(topo.adjacency, dtype=torch.float32, device=device)
            static_a = static_a.expand(*lead, *static_a.shape)

            def screen(rnd):
                a = rnd.A if rnd is not None else static_a
                return None, (lambda v: agg(a, v))
        else:
            # A matrix-free graph's own table, else the adjacency's (the
            # same layout).
            nbr_idx, nbr_mask = neighbor_tables_for(topo)
            if faulty is not None and topo.is_matrix_free:
                nbr = faulty.device_table(nbr_idx, nbr_mask)
            else:
                nbr = torch.as_tensor(nbr_idx, dtype=torch.int64, device=device)
            static_live = torch.as_tensor(nbr_mask, dtype=torch.float32, device=device)
            static_live = static_live.expand(*lead, *static_live.shape)
            table = (*rule, nbr_idx, tau)
            if robust_impl == "fused":
                agg = make_fused_robust_aggregator(*table, device=device)
            else:
                agg = make_gather_robust_aggregator(*table, device=device)
            if robust_impl == "fused" and algo.name == "dsgd":
                kernel = make_fused_robust_dsgd_step(*table, device=device)

            def screen(rnd):
                live = rnd.live(nbr, static_live) if rnd is not None else static_live
                return live, (lambda v: agg(live, v))

    def at(t, rnd):
        base_mix = rnd.mix if rnd is not None else mix_op.apply
        base_nbr = rnd.neighbor_sum if rnd is not None else mix_op.neighbor_sum
        aggregate = fused_step = None
        if screen is not None:
            live, aggregate = screen(rnd)
            if kernel is not None:

                def fused_step(x, g, eta):
                    # One launch for honest rows; Byzantine rows keep the
                    # benign mix of the true stack, then the same − η·g.
                    xc = adversary.corrupt(x, t) if adversary is not None else x
                    out = kernel(live, xc, g, eta)
                    if adversary is not None:
                        out = torch.where(adversary.rows > 0, base_mix(x) - eta * g, out)
                    return out

        nbr_sum = base_nbr
        if adversary is not None:
            nbr_sum = lambda v: base_nbr(adversary.corrupt(v, t))  # noqa: E731
        return make_byzantine_mixing(adversary, base_mix, aggregate, t), nbr_sum, fused_step

    return Byzantine(
        adversary=adversary,
        at=at,
        honest_w=(torch.as_tensor(adversary.honest, dtype=dtype, device=device)
                  if adversary is not None else None),
    )


def build_faulty(config, algo: Algorithm, topo: Topology, T: int, *,
                 device: torch.device, seeds=None, drop_probs=None) -> Optional[FaultyMixing]:
    """The port of ``_build_faulty``: the per-round mixing of a time-varying
    graph (faults, or a matching schedule), or None for a static graph,
    after the JAX package's algorithm checks. Persistent processes unroll
    their timeline here (on a card, one launch pair) over ``T`` rounds.
    ``seeds`` (a list of R) and ``drop_probs`` (R, where swept) bind the
    replica axis: each replica's streams and timeline from its own seed."""
    if not config.time_varying:
        return None
    if not algo.supports_edge_faults:
        raise ValueError(
            f"time-varying gossip is unsupported for {algo.name!r}: "
            "the step rule is not faithful under per-iteration "
            "graphs — participation sampling included (ADMM pairs "
            "neighbor sums with static degrees; CHOCO's shared "
            "estimate state cannot represent undelivered updates; "
            "EXTRA's fixed-point argument requires a static W)"
        )
    if config.mttf > 0.0 and not algo.supports_churn:
        raise ValueError(
            f"crash-recovery churn is unsupported for {algo.name!r}: "
            "multi-round outages freeze a node's whole state and "
            "may warm-restart its model on rejoin, which only "
            "mix-based rules tolerate (push-sum's (num, w) mass "
            "pair cannot be restarted consistently; EXTRA/ADMM/"
            "CHOCO already reject time-varying graphs) — use "
            "'dsgd' or 'gradient_tracking'"
        )
    if config.gossip_schedule == "round_robin":
        return make_round_robin_mixing(topo, device=device)
    return make_faulty_mixing(
        topo, config.edge_drop_prob if drop_probs is None else list(drop_probs),
        config.seed if seeds is None else list(seeds),
        straggler_prob=config.straggler_prob,
        one_peer=config.gossip_schedule == "one_peer",
        burst_len=config.burst_len, mttf=config.mttf, mttr=config.mttr,
        rejoin=config.rejoin, horizon=T,
        participation_rate=config.participation_rate,
        device=device, x64=config.dtype == "float64",
    )


def _make_grad_factory(problem, reg, config, X, y, n_valid, schedule, sampling_impl,
                       seeds=None):
    """``grad_for(t)`` gives the step's ``grad(params, slot)`` at counter t:
    on injected batches, the whole shard (b >= L), or the batches the JAX
    package draws, through the card's sampling kernel or on the CPU its
    plain twin. ``slot`` is a Python int; its key, ``fold_in(key(seed),
    slot)``, is made on the host once. With ``seeds`` (the replica axis)
    a slot's key is the ``[R, 2]`` stack of the replicas' keys on the
    run's device, every slot's made here, before any capture (a copy to
    the card cannot be captured), and one launch draws all R batches."""
    batch_size = config.local_batch_size
    L = X.shape[1]
    if schedule is None and batch_size >= L:
        # Full-batch fast path: b >= L without replacement is the whole
        # shard with 1/n_i weights; no sampling at all.
        fmask = (torch.arange(L, device=X.device)[None, :] < n_valid[:, None]).to(X.dtype)
        full_wts = fmask / torch.clamp(n_valid[:, None].to(X.dtype), min=1.0)
    x64 = X.dtype == torch.float64
    if seeds is None:
        run_key = prng.key(config.seed, x64=x64)
        slot_key = functools.lru_cache(maxsize=None)(lambda slot: prng.fold_in(run_key, slot))
    else:
        stacks = {slot: prng.keys(seeds, x64=x64, tags=(slot,), device=X.device)
                  for slot in range(config.local_steps)}
        slot_key = stacks.__getitem__

    def grad_for(t: torch.Tensor):
        def grad(params, slot, unrounded=False):
            if schedule is not None:
                idx = schedule.index_select(0, t)[0]  # [N, b] injected batch indices
                Xb, yb = gather_batches(X, y, idx)
                wts = torch.full(idx.shape, 1.0 / idx.shape[1], dtype=X.dtype, device=X.device)
            elif batch_size >= L:
                Xb, yb, wts = X, y, full_wts
            elif sampling_impl == "dense":
                Xb, yb = X, y
                wts = sampling_kernels.sample_worker_batch_weights(
                    slot_key(slot), t, n_valid, L, batch_size, X.dtype
                )
            else:
                Xb, yb, wts = sampling_kernels.sample_worker_batches(
                    slot_key(slot), t, X, y, n_valid, batch_size
                )
            if unrounded:  # a problem whose gradient takes the keyword (ops/losses.py)
                return problem.gradient_weighted(params, Xb, yb, wts, reg, unrounded=True)
            return problem.gradient_weighted(params, Xb, yb, wts, reg)

        return grad

    return grad_for


def _make_chunk(program: _Program, iterations: int, t: torch.Tensor, k: torch.Tensor,
                metrics: Optional[Callable]):
    """The port of ``make_chunk``: ``iterations`` steps, each advancing the
    counter ``t`` in place, then ``metrics(state, k)`` (if given), which
    writes eval slot ``k`` and advances it."""

    def chunk(state):
        for _ in range(iterations):
            state = program.step(state, t)
            t.add_(1)
        if metrics is not None:
            metrics(state, k)
            k.add_(1)
        return state

    return chunk


@functools.lru_cache(maxsize=None)
def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """One side stream per card for every run's warm-up and captures:
    PyTorch keeps a cuBLAS workspace for each stream it multiplies on, so a
    new stream each run would leave one more workspace allocated."""
    return torch.cuda.Stream(dev)


def _warm_up_and_capture(chunk, state, dev: torch.device, capture: bool):
    """The warm-up chunk on a side stream, then (if ``capture``) one chunk
    captured as a CUDA graph on that stream. Returns ``(graph or None,
    state)``: the state in distinct, contiguous buffers that each replay
    writes its result back into."""
    stream = _side_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = None
    # The outer stream context restores the caller's stream even where a
    # failed capture leaves torch.cuda.graph's own context unexited.
    with torch.cuda.stream(stream):
        state = {key: value.clone() for key, value in chunk(state).items()}
        if capture:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                out = chunk(state)
                # A state entry may come back as another's input buffer
                # (EXTRA's x_prev is the x it was given): copy it aside
                # before the write-back overwrites that buffer.
                inputs = {id(buf) for buf in state.values()}
                out = {key: value.clone() if id(value) in inputs else value
                       for key, value in out.items()}
                for key, buf in state.items():
                    buf.copy_(out[key])
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graph, state


@dataclasses.dataclass
class _Replicas:
    """The replica axis of ``run_batch``: R seeds, the per-replica configs
    (``config.replace(seed=s, topology_seed=<base>, **sweep)``, each the
    sequential run replica r equals), the swept fields, the first
    iteration ``t0`` and the stacked state to continue from."""

    seeds: list
    configs: list
    sweep: dict
    t0: int = 0
    state0: Optional[dict] = None

    def values(self, field: str) -> Optional[list]:
        """The replicas' values of a swept ``field``, else None."""
        return [getattr(c, field) for c in self.configs] if field in self.sweep else None


@dataclasses.dataclass
class _Built:
    """A run bound to its device, before it runs: the program, the chunk,
    the initial state's maker and the buffers the metrics land in."""

    program: _Program
    chunk: Callable
    init_state: Callable[[], dict]
    n_evals: int
    gap_hist: torch.Tensor  # [n_evals] ([n_evals, R] on the replica axis)
    cons_hist: torch.Tensor
    track_consensus: bool
    floats_per_iter: float
    edge_payload: Optional[float]
    spectral_gap: Optional[float]
    fault_seconds: float
    topology_seconds: float


def _replicate(state: dict, replicas: _Replicas, dev: torch.device) -> dict:
    """The initial state of R replicas: every leaf repeated R times, or the
    caller's stacked ``state0`` after the JAX package's checks."""
    R = len(replicas.seeds)
    if replicas.state0 is None:
        return {k: v.unsqueeze(0).repeat(R, *([1] * v.dim())) for k, v in state.items()}
    if set(replicas.state0) != set(state):
        raise ValueError(
            f"state0 leaves {sorted(replicas.state0)} do not match the "
            f"algorithm's state {sorted(state)}"
        )
    out = {}
    for k, v in replicas.state0.items():
        v = torch.as_tensor(np.asarray(v)).to(device=dev, dtype=state[k].dtype)
        if tuple(v.shape) != (R,) + tuple(state[k].shape):
            raise ValueError(
                f"state0[{k!r}] has shape {tuple(v.shape)}; expected "
                f"{(R,) + tuple(state[k].shape)} ([replicas, ...])"
            )
        out[k] = v.contiguous()
    return out


def _build(config, dataset: HostDataset, f_opt: float, dev: torch.device, *,
           batch_schedule: Optional[np.ndarray] = None, collect_metrics: bool = True,
           replicas: Optional[_Replicas] = None) -> _Built:
    """Bind one run (``replicas`` None) or R replicas of it to ``dev``."""
    dtype = _DTYPES[config.dtype]
    algo = get_algorithm(config.algorithm)
    problem = get_problem(config.problem_type, huber_delta=config.huber_delta,
                          n_classes=config.n_classes)
    reg = config.reg_param
    T = config.n_iterations
    n = config.n_workers
    eval_every = config.eval_every
    n_evals = T // eval_every
    # On the replica axis: the seeds, the first iteration, and the config
    # whose run-level flags every replica shares (a swept edge_drop_prob
    # makes each replica's run time-varying where the base config's is not).
    seeds = replicas.seeds if replicas is not None else None
    t0 = replicas.t0 if replicas is not None else 0
    flags = replicas.configs[0] if replicas is not None else config
    lead = () if seeds is None else (len(seeds),)

    host = stack_shards(dataset, dtype=config.dtype)
    X = torch.as_tensor(host.X, device=dev)
    y = torch.as_tensor(host.y, device=dev)
    n_valid = torch.as_tensor(host.n_valid, dtype=torch.int64, device=dev)
    # The trained parameter's length: the feature count for the
    # scalar-output families, d·K for softmax's flat [d, K] matrix. The
    # state, the payload and the floats transmitted are sized from it.
    d = problem.param_dim(host.n_features)

    mix_op = byz = faulty = None
    fused_mix_step = None
    fault_seconds = topology_seconds = 0.0
    edge_payload = None
    if algo.is_decentralized:
        # The representation and sampler as replica 0's config resolves
        # them (each replica's is the base config's graph).
        t_topo = time.perf_counter()
        topo = build_topology(config.topology, n, erdos_renyi_p=config.erdos_renyi_p,
                              seed=config.resolved_topology_seed(),
                              impl=flags.resolved_topology_impl(),
                              sampler=flags.resolved_topology_sampler())
        topology_seconds = time.perf_counter() - t_topo
        mix_op = make_mixing_op(topo, config.mixing_impl, device=dev, dtype=dtype)
        degrees = torch.as_tensor(topo.degrees, dtype=dtype, device=dev)[:, None]
        if algo.comm_payload is not None:
            # The rule's floats an edge: the compressor's payload, or d a round.
            edge_payload = algo.comm_payload(config, d)
            floats_per_iter = topo.floats_per_iteration * edge_payload
        else:
            edge_payload = d * algo.gossip_rounds
            floats_per_iter = decentralized_floats_per_iteration(topo, d, algo.gossip_rounds)
        spectral_gap = topo.spectral_gap
        t_fault = time.perf_counter()
        # The timeline covers t0 + T rounds: a continued batch reads the
        # rounds the one-shot run would (timelines are prefix-stable).
        faulty = build_faulty(flags, algo, topo, t0 + T, device=dev, seeds=seeds,
                              drop_probs=replicas.values("edge_drop_prob") if replicas else None)
        if faulty is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fault_seconds = time.perf_counter() - t_fault
        byz = bind_byzantine(config, algo, topo, mix_op, device=dev, dtype=dtype, seeds=seeds,
                             clip_tau=replicas.values("clip_tau") if replicas else None,
                             faulty=faulty)
        if (replicas is None and byz is None and faulty is None and mix_op.impl == "pallas"
                and topo.name == "ring"):
            # The fused W x − η g kernel, bound as the JAX package binds its
            # Pallas counterpart: never under Byzantine injection, where it
            # would skip the corruption and the screen, nor over a
            # time-varying graph, whose W_t it does not apply.
            fused_mix_step = ring_kernels.fused_ring_dsgd_step
    else:
        if flags.byzantine_active or flags.time_varying:
            raise ValueError(
                "fault injection / matching-based gossip / Byzantine "
                "injection model peer exchanges and apply only to "
                "decentralized algorithms; the centralized pattern has no "
                "peer edges"
            )
        degrees = torch.zeros((n, 1), dtype=dtype, device=dev)
        floats_per_iter = centralized_floats_per_iteration(n, d)
        spectral_gap = None

    schedule = None
    if batch_schedule is not None:
        indices = np.asarray(batch_schedule)
        if indices.ndim != 3 or indices.shape[:2] != (T, n):
            raise ValueError(
                f"batch_schedule must be [T={T}, N={n}, b], got {indices.shape}"
            )
        if indices.min() < 0 or indices.max() >= X.shape[1]:
            raise ValueError(
                f"batch_schedule indices must lie in [0, L={X.shape[1]})"
            )
        schedule = torch.as_tensor(indices, dtype=torch.int64, device=dev)
    sampling_impl = config.resolved_sampling_impl(dev.type, X.shape[1])
    if config.sampling_impl == "dense" and X.shape[1] > DENSE_SAMPLING_WARN_ROWS:
        warnings.warn(
            f"--sampling-impl dense weighs all L = {X.shape[1]} rows of every "
            "shard each iteration (and on the CPU ranks them by an [L, L] "
            "comparison); at this L the JAX package's measured crossover "
            "favors 'gather' — forcing dense anyway as requested",
            stacklevel=3,
        )

    program = _Program(
        algo=algo, config=config,
        grad_for=_make_grad_factory(
            problem, reg, config, X, y, n_valid, schedule, sampling_impl, seeds
        ),
        mix_op=mix_op, fused_mix_step=fused_mix_step,
        eta=make_eta_schedule(
            config, t0 + T, dev, dtype,
            eta0=None if replicas is None else [c.learning_rate_eta0 for c in replicas.configs]),
        degrees=degrees,
        full_objective=make_full_objective_fn(problem, reg),
        data=(X, y, n_valid), byz=byz, faulty=faulty,
        degree_total=(torch.zeros(lead, dtype=torch.float64, device=dev)
                      if faulty is not None else None),
        replicas=lead[0] if lead else None,
    )

    track_consensus = collect_metrics and algo.is_decentralized and config.record_consensus
    gap_hist = torch.empty((n_evals, *lead), dtype=dtype, device=dev)
    cons_hist = torch.empty((n_evals, *lead), dtype=dtype, device=dev)

    # f* in the run dtype before the subtraction, as the JAX package's weak
    # Python float is.
    f_star = scalar(f_opt, dtype)

    def write_metrics(state, k):
        gap, spread = program.metrics(state["x"], f_star, track_consensus)
        gap_hist.index_copy_(0, k, gap.reshape(1, *lead))
        if track_consensus:
            cons_hist.index_copy_(0, k, spread.reshape(1, *lead))

    t = torch.full((1,), t0, dtype=torch.int64, device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)

    def init_state():
        # ADMM's A x_0, through the unscreened mixing op's neighbour sum, as
        # the JAX package binds it; R replicas start from R copies.
        state = algo.init(
            torch.zeros((n, d), dtype=dtype, device=dev), config,
            neighbor_sum=mix_op.neighbor_sum if mix_op is not None else None,
        )
        return state if replicas is None else _replicate(state, replicas, dev)

    return _Built(
        program=program,
        chunk=_make_chunk(program, eval_every, t, k, write_metrics if collect_metrics else None),
        init_state=init_state, n_evals=n_evals, gap_hist=gap_hist, cons_hist=cons_hist,
        track_consensus=track_consensus, floats_per_iter=floats_per_iter,
        edge_payload=edge_payload, spectral_gap=spectral_gap, fault_seconds=fault_seconds,
        topology_seconds=topology_seconds,
    )


def _execute(built: _Built, config, dev: torch.device, measure_timestamps: bool):
    """Run a bound run: the initial state and the warm-up chunk, then every
    chunk left as a replay of one captured graph on a card (the chunk
    function from the host on the CPU or with ``measure_timestamps``).
    Returns ``(final state, compile seconds, steady seconds, stamps)``."""
    n_evals = built.n_evals
    use_graphs = dev.type == "cuda" and not measure_timestamps

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    graph = None
    tf32 = tf32_for(config, dev)
    matmul = torch.backends.cuda.matmul
    caller_tf32 = matmul.allow_tf32
    caller_bf16 = matmul.allow_bf16_reduced_precision_reduction
    try:
        if tf32 is not None:
            # Before the warm-up and the capture: a CUDA graph keeps the
            # cuBLAS algorithm chosen while it was captured.
            matmul.allow_tf32 = tf32
        if config.dtype == "bfloat16" and dev.type == "cuda":
            # bfloat16 products accumulate in float32 and round once.
            matmul.allow_bf16_reduced_precision_reduction = False
        sync()
        t0 = time.perf_counter()
        # Eager, once, before the warm-up.
        state = built.init_state()
        if use_graphs:
            graph, state = _warm_up_and_capture(built.chunk, state, dev, capture=n_evals > 1)
        else:
            state = built.chunk(state)
        sync()
        # The fault timeline's set-up counts as compile time, as the JAX
        # package's host precompute does.
        compile_seconds = time.perf_counter() - t0 + built.fault_seconds

        stamps = [0.0]  # the warm-up chunk's eval, as the steady loop starts
        t0 = time.perf_counter()
        with torch.profiler.record_function(STEADY_LOOP):
            if use_graphs:
                for _ in range(n_evals - 1):
                    graph.replay()
            else:
                for _ in range(n_evals - 1):
                    state = built.chunk(state)
                    if measure_timestamps:
                        sync()
                        stamps.append(time.perf_counter() - t0)
            sync()
        run_seconds = time.perf_counter() - t0
    finally:
        matmul.allow_tf32 = caller_tf32
        matmul.allow_bf16_reduced_precision_reduction = caller_bf16
        if graph is not None:
            graph.reset()
    return state, compile_seconds, run_seconds, stamps


def _host64(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host float64 array (numpy has no bfloat16)."""
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def _histories(built: _Built, collect_metrics: bool):
    """The gap and consensus histories on the host, float64."""
    if not collect_metrics:
        return np.empty((0,) + tuple(built.gap_hist.shape[1:])), None
    gap = _host64(built.gap_hist)
    cons = _host64(built.cons_hist) if built.track_consensus else None
    return gap, cons


def run(
    config,
    dataset: HostDataset,
    f_opt: float,
    *,
    device: torch.device | str = "cuda",
    batch_schedule: Optional[np.ndarray] = None,
    collect_metrics: bool = True,
    measure_timestamps: bool = False,
    return_state: bool = False,
) -> BackendRunResult:
    """Run ``config.algorithm`` on ``dataset`` for ``config.n_iterations``.

    ``batch_schedule [T, N, b]`` injects fixed batch indices (equivalence
    tests against the JAX package). ``device`` defaults to ``cuda`` and
    raises when no card is visible. ``measure_timestamps=True`` runs the
    chunks from the host without CUDA graphs, synchronising after each, and
    records a measured time per eval (``history.time_measured``); by
    default ``history.time`` spreads the run's wall clock evenly over the
    evals. ``return_state=True`` also fetches every leaf of the final state
    (e.g. the estimates ``xhat``, ``yhat`` of a compressed run) into
    ``final_state``, as host float64 arrays. On a card, a float32 run's
    products follow ``config.matmul_precision`` (``tf32_for``), and the
    caller's TF32 setting is restored when the run returns.

    ``execution='async'`` runs the event clock (``async_scan.run_async``),
    which has no per-eval timestamps.
    """
    if config.execution == "async":
        if measure_timestamps:
            raise ValueError(
                "execution='async' reports the event schedule's simulated "
                "VIRTUAL clock (telemetry.async health block), not "
                "host-driven per-eval timestamps"
            )
        from distributed_optimization_tpu_torch.backends import async_scan

        return async_scan.run_async(config, dataset, f_opt, device=device,
                                    batch_schedule=batch_schedule,
                                    collect_metrics=collect_metrics, return_state=return_state)
    dev = resolve_device(device)
    T = config.n_iterations
    eval_every = config.eval_every
    built = _build(config, dataset, f_opt, dev, batch_schedule=batch_schedule,
                   collect_metrics=collect_metrics)
    state, compile_seconds, run_seconds, stamps = _execute(built, config, dev,
                                                           measure_timestamps)
    program = built.program
    gap_np, cons_np = _histories(built, collect_metrics)
    history = RunHistory(
        objective=gap_np,
        consensus_error=cons_np,
        time=(np.asarray(stamps[: len(gap_np)]) if measure_timestamps else
              np.linspace(run_seconds / max(len(gap_np), 1), run_seconds, len(gap_np))),
        time_measured=measure_timestamps,
        eval_iterations=np.arange(eval_every, T + 1, eval_every)[: len(gap_np)],
        # Under a time-varying graph, the floats the realized edges carried:
        # Σ_t Σ_i realized deg_i (a whole number) times an edge's payload.
        total_floats_transmitted=(float(program.degree_total) * built.edge_payload
                                  if program.faulty is not None else built.floats_per_iter * T),
        iters_per_second=((T - eval_every) / run_seconds
                          if T > eval_every and run_seconds > 0 else float("nan")),
        compile_seconds=compile_seconds,
        spectral_gap=built.spectral_gap,
        fault_setup_seconds=built.fault_seconds,
        topology_setup_seconds=built.topology_seconds,
    )
    final_models = _host64(state["x"])
    # Under an attack the reported model is the honest average.
    adversary = program.byz.adversary if program.byz is not None else None
    honest = adversary.honest if adversary is not None else slice(None)
    return BackendRunResult(
        history=history,
        final_models=final_models,
        final_avg_model=final_models[honest].mean(axis=0),
        final_state=({key: _host64(value) for key, value in state.items()}
                     if return_state else None),
    )


# --------------------------------------------------------------------------
# The replica axis: R seeds of one config (and per-replica sweeps of its
# scalar fields) as one program over [R, N, d] state, one captured graph on
# a card, the port of ``jax_backend.run_batch``.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BatchRunResult:
    """R replica trajectories from one ``run_batch`` call.

    ``results[r]`` is a per-replica ``BackendRunResult`` whose history is
    trajectory-equivalent to a sequential ``run`` of ``config.replace(
    seed=seeds[r], topology_seed=<base>, **{f: sweep[f][r]})``.
    ``aggregate_iters_per_second`` is R times the iterations timed (those
    after the warm-up chunk, as in ``run``) over ``run_seconds``; each
    replica's ``iters_per_second`` is the aggregate divided by R (the batch
    time-slices the card evenly). ``final_states`` holds the stacked state
    ([R, ...] leaves, run dtype): pass it back as ``state0`` with ``t0``
    advanced to continue the batch exactly.
    """

    results: list
    seeds: list
    sweep: Optional[dict]
    objective: np.ndarray  # [R, n_evals] suboptimality gaps
    consensus_error: Optional[np.ndarray]  # [R, n_evals] or None
    aggregate_iters_per_second: float
    run_seconds: float
    compile_seconds: float
    final_states: dict


def batch_unsupported_reason(config) -> Optional[str]:
    """Why ``run_batch`` cannot execute this config, or None when it can:
    the JAX package's reasons (and strings) for the fields the port has."""
    if config.algorithm == "choco":
        return (
            "run_batch does not support 'choco': its step rule derives "
            "the compressor stream from config.seed internally, which the "
            "batched per-replica seed axis cannot reach — replicas would "
            "silently share compression draws"
        )
    if config.mixing_impl in ("shard_map", "pallas"):
        return (
            f"run_batch is incompatible with mixing_impl="
            f"{config.mixing_impl!r}: shard_map stencils pin a device "
            "mesh and the pallas kernels address unbatched VMEM blocks — "
            "use 'auto', 'dense', 'stencil', or 'sparse'"
        )
    if config.robust_impl == "fused":
        return (
            "run_batch is incompatible with robust_impl='fused': the "
            "fused pallas kernel addresses unbatched VMEM blocks — use "
            "'auto', 'gather', or 'dense' (auto never promotes to fused "
            "inside the replica batch)"
        )
    if config.compression != "none":
        return (
            "run_batch does not support compressed gossip: the "
            "error-feedback step derives its compressor stream from "
            "config.seed internally, which the batched per-replica seed "
            "axis cannot reach — replicas would silently share "
            "compression draws"
        )
    if config.dtype == "bfloat16":
        return (
            "run_batch with dtype='bfloat16': the PyTorch port does not "
            "have it yet (the replica entries of the sampling, round and "
            "noise kernels have no bfloat16 instance)"
        )
    if config.execution == "async":
        return (
            "run_batch does not support execution='async': the event "
            "path is a sequential scan over one totally ordered schedule "
            "per seed, and the per-replica schedules have different "
            "event ORDERS (the order is data, but the staleness replay "
            "is not) — run seeds sequentially"
        )
    return None


def _replicas_for(config, seeds, sweep, t0: int, state0) -> _Replicas:
    """The JAX package's validation of a batch's seeds, sweep and start,
    with its messages, and the per-replica configs."""
    if seeds is None:
        seeds = config.replica_seeds()
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("run_batch needs at least one replica seed")
    R = len(seeds)
    sweep = {k: list(v) for k, v in (sweep or {}).items()}
    for field, values in sweep.items():
        if field not in SWEEPABLE_FIELDS:
            raise ValueError(
                f"cannot sweep {field!r} inside one batched program: only "
                f"per-replica scalars that enter the compiled program as "
                f"data batch this way ({', '.join(SWEEPABLE_FIELDS)}); "
                "structural axes change the traced program itself — run "
                "separate (possibly batched) calls per value"
            )
        if len(values) != R:
            raise ValueError(
                f"sweep[{field!r}] has {len(values)} values for {R} "
                "replicas; every swept axis must match the seed vector's "
                "length"
            )
    unbatchable = batch_unsupported_reason(config)
    if unbatchable is not None:
        raise ValueError(unbatchable)
    if t0 < 0:
        raise ValueError(f"t0 must be >= 0, got {t0}")
    if not get_algorithm(config.algorithm).is_decentralized and (
        config.edge_drop_prob > 0.0
        or config.straggler_prob > 0.0
        or config.mttf > 0.0
        or config.gossip_schedule != "synchronous"
        or config.attack != "none"
        or (config.aggregation != "gossip" and config.robust_b > 0)
        or "edge_drop_prob" in sweep
    ):
        raise ValueError(
            "fault injection / matching-based gossip / Byzantine "
            "injection model peer exchanges and apply only to "
            "decentralized algorithms; the centralized pattern has no "
            "peer edges"
        )
    if "edge_drop_prob" in sweep and not all(
        0.0 < float(v) < 1.0 for v in sweep["edge_drop_prob"]
    ):
        raise ValueError(
            "swept edge_drop_prob values must all be in (0, 1): the "
            "batched fault threshold is traced data, so every replica "
            "must run the fault-sampling path (p = 0 rows belong in a "
            "separate fault-free batch)"
        )
    if "clip_tau" in sweep:
        if config.aggregation != "clipped_gossip" or config.robust_b <= 0:
            raise ValueError(
                "sweeping clip_tau requires aggregation='clipped_gossip' "
                "with robust_b > 0 — otherwise the radius is silently "
                "ignored"
            )
        if not all(float(v) > 0.0 for v in sweep["clip_tau"]):
            raise ValueError(
                "swept clip_tau values must all be > 0: the adaptive "
                "radius (clip_tau=0) is a different traced program — run "
                "it as its own batch"
            )
    # Replica r is exactly the sequential run of configs[r] (each validated
    # by the dataclass's own checks); the topology seed is pinned to the
    # base config's, so every replica gossips over one graph.
    configs = [
        config.replace(
            seed=s, topology_seed=config.resolved_topology_seed(),
            **{f: type(getattr(config, f))(vals[r]) for f, vals in sweep.items()},
        )
        for r, s in enumerate(seeds)
    ]
    return _Replicas(seeds=seeds, configs=configs, sweep=sweep, t0=t0, state0=state0)


def run_batch(
    config,
    dataset: HostDataset,
    f_opt: float,
    *,
    seeds=None,
    sweep=None,
    device: torch.device | str = "cuda",
    collect_metrics: bool = True,
    measure_timestamps: bool = False,
    state0=None,
    t0: int = 0,
    executable_cache=None,
    progress_cb=None,
    monitors=None,
) -> BatchRunResult:
    """Run R replicas of ``config`` as one program over a leading [R] axis:
    on a card one CUDA graph, each step's sampling, round and noise draws
    one launch for all R.

    ``seeds``: the per-replica seeds (default ``config.replica_seeds()``:
    seed, seed+1, ..., seed+replicas−1). ``sweep``: a dict mapping a
    ``SWEEPABLE_FIELDS`` name to R per-replica values. Replica r is the
    sequential ``run`` of ``config.replace(seed=seeds[r],
    topology_seed=<base>, **{field: values[r]})``: the graph is the base
    config's, the sampling, fault, match, Byzantine-set and noise streams
    are replica r's. ``state0``/``t0`` continue a previous batch from its
    ``final_states`` (the counter-based draws resume at t0, so the
    continuation is the one-shot batch split in two).
    ``measure_timestamps=True`` drives the chunks from the host with no
    graph (the graph run's bitwise reference). ``device`` defaults to
    ``cuda`` and raises when no card is visible.

    The JAX package's rejections (its messages): a structural sweep axis,
    a sweep whose length is not R, bad swept values, a centralized run with
    faults or an attack, a bad ``state0``, and
    ``batch_unsupported_reason``. ``executable_cache``, ``progress_cb`` and
    ``monitors`` (serving and observability) are not ported yet and raise.
    """
    for name, value in (("executable_cache", executable_cache),
                        ("progress_cb", progress_cb), ("monitors", monitors)):
        if value is not None:
            raise ValueError(
                f"run_batch({name}=...): the PyTorch port does not have it yet "
                "(serving and observability are not ported)"
            )
    replicas = _replicas_for(config, seeds, sweep, t0, state0)
    dev = resolve_device(device)
    R = len(replicas.seeds)
    T = config.n_iterations
    eval_every = config.eval_every
    built = _build(config, dataset, f_opt, dev, collect_metrics=collect_metrics,
                   replicas=replicas)
    state, compile_seconds, run_seconds, stamps = _execute(built, config, dev,
                                                           measure_timestamps)
    program = built.program
    gap, cons = _histories(built, collect_metrics)  # [n_evals, R]
    objective = gap.T if collect_metrics else np.full((R, built.n_evals), np.nan)
    cons = cons.T if cons is not None else None
    timed = T - eval_every
    aggregate = (R * timed / run_seconds if timed > 0 and run_seconds > 0 else float("nan"))
    n_done = objective.shape[1]
    times = (np.asarray(stamps[:n_done]) if measure_timestamps else
             np.linspace(run_seconds / max(n_done, 1), run_seconds, n_done))
    eval_iterations = np.arange(t0 + eval_every, t0 + T + 1, eval_every)[:n_done]
    final_states = {key: value.cpu().numpy() for key, value in state.items()}
    final_models = final_states["x"].astype(np.float64)  # [R, N, d]
    adversary = program.byz.adversary if program.byz is not None else None
    degree_totals = (program.degree_total.cpu().numpy() if program.faulty is not None
                     else None)
    results = []
    for r in range(R):
        history = RunHistory(
            objective=objective[r],
            consensus_error=cons[r] if cons is not None else None,
            time=times,
            time_measured=measure_timestamps,
            eval_iterations=eval_iterations,
            total_floats_transmitted=(float(degree_totals[r]) * built.edge_payload
                                      if degree_totals is not None
                                      else built.floats_per_iter * T),
            iters_per_second=aggregate / R,
            compile_seconds=compile_seconds,
            spectral_gap=built.spectral_gap,
            fault_setup_seconds=built.fault_seconds,
            topology_setup_seconds=built.topology_seconds,
        )
        honest = adversary.honest[r] if adversary is not None else slice(None)
        results.append(BackendRunResult(
            history=history,
            final_models=final_models[r],
            final_avg_model=final_models[r][honest].mean(axis=0),
        ))
    return BatchRunResult(
        results=results, seeds=replicas.seeds, sweep=replicas.sweep or None,
        objective=objective, consensus_error=cons, aggregate_iters_per_second=aggregate,
        run_seconds=run_seconds, compile_seconds=compile_seconds, final_states=final_states,
    )
