"""The asynchronous event clock (``execution='async'``): a run over events.

The port of ``distributed_optimization_tpu/backends/async_scan.py``. Where
the synchronous run advances all N workers a round behind a barrier, this
one runs the EVENTS of a precomputed ``parallel/events.py`` schedule: each
event is one worker's local D-SGD (or gradient-tracking) update at its
realized staleness plus a pairwise average with its partner, AD-PSGD
(Lian et al. '17).

The event body (the JAX package's ``event_step``): read x[i] and x[j] (and
under ``neighbor_restart`` a rejoining worker's warm row, ``restart_w @
x``, first), average the pair, take the stale-read gradient at
``x_read[i]`` (its batch drawn with the block's, below), write j
and then i (so the solo case j == i stays a plain local step), and re-read
``x_read[i] <- x[i]``. Gradient tracking telescopes its tracker ``y`` and
last gradient ``g_prev`` per event; τ > 1 fuses τ local descents into the
event (``local_chain``). Under faults a non-firing event is a no-op, and a
dead exchange has already degraded to the solo step in the realization's
partner.

Every event reads the schedule (worker, partner, local step, fire, rejoin)
at an int64 event cursor in device memory and advances it in place, so the
event's work does not depend on the host. A block of events first draws
all its batches in one launch of the card's event sampling kernel
(``sample_event_block``, a grid block a draw; an event's batch depends on
its worker, step and descent alone, never on the models), then runs its
events, each reading its static slice of the run's batch buffer:

- On the CPU the events run one after another from the host.
- On a card, the first block of events runs eagerly on a side stream (the
  warm-up: kernels built, cuBLAS set up), then one block of events and the
  eval's metrics are each captured as a CUDA graph. Each eval window of
  ``eval_every · N`` events is that block graph's replays followed by one
  replay of the metrics graph, which writes the gap and consensus of the
  window's end into device buffers. The histories are fetched once, at the
  end. ``capture=False`` runs the same blocks eagerly from the host: the
  graph run's bitwise reference.

The history follows the JAX package: round-numbered ``eval_iterations``
(N events a round), ``time_measured=False``, and
``total_floats_transmitted`` = (2·d, or 4·d for gradient tracking) × the
fired live exchanges. ``iters_per_second`` counts rounds a second over the
events after the warm-up block, and ``capture_seconds`` the capture of the
two graphs (both within ``compile_seconds``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from distributed_optimization_tpu_torch.backends.base import BackendRunResult, resolve_device
from distributed_optimization_tpu_torch.backends.torch_backend import (
    _DTYPES,
    _side_stream,
    make_eta_schedule,
    make_full_objective_fn,
    tf32_for,
)
from distributed_optimization_tpu_torch.metrics import RunHistory
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import sampling, sampling_kernels
from distributed_optimization_tpu_torch.parallel.events import (
    EventFaultRealization,
    EventTimeline,
    RestartTable,
    build_event_timeline,
    realize_event_faults,
    rejoin_restart_table,
)
from distributed_optimization_tpu_torch.parallel.faults import timeline_for_config
from distributed_optimization_tpu_torch.parallel.topology import Topology, build_topology
from distributed_optimization_tpu_torch.utils.data import HostDataset, stack_shards

# The most events one captured graph holds; a block is the largest divisor
# of an eval window's events up to this.
EVENT_BLOCK = 256


@functools.lru_cache(maxsize=8)
def _cached_timeline(topology, n, er_p, topo_seed, horizon, seed, latency_model,
                     latency_mean, latency_tail, gossip_schedule, x64, device):
    topo = build_topology(topology, n, erdos_renyi_p=er_p, seed=topo_seed, impl="dense")
    return topo, build_event_timeline(
        topo, horizon, seed,
        latency_model=latency_model, latency_mean=latency_mean,
        latency_tail=latency_tail, gossip_schedule=gossip_schedule,
        device=device, x64=x64,
    )


def timeline_for(config, device="cuda") -> tuple[Topology, EventTimeline]:
    """(topology, event timeline) of this config's async run: the same
    for the run and the benches (pure in the config). The matchings draw
    on ``device`` (a card unless the caller asks for the CPU), keyed as the
    run's dtype keys them; the result is the same host arrays on either,
    and a small cache shares one build among the calls of a run."""
    dev = resolve_device(device)
    return _cached_timeline(
        config.topology, config.n_workers, config.erdos_renyi_p,
        config.resolved_topology_seed(), config.n_iterations, config.seed,
        config.latency_model, config.latency_mean, config.latency_tail,
        config.gossip_schedule, config.dtype == "float64", dev.type,
    )


def event_faults_for(config, topo: Topology, timeline: EventTimeline, fault_timeline=None,
                     *, device="cuda"):
    """The config's fault chains realized on the event axis:
    ``(fault_timeline, realization, restart)``, or ``(None, None, None)``
    when no fault process is on (the run then carries no fault arrays).
    ``fault_timeline`` overrides the config's chains (a hand-built
    ``FaultTimeline``, for the equivalence tests); the config's draw on
    ``device``. ``restart`` is the ``RestartTable`` of the rejoin events
    under ``rejoin='neighbor_restart'`` when any event rejoins, else None."""
    if fault_timeline is None:
        if not config.faults_active:
            return None, None, None
        fault_timeline = timeline_for_config(config, topo, timeline.n_rounds, device=device)
    realization = realize_event_faults(timeline, fault_timeline)
    restart = None
    if config.rejoin == "neighbor_restart" and bool(realization.rejoin.any()):
        restart = rejoin_restart_table(timeline, fault_timeline, realization, topo)
    return fault_timeline, realization, restart


def _validate_slice(config, E: int, start_event: int, n_events: Optional[int]):
    """The executed event window [start, start + n): both ends on eval
    boundaries (every ``eval_every · N`` events), so a continuation's
    metric rows line up with the one-shot run's."""
    n = config.n_workers
    events_per_eval = config.eval_every * n
    if n_events is None:
        n_events = E - start_event
    if not 0 <= start_event < E or start_event + n_events > E or n_events <= 0:
        raise ValueError(
            f"event window [{start_event}, {start_event + n_events}) is "
            f"outside the schedule's {E} events"
        )
    if start_event % events_per_eval or n_events % events_per_eval:
        raise ValueError(
            f"event window must align to eval boundaries "
            f"(eval_every * N = {events_per_eval} events): got start="
            f"{start_event}, length={n_events}"
        )
    return n_events, events_per_eval


def event_block(events_per_eval: int) -> int:
    """The events of one captured graph: the largest divisor of an eval
    window's events up to ``EVENT_BLOCK``."""
    return max(b for b in range(1, min(EVENT_BLOCK, events_per_eval) + 1)
               if events_per_eval % b == 0)


@dataclasses.dataclass
class _Schedule:
    """The run's event arrays on its device, indexed by the event cursor."""

    worker: torch.Tensor      # [E] int64
    partner: torch.Tensor     # [E] int64, the effective partner under faults
    local_step: torch.Tensor  # [E] int64
    fire: Optional[torch.Tensor] = None          # [E] bool, under faults
    rejoin: Optional[torch.Tensor] = None        # [E] bool, under neighbor_restart
    restart_index: Optional[torch.Tensor] = None  # [E] int64
    restart_rows: Optional[torch.Tensor] = None   # [n_rejoin + 1, N], run dtype
    batches: Optional[torch.Tensor] = None        # [E, b] or [E, τ, b] int64


def _schedule(timeline: EventTimeline, real: Optional[EventFaultRealization],
              restart: Optional[RestartTable], batches, dev, dtype) -> _Schedule:
    def put(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt).contiguous()

    sched = _Schedule(
        worker=put(timeline.worker),
        partner=put(real.partner if real is not None else timeline.partner),
        local_step=put(timeline.local_step),
    )
    if real is not None:
        sched.fire = put(real.fire, torch.bool)
    if restart is not None:
        sched.rejoin = put(real.rejoin, torch.bool)
        sched.restart_index = put(restart.index)
        sched.restart_rows = put(restart.rows, dtype)
    if batches is not None:
        sched.batches = put(batches)
    return sched


def _check_batches(batch_schedule, E: int, tau: int, n_local: int) -> np.ndarray:
    """The JAX package's checks of an injected per-event schedule, with its
    messages, and the indices' range."""
    batches = np.asarray(batch_schedule)
    if batches.shape[0] != E:
        raise ValueError(
            f"async batch_schedule carries {batches.shape[0]} "
            f"event rows; the schedule has {E} events (one index "
            "row per event into the firing worker's shard)"
        )
    if tau == 1:
        if batches.ndim != 2:
            raise ValueError(
                f"async batch_schedule must be [E, b] at local_steps="
                f"1; got shape {batches.shape}"
            )
    elif batches.ndim != 3 or batches.shape[1] != tau:
        raise ValueError(
            f"async batch_schedule must be [E, {tau}, b] at "
            f"local_steps={tau} (one [b] row per local descent); got "
            f"shape {batches.shape}"
        )
    if batches.min() < 0 or batches.max() >= n_local:
        raise ValueError(f"batch_schedule indices must lie in [0, L={n_local})")
    return batches


def _initial_state(state0, carry_leaves, start_event: int, n: int, d_model: int, dev, dtype):
    """The carry (``x``, ``x_read``, and ``y``, ``g_prev`` for gradient
    tracking): zeros, or the previous slice's ``final_state`` after the JAX
    package's checks and messages."""
    if state0 is None:
        if start_event != 0:
            raise ValueError(
                "continuing from start_event > 0 needs the previous "
                f"slice's final_state ({list(carry_leaves)}) as state0"
            )
        return {k: torch.zeros((n, d_model), dtype=dtype, device=dev) for k in carry_leaves}
    if set(state0) != set(carry_leaves):
        raise ValueError(
            f"async state0 leaves {sorted(state0)} do not match the "
            f"event-path carry {list(carry_leaves)}"
        )
    out = {}
    for k in carry_leaves:
        v = torch.as_tensor(np.asarray(state0[k]) if not isinstance(state0[k], torch.Tensor)
                            else state0[k])
        if tuple(v.shape) != (n, d_model):
            raise ValueError(
                f"state0[{k!r}] has shape {tuple(v.shape)}; expected "
                f"{(n, d_model)}"
            )
        out[k] = v.to(device=dev, dtype=dtype).clone().contiguous()
    return out


def _make_block(config, problem, data, sched: _Schedule, state: dict, cursor: torch.Tensor,
                eta_table: torch.Tensor, base_key, full_batch: bool, B: int):
    """``block()``: B events from the cursor, their writes into ``state`` in
    place, the cursor advanced past them. Without injected batches or a
    full batch, the block's batches are drawn first, at the cursor, by one
    ``sample_event_block`` into a buffer of the run (an event's batch
    depends on its worker, step and descent alone); event e of the block
    reads its static slice."""
    X, y_data, n_valid = data
    dev, dtype = X.device, X.dtype
    reg = config.reg_param
    tau = int(config.local_steps)
    algo_gt = config.algorithm == "gradient_tracking"
    b = config.local_batch_size
    L = X.shape[1]
    rows = torch.arange(L, device=dev)
    uniform = (torch.full((1, sched.batches.shape[-1]), 1.0 / sched.batches.shape[-1],
                          dtype=dtype, device=dev) if sched.batches is not None else None)
    drawn = None
    if sched.batches is None and not full_batch:
        drawn = sampling_kernels.event_block_buffer(B, tau, b, X.shape[2], dtype, dev,
                                                    y_data.dtype)

    def grad(params, i, e, m):
        """The stale-read gradient of the m-th local descent of the block's
        event e (m None: the single descent of τ = 1, whose key folds no
        descent in)."""
        if sched.batches is not None:
            idx = sched.batches.index_select(0, cursor)[0]
            if m is not None:
                idx = idx[m]
            Xb = X.index_select(0, i)[:, idx]
            yb = y_data.index_select(0, i)[:, idx]
            wts = uniform
        elif full_batch:
            ni = n_valid.index_select(0, i)
            mask = (rows[None, :] < ni[:, None]).to(dtype)
            wts = mask / torch.clamp(ni.to(dtype), min=1.0)[:, None]
            Xb, yb = X.index_select(0, i), y_data.index_select(0, i)
        else:
            at = (e, 0 if m is None else m)
            Xb, yb, wts = drawn.Xb[at][None], drawn.yb[at][None], drawn.w[at][None]
        return problem.gradient_weighted(params, Xb, yb, wts, reg)

    def local_chain(x_start, corr, eta, i, e):
        """τ local descents fused into the event: z_{m+1} = z_m − η(corr +
        g(z_m)); (z_τ − z_0, the mean gradient)."""
        z = x_start
        gsum = torch.zeros_like(x_start)
        for m in range(tau):
            gm = grad(z, i, e, m)
            gsum = gsum + gm
            z = z - eta * (gm if corr is None else corr + gm)
        return z - x_start, gsum / tau

    def event(e):
        x, x_read = state["x"], state["x_read"]
        i = sched.worker.index_select(0, cursor)
        j = sched.partner.index_select(0, cursor)
        eta = eta_table.index_select(0, sched.local_step.index_select(0, cursor))
        x_i = x.index_select(0, i)
        xi, read_i = x_i, x_read.index_select(0, i)
        if sched.restart_rows is not None:
            # neighbor_restart: the rejoining worker warm-starts from its
            # alive neighbourhood's average (x only; the trackers stay).
            w_row = sched.restart_rows.index_select(
                0, sched.restart_index.index_select(0, cursor))
            warm = w_row @ x
            rj = sched.rejoin.index_select(0, cursor)[:, None]
            xi = torch.where(rj, warm, xi)
            read_i = torch.where(rj, warm, read_i)
        xj = x.index_select(0, j)
        matched = (j != i)[:, None]
        avg = 0.5 * (xi + xj)
        base_i = torch.where(matched, avg, xi)
        if algo_gt:
            y, g_prev = state["y"], state["g_prev"]
            yi, yj, gpi = y.index_select(0, i), y.index_select(0, j), g_prev.index_select(0, i)
            avg_y = 0.5 * (yi + yj)
            base_y = torch.where(matched, avg_y, yi)
            if tau == 1:
                g_ev = grad(read_i, i, e, None)
                new_y_i = base_y + g_ev - gpi
                new_i = base_i - eta * new_y_i
            else:
                delta, g_ev = local_chain(read_i, base_y - gpi, eta, i, e)
                new_y_i = base_y + g_ev - gpi
                new_i = base_i + delta
            new_y_j = torch.where(matched, avg_y, yj)
        elif tau == 1:
            new_i = base_i - eta * grad(read_i, i, e, None)
        else:
            delta, _ = local_chain(read_i, None, eta, i, e)
            new_i = base_i + delta
        new_j = torch.where(matched, avg, xj)
        if sched.fire is not None:
            # A non-firing event is a no-op: the in-flight gradient is lost.
            fire = sched.fire.index_select(0, cursor)[:, None]
            new_i = torch.where(fire, new_i, x_i)
            new_j = torch.where(fire, new_j, xj)
            new_read = torch.where(fire, new_i, x_read.index_select(0, i))
        else:
            new_read = new_i
        x.index_copy_(0, j, new_j)
        x.index_copy_(0, i, new_i)
        x_read.index_copy_(0, i, new_read)
        if algo_gt:
            new_gp = g_ev
            if sched.fire is not None:
                new_y_i = torch.where(fire, new_y_i, yi)
                new_y_j = torch.where(fire, new_y_j, yj)
                new_gp = torch.where(fire, g_ev, gpi)
            y.index_copy_(0, j, new_y_j)
            y.index_copy_(0, i, new_y_i)
            g_prev.index_copy_(0, i, new_gp)
        cursor.add_(1)

    def block():
        if drawn is not None:
            sampling_kernels.sample_event_block(
                base_key, cursor, sched.worker, sched.local_step, X, y_data, n_valid, b, B,
                descents=None if tau == 1 else tau, out=drawn)
        for e in range(B):
            event(e)

    return block


def _not_yet(name: str) -> ValueError:
    return ValueError(
        f"run_async({name}=...): the PyTorch port does not have it yet (the "
        "surrounding layers, ROADMAP.md Queue 1 item 5: serving, observability "
        "and checkpointing, are not ported)"
    )


def run_async(
    config,
    dataset: HostDataset,
    f_opt: float,
    *,
    device: torch.device | str = "cuda",
    batch_schedule: Optional[np.ndarray] = None,
    collect_metrics: bool = True,
    return_state: bool = False,
    state0: Optional[dict] = None,
    start_event: int = 0,
    n_events: Optional[int] = None,
    capture: bool = True,
    executable_cache=None,
    progress_cb=None,
    monitors=None,
    checkpoint=None,
    _fault_timeline=None,
) -> BackendRunResult:
    """Run one asynchronous experiment (``config.execution == 'async'``).

    ``batch_schedule`` injects per-EVENT batch indices into the firing
    worker's shard: ``[E, b]``, or ``[E, τ, b]`` at ``local_steps=τ > 1``
    (one row a local descent), with weights 1/b. Without it each event
    draws its batch (the card's event sampling kernel, a launch a block of
    events; on the CPU its plain version), or takes the whole shard when b
    >= L. ``state0`` /
    ``start_event`` / ``n_events`` continue a previous slice from its
    ``final_state`` (every leaf, ``return_state=True``): the continuation
    is the one-shot run split in two, bit for bit. ``_fault_timeline``
    injects a hand-built ``FaultTimeline`` in place of the config's chains.
    ``device`` defaults to ``cuda`` and raises when no card is visible;
    ``capture=False`` runs the card's event blocks from the host with no
    graph (the graph run's bitwise reference). ``executable_cache``,
    ``progress_cb``, ``monitors`` and ``checkpoint`` are not ported yet
    and raise.
    """
    for name, value in (("executable_cache", executable_cache), ("progress_cb", progress_cb),
                        ("monitors", monitors), ("checkpoint", checkpoint)):
        if value is not None:
            raise _not_yet(name)
    dev = resolve_device(device)
    dtype = _DTYPES[config.dtype]
    problem = get_problem(config.problem_type, huber_delta=config.huber_delta,
                          n_classes=config.n_classes)
    n = config.n_workers
    host = stack_shards(dataset, dtype=config.dtype)
    X = torch.as_tensor(host.X, device=dev)
    y_data = torch.as_tensor(host.y, device=dev)
    n_valid = torch.as_tensor(host.n_valid, dtype=torch.int64, device=dev)
    d_model = problem.param_dim(host.n_features)
    L = X.shape[1]

    t_setup = time.perf_counter()
    topo, timeline = timeline_for(config, dev)
    topology_seconds = time.perf_counter() - t_setup
    E = timeline.n_events
    n_events, events_per_eval = _validate_slice(config, E, start_event, n_events)
    n_evals = n_events // events_per_eval
    start_round = start_event // n
    tau = int(config.local_steps)
    carry_leaves = ("x", "x_read") + (("y", "g_prev") if config.algorithm
                                      == "gradient_tracking" else ())

    t_fault = time.perf_counter()
    _, fault_real, restart = event_faults_for(config, topo, timeline, _fault_timeline,
                                              device=dev)
    batches = (_check_batches(batch_schedule, E, tau, L) if batch_schedule is not None
               else None)
    sched = _schedule(timeline, fault_real, restart, batches, dev, dtype)
    fault_seconds = time.perf_counter() - t_fault
    state = _initial_state(state0, carry_leaves, start_event, n, d_model, dev, dtype)

    B = event_block(events_per_eval)
    blocks_per_eval = events_per_eval // B
    cursor = torch.full((1,), start_event, dtype=torch.int64, device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)
    # Every block starts at start_event plus a multiple of B and ends by the
    # window's end (B divides the window's eval-aligned length): no block
    # draws past the schedule.
    block = _make_block(
        config, problem, (X, y_data, n_valid), sched, state, cursor,
        make_eta_schedule(config, config.n_iterations, dev, dtype),
        sampling.event_key(config.seed, x64=dtype == torch.float64),
        batch_schedule is None and config.local_batch_size >= L, B)
    full_objective = make_full_objective_fn(problem, config.reg_param)
    track_consensus = collect_metrics and config.record_consensus
    gap_hist = torch.full((n_evals,), float("nan"), dtype=dtype, device=dev)
    cons_hist = torch.full((n_evals,), float("nan"), dtype=dtype, device=dev)

    def metrics():
        x = state["x"]
        xbar = x.mean(dim=0)
        gap_hist.index_copy_(0, k, (full_objective(xbar, X, y_data, n_valid) - f_opt).reshape(1))
        if track_consensus:
            spread = torch.mean(torch.sum((x - xbar[None, :]) ** 2, dim=1))
            cons_hist.index_copy_(0, k, spread.reshape(1))
        k.add_(1)

    use_graphs = dev.type == "cuda" and capture
    graphs = []
    capture_seconds = 0.0
    tf32 = tf32_for(config, dev)
    caller_tf32 = torch.backends.cuda.matmul.allow_tf32

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        if tf32 is not None:
            # Before the warm-up and the capture: a CUDA graph keeps the
            # cuBLAS algorithm chosen while it was captured.
            torch.backends.cuda.matmul.allow_tf32 = tf32
        sync()
        t0 = time.perf_counter()
        if dev.type == "cuda":
            stream = _side_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                block()  # the warm-up: the run's first block of events
                if collect_metrics and use_graphs:
                    # The metrics' own warm-up, written into slot 0 and
                    # then left for the first window's replay to overwrite.
                    metrics()
                    k.zero_()
                if use_graphs:
                    torch.cuda.synchronize(dev)
                    t_cap = time.perf_counter()
                    for fn in (block, metrics) if collect_metrics else (block,):
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graph, stream=stream):
                            fn()
                        graphs.append(graph)
                    torch.cuda.synchronize(dev)
                    capture_seconds = time.perf_counter() - t_cap
            torch.cuda.current_stream(dev).wait_stream(stream)
        else:
            block()
        sync()
        compile_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_block = graphs[0].replay if use_graphs else block
        run_metrics = (graphs[1].replay if use_graphs else metrics) if collect_metrics else None
        for w in range(n_evals):
            for _ in range(blocks_per_eval - (1 if w == 0 else 0)):
                run_block()
            if run_metrics is not None:
                run_metrics()
        sync()
        run_seconds = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = caller_tf32
        for graph in graphs:
            graph.reset()

    sl = slice(start_event, start_event + n_events)
    matched_eff = fault_real.matched_fired if fault_real is not None else timeline.matched()
    per_exchange = (4.0 if config.algorithm == "gradient_tracking" else 2.0) * float(d_model)
    done_rounds = n_events // n
    timed_rounds = (n_events - B) / n
    history = RunHistory(
        objective=(gap_hist.cpu().numpy().astype(np.float64) if collect_metrics
                   else np.full(n_evals, np.nan)),
        consensus_error=(cons_hist.cpu().numpy().astype(np.float64) if track_consensus
                         else None),
        time=np.linspace(run_seconds / max(n_evals, 1), run_seconds, n_evals),
        time_measured=False,
        # Rounds of N events, so iterations to ε compare with the
        # synchronous paths.
        eval_iterations=np.arange(start_round + config.eval_every,
                                  start_round + done_rounds + 1, config.eval_every),
        total_floats_transmitted=float(per_exchange * matched_eff[sl].sum()),
        iters_per_second=(timed_rounds / run_seconds
                          if timed_rounds > 0 and run_seconds > 0 else float("nan")),
        compile_seconds=compile_seconds + fault_seconds,
        spectral_gap=topo.spectral_gap,
        fault_setup_seconds=fault_seconds,
        topology_setup_seconds=topology_seconds,
        capture_seconds=capture_seconds,
    )
    final_models = state["x"].cpu().numpy().astype(np.float64)
    return BackendRunResult(
        history=history,
        final_models=final_models,
        final_avg_model=final_models.mean(axis=0),
        final_state=({key: value.cpu().numpy().astype(np.float64)
                      for key, value in state.items()} if return_state else None),
    )
