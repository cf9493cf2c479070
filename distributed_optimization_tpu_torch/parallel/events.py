"""The asynchronous event clock's schedules (AD-PSGD), host numpy.

The port's copy of ``distributed_optimization_tpu/parallel/events.py``.
Every other path is bulk-synchronous: a round ends at a barrier, so one
straggling worker stalls all N, and a round costs the MAX of N compute-time
draws. On the event clock (Lian et al. '17, AD-PSGD) each worker fires its
own gradient + gossip events at its own pace. The event ORDER depends only
on presampled per-worker compute-time draws, never on the optimization
state, so the whole asynchronous execution unrolls once at set-up into a
static, totally ordered EVENT SCHEDULE, and ``backends/async_scan.py``
runs over events instead of rounds. The schedule is a pure function of
(topology, horizon, seed, latency model), with no carried RNG.

Event model (one event = one worker finishing a gradient computation):

- Worker i draws compute durations ``dur[k, i]`` from the latency model
  (``latency_model`` / ``latency_mean`` / ``latency_tail``) and finishes
  its k-th gradient at virtual time ``T_i(k) = Σ_{r<=k} dur[r, i]``.
- At its event, worker i holds a gradient computed at the snapshot it read
  when the computation started (its model right after its previous own
  event). The writes to row i in between are the event's STALENESS.
- Round k's pairings are the synchronous one-peer schedule's mutual
  matching P_k (the same key stream, ``fold_in(key(seed), 0x3A7C4)`` then
  t, drawn through ``ops/prng.py`` and ``parallel/faults.py::
  sample_one_peer_matching`` on the caller's device), or the round-robin
  phases; the pair {i, j = P_k[i]} exchanges once a round, at the event of
  its initiator min(i, j):

      x_i, x_j <- (x_i + x_j)/2        (pairwise average)
      x_i      <- x_i - eta_k * g_i(x_read_i)

  A non-initiating or unmatched worker's event is a solo local step. Then
  worker i re-reads (``x_read_i <- x_i``). ``eta_k`` follows the worker's
  own step count k.

Events merge across workers by virtual finish time, ties by worker id then
step, so a horizon of T rounds is exactly N·T events and the constant-
latency schedule fires workers 0..N-1 in order at every tick: it IS the
synchronous one-peer D-PSGD round on the same matchings.

The event-indexed fault realization (``realize_event_faults``) reads the
round-clock ``FaultTimeline`` chains (``parallel/faults.py``) at each
firing worker's own local step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from distributed_optimization_tpu_torch.backends.base import resolve_device
from distributed_optimization_tpu_torch.config import LATENCY_MODELS
from distributed_optimization_tpu_torch.ops import prng
from distributed_optimization_tpu_torch.parallel.faults import (
    MATCH_TAG,
    sample_one_peer_matching,
)
from distributed_optimization_tpu_torch.parallel.matchings import round_robin_partners
from distributed_optimization_tpu_torch.parallel.topology import Topology

# Latency models for per-worker compute-time draws. All are normalized so
# the MEAN duration is exactly ``latency_mean`` (the tail knob changes the
# shape, never the mean — matched-mean by construction, so sync and async
# runs burn the same expected compute per gradient step and the measured
# gap is purely the barrier's straggler tax):
# - 'constant':    every draw == latency_mean (the degenerate sync gate);
# - 'exponential': Exp with mean latency_mean (memoryless jitter);
# - 'lognormal':   exp(sigma Z - sigma^2/2) * latency_mean with
#                  sigma = latency_tail (heavy upper tail for sigma >~ 1);
# - 'pareto':      Pareto(alpha = latency_tail > 1) scaled to the mean
#                  (the extreme-tail stress case; alpha <= 1 has no mean).
# (The tuple is the config's.)

# Derivation tag for the duration stream. Drawing [horizon, N] row-major
# from a dedicated Generator keeps the timeline PREFIX-STABLE in the
# horizon: the first H rounds of a longer build are bit-identical to a
# shorter build's — the same contract build_fault_timeline gets from
# per-t fold_in keys. (Matchings use the synchronous one-peer sampler's
# key stream verbatim — see ``_round_matchings`` — so the degenerate
# constant-latency schedule realizes the IDENTICAL pairings a sync
# one_peer run realizes.)
_DURATION_TAG = 0xE7D7


@dataclasses.dataclass(frozen=True)
class EventTimeline:
    """Precomputed, totally ordered asynchronous event schedule (host arrays).

    Pure function of (topology, horizon, seed, latency params) — see
    ``build_event_timeline``. All per-event arrays are indexed by the
    global event order; ``durations`` keeps the raw [horizon, N] draws so
    synchronous wall-clock twins (``sync_round_times``) price the SAME
    realization.
    """

    n_workers: int
    n_rounds: int            # per-worker gradient steps (the horizon, T)
    latency_model: str
    latency_mean: float
    latency_tail: float
    worker: np.ndarray       # [E] int32 firing worker, E = N * T
    partner: np.ndarray      # [E] int32 gossip partner (== worker: solo)
    local_step: np.ndarray   # [E] int32 firing worker's own step index k
    t_virtual: np.ndarray    # [E] float64 event times, nondecreasing
    staleness: np.ndarray    # [E] int32 writes to row i between read & fire
    durations: np.ndarray    # [T, N] float64 per-(round, worker) draws

    @property
    def n_events(self) -> int:
        return self.worker.shape[0]

    def matched(self) -> np.ndarray:
        """[E] bool — initiator events, each realizing ONE pairwise
        exchange (2·d floats); non-initiator/unmatched events are solo
        local steps and move nothing. Per round the matched count is the
        round's matching size — exactly the synchronous one-peer comms
        budget."""
        return self.partner != self.worker

    def worker_clocks(self) -> np.ndarray:
        """[N] float64 per-worker final virtual clocks — Σ of each
        worker's own durations (passive participations cost nothing)."""
        return self.durations.sum(axis=0)


def _uniforms(seed: int, tag: int, horizon: int, n: int) -> np.ndarray:
    """[horizon, n] float64 open-interval uniforms from a dedicated
    counter-style stream. Row-major fill from a per-purpose Generator
    makes each stream prefix-stable in the horizon; nextafter keeps draws
    strictly inside (0, 1) so every inverse-CDF below is finite."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, tag])
    u = rng.random((horizon, n))
    return np.clip(u, np.nextafter(0.0, 1.0), np.nextafter(1.0, 0.0))


def sample_durations(
    horizon: int,
    n: int,
    seed: int,
    *,
    latency_model: str,
    latency_mean: float,
    latency_tail: float,
) -> np.ndarray:
    """[horizon, n] float64 compute-time draws, mean == latency_mean.

    Every model is realized by an explicit inverse-CDF over exactly one
    (lognormal: two, Box-Muller) uniform per cell, so the draw count per
    cell is fixed and the stream stays prefix-stable — numpy's ziggurat
    samplers consume a data-dependent number of uniforms and would break
    that contract.
    """
    if horizon <= 0:
        raise ValueError(f"event horizon must be positive, got {horizon}")
    if latency_mean <= 0.0:
        raise ValueError(
            f"latency_mean must be positive, got {latency_mean}"
        )
    if latency_model == "constant":
        return np.full((horizon, n), float(latency_mean))
    u = _uniforms(seed, _DURATION_TAG, horizon, n)
    if latency_model == "exponential":
        return -latency_mean * np.log1p(-u)
    if latency_model == "lognormal":
        sigma = float(latency_tail)
        if sigma <= 0.0:
            raise ValueError(
                "latency_model='lognormal' needs latency_tail > 0 "
                f"(the log-std tail knob), got {latency_tail}"
            )
        u2 = _uniforms(seed, _DURATION_TAG + 1, horizon, n)
        z = np.sqrt(-2.0 * np.log(u)) * np.cos(2.0 * np.pi * u2)
        return latency_mean * np.exp(sigma * z - 0.5 * sigma * sigma)
    if latency_model == "pareto":
        alpha = float(latency_tail)
        if alpha <= 1.0:
            raise ValueError(
                "latency_model='pareto' needs latency_tail > 1 (the "
                f"shape alpha; alpha <= 1 has no finite mean), got "
                f"{latency_tail}"
            )
        x_m = latency_mean * (alpha - 1.0) / alpha
        return x_m / np.power(u, 1.0 / alpha)
    raise ValueError(
        f"Unknown latency model: {latency_model!r}; known: {LATENCY_MODELS}"
    )


def _round_matchings(
    topo: Topology, horizon: int, seed: int,
    schedule: str = "one_peer", *, device="cuda", x64: bool = False,
) -> np.ndarray:
    """[horizon, N] per-round partner involutions P_k: the draws the
    synchronous one-peer schedule realizes, bit for bit.

    Round t's proposal scores are ``uniform(fold_in(fold_in(key(seed),
    0x3A7C4), t), (N, N))`` in float32 times the adjacency (``ops/prng.py``
    on ``device``), and ``sample_one_peer_matching`` pairs the mutual
    proposals. ``x64`` keys the stream as a float64 run does. Rounds are
    drawn in chunks of 2²² / N² (the JAX package's), so no [horizon, N, N]
    array is ever made. ``'round_robin'`` cycles the deterministic phases
    of ``parallel/matchings.py::round_robin_partners``; ``'synchronous'``
    names the same sampled matchings as ``'one_peer'``."""
    if schedule == "round_robin":
        phases = np.asarray(round_robin_partners(topo), dtype=np.int64)
        reps = -(-horizon // phases.shape[0])  # ceil-div
        return np.tile(phases, (reps, 1))[:horizon]
    if schedule not in ("one_peer", "synchronous"):
        raise ValueError(
            f"unknown event matching schedule {schedule!r}; known: "
            "'synchronous'/'one_peer' (sampled mutual matchings) and "
            "'round_robin' (deterministic phases)"
        )
    if topo.is_matrix_free:
        raise ValueError(
            "event timelines sample one-peer matchings from the dense "
            "adjacency; build the topology with impl='dense' (the event "
            "scan's regime is modest N, not the matrix-free axis)"
        )
    dev = resolve_device(device)
    A = torch.as_tensor(np.asarray(topo.adjacency), dtype=torch.float32, device=dev)
    n_nodes = A.shape[0]
    match_key = prng.fold_in(prng.key(seed, x64=x64), MATCH_TAG)
    counters = torch.arange(n_nodes * n_nodes, dtype=torch.int64,
                            device=dev).reshape(n_nodes, n_nodes)
    chunk = max(1, 2**22 // max(n_nodes * n_nodes, 1))
    out = np.empty((horizon, n_nodes), dtype=np.int64)
    for s in range(0, horizon, chunk):
        e = min(s + chunk, horizon)
        keys = prng.fold_in(match_key, torch.arange(s, e, dtype=torch.int64, device=dev))
        scores = prng.uniform_at(keys, counters) * A
        out[s:e] = sample_one_peer_matching(scores, A).cpu().numpy()
    return out


def build_event_timeline(
    topo: Topology,
    horizon: int,
    seed: int,
    *,
    latency_model: str = "constant",
    latency_mean: float = 1.0,
    latency_tail: float = 0.0,
    gossip_schedule: str = "one_peer",
    device="cuda",
    x64: bool = False,
) -> EventTimeline:
    """Unroll the asynchronous execution into a static event schedule.

    ``horizon`` counts per-worker gradient steps (rounds): the schedule
    holds exactly ``horizon * N`` events. Pure in (topology, horizon,
    seed, latency params) and prefix-stable in the horizon — the first
    H rounds' draws of a longer build are bit-identical — so a resumed or
    re-twinned run rebuilds the identical schedule from the config alone
    (the ``build_fault_timeline`` contract). The matchings draw on
    ``device`` (a card unless the caller asks for the CPU); ``x64`` keys
    them as a float64 run does.

    The O(E) host pass below merges the per-worker event streams, assigns
    each round's mutual matching to its initiator events, and replays the
    write counts that define realized staleness. Directed topologies are
    rejected: the pairwise average is a mutual exchange.
    """
    if topo.directed:
        raise ValueError(
            "asynchronous pairwise gossip is an undirected exchange; "
            f"topology {topo.name!r} has one-way links"
        )
    n = topo.n
    durations = sample_durations(
        horizon, n, seed,
        latency_model=latency_model, latency_mean=latency_mean,
        latency_tail=latency_tail,
    )
    finish = np.cumsum(durations, axis=0)  # [T, N] worker i's event times

    # Per-round mutual matchings, shared with the synchronous one-peer
    # sampler; the pair's exchange rides on its INITIATOR's (pair min's)
    # k-th event, so each matched pair exchanges exactly once per round —
    # the one-peer comms budget — while non-initiators fire solo local
    # steps at their own pace.
    P = _round_matchings(topo, horizon, seed, schedule=gossip_schedule,
                         device=device, x64=x64)
    idx = np.arange(n, dtype=np.int64)[None, :]
    initiates = (P != idx) & (idx < P)
    partner_kn = np.where(initiates, P, idx)

    # Global order: by virtual finish time, ties by worker id then step —
    # stable and deterministic, so the constant-latency degenerate case
    # fires workers 0..N-1 in id order at every tick.
    step_f = np.repeat(np.arange(horizon, dtype=np.int64), n)
    worker_f = np.tile(np.arange(n, dtype=np.int64), horizon)
    time_f = finish.reshape(-1)
    partner_f = partner_kn.reshape(-1)
    order = np.lexsort((step_f, worker_f, time_f))

    worker = worker_f[order].astype(np.int32)
    partner = partner_f[order].astype(np.int32)
    local_step = step_f[order].astype(np.int32)
    t_virtual = time_f[order]

    # Realized staleness: writes to the firing worker's row between its
    # read (right after its previous own event) and this event. Row i is
    # written only at its own events and at initiator events whose
    # partner is i, so the staleness of i's k-th event is the count of
    # PASSIVE writes strictly between consecutive own events. One stable
    # grouping of own/passive event ids by row (O(E log E) total — never
    # a per-row scan of the full [E] arrays) feeds a per-row
    # searchsorted over small contiguous segments.
    E_total = worker.shape[0]
    staleness = np.zeros(E_total, dtype=np.int32)
    o_order = np.argsort(worker, kind="stable")  # ascending ids per row
    o_bounds = np.searchsorted(worker[o_order], np.arange(n + 1))
    pas_ids = np.flatnonzero(partner != worker)
    p_order = np.argsort(partner[pas_ids], kind="stable")
    pas_sorted = pas_ids[p_order]
    p_bounds = np.searchsorted(partner[pas_sorted], np.arange(n + 1))
    for i in range(n):
        own_idx = o_order[o_bounds[i]:o_bounds[i + 1]]
        pas_idx = pas_sorted[p_bounds[i]:p_bounds[i + 1]]
        before = np.searchsorted(pas_idx, own_idx)
        staleness[own_idx] = np.diff(before, prepend=0).astype(np.int32)

    return EventTimeline(
        n_workers=n,
        n_rounds=horizon,
        latency_model=latency_model,
        latency_mean=float(latency_mean),
        latency_tail=float(latency_tail),
        worker=worker,
        partner=partner,
        local_step=local_step,
        t_virtual=t_virtual,
        staleness=staleness,
        durations=durations,
    )


def sync_round_times(timeline: EventTimeline) -> np.ndarray:
    """[T] float64 cumulative virtual clock of the BULK-SYNCHRONOUS twin.

    A synchronous round ends when its slowest worker finishes, so round r
    costs ``max_i durations[r, i]`` — priced on the SAME latency draws the
    asynchronous schedule consumed, which is what makes sync-vs-async
    wall-clock-to-ε comparisons an apples-to-apples statement about the
    barrier, not about the draw realization.
    """
    return np.cumsum(timeline.durations.max(axis=1))


def staleness_histogram(
    timeline: EventTimeline, max_bucket: int = 8, *, events=None,
) -> dict:
    """Realized-staleness summary: counts per staleness value (values
    >= max_bucket collapsed into one tail bucket), plus mean and max —
    the JAX package's async health block (docs/ASYNC.md). ``events``: an
    optional (start, stop) event window, so a continuation slice's
    health describes the events it actually executed."""
    sl = slice(*events) if events is not None else slice(None)
    s = np.asarray(timeline.staleness[sl], dtype=np.int64)
    buckets: dict[str, int] = {}
    for v in range(max_bucket):
        c = int(np.sum(s == v))
        if c:
            buckets[str(v)] = c
    tail = int(np.sum(s >= max_bucket))
    if tail:
        buckets[f"{max_bucket}+"] = tail
    return {
        "buckets": buckets,
        "mean": float(s.mean()) if s.size else 0.0,
        "max": int(s.max()) if s.size else 0,
    }


# --- event-indexed fault processes ------------------------------------------
#
# The round-clock fault chains (``parallel/faults.py::FaultTimeline``) are
# realized ON THE EVENT AXIS by indexing every [horizon, N]/[horizon, E]
# chain at the firing worker's OWN local step: worker i's k-th event
# consults ``node_up[k, i]``, its partner's liveness at ``node_up[k, j]``,
# and the pair's edge chain at row k. Because each worker walks rounds at
# its own pace, this is exactly "the round clock, experienced locally" —
# and at constant latency (where local step == global round for every
# event) the realization collapses BITWISE onto the round-clock arrays
# (tests/test_async_faults.py pins it).


@dataclasses.dataclass(frozen=True)
class EventFaultRealization:
    """Per-event realization of a round-indexed fault timeline (host arrays).

    Semantics (docs/ASYNC.md "Faults on the event clock"):

    - ``fire[e]`` False — the firing worker was crashed (mid-flight loss:
      the in-progress gradient is discarded, nothing is written) or
      sampled out by participation thinning (the event is skipped at the
      matched rate). The event is a total no-op.
    - ``partner[e]`` — the EFFECTIVE partner: the schedule's partner when
      the exchange is alive (both endpoints up and sampled in, edge chain
      up), else the worker itself — the pairing degrades to the solo
      local-step path the schedule already has for unmatched workers.
    - ``rejoin[e]`` True — the worker's first fired event after an outage
      (the round-clock ``FaultTimeline.rejoin`` record, experienced at the
      worker's own pace): the re-entry point where the ``frozen`` /
      ``neighbor_restart`` rejoin policies apply.

    Diagnostics: ``n_inflight_lost`` counts crash no-ops (gradients lost
    mid-flight), ``n_thinned`` participation skips, ``n_degraded`` fired
    matched events whose exchange died (solo fallback);
    ``matched_fired[e]`` marks the events that realized a live pairwise
    exchange — the realized comms accounting bills exactly these.
    """

    fire: np.ndarray           # [E] bool
    partner: np.ndarray        # [E] int32 effective partner (== worker: solo)
    rejoin: np.ndarray         # [E] bool
    matched_fired: np.ndarray  # [E] bool
    n_inflight_lost: int
    n_thinned: int
    n_degraded: int

    @property
    def availability(self) -> float:
        """Realized per-event availability: fired events / all events."""
        return float(self.fire.mean()) if self.fire.size else 1.0


def _edge_id_table(n: int, edge_index: np.ndarray) -> np.ndarray:
    """[N, N] int64 symmetric (i, j) -> edge-chain row lookup (-1: no edge)."""
    eid = np.full((n, n), -1, dtype=np.int64)
    rows = np.arange(edge_index.shape[0], dtype=np.int64)
    eid[edge_index[:, 0], edge_index[:, 1]] = rows
    eid[edge_index[:, 1], edge_index[:, 0]] = rows
    return eid


def realize_event_faults(timeline, faults) -> EventFaultRealization:
    """Realize a round-indexed ``FaultTimeline`` on the event axis.

    Every chain is indexed at the firing worker's LOCAL step (its own
    round count), so the realization is a pure host-side function of the
    two timelines — both backends, the diagnostics, and the incident
    forensics consume the identical arrays (the ``build_fault_timeline``
    purity contract, lifted to events). ``faults.horizon`` must cover the
    schedule's per-worker rounds.
    """
    if faults.horizon < timeline.n_rounds:
        raise ValueError(
            f"fault timeline horizon {faults.horizon} does not cover the "
            f"event schedule's {timeline.n_rounds} per-worker rounds"
        )
    E = timeline.n_events
    n = timeline.n_workers
    k = timeline.local_step.astype(np.int64)
    i = timeline.worker.astype(np.int64)
    j = timeline.partner.astype(np.int64)

    def alive(node):
        """Up AND sampled-in at the node's row of the event's step."""
        a = np.ones(E, dtype=bool)
        if faults.node_up is not None:
            a &= faults.node_up[k, node]
        if faults.part_up is not None:
            a &= faults.part_up[k, node]
        return a

    worker_up = (
        faults.node_up[k, i] if faults.node_up is not None
        else np.ones(E, dtype=bool)
    )
    worker_in = (
        faults.part_up[k, i] if faults.part_up is not None
        else np.ones(E, dtype=bool)
    )
    fire = worker_up & worker_in
    matched = j != i
    exchange = fire & matched & alive(j)
    if faults.edge_up is not None:
        eid = _edge_id_table(n, faults.edge_index)
        ids = eid[i, j]
        exchange &= (ids >= 0) & faults.edge_up[k, np.maximum(ids, 0)]
    partner_eff = np.where(exchange, j, i).astype(np.int32)
    rejoin = (
        (faults.rejoin[k, i] & fire) if faults.rejoin is not None
        else np.zeros(E, dtype=bool)
    )
    return EventFaultRealization(
        fire=fire,
        partner=partner_eff,
        rejoin=rejoin,
        matched_fired=exchange,
        n_inflight_lost=int(np.sum(~worker_up)),
        n_thinned=int(np.sum(worker_up & ~worker_in)),
        n_degraded=int(np.sum(fire & matched & ~exchange)),
    )


def all_up_realization(timeline) -> EventFaultRealization:
    """The degenerate fault-free realization: every event fires, every
    scheduled exchange is live. Exists for the crash-free bitwise gate —
    threading THESE masks through the fault-aware program must reproduce
    the unmasked program's trajectory exactly."""
    matched = timeline.partner != timeline.worker
    return EventFaultRealization(
        fire=np.ones(timeline.n_events, dtype=bool),
        partner=timeline.partner.copy(),
        rejoin=np.zeros(timeline.n_events, dtype=bool),
        matched_fired=matched,
        n_inflight_lost=0,
        n_thinned=0,
        n_degraded=0,
    )


@dataclasses.dataclass(frozen=True)
class RestartTable:
    """The ``neighbor_restart`` rows of the rejoin events alone: row 0 of
    ``rows`` is zero, row r + 1 the r-th rejoin event's weights, and
    ``index[e]`` the row of event e (0 off the rejoin events). The same
    rows as ``rejoin_restart_rows``'s [E, N] table, in [R + 1, N]."""

    rows: np.ndarray   # [n_rejoin + 1, N] float64
    index: np.ndarray  # [E] int64

    def dense(self) -> np.ndarray:
        """The [E, N] table ``rejoin_restart_rows`` gives."""
        return self.rows[self.index]


def rejoin_restart_table(
    timeline, faults, realization: EventFaultRealization, topo: Topology,
) -> RestartTable:
    """The warm-restart weight rows for ``neighbor_restart`` at the rejoin
    events (``RestartTable``).

    At a rejoin event the row is the normalized indicator of the rejoining
    worker's ALIVE realized neighborhood at its re-entry step (base-topology
    neighbors that are up, sampled in, and — when an edge chain is active —
    connected by a live edge). A rejoiner with no alive neighbor gets the
    one-hot self row, i.e. it keeps its frozen state — the same fallback
    the synchronous ``rejoin_restart`` path applies. The backend applies
    ``x_i <- w_e @ x`` (and re-reads) at rejoin events BEFORE the update;
    tracker leaves are never restarted, preserving the gradient-tracking
    invariant through every outage.
    """
    n = timeline.n_workers
    ev_ids = np.flatnonzero(realization.rejoin)
    rows = np.zeros((ev_ids.size + 1, n))
    index = np.zeros(timeline.n_events, dtype=np.int64)
    index[ev_ids] = np.arange(1, ev_ids.size + 1)
    if ev_ids.size == 0:
        return RestartTable(rows, index)
    A = np.asarray(topo.adjacency, dtype=np.float64)
    eid = (
        _edge_id_table(n, faults.edge_index)
        if faults.edge_up is not None else None
    )
    for r, e in enumerate(ev_ids, start=1):
        kk = int(timeline.local_step[e])
        ii = int(timeline.worker[e])
        row = A[ii].copy()
        if faults.node_up is not None:
            row *= faults.node_up[kk]
        if faults.part_up is not None:
            row *= faults.part_up[kk]
        if eid is not None:
            ids = eid[ii]
            live = (ids >= 0) & faults.edge_up[kk, np.maximum(ids, 0)]
            row *= live
        deg = row.sum()
        if deg > 0:
            rows[r] = row / deg
        else:
            rows[r, ii] = 1.0
    return RestartTable(rows, index)


def rejoin_restart_rows(
    timeline, faults, realization: EventFaultRealization, topo: Topology,
) -> np.ndarray:
    """[E, N] float64 warm-restart weight rows for ``neighbor_restart``:
    zero except at rejoin events, whose rows ``rejoin_restart_table``
    gives. The run keeps the compact table instead; at large E this one
    costs gigabytes."""
    return rejoin_restart_table(timeline, faults, realization, topo).dense()


def clock_skew(timeline: EventTimeline, *, rounds=None) -> dict:
    """Per-worker virtual-clock spread at the horizon (or over an
    optional (start, stop) ROUND window): the realized clock drift a
    barrier would have flattened every round."""
    if rounds is not None:
        clocks = timeline.durations[slice(*rounds)].sum(axis=0)
    else:
        clocks = timeline.worker_clocks()
    mean = float(clocks.mean())
    return {
        "mean": mean,
        "min": float(clocks.min()),
        "max": float(clocks.max()),
        "rel_spread": float((clocks.max() - clocks.min()) / mean)
        if mean > 0 else 0.0,
    }
