"""Failure injection: gossip over dropped edges, stragglers, churn and matchings.

The port of ``distributed_optimization_tpu/parallel/faults.py``'s dense and
matrix-free (gather) forms. Each round t realizes a graph from the base
topology:

- **edge drops** (``drop_prob``): each edge drops with probability p, both
  ends agreeing (one-way links drop on their own on a directed graph);
- **stragglers** (``straggler_prob``): each node sits the round out with
  probability q: it exchanges nothing and the backend freezes its state;
- **bursty edges** (``burst_len >= 1``): a Gilbert-Elliott chain per edge at
  the same marginal rate, ``burst_len=1`` bitwise the memoryless draws;
- **crash-recovery churn** (``mttf``/``mttr``): a two-state chain per node,
  with the rejoin policy ``frozen`` or ``neighbor_restart``;
- **participation** (``participation_rate``): per-round client sampling;
- **one-peer gossip**: each node proposes one random neighbour; an edge
  activates iff the proposal is mutual, W_t = ½(I + P_t);
- **round-robin matchings** (``make_round_robin_mixing``), from
  ``parallel/matchings.py``.

Undirected graphs mix with the Metropolis-Hastings weights of the realized
graph, directed ones with its column-stochastic out-weights. Every draw is
the JAX package's: float32 uniforms of ``ops/prng.py``'s Threefry stream at
``fold_in(tag key, t)``, edge (i, j) at counter i·N + j (the i < j entry
for an undirected edge). Persistent processes (bursty edges, churn,
participation) unroll a ``FaultTimeline`` once at set-up
(``fault_timeline``: two launches, the draws and the chains' scan) that
each round reads at t; memoryless
ones draw each round. Either way a round is one launch on a card
(``ops/draw_kernels.realize_round``): A_t, the active mask, W_t in the
run's accumulation dtype and the round's degree count, over the base
graph's neighbour tables (``round_tables``, built once). Masks and A_t are
float32 whatever the run dtype; W_t and the mixed values take
promote(float32, dtype).

``FaultyMixing.realize(t, degree_total)`` gives one ``Round``: its realized
A_t, W_t, active mask or partners on the run's device, and the mix,
neighbour sum, gather-form liveness and warm restart over them; the
round's realized degree count lands in ``degree_total``. ``t`` is the
run's int64 counter tensor, so a captured CUDA graph replays every round.

A matrix-free topology (``topology.is_matrix_free``) takes the gather
form, the JAX package's ``_make_gather_faulty_mixing``: every fault
process goes through the timeline (iid drops and stragglers as its
``burst_len = 1`` chains), whose edge chains draw on the per-edge stream
(edge e of ``_edge_list`` at counter e of the round's ``(E,)`` draw,
another realization than the dense form's); a round is one launch pair
of ``ops/draw_kernels.realize_slot_round`` over the ``[N, k_max]`` table
(``slot_tables``), whose ``GatherRound`` mixes with the realized slot
weights, w_self·x + Σ_s w[:, s]·x[nbr[:, s]], with no [N, N] object. Its
host tables are O(N·k_max), as ``round_tables``' are for every graph.

The replica axis (``torch_backend.run_batch``): ``make_faulty_mixing``
given R seeds (and R drop probabilities, where swept) keys each replica's
streams from its own seed, builds each persistent replica's timeline as
the single run would (a launch pair each) and stacks them
(``stack_fault_timelines``); a round is then one launch for all R, and
every ``Round`` operand and operation gains a leading ``[R]``. Round-robin
matchings draw nothing, so their schedule stays shared. The worker-mesh
form (``make_halo_faulty_mixing``) is not ported.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from distributed_optimization_tpu_torch.backends.base import resolve_device
from distributed_optimization_tpu_torch.config import REJOINS
from distributed_optimization_tpu_torch.ops import draw_kernels, prng
from distributed_optimization_tpu_torch.ops.robust_aggregation import slot_sum
from distributed_optimization_tpu_torch.parallel.topology import (
    Topology,
    incident_edge_slots,
    neighbor_tables_for,
    pair_edge_ids,
)

# Allowed rejoin policies after a crash-recovery outage.
REJOIN_POLICIES = REJOINS
# The stream tags folded into the seed key.
FAULT_TAG, NODE_TAG, MATCH_TAG, PART_TAG = 0x0FA17, 0x57A66, 0x3A7C4, 0x9AC70


@dataclasses.dataclass(frozen=True)
class FaultTimeline:
    """Precomputed ``[horizon]``-indexed fault realizations (host arrays).

    ``edge_up[t, e]`` indexes the base topology's edge list ``edge_index``
    ([E, 2]; i < j rows for undirected graphs, (receiver, sender) pairs for
    directed ones). ``node_up[t, i]`` is node availability; ``rejoin[t, i]``
    marks the first up-round after an outage; ``part_up[t, i]`` the
    participation draw. None for a process that is off.
    """

    horizon: int
    directed: bool
    edge_index: Optional[np.ndarray] = None  # [E, 2] int32
    edge_up: Optional[np.ndarray] = None     # [horizon, E] bool
    node_up: Optional[np.ndarray] = None     # [horizon, N] bool
    rejoin: Optional[np.ndarray] = None      # [horizon, N] bool
    part_up: Optional[np.ndarray] = None     # [horizon, N] bool


def _tag_keys(seed: int, x64: bool, *tags):
    base = prng.key(seed, x64=x64)
    return tuple(prng.fold_in(base, tag) for tag in tags)


def replica_keys(seeds: Sequence[int], x64: bool, *tags, device) -> torch.Tensor:
    """The replica axis's keys: int64 ``[R, len(tags), 2]`` on ``device``,
    row r the tag keys ``_tag_keys(seeds[r], x64, *tags)``."""
    return torch.stack([prng.keys(seeds, x64=x64, tags=(tag,), device=device) for tag in tags],
                       dim=1).contiguous()


def stack_fault_timelines(timelines: list[FaultTimeline]) -> FaultTimeline:
    """Stack per-replica timelines into one with [R, ...] leading axes, as
    the JAX package's function of that name does (its checks and
    messages): ``edge_index`` is the topology's and shared; which processes
    are on must match across the replicas (one config, many seeds)."""
    if not timelines:
        raise ValueError("need at least one timeline to stack")
    t0 = timelines[0]
    for t in timelines[1:]:
        if (
            t.horizon != t0.horizon
            or t.directed != t0.directed
            or (t.edge_up is None) != (t0.edge_up is None)
            or (t.node_up is None) != (t0.node_up is None)
            or (t.part_up is None) != (t0.part_up is None)
        ):
            raise ValueError(
                "timelines disagree in structure (horizon / fault modes); "
                "replica stacking requires one config over many seeds"
            )

    def _stack(field):
        vals = [getattr(t, field) for t in timelines]
        return np.stack(vals) if vals[0] is not None else None

    return FaultTimeline(
        horizon=t0.horizon,
        directed=t0.directed,
        edge_index=t0.edge_index,
        edge_up=_stack("edge_up"),
        node_up=_stack("node_up"),
        rejoin=_stack("rejoin"),
        part_up=_stack("part_up"),
    )


def metropolis_hastings_weights(adjacency: torch.Tensor) -> torch.Tensor:
    """MH weights of a realized 0/1 adjacency: W_ij = 1/(1 + max(d_i, d_j))
    on edges, the row remainder on the diagonal (1 for an isolated node)."""
    deg = torch.sum(adjacency, dim=-1)
    pair = 1.0 / (1.0 + torch.maximum(deg[..., :, None], deg[..., None, :]))
    W = adjacency * pair
    return W + torch.diag_embed(1.0 - torch.sum(W, dim=-1))


def column_stochastic_weights(adjacency: torch.Tensor) -> torch.Tensor:
    """Uniform out-weights of a realized directed graph (``adjacency[i, j] =
    1`` iff j sends to i): W_ij = 1/(1 + outdeg_j), the column remainder on
    the diagonal, so every column sums to 1 (push-sum's mass)."""
    out_deg = torch.sum(adjacency, dim=0)
    W = adjacency / (1.0 + out_deg)[None, :]
    return W + torch.diag(1.0 - torch.sum(W, dim=0))


def sample_one_peer_matching(scores: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
    """Mutual-proposal matching from the proposal scores ``u · A_t``:
    partner[i] (self if unmatched). Each node proposes its first highest
    score; isolated rows propose themselves. ``[R, N]`` partners for
    ``[R, N, N]`` rounds."""
    n = adjacency.shape[-1]
    idx = torch.arange(n, device=adjacency.device)
    prop = torch.argmax(scores, dim=-1)
    prop = torch.where(torch.sum(adjacency, dim=-1) > 0, prop, idx)
    mutual = torch.gather(prop, -1, prop) == idx
    return torch.where(mutual, prop, idx)


def iid_equivalent_churn(straggler_prob: float) -> tuple[float, float]:
    """The (mttf, mttr) point at which churn reduces bitwise to iid
    stragglers at rate q: mttf = 1/q, mttr = 1/(1−q)."""
    if not 0.0 < straggler_prob < 1.0:
        raise ValueError(
            f"straggler_prob must be in (0, 1), got {straggler_prob}"
        )
    return 1.0 / straggler_prob, 1.0 / (1.0 - straggler_prob)


def _edge_list(topo: Topology) -> np.ndarray:
    """[E, 2] int32 edge list: one i < j row per undirected edge (the triu
    entry both ends share), or one (i, j) row per one-way link. A
    matrix-free graph gives the same i < j rows from its table."""
    if topo.is_matrix_free:
        rows, slots = np.nonzero(topo.nbr_mask)
        js = topo.nbr_idx[rows, slots]
        keep = rows < js
        return np.stack([rows[keep], js[keep]], axis=1).astype(np.int32)
    A = np.asarray(topo.adjacency)
    src = np.triu(A, 1) if not topo.directed else A
    ei, ej = np.nonzero(src)
    return np.stack([ei, ej], axis=1).astype(np.int32)


def config_faults_active(config) -> bool:
    """Whether a config runs any synchronous node or edge fault process."""
    return config.faults_active


def timeline_for_config(config, topo: Topology, horizon: int, seed=None, *,
                        device="cuda") -> FaultTimeline:
    """The config → ``build_fault_timeline`` mapping of the JAX package: the
    burst clamp and the straggler-vs-churn rule in one place."""
    return build_fault_timeline(
        topo, horizon, config.seed if seed is None else seed,
        edge_drop_prob=config.edge_drop_prob,
        burst_len=config.burst_len if config.burst_len >= 1.0 else 1.0,
        straggler_prob=(
            0.0 if config.mttf > 0.0 else config.straggler_prob
        ),
        mttf=config.mttf, mttr=config.mttr,
        participation_rate=config.participation_rate,
        device=device, x64=config.dtype == "float64",
    )


def _check_timeline_args(horizon, burst_len, straggler_prob, mttf, mttr,
                         participation_rate) -> None:
    if horizon <= 0:
        raise ValueError(f"timeline horizon must be positive, got {horizon}")
    if burst_len < 1.0:
        raise ValueError(f"burst_len must be >= 1, got {burst_len}")
    if (mttf > 0.0) != (mttr > 0.0):
        raise ValueError("mttf and mttr must be set together")
    if mttf > 0.0 and (mttf < 1.0 or mttr < 1.0):
        raise ValueError(
            f"mttf/mttr are mean holding times in rounds and must be >= 1 "
            f"(got mttf={mttf}, mttr={mttr})"
        )
    if mttf > 0.0 and straggler_prob > 0.0:
        raise ValueError(
            "crash-recovery churn replaces iid stragglers; set one of "
            "(mttf, mttr) / straggler_prob, not both"
        )
    if not 0.0 < participation_rate <= 1.0:
        raise ValueError(
            f"participation_rate must be in (0, 1], got {participation_rate}"
        )


def timeline_args(topo: Topology, seed: int, *, edge_drop_prob: float, burst_len: float,
                  straggler_prob: float, mttf: float, mttr: float, participation_rate: float,
                  device, x64: bool):
    """The processes' arguments of ``draw_kernels.fault_timeline`` (and of
    its plain version) but the horizon and device: the keys, N, the edge
    list on ``device`` (None with its count ``n_edges`` on a matrix-free
    graph, whose chains draw on the per-edge stream), the chains'
    thresholds and p_out; and the edge list on the host."""
    keys = _tag_keys(seed, x64, FAULT_TAG, NODE_TAG, PART_TAG)
    edge_index = edges = edge_chain = n_edges = None
    if edge_drop_prob > 0.0:
        edge_index = _edge_list(topo)
        if topo.is_matrix_free:
            n_edges = len(edge_index)
        else:
            edges = torch.as_tensor(edge_index, device=device)
        p = edge_drop_prob
        if burst_len == 1.0:
            # State-independent thresholds: exactly the iid comparison.
            edge_chain = (p, p, p)
        else:
            edge_chain = (p, p / burst_len, 1.0 - (1.0 - p) / burst_len)
    node_chain = None
    if mttf > 0.0:
        node_chain = (mttr / (mttf + mttr), 1.0 / mttf, 1.0 - 1.0 / mttr)
    elif straggler_prob > 0.0:
        node_chain = (straggler_prob,) * 3
    p_out = 1.0 - participation_rate if participation_rate < 1.0 else None
    return dict(keys=keys, n=topo.n, edges=edges, n_edges=n_edges, edge_chain=edge_chain,
                node_chain=node_chain, p_out=p_out), edge_index


def _timeline_tensors(topo: Topology, horizon: int, seed: int, *, edge_drop_prob: float,
                      burst_len: float, straggler_prob: float, mttf: float, mttr: float,
                      participation_rate: float, device, x64: bool):
    """The timeline's bool tensors on ``device`` (``draw_kernels.fault_timeline``)
    and the edge list."""
    _check_timeline_args(horizon, burst_len, straggler_prob, mttf, mttr, participation_rate)
    args, edge_index = timeline_args(
        topo, seed, edge_drop_prob=edge_drop_prob, burst_len=burst_len,
        straggler_prob=straggler_prob, mttf=mttf, mttr=mttr,
        participation_rate=participation_rate, device=device, x64=x64)
    return draw_kernels.fault_timeline(horizon=horizon, device=device, **args), edge_index


def build_fault_timeline(
    topo: Topology,
    horizon: int,
    seed: int,
    *,
    edge_drop_prob: float = 0.0,
    burst_len: float = 1.0,
    straggler_prob: float = 0.0,
    mttf: float = 0.0,
    mttr: float = 0.0,
    participation_rate: float = 1.0,
    device="cuda",
    x64: bool = False,
) -> FaultTimeline:
    """Unroll the per-edge / per-node fault chains into host arrays, bit for
    bit the JAX package's: alive iff u >= the threshold, with

        edge:  P(down | up) = p/B,   P(down | down) = 1 − (1−p)/B
        node:  P(down | up) = 1/mttf, P(down | down) = 1 − 1/mttr (or q)

    and the t = 0 state from the stationary marginal. The draws run on
    ``device``, a card unless the caller asks for the CPU, as the two
    launches of ``draw_kernels.fault_timeline``; ``x64`` keys the stream as
    a float64 run does."""
    out, edge_index = _timeline_tensors(
        topo, horizon, seed, edge_drop_prob=edge_drop_prob, burst_len=burst_len,
        straggler_prob=straggler_prob, mttf=mttf, mttr=mttr,
        participation_rate=participation_rate, device=resolve_device(device), x64=x64)
    host = {k: (v.cpu().numpy() if v is not None else None) for k, v in out.items()}
    return FaultTimeline(horizon=horizon, directed=topo.directed, edge_index=edge_index,
                         **host)


# --- availability / staleness diagnostics (host-side, over a timeline) ----


def node_downtime(timeline: FaultTimeline) -> np.ndarray:
    """Per-node fraction of rounds spent down over the timeline horizon."""
    if timeline.node_up is None:
        raise ValueError("timeline has no node fault process")
    return 1.0 - timeline.node_up.mean(axis=0)


def outage_stats(timeline: FaultTimeline) -> dict:
    """Count, mean and max outage length (rounds) across all nodes."""
    if timeline.node_up is None:
        raise ValueError("timeline has no node fault process")
    lengths: list[int] = []
    for i in range(timeline.node_up.shape[1]):
        run = 0
        for up in timeline.node_up[:, i]:
            if not up:
                run += 1
            elif run:
                lengths.append(run)
                run = 0
        if run:
            lengths.append(run)  # outage still open at the horizon
    return {
        "n_outages": len(lengths),
        "mean_outage_rounds": float(np.mean(lengths)) if lengths else 0.0,
        "max_outage_rounds": int(max(lengths)) if lengths else 0,
    }


def _realized_edge_alive(timeline: FaultTimeline, topo: Topology):
    """([T, E] alive mask, [E, 2] edge list): an edge is alive iff its link
    is up and both its ends are up and sampled in."""
    edges = timeline.edge_index if timeline.edge_index is not None else _edge_list(topo)
    T = timeline.horizon
    alive = (timeline.edge_up.copy() if timeline.edge_up is not None
             else np.ones((T, edges.shape[0]), dtype=bool))
    for mask in (timeline.node_up, timeline.part_up):
        if mask is not None:
            alive &= mask[:, edges[:, 0]] & mask[:, edges[:, 1]]
    return alive, edges


def _union_connected(present: np.ndarray, edges: np.ndarray, n: int) -> bool:
    """Union-find connectivity of the graph with ``edges[present]``."""
    parent = list(range(n))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    comps = n
    for i, j in edges[present]:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
            comps -= 1
    return comps == 1


def windowed_connectivity(timeline: FaultTimeline, topo: Topology) -> Optional[int]:
    """B̂: the smallest B such that every length-B window's union of realized
    graphs is connected (weakly, for directed graphs); None if even the
    whole horizon's union is not."""
    alive, edges = _realized_edge_alive(timeline, topo)
    n = topo.n
    T = timeline.horizon
    csum = np.concatenate(
        [np.zeros((1, edges.shape[0]), dtype=np.int64),
         np.cumsum(alive, axis=0, dtype=np.int64)],
        axis=0,
    )

    def all_windows_connected(B: int) -> bool:
        for s in range(T - B + 1):
            if not _union_connected((csum[s + B] - csum[s]) > 0, edges, n):
                return False
        return True

    if not all_windows_connected(T):
        return None
    lo, hi = 1, T
    while lo < hi:
        mid = (lo + hi) // 2
        if all_windows_connected(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


# --- one round ---------------------------------------------------------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(torch.float32, dtype)


def _padded_pairs(rows: np.ndarray, cols: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major (row, col) pairs as each row's cols in order, padded with
    the row, and the rows' counts: ([N, k] int32, [N] int32), k the largest
    count (at least 1)."""
    counts = np.bincount(rows, minlength=n)
    k = max(int(counts.max()) if n else 0, 1)
    table = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    slot = np.arange(len(rows), dtype=np.int64) - (np.cumsum(counts) - counts)[rows]
    table[rows, slot] = cols
    return table, counts.astype(np.int32)


def round_tables(topo: Topology, edge_index: Optional[np.ndarray] = None, *,
                 device) -> draw_kernels.RoundTables:
    """The round kernel's neighbour tables of the base graph on ``device``:
    each row's neighbours (on a directed graph its senders, and then each
    node's receivers); with ``edge_index`` (a timeline's [E, 2] edge list),
    each slot's edge id (−1 on padded slots). O(N·k_max) on the host: the
    undirected graphs' ``neighbor_tables_for`` (a matrix-free graph's own
    table), a directed graph's nonzero pairs."""
    n = topo.n
    out_nbr = out_cnt = out_eid = in_eid = None
    if topo.directed:
        in_nbr, in_cnt = _padded_pairs(*np.nonzero(topo.adjacency), n)
        out_nbr, out_cnt = _padded_pairs(*np.nonzero(topo.adjacency.T), n)
    else:
        in_nbr, mask = neighbor_tables_for(topo)
        in_cnt = mask.sum(axis=1).astype(np.int32)
    k = np.arange(in_nbr.shape[1])
    in_valid = k[None, :] < in_cnt[:, None]
    if edge_index is not None:
        rows = np.broadcast_to(np.arange(n)[:, None], in_nbr.shape)
        if topo.directed:
            in_eid = pair_edge_ids(rows, in_nbr, in_valid, edge_index, n)
            out_rows = np.broadcast_to(np.arange(n)[:, None], out_nbr.shape)
            out_valid = np.arange(out_nbr.shape[1])[None, :] < out_cnt[:, None]
            # The link into out_nbr[j, s] from j.
            out_eid = pair_edge_ids(out_nbr, out_rows, out_valid, edge_index, n)
        else:
            in_eid = np.where(in_valid, incident_edge_slots(in_nbr, in_valid, edge_index), -1)

    def put(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=device)

    return draw_kernels.RoundTables(n, topo.directed, put(in_nbr), put(in_cnt), put(in_eid),
                                    put(out_nbr), put(out_cnt), put(out_eid))


def slot_tables(nbr_idx: np.ndarray, nbr_mask: np.ndarray,
                edge_index: Optional[np.ndarray] = None, *, device) -> draw_kernels.SlotTables:
    """The slot round's tables of a neighbour table on ``device``: the
    table, each row's real slots (its count) and, with a timeline's
    ``edge_index``, each slot's edge id (``incident_edge_slots``; −1 on
    padded slots). Where the mask's real slots are not the first of each
    row (as every topology constructor lays them out), or it holds values other than 0
    and 1, the float32 mask goes along (``slot_liveness`` takes it).
    O(N·k_max) on the host."""
    nbr_mask = np.asarray(nbr_mask)
    real = nbr_mask != 0
    cnt = real.sum(axis=1)
    prefix = np.array_equal(real, np.arange(nbr_mask.shape[1])[None, :] < cnt[:, None])
    binary = bool(np.all((nbr_mask == 0) | (nbr_mask == 1)))
    eid = None
    if edge_index is not None:
        eid = np.where(real, incident_edge_slots(nbr_idx, real, edge_index), -1)

    def put(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=device)

    mask = None if prefix and binary else torch.as_tensor(
        np.ascontiguousarray(nbr_mask, dtype=np.float32), device=device)
    return draw_kernels.SlotTables(nbr_idx.shape[0], put(nbr_idx), put(cnt), put(eid), mask)


def _add_matched(degree_total: Optional[torch.Tensor], partner: torch.Tensor) -> None:
    """A matching's degree count: its matched nodes (each replica's, for
    [R, N] partners; a shared [N] matching adds its count to every
    replica's total)."""
    if degree_total is not None:
        idx = torch.arange(partner.shape[-1], device=partner.device)
        degree_total.add_(torch.sum(partner != idx, dim=-1).to(torch.float64))


def _partner_rows(x: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
    """Each worker's partner's row of x (the worker axis −2): a shared [N]
    matching, or a replica's own [R, N] one."""
    if partner.dim() == 1:
        return x.index_select(x.dim() - 2, partner)
    return torch.take_along_dim(x, partner[..., None], dim=-2)


class Round:
    """One round's realized graph on the run's device, and the operations
    over it. ``A``: the float32 [N, N] realized adjacency (None under a
    matching schedule); ``W``: W_t in the run's promote(float32, dtype) (MH,
    or column-stochastic on a directed graph), from the same launch;
    ``active``: the float32 [N]
    node mask; ``partner``: the int64 [N] matching (matching schedules);
    ``rejoin``: this round's rejoining nodes (bool [N]) under
    ``neighbor_restart``. On the replica axis each has a leading [R] (a
    round-robin matching and its mask stay [N], shared), and the
    operations take [R, N, ...] stacks."""

    def __init__(self, A, active, partner=None, *, W=None, rejoin=None):
        self.A, self.active, self.partner = A, active, partner
        self.W, self.rejoin = W, rejoin

    def weights(self, acc: torch.dtype) -> torch.Tensor:
        """W_t, realized in ``acc``."""
        if acc != self.W.dtype:
            raise ValueError(f"this round's W_t was realized in {self.W.dtype}, not {acc}")
        return self.W

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """W_t x, in promote(float32, dtype), cast back."""
        if self.partner is not None:
            return (0.5 * (x + _partner_rows(x, self.partner))).to(x.dtype)
        acc = _acc(x.dtype)
        return torch.matmul(self.weights(acc), x.to(acc)).to(x.dtype)

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A_t x (the matched partner's row under a matching)."""
        if self.partner is not None:
            idx = torch.arange(self.partner.shape[-1], device=x.device)
            matched = (self.partner != idx).to(x.dtype)
            return (_partner_rows(x, self.partner) * matched[..., None]).to(x.dtype)
        acc = _acc(x.dtype)
        return torch.matmul(self.A.to(acc), x.to(acc)).to(x.dtype)

    def live(self, nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The gather form: float32 [N, k_max] liveness of each neighbour-table
        slot, A_t[i, nbr[i, s]] on live slots (bitwise the JAX package's
        per-slot gather of the same draws); [R, N, k_max] on the replica
        axis."""
        return torch.gather(self.A, -1, nbr.expand(*self.A.shape[:-2], *nbr.shape)) * mask

    def restart(self, x: torch.Tensor) -> torch.Tensor:
        """``neighbor_restart``: a rejoining node with realized neighbours
        takes their average; every other row passes through."""
        acc = _acc(x.dtype)
        A = self.A.to(acc)
        deg = torch.sum(A, dim=-1)
        nbr_avg = torch.matmul(A, x.to(acc)) / torch.clamp(deg, min=1.0)[..., None]
        take = self.rejoin & (deg > 0)
        return torch.where(take[..., None], nbr_avg, x.to(acc)).to(x.dtype)


class GatherRound:
    """One round of the matrix-free (gather) form on the run's device: the
    operations of ``Round`` over the realized slot table. ``A`` and ``W``
    are None (no [N, N] object); ``active``: the float32 [N] node mask;
    ``rejoin``: this round's rejoining nodes under ``neighbor_restart``. On
    the replica axis each has a leading [R]."""

    A = W = partner = None

    def __init__(self, realized: draw_kernels.SlotRound, nbr: torch.Tensor, *, rejoin=None,
                 liveness=None):
        self._r, self._nbr = realized, nbr  # nbr: int64 [N, k] on the device
        self.active, self.rejoin = realized.active, rejoin
        self._liveness = liveness  # SlotTables -> this round's liveness over that table

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """x's rows at each slot's neighbour, in promote(float32, dtype): [...,
        N, k, d]."""
        return x.to(_acc(x.dtype))[..., self._nbr, :]

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """w_self·x + Σ_s w[:, s]·x[nbr[:, s]] (slots in order), in
        promote(float32, dtype), cast back. bfloat16 rows take
        ``_mix_contracted``."""
        acc = _acc(x.dtype)
        if acc != self._r.w.dtype:
            raise ValueError(f"this round's weights were realized in {self._r.w.dtype}, "
                             f"not {acc}")
        if x.dtype == torch.bfloat16:
            return self._mix_contracted(x)
        out = self._r.w_self[..., None] * x.to(acc) + slot_sum(
            self._r.w[..., None] * self._gathered(x))
        return out.to(x.dtype)

    def _mix_contracted(self, x: torch.Tensor) -> torch.Tensor:
        """The bfloat16 mix as the JAX package's jitted mix computes it on the
        CPU: XLA contracts the float32 slot sum into a chain of fused
        multiply-adds, s = fma(w_s, x_s, s) from s = w_0·x_0 (rounded), and
        the self term into one more, fma(w_self, x, s); the float32 result
        is cast to bfloat16. Each fma is computed in float64 and rounded to
        float32: a float32 weight times a bfloat16 value is exact in
        float64, and so is its sum with a float32 value up to a tail that
        cannot move the float32 rounding, so every step is the fma's."""
        w = self._r.w.double()[..., None]
        xs = x.double()[..., self._nbr, :]
        total = (w[..., 0, :] * xs[..., 0, :]).float()
        for s in range(1, xs.shape[-2]):
            total = (w[..., s, :] * xs[..., s, :] + total.double()).float()
        out = self._r.w_self.double()[..., None] * x.double() + total.double()
        return out.float().to(x.dtype)

    def neighbor_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ_s live[:, s]·x[nbr[:, s]]."""
        acc = _acc(x.dtype)
        return slot_sum(self._r.live.to(acc)[..., None] * self._gathered(x)).to(x.dtype)

    def live(self, nbr, mask) -> torch.Tensor:
        """The float32 liveness of each slot of a neighbour table, as
        ``FaultyMixing.device_table`` gives it: the graph's own (this round's
        live slots; ``mask`` is the table's own and unread) or a caller's
        ``SlotTables``, whose liveness at this round is one launch of the
        slot round's live pass (its mask in the tables)."""
        if nbr is self._nbr:
            return self._r.live
        if not isinstance(nbr, draw_kernels.SlotTables):
            raise TypeError("a matrix-free round's liveness takes the table "
                            "FaultyMixing.device_table gives")
        return self._liveness(nbr)

    def restart(self, x: torch.Tensor) -> torch.Tensor:
        """``neighbor_restart``: a rejoining node with realized neighbours
        takes their average; every other row passes through."""
        acc = _acc(x.dtype)
        lv = self._r.live.to(acc)
        deg = torch.sum(lv, dim=-1)
        nbr_avg = slot_sum(lv[..., None] * self._gathered(x)) / torch.clamp(deg, min=1.0)[
            ..., None]
        take = self.rejoin & (deg > 0)
        return torch.where(take[..., None], nbr_avg, x.to(acc)).to(x.dtype)


class FaultyMixing:
    """Per-round mixing over a randomly failing topology (see the module
    docstring); ``realize(t, degree_total)`` gives the round. ``freezes``:
    inactive nodes keep their whole state for the round (stragglers, churn
    or participation). ``timeline``: the host timeline, or None on the
    memoryless path. ``acc``: the dtype of each round's W_t, the run's
    promote(float32, dtype). ``replicas``: R on the replica axis (``keys``
    an int64 [R, 3, 2] tensor, ``drop_prob`` a float or a float32 [R]
    tensor, the timeline stacked), else None."""

    def __init__(self, topo: Topology, *, device, drop_prob=0.0, straggler_prob=0.0,
                 one_peer=False, churn_active=False, participation_active=False,
                 rejoin="frozen", keys=None, timeline_tensors=None, timeline=None,
                 partners=None, acc=torch.float32):
        self.topo, self.device = topo, device
        self.drop_prob, self.straggler_prob = drop_prob, straggler_prob
        self.one_peer, self.churn_active = one_peer, churn_active
        self.participation_active, self.rejoin = participation_active, rejoin
        self.timeline, self.acc = timeline, acc
        self.freezes = straggler_prob > 0.0 or churn_active or participation_active
        self.replicas = draw_kernels.replica_count(keys)
        self._keys = keys
        self._partners = partners  # round-robin phases [P, N]
        self._ones = torch.ones(topo.n, dtype=torch.float32, device=device)
        self._tl = self._rejoin = None
        edge_index = None
        if timeline_tensors is not None:
            tl = timeline_tensors
            self._tl = draw_kernels.RoundTimeline(tl["edge_up"], tl["node_up"], tl["part_up"])
            self._rejoin = tl["rejoin"] if rejoin == "neighbor_restart" else None
            if tl["edge_up"] is not None:
                edge_index = (timeline.edge_index if timeline.edge_index is not None
                              else _edge_list(topo))
        self._tables = self._slots = None
        self._edge_index = edge_index
        if topo.is_matrix_free:
            self._slots = slot_tables(topo.nbr_idx, topo.nbr_mask, edge_index, device=device)
            self._nbr = self._slots.nbr.long()
        elif partners is None:
            self._tables = round_tables(topo, edge_index, device=device)

    @property
    def directed(self) -> bool:
        return self.topo.directed

    def realize(self, t: torch.Tensor, degree_total: Optional[torch.Tensor] = None) -> Round:
        """The round at the counter ``t`` (an int64 tensor of one element on
        the run's device), its W_t in ``self.acc``; its realized degree count
        (matched nodes under a matching) is added to ``degree_total``, a
        float64 tensor of one element, where given."""
        if self._slots is not None:
            out = draw_kernels.realize_slot_round(t, self._slots, self._tl, weights=self.acc,
                                                  degree_total=degree_total,
                                                  replicas=self.replicas)
            return GatherRound(out, self._nbr, rejoin=self._rejoin_at(t),
                               liveness=lambda tables: self._slot_liveness(t, tables))
        if self._partners is not None:
            phase = torch.remainder(t, self._partners.shape[0])
            partner = self._partners.index_select(0, phase)[0]
            _add_matched(degree_total, partner)
            return Round(None, self._ones, partner)
        out = draw_kernels.realize_round(
            t, self._keys, self._tables, drop_prob=self.drop_prob,
            straggler_prob=self.straggler_prob, timeline=self._tl,
            weights=None if self.one_peer else self.acc, scores=self.one_peer,
            degree_total=None if self.one_peer else degree_total)
        if self.one_peer:
            partner = sample_one_peer_matching(out.scores, out.A)
            _add_matched(degree_total, partner)
            return Round(None, out.active, partner)
        return Round(out.A, out.active, W=out.W, rejoin=self._rejoin_at(t))

    def _rejoin_at(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The rejoining nodes at t under ``neighbor_restart``, else None."""
        if self._rejoin is None:
            return None
        row = draw_kernels.timeline_row(t, self._rejoin.shape[-2])
        return self._rejoin.index_select(-2, row).squeeze(-2)

    # The JAX package's per-t functions, through ``realize`` (for the tests).

    def _t(self, t) -> torch.Tensor:
        if isinstance(t, torch.Tensor):
            return t.reshape(1).to(device=self.device, dtype=torch.int64)
        return torch.tensor([int(t)], dtype=torch.int64, device=self.device)

    def realized_adjacency(self, t) -> torch.Tensor:
        return self.realize(self._t(t)).A

    def active(self, t) -> torch.Tensor:
        return self.realize(self._t(t)).active

    def partner(self, t) -> torch.Tensor:
        return self.realize(self._t(t)).partner

    def mix(self, t, x: torch.Tensor) -> torch.Tensor:
        """W_t x, with W_t realized in x's promote(float32, dtype)."""
        same = copy.copy(self)
        same.acc = _acc(x.dtype)
        return same.realize(self._t(t)).mix(x)

    def neighbor_sum(self, t, x: torch.Tensor) -> torch.Tensor:
        return self.realize(self._t(t)).neighbor_sum(x)

    def realized_degree_sum(self, t) -> torch.Tensor:
        """Σ realized degrees at t, a float64 tensor of one element (one a
        replica)."""
        total = torch.zeros((self.replicas,) if self.replicas else (), dtype=torch.float64,
                            device=self.device)
        self.realize(self._t(t), total)
        return total

    def rejoin_restart(self, t, x: torch.Tensor) -> torch.Tensor:
        return self.realize(self._t(t)).restart(x)

    def _slot_liveness(self, t: torch.Tensor, tables: draw_kernels.SlotTables) -> torch.Tensor:
        return draw_kernels.slot_liveness(t, tables, self._tl, replicas=self.replicas)

    def device_table(self, nbr_idx: np.ndarray, nbr_mask: np.ndarray):
        """The device table a matrix-free round's ``live`` takes for the
        caller's host table: the topology's own table's int64 tensor (the
        slot round realizes its slots), or, for any other table, its
        ``SlotTables`` (the edge ids of its slots from the timeline's edge
        list, and its mask where its real slots are not a prefix of each
        row), built once here."""
        topo = self.topo
        if (np.array_equal(np.asarray(nbr_idx), topo.nbr_idx)
                and np.array_equal(np.asarray(nbr_mask), topo.nbr_mask)):
            return self._nbr
        return slot_tables(np.asarray(nbr_idx), nbr_mask, self._edge_index, device=self.device)

    def make_neighbor_liveness(self, nbr_idx: np.ndarray, nbr_mask: np.ndarray):
        """``live(t)``: the float32 liveness of each slot of an undirected
        neighbour table at t (the JAX package's function of that name): on
        a dense graph, the per-slot gather of the round's realized graph;
        on a matrix-free one, the slot round's liveness over the topology's
        own table, or the live pass over the caller's
        (``mask · edge_up[t][slots] · m[i] · m[nbr]``)."""
        if self._slots is not None:
            table = self.device_table(nbr_idx, nbr_mask)
            if table is self._nbr:
                return lambda t: self.realize(self._t(t)).live(table, None)
            return lambda t: self._slot_liveness(self._t(t), table)
        nbr = torch.as_tensor(np.asarray(nbr_idx), dtype=torch.int64, device=self.device)
        mask = torch.as_tensor(np.asarray(nbr_mask), dtype=torch.float32, device=self.device)
        return lambda t: self.realize(self._t(t)).live(nbr, mask)


def make_round_robin_mixing(topo: Topology, *, device="cuda") -> FaultyMixing:
    """The deterministic matching schedule (``parallel/matchings.py``) as
    per-round mixing: phase t mod P at round t."""
    from distributed_optimization_tpu_torch.parallel.matchings import round_robin_partners

    device = resolve_device(device)
    partners = torch.as_tensor(round_robin_partners(topo), dtype=torch.int64, device=device)
    return FaultyMixing(topo, device=device, partners=partners)


def _timeline_stack(topo: Topology, horizon: int, seeds, drops, **processes):
    """The timelines of R replicas (``_timeline_tensors`` a seed and drop
    probability: a launch pair each on a card), as one dict of ``[R, T,
    ...]`` device tensors and the stacked host ``FaultTimeline``."""
    tensors, hosts = [], []
    for seed, drop in zip(seeds, drops):
        out, edge_index = _timeline_tensors(topo, horizon, seed, edge_drop_prob=drop,
                                            **processes)
        tensors.append(out)
        hosts.append(FaultTimeline(
            horizon=horizon, directed=topo.directed, edge_index=edge_index,
            **{k: (v.cpu().numpy() if v is not None else None) for k, v in out.items()}))
    stacked = {k: (torch.stack([out[k] for out in tensors]) if tensors[0][k] is not None
                   else None) for k in tensors[0]}
    return stacked, stack_fault_timelines(hosts)


def make_faulty_mixing(
    topo: Topology,
    drop_prob,
    seed,
    straggler_prob: float = 0.0,
    one_peer: bool = False,
    burst_len: float = 0.0,
    mttf: float = 0.0,
    mttr: float = 0.0,
    rejoin: str = "frozen",
    horizon: Optional[int] = None,
    timeline: Optional[FaultTimeline] = None,
    participation_rate: float = 1.0,
    *,
    device="cuda",
    x64: bool = False,
) -> FaultyMixing:
    """Per-round mixing over the base topology, with the JAX package's
    validation and messages. Memoryless faults draw each round; bursty
    edges, churn and participation need ``horizon`` and unroll a timeline
    at set-up (bitwise the memoryless draws at burst_len=1 and at the
    iid-equivalent churn point). ``timeline`` injects a prebuilt one. A
    matrix-free topology takes the gather form, every process through the
    timeline (its edge chains on the per-edge stream), and refuses
    matchings and directed graphs.
    ``x64`` keys the streams as a float64 run does and realizes W_t in
    float64.

    The replica axis: ``seed`` a sequence of R seeds, and ``drop_prob`` a
    float or a sequence of R (a swept edge_drop_prob); replica r's rounds
    are the single run's with seed r and drop probability r, and an
    injected ``timeline`` is a stacked one."""
    replicated = isinstance(seed, (list, tuple))
    swept = isinstance(drop_prob, (list, tuple))
    if swept and not replicated:
        raise ValueError("a drop probability a replica needs a seed a replica")
    seeds = list(seed) if replicated else [seed]
    drops = [float(p) for p in drop_prob] if swept else [drop_prob] * len(seeds)
    if len(drops) != len(seeds) or not seeds:
        raise ValueError(f"{len(drops)} drop probabilities for {len(seeds)} seeds")
    for drop in drops:
        if not 0.0 <= drop < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got {drop}")
    if not 0.0 <= straggler_prob < 1.0:
        raise ValueError(
            f"straggler_prob must be in [0, 1), got {straggler_prob}"
        )
    if topo.directed and one_peer:
        raise ValueError(
            "one_peer gossip is a mutual-matching (undirected) schedule; "
            f"topology {topo.name!r} has one-way links, so a pairwise "
            "exchange cannot be realized"
        )
    if burst_len != 0.0 and burst_len < 1.0:
        raise ValueError(
            f"burst_len must be 0 (iid sampler) or >= 1, got {burst_len}"
        )
    if rejoin not in REJOIN_POLICIES:
        raise ValueError(
            f"Unknown rejoin policy: {rejoin!r}; known: {REJOIN_POLICIES}"
        )
    churn_active = mttf > 0.0 or mttr > 0.0
    if churn_active and one_peer:
        raise ValueError(
            "crash-recovery churn requires the synchronous schedule: rejoin "
            "policies act on the realized neighborhood, which a one-peer "
            "matching (at most one partner per round) cannot supply"
        )
    if not 0.0 < participation_rate <= 1.0:
        raise ValueError(
            f"participation_rate must be in (0, 1], got {participation_rate}"
        )
    participation_active = participation_rate < 1.0
    if participation_active and one_peer:
        raise ValueError(
            "participation sampling requires the synchronous schedule: the "
            "sampled subgraph reweights the whole realized neighborhood, "
            "which a one-peer matching cannot supply"
        )
    device = resolve_device(device)
    drop_active = swept or any(drop > 0.0 for drop in drops)
    use_timeline = (burst_len >= 1.0 or churn_active or participation_active
                    or timeline is not None
                    # The matrix-free form takes every process through the
                    # timeline: iid drops and stragglers are its burst_len=1
                    # chains, with no [N, N] draw anywhere.
                    or (topo.is_matrix_free and (straggler_prob > 0.0 or drop_active)))
    if use_timeline and timeline is None and horizon is None:
        raise ValueError(
            "persistent fault processes (burst_len >= 1, mttf/mttr, or "
            "participation_rate < 1) precompute a [horizon]-indexed "
            "timeline; pass horizon=n_iterations"
        )
    if topo.is_matrix_free and (one_peer or topo.directed):
        raise ValueError(
            "matrix-free topologies support synchronous fault "
            "processes only; matching schedules and directed graphs "
            "need the dense adjacency — use topology_impl='dense'"
        )
    if replicated:
        keys = replica_keys(seeds, x64, FAULT_TAG, NODE_TAG, MATCH_TAG, device=device)
        if swept:
            drop_prob = torch.tensor(drops, dtype=torch.float32, device=device)
    else:
        keys = _tag_keys(seed, x64, FAULT_TAG, NODE_TAG, MATCH_TAG)
    tensors = None
    if use_timeline:
        if timeline is None:
            processes = dict(
                burst_len=burst_len if burst_len >= 1.0 else 1.0,
                straggler_prob=0.0 if churn_active else straggler_prob,
                mttf=mttf, mttr=mttr, participation_rate=participation_rate,
                device=device, x64=x64)
            if replicated:
                tensors, timeline = _timeline_stack(topo, horizon, seeds, drops, **processes)
            else:
                tensors, edge_index = _timeline_tensors(
                    topo, horizon, seed, edge_drop_prob=drop_prob, **processes)
                timeline = FaultTimeline(
                    horizon=horizon, directed=topo.directed, edge_index=edge_index,
                    **{k: (v.cpu().numpy() if v is not None else None)
                       for k, v in tensors.items()})
        else:
            tensors = {k: (torch.as_tensor(getattr(timeline, k), device=device).contiguous()
                           if getattr(timeline, k) is not None else None)
                       for k in ("edge_up", "node_up", "rejoin", "part_up")}
    return FaultyMixing(
        topo, device=device, drop_prob=drop_prob, straggler_prob=straggler_prob,
        one_peer=one_peer, churn_active=churn_active,
        participation_active=participation_active, rejoin=rejoin, keys=keys,
        timeline_tensors=tensors, timeline=timeline,
        acc=torch.float64 if x64 else torch.float32,
    )
