"""The card's fault and noise draws: three hand-written CUDA kernels.

No Pallas kernel stands behind them: they are the counterparts of the XLA
code that ``jax.random`` compiles to in the JAX package's fault layer
(``distributed_optimization_tpu/parallel/faults.py``) and its large-noise
attack (``parallel/adversary.py``). A draw there is a Threefry stream at
``fold_in(tag key, t)``; the twin of ``jax.random`` in ``ops/prng.py``
spends about 350 elementwise launches on one such draw inside a captured
graph, so the card takes each as one kernel:

- ``realize_round``: one round's mixing operands at the device counter
  ``t``, the JAX package's ``mix(t, x)`` up to the product: the float32
  ``A_t [N, N]`` (the surviving edges, the node mask applied), ``active
  [N]``, ``W_t [N, N]`` in the run's accumulation dtype (Metropolis-Hastings
  on the realized degrees, or column-stochastic on a directed graph), the
  round's realized degree count added to the run's float64 total, and where
  asked the one-peer proposal scores ``u · A_t``; from the memoryless draws,
  or from a precomputed timeline's edge and node states at t (row
  ``timeline_row(t, T)``, JAX's index of a traced t). It walks the
  base graph's neighbour tables (``RoundTables``, built once on the host),
  so it draws only on base edges;
- ``realize_slot_round``: one round of the matrix-free fault form (the JAX
  package's ``_make_gather_faulty_mixing``) read from a timeline at ``t``,
  over the ``[N, k_max]`` neighbour table (``SlotTables``) with no
  ``[N, N]`` object: the float32 live slots, ``active``, the MH slot
  weights ``w`` and ``w_self`` in the run's accumulation dtype and the
  round's degree count; two launches (the liveness, each row's count and
  its live bits, then the weights, which need the neighbours' counts);
  ``slot_liveness``: the first launch alone over any caller's table (a
  mask where its real slots are not a prefix of each row), the JAX
  package's ``make_neighbor_liveness`` over that table;
- ``fault_timeline``: the per-edge Gilbert-Elliott chains, the
  crash-recovery node chains (with their rejoin rounds) and the
  participation stream over a horizon, as ``[T, E]`` / ``[T, N]`` bool;
  the edge chains on the dense form's stream (edge (i, j) at counter
  i·N + j) or on a matrix-free graph's per-edge stream (edge e at e).
  Each round of a chain is a map of its two states drawn on its own, so
  the card draws every (round, entity) at once and unrolls the chains as a
  scan over those maps: two launches, the draws (with each tile of rounds
  composed into a byte a chain of a workspace the wrapper allocates) and
  the scan. ``_chains_scan`` is that decomposition in torch ops, for the
  CPU tests;
- ``large_noise``: ``x + s·√2·erf_inv(u)`` on the Byzantine rows, ``u``
  ``jax.random.normal``'s uniform at the 64-bit counter i·d + j, an
  element a thread (the ``.cu`` header's "Design."); ``large_noise_rows_plain``
  draws chosen rows alone, for tests past the plain version's size.

Every counter is 64 bits wide, as ``jax.random``'s element counter is:
below 2³² its high word is 0. ``realize_round_rows_plain`` computes chosen
rows of a round alone, for tests at N past 65,535, where the plain
version's [N, N] arrays do not fit.

For CUDA tensors (``realize_round``, ``large_noise``) or a CUDA ``device``
(``fault_timeline``) each launches its kernel of ``csrc/draw_kernels.cu``
on the current stream, or raises; on the CPU it runs its plain version
(``*_plain``, in torch ops on ``ops/prng.py``), which the kernel matches
bit for bit on the card. ``t`` is the run's int64 counter of one element,
read from device memory, so a captured CUDA graph replays with the current
t. Keys are two host words each.

The replica axis (``torch_backend.run_batch``): ``realize_round`` also
takes R replicas' keys as an int64 ``[R, 3, 2]`` tensor on the card (the
fault, node and match keys of each), the drop threshold as a float32
``[R]`` tensor where it is swept, ``[R, T, ...]`` timeline states and an
``[R]`` degree total, and gives ``[R, ...]`` outputs in one launch;
``large_noise`` takes ``[R, 2]`` keys, ``[R, N]`` flags and ``[R, N, d]``
stacks in one launch. Replica r's outputs are the single launch's with
replica r's keys and threshold, bit for bit. Their plain versions call the
single plain version once a replica. The timeline has no replica axis: a
batch builds one a replica at set-up and stacks them.

The shared library is built at first use by ``ops/_cuda_build.py``.
``LAUNCHES`` maps each kernel to its launches on the card, which it counts
where it runs (``_cuda_build.LaunchCounts``); the plain versions count
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_optimization_tpu_torch.ops import _cuda_build, prng

SOURCE = _cuda_build.CSRC / "draw_kernels.cu"

# In the order of the kernels' launch-count slots (csrc/draw_kernels.cu).
KERNELS = ("realize_round", "fault_timeline", "large_noise", "realize_slot_round")
# The largest N: the neighbour tables hold int32 indices.
MAX_ROWS = 2**31 - 1
# Launches of one fault_timeline call on the card: the draws, then the scan.
TIMELINE_LAUNCHES = 2
# Launches of one realize_slot_round call: the liveness, then the weights.
SLOT_ROUND_LAUNCHES = 2

_ROUND_POINTERS = ("t", "in_nbr", "in_cnt", "in_eid", "out_nbr", "out_cnt", "out_eid",
                   "edge_up", "node_up", "part_up", "a", "active", "w", "scores",
                   "degree_total")


class _RoundArgs(ctypes.Structure):
    """``RoundArgs`` of csrc/draw_kernels.cu, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _ROUND_POINTERS]
                + [(name, ctypes.c_int64)
                   for name in ("n", "k_in", "k_out", "n_edges", "horizon")]
                + [("keys", ctypes.c_uint32 * 6), ("p", ctypes.c_float), ("q", ctypes.c_float)]
                + [(name, ctypes.c_int32) for name in ("drop", "strag", "directed")]
                + [("rkeys", ctypes.c_void_p), ("rp", ctypes.c_void_p),
                   ("replicas", ctypes.c_int64)])


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"realize_round_{suffix}")
        fn.argtypes = [ptr, ptr]
        fn.restype = ctypes.c_int
    lib.fault_timeline.argtypes = [ptr, i64, ptr, i64, i64, i64, ptr, i64, ptr, ptr, ptr, ptr,
                                   ptr, ptr]
    lib.fault_timeline.restype = ctypes.c_int
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"realize_slot_round_{suffix}")
        fn.argtypes = [ptr, ptr]
        fn.restype = ctypes.c_int
    lib.fault_timeline_tile.argtypes = []
    lib.fault_timeline_tile.restype = ctypes.c_int
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"large_noise_{suffix}")
        fn.argtypes = [ptr, ctypes.c_uint32, ctypes.c_uint32, ptr, ptr, ctypes.c_double, ptr,
                       i64, i64, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"large_noise_batch_{suffix}")
        fn.argtypes = [ptr, ptr, i64, ptr, ptr, ctypes.c_double, ptr, i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def _words(*keys) -> "ctypes.Array":
    flat = [w & 0xFFFFFFFF for k in keys for w in k]
    return (ctypes.c_uint32 * len(flat))(*flat)


def _check_counter(t, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.numel() != 1:
        raise TypeError("t must be an int64 tensor of one element")
    if t.device != device:
        raise ValueError(f"t lies on {t.device}, the draw's tensors on {device}")


def _raise(err: int, name: str) -> None:
    if err == _cuda_build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name} refuses its arguments")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _f32(v: float) -> float:
    """A threshold as the float32 the JAX package compares in."""
    return float(np.float32(v))


# --- one round -------------------------------------------------------------------


class RoundTables(NamedTuple):
    """A base graph's neighbour tables for ``realize_round``, on one device.

    ``in_nbr [N, k_in]`` int32: row i's base neighbours in ascending order
    (on a directed graph the senders j with ``adjacency[i, j] = 1``),
    padded with i; ``in_cnt [N]`` int32 the real slots. On a directed graph
    ``out_nbr``/``out_cnt`` list each node's receivers the same way (None
    on an undirected one). ``in_eid``/``out_eid``, the same shapes, give each
    slot's edge id in a timeline's edge list (None without one).
    """

    n: int
    directed: bool
    in_nbr: torch.Tensor
    in_cnt: torch.Tensor
    in_eid: Optional[torch.Tensor] = None
    out_nbr: Optional[torch.Tensor] = None
    out_cnt: Optional[torch.Tensor] = None
    out_eid: Optional[torch.Tensor] = None


class RoundTimeline(NamedTuple):
    """A precomputed timeline's states, bool ``[T, E]`` (edge_up, indexed
    by the tables' edge ids) and ``[T, N]`` (node_up, part_up), None for a
    process that is off; on the replica axis ``[R, T, ...]``, a timeline a
    replica."""

    edge_up: Optional[torch.Tensor] = None
    node_up: Optional[torch.Tensor] = None
    part_up: Optional[torch.Tensor] = None

    @property
    def horizon(self) -> int:
        """T, the rows of its states (0 with every process off)."""
        return next((x.shape[-2] for x in self if x is not None), 0)

    def replica(self, r: int) -> "RoundTimeline":
        """Replica r's timeline of a stacked one."""
        return RoundTimeline(*(x[r] if x is not None else None for x in self))


def timeline_row(t: torch.Tensor, horizon: int) -> torch.Tensor:
    """The row of a timeline of ``horizon`` rows at the counter ``t`` (int64,
    one element) as JAX indexes such an array with a traced t: t < 0 counts
    from the end, then the index is clamped into [0, T)."""
    return torch.where(t < 0, t + horizon, t).clamp(0, horizon - 1).reshape(1)


class Realized(NamedTuple):
    """One round: ``A [N, N]`` float32, ``active [N]`` float32, ``W [N, N]``
    in the asked dtype (or None) and the one-peer ``scores [N, N]`` float32
    (or None)."""

    A: torch.Tensor
    active: torch.Tensor
    W: Optional[torch.Tensor]
    scores: Optional[torch.Tensor]


def realize_round_plain(t, keys, tables: RoundTables, *, drop_prob: float,
                        straggler_prob: float, timeline: Optional[RoundTimeline] = None,
                        weights: Optional[torch.dtype] = None, scores: bool = False,
                        degree_total: Optional[torch.Tensor] = None) -> Realized:
    """The plain version of ``realize_round``, in torch ops on ``prng``:
    the same slots, draws and sums in the same order (W_t's diagonal adds
    the slots in ascending index order, a loop of k adds)."""
    fault_key, node_key, match_key = keys
    n, dev = tables.n, tables.in_nbr.device
    tt = t.reshape(())
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    edge_at = None
    if timeline is not None:
        row = timeline_row(t, timeline.horizon)
        up = torch.ones(n, dtype=torch.bool, device=dev)
        for states in (timeline.node_up, timeline.part_up):
            if states is not None:
                up = up & states.index_select(0, row)[0].bool()
        if timeline.edge_up is not None:
            edge_at = timeline.edge_up.index_select(0, row)[0].bool()
    elif straggler_prob > 0.0:
        up = prng.uniform_at(prng.fold_in(node_key, tt), nodes) >= _f32(straggler_prob)
    else:
        up = torch.ones(n, dtype=torch.bool, device=dev)
    draw = timeline is None and drop_prob > 0.0

    def links(i, j, eid):
        """The base link into i from j survives (i, j int64 [N, k])."""
        if edge_at is not None:
            return edge_at[eid.long()]
        if draw:
            lo, hi = (i, j) if tables.directed else (torch.minimum(i, j), torch.maximum(i, j))
            return prng.uniform_at(prng.fold_in(fault_key, tt), lo * n + hi) >= _f32(drop_prob)
        return torch.ones(i.shape, dtype=torch.bool, device=dev)

    def slots(nbr, cnt, eid, receivers_are_rows):
        """Each slot's liveness: the link survives and both ends are up."""
        other = nbr.long()
        rows = nodes[:, None].expand_as(other)
        valid = torch.arange(other.shape[1], device=dev)[None, :] < cnt[:, None]
        i, j = (rows, other) if receivers_are_rows else (other, rows)
        return valid & up[:, None] & up[other] & links(i, j, eid), other

    live, j = slots(tables.in_nbr, tables.in_cnt, tables.in_eid, True)
    A = torch.zeros((n, n), dtype=torch.float32, device=dev).scatter_(1, j, live.float())
    d = live.sum(dim=1)
    if degree_total is not None:
        degree_total.add_(d.sum().to(torch.float64))
    W = None
    if weights is not None:
        one = torch.ones((), dtype=weights, device=dev)
        if tables.directed:
            out_live, _ = slots(tables.out_nbr, tables.out_cnt, tables.out_eid, False)
            c = one / (one + out_live.sum(dim=1).to(weights))
            w_slot = torch.where(live, c[j], 0.0)
            terms = torch.where(out_live, c[:, None], 0.0)  # column i's weights
        else:
            deg = d.to(weights)
            w_slot = torch.where(live, one / (one + torch.maximum(deg[:, None], deg[j])), 0.0)
            terms = w_slot
        total = torch.zeros(n, dtype=weights, device=dev)
        for col in terms.unbind(1):
            total = total + col
        W = torch.zeros((n, n), dtype=weights, device=dev).scatter_(1, j, w_slot)
        W.diagonal().copy_(one - total)
    s = None
    if scores:
        u = prng.uniform_at(prng.fold_in(match_key, tt), nodes[:, None] * n + j)
        s = torch.zeros((n, n), dtype=torch.float32, device=dev).scatter_(
            1, j, torch.where(live, u, 0.0))
    return Realized(A, up.float(), W, s)


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def replica_count(keys) -> Optional[int]:
    """R for the replica axis's ``[R, 3, 2]`` key tensor, else None (three
    host keys)."""
    return keys.shape[0] if isinstance(keys, torch.Tensor) else None


def _check_replicas(keys, drop_prob, dev) -> Optional[int]:
    replicas = replica_count(keys)
    if replicas is None:
        if isinstance(drop_prob, torch.Tensor):
            raise TypeError("a drop threshold a replica needs the replica axis's keys")
        return None
    if (keys.dtype != torch.int64 or keys.shape[1:] != (3, 2) or not keys.is_contiguous()
            or keys.device != dev or not 1 <= replicas <= 65535):
        raise ValueError("the replica axis's keys must be a contiguous int64 [R, 3, 2] tensor "
                         f"(1 <= R <= 65,535) on {dev}")
    if isinstance(drop_prob, torch.Tensor) and (
            drop_prob.dtype != torch.float32 or drop_prob.shape != (replicas,)
            or drop_prob.device != dev or not drop_prob.is_contiguous()):
        raise ValueError(f"a drop threshold a replica must be a float32 [{replicas}] tensor "
                         f"on {dev}")
    return replicas


def _check_round(t, tables: RoundTables, timeline, weights, degree_total,
                 replicas: Optional[int] = None) -> None:
    dev = tables.in_nbr.device
    _check_counter(t, dev)
    n = tables.n
    if not 0 < n <= MAX_ROWS:
        raise ValueError(f"realize_round takes 0 < N <= {MAX_ROWS}, got {n}")
    for name in ("in_nbr", "in_cnt", "in_eid", "out_nbr", "out_cnt", "out_eid"):
        x = getattr(tables, name)
        if x is not None and (x.dtype != torch.int32 or x.device != dev
                              or not x.is_contiguous() or x.shape[0] != n):
            raise ValueError(f"tables.{name} must be a contiguous int32 tensor of N rows on {dev}")
    if tables.directed and tables.out_nbr is None:
        raise ValueError("a directed graph's tables need its out-lists")
    if weights not in (None, torch.float32, torch.float64):
        raise TypeError(f"weights must be None, float32 or float64, got {weights}")
    _check_total_and_states(degree_total, timeline, replicas, dev)
    if timeline is not None and timeline.edge_up is not None and (tables.in_eid is None or (
            tables.directed and tables.out_eid is None)):
        raise ValueError("a timeline's edges need the tables' edge ids")


def _check_total_and_states(degree_total, timeline, replicas: Optional[int], dev) -> None:
    """A round's degree total (float64, one element a replica) and timeline
    states (contiguous bool [T, M], or [R, T, M] on the replica axis, of one
    T) on ``dev``."""
    lead = () if replicas is None else (replicas,)
    if degree_total is not None and (degree_total.dtype != torch.float64
                                     or degree_total.numel() != (replicas or 1)
                                     or degree_total.device != dev
                                     or not degree_total.is_contiguous()):
        raise ValueError("degree_total must be a float64 tensor of one element (one a "
                         "replica) on the tables' device")
    if timeline is not None:
        for name, states in timeline._asdict().items():
            if states is not None and (states.dtype not in (torch.bool, torch.uint8)
                                       or states.dim() != 2 + len(lead)
                                       or states.shape[:len(lead)] != lead
                                       or not states.is_contiguous()
                                       or states.device != dev):
                raise ValueError(f"timeline.{name} must be a contiguous bool "
                                 f"{'[R, T, M]' if lead else '[T, M]'} tensor on {dev}")
        if len({x.shape[-2] for x in timeline if x is not None}) > 1:
            raise ValueError("the timeline's states must share their T rows")


def _replica_rounds(t, keys, tables, *, drop_prob, straggler_prob, timeline, weights, scores,
                    degree_total) -> Realized:
    """The replica axis's plain version: the single plain version once a
    replica, with its host keys and threshold, stacked."""
    rounds = []
    for r in range(keys.shape[0]):
        rounds.append(realize_round_plain(
            t, tuple(tuple(k) for k in keys[r].tolist()), tables,
            drop_prob=float(drop_prob[r]) if isinstance(drop_prob, torch.Tensor) else drop_prob,
            straggler_prob=straggler_prob,
            timeline=timeline.replica(r) if timeline is not None else None,
            weights=weights, scores=scores,
            degree_total=degree_total[r:r + 1] if degree_total is not None else None))
    return Realized(*(torch.stack(parts) if parts[0] is not None else None
                      for parts in zip(*rounds)))


def realize_round(t, keys, tables: RoundTables, *, drop_prob, straggler_prob: float,
                  timeline: Optional[RoundTimeline] = None,
                  weights: Optional[torch.dtype] = None, scores: bool = False,
                  degree_total: Optional[torch.Tensor] = None) -> Realized:
    """One round at the counter ``t`` over the base graph of ``tables``.
    ``keys``: the fault, node and match tag keys. Memoryless edge drops and
    stragglers draw at ``drop_prob``/``straggler_prob``; with ``timeline``
    the round reads its states at ``timeline_row(t, T)`` instead (a t at or
    past the horizon reads its last row). ``weights``: W_t's dtype, or
    None for no W_t. ``scores``: the one-peer proposal scores. The round's
    realized degree count is added to ``degree_total`` (float64, one
    element) where given. On the replica axis (``keys`` an int64 ``[R, 3,
    2]`` tensor; ``drop_prob`` a float or a float32 ``[R]`` tensor;
    ``[R, T, ...]`` timeline states; ``degree_total [R]``) every output
    gains a leading ``[R]``, in one launch."""
    dev = tables.in_nbr.device
    replicas = _check_replicas(keys, drop_prob, dev)
    _check_round(t, tables, timeline, weights, degree_total, replicas)
    per_replica = isinstance(drop_prob, torch.Tensor)
    if dev.type == "cpu":
        rounds = realize_round_plain if replicas is None else _replica_rounds
        return rounds(t, keys, tables, drop_prob=drop_prob, straggler_prob=straggler_prob,
                      timeline=timeline, weights=weights, scores=scores,
                      degree_total=degree_total)
    n = tables.n
    lead = () if replicas is None else (replicas,)
    A = torch.empty(lead + (n, n), dtype=torch.float32, device=dev)
    active = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    W = torch.empty(lead + (n, n), dtype=weights, device=dev) if weights is not None else None
    s = torch.empty(lead + (n, n), dtype=torch.float32, device=dev) if scores else None
    tl = timeline if timeline is not None else RoundTimeline()
    drop = per_replica or drop_prob > 0.0
    args = _RoundArgs(
        t.data_ptr(), tables.in_nbr.data_ptr(), tables.in_cnt.data_ptr(), _ptr(tables.in_eid),
        _ptr(tables.out_nbr), _ptr(tables.out_cnt), _ptr(tables.out_eid), _ptr(tl.edge_up),
        _ptr(tl.node_up), _ptr(tl.part_up), A.data_ptr(), active.data_ptr(), _ptr(W), _ptr(s),
        _ptr(degree_total), n, tables.in_nbr.shape[1],
        tables.out_nbr.shape[1] if tables.out_nbr is not None else 0,
        tl.edge_up.shape[-1] if tl.edge_up is not None else 0, tl.horizon,
        _words(*keys) if replicas is None else _words((0, 0), (0, 0), (0, 0)),
        0.0 if per_replica else _f32(drop_prob), _f32(straggler_prob),
        int(timeline is None and drop), int(timeline is None and straggler_prob > 0.0),
        int(tables.directed), _ptr(keys) if replicas is not None else None,
        _ptr(drop_prob) if per_replica else None, replicas or 1)
    fn = getattr(_library(), "realize_round_" + ("f64" if weights == torch.float64 else "f32"))
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, "realize_round")
    return Realized(A, active, W, s)


def realize_round_rows_plain(t, keys, tables: RoundTables, rows, *, drop_prob: float,
                             straggler_prob: float, weights: torch.dtype = torch.float32):
    """Rows ``rows`` of ``realize_round_plain``'s A_t and W_t and their
    active flags, computed alone on an undirected graph's memoryless draws:
    each row's live slots and its neighbours' counts from their own slots,
    with the same draws, weights and sums (the diagonal's slots added in
    ascending order). For tests at N past the plain version's size."""
    if tables.directed:
        raise ValueError("realize_round_rows_plain takes an undirected graph's tables")
    fault_key, node_key, _ = keys
    n, dev = tables.n, tables.in_nbr.device
    tt = t.reshape(())
    k = tables.in_nbr.shape[1]
    slot = torch.arange(k, device=dev)

    def up(nodes):
        if straggler_prob > 0.0:
            return prng.uniform_at(prng.fold_in(node_key, tt), nodes) >= _f32(straggler_prob)
        return torch.ones(nodes.shape, dtype=torch.bool, device=dev)

    def live_of(i):
        """[r, k] liveness of the slots of rows i (int64 [r]) and the slots'
        neighbours."""
        j = tables.in_nbr.index_select(0, i).long()
        ok = slot[None, :] < tables.in_cnt.index_select(0, i)[:, None]
        ok = ok & up(i)[:, None] & up(j)
        if drop_prob > 0.0:
            ii = i[:, None].expand_as(j)
            lo, hi = torch.minimum(ii, j), torch.maximum(ii, j)
            u = prng.uniform_at(prng.fold_in(fault_key, tt), lo * n + hi)
            ok = ok & (u >= _f32(drop_prob))
        return ok, j

    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    live, j = live_of(rows)
    d = live.sum(dim=1)
    live_j, _ = live_of(j.reshape(-1))
    d_j = live_j.sum(dim=1).reshape(j.shape)
    one = torch.ones((), dtype=weights, device=dev)
    pair = torch.maximum(d[:, None], d_j).to(weights)
    w_slot = torch.where(live, one / (one + pair), 0.0)
    total = torch.zeros(len(rows), dtype=weights, device=dev)
    for col in w_slot.unbind(1):
        total = total + col
    A = torch.zeros((len(rows), n), dtype=torch.float32, device=dev).scatter_(1, j, live.float())
    W = torch.zeros((len(rows), n), dtype=weights, device=dev).scatter_(1, j, w_slot)
    W.scatter_(1, rows[:, None], (one - total)[:, None])
    return A, W, up(rows).float()


# --- one round of the matrix-free fault form ---------------------------------------


class SlotTables(NamedTuple):
    """A neighbour table for ``realize_slot_round`` and ``slot_liveness``, on
    one device: ``nbr [N, k]`` int32 (row i's neighbours, padded with i),
    ``cnt [N]`` int32 its real slots (the first cnt[i]) and, with a
    timeline's edges, ``eid [N, k]`` int32 each slot's edge id (−1 on
    padded slots). ``mask`` (float32 ``[N, k]``, or None): a caller's slot
    mask where its real slots are not the first cnt[i] of each row, or are
    weighed by other values than 0 and 1; ``slot_liveness`` alone takes
    it."""

    n: int
    nbr: torch.Tensor
    cnt: torch.Tensor
    eid: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


class SlotRound(NamedTuple):
    """One round over the table: ``live [N, k]`` float32, ``w [N, k]`` and
    ``w_self [N]`` in the asked dtype, ``active [N]`` float32; each with a
    leading ``[R]`` on the replica axis."""

    live: torch.Tensor
    w: torch.Tensor
    w_self: torch.Tensor
    active: torch.Tensor


def _slot_states(t, tables: SlotTables, timeline: Optional[RoundTimeline]):
    """(the nodes that are up [N], each slot's liveness [N, k] bool) at
    ``timeline_row(t, T)``: a slot is live iff it is real, both ends are up
    and its edge is up."""
    n, dev = tables.n, tables.nbr.device
    k = tables.nbr.shape[1]
    up = torch.ones(n, dtype=torch.bool, device=dev)
    edge_at = None
    if timeline is not None and timeline.horizon:
        row = timeline_row(t, timeline.horizon)
        for states in (timeline.node_up, timeline.part_up):
            if states is not None:
                up = up & states.index_select(0, row)[0].bool()
        if timeline.edge_up is not None:
            edge_at = timeline.edge_up.index_select(0, row)[0].bool()
    nbr = tables.nbr.long()
    if tables.mask is not None:
        live = tables.mask != 0
    else:
        live = torch.arange(k, device=dev)[None, :] < tables.cnt[:, None]
    live = live & up[:, None] & up[nbr]
    if edge_at is not None:
        live = live & edge_at[tables.eid.long().clamp(min=0)]
    return up, live


def slot_liveness_plain(t, tables: SlotTables,
                        timeline: Optional[RoundTimeline] = None) -> torch.Tensor:
    """The plain version of ``slot_liveness``: float32 ``[N, k]``, the
    caller's mask times each slot's liveness (0 or 1), or the liveness
    where the table has no mask."""
    _, live = _slot_states(t, tables, timeline)
    return live.float() if tables.mask is None else tables.mask * live.float()


def realize_slot_round_plain(t, tables: SlotTables, timeline: Optional[RoundTimeline] = None, *,
                             weights: torch.dtype = torch.float32,
                             degree_total: Optional[torch.Tensor] = None) -> SlotRound:
    """The plain version of ``realize_slot_round``, in torch ops: the same
    slots and weights, w_self adding the slots in ascending order (a loop
    of k adds)."""
    up, live = _slot_states(t, tables, timeline)
    d = live.sum(dim=1)
    if degree_total is not None:
        degree_total.add_(d.sum().to(torch.float64))
    deg = d.to(weights)
    one = torch.ones((), dtype=weights, device=tables.nbr.device)
    w = torch.where(live, one / (one + torch.maximum(deg[:, None], deg[tables.nbr.long()])), 0.0)
    total = torch.zeros(tables.n, dtype=weights, device=tables.nbr.device)
    for col in w.unbind(1):
        total = total + col
    return SlotRound(live.float(), w, one - total, up.float())


def _check_slot_round(t, tables: SlotTables, timeline, weights, degree_total,
                      replicas: Optional[int]) -> None:
    dev = tables.nbr.device
    _check_counter(t, dev)
    n = tables.n
    if not 0 < n <= MAX_ROWS:
        raise ValueError(f"realize_slot_round takes 0 < N <= {MAX_ROWS}, got {n}")
    for name in ("nbr", "cnt", "eid"):
        x = getattr(tables, name)
        if x is not None and (x.dtype != torch.int32 or x.device != dev
                              or not x.is_contiguous() or x.shape[0] != n):
            raise ValueError(f"tables.{name} must be a contiguous int32 tensor of N rows on {dev}")
    if tables.nbr.dim() != 2 or tables.nbr.shape[1] < 1:
        raise ValueError("tables.nbr must be [N, k] with k >= 1")
    if tables.mask is not None and (tables.mask.dtype != torch.float32
                                    or tables.mask.shape != tables.nbr.shape
                                    or tables.mask.device != dev
                                    or not tables.mask.is_contiguous()):
        raise ValueError(f"tables.mask must be a contiguous float32 [N, k] tensor on {dev}")
    if weights not in (torch.float32, torch.float64):
        raise TypeError(f"weights must be float32 or float64, got {weights}")
    if replicas is not None and not 1 <= replicas <= 65535:
        raise ValueError(f"the replica axis takes 1 <= R <= 65,535, got {replicas}")
    _check_total_and_states(degree_total, timeline, replicas, dev)
    if timeline is not None and timeline.edge_up is not None and tables.eid is None:
        raise ValueError("a timeline's edges need the tables' edge ids")


class _SlotArgs(ctypes.Structure):
    """``SlotArgs`` of csrc/draw_kernels.cu, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "t", "nbr", "cnt", "eid", "mask", "edge_up", "node_up", "part_up", "live", "w",
        "w_self", "active", "deg", "bits", "degree_total")]
        + [(name, ctypes.c_int64) for name in ("n", "k", "n_edges", "horizon", "replicas")]
        + [("passes", ctypes.c_int32)])


# SlotArgs.passes: the live pass (live, active, each row's count and live
# bits, the degree count), the weight pass (w and w_self), or both.
LIVE_PASS, WEIGHT_PASS = 1, 2


def _slot_launch(t, tables: SlotTables, timeline, weights, degree_total, replicas, passes):
    """The card's slot-round outputs and workspace, and ``launch(passes)``,
    which launches the asked passes over them on the current stream."""
    dev = tables.nbr.device
    n, k = tables.n, tables.nbr.shape[1]
    lead = () if replicas is None else (replicas,)
    live = torch.empty(lead + (n, k), dtype=torch.float32, device=dev)
    active = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    deg = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    bits = torch.empty(lead + (n, (k + 31) // 32), dtype=torch.int32, device=dev)
    w = w_self = None
    if passes & WEIGHT_PASS:
        w = torch.empty(lead + (n, k), dtype=weights, device=dev)
        w_self = torch.empty(lead + (n,), dtype=weights, device=dev)
    tl = timeline if timeline is not None else RoundTimeline()
    fn = getattr(_library(), "realize_slot_round_" + ("f64" if weights == torch.float64
                                                      else "f32"))

    def launch(which: int) -> None:
        # The pointers are taken here, so the closure holds every buffer.
        args = _SlotArgs(
            t.data_ptr(), tables.nbr.data_ptr(), tables.cnt.data_ptr(), _ptr(tables.eid),
            _ptr(tables.mask), _ptr(tl.edge_up), _ptr(tl.node_up), _ptr(tl.part_up),
            live.data_ptr(), _ptr(w), _ptr(w_self), active.data_ptr(), deg.data_ptr(),
            bits.data_ptr(), _ptr(degree_total), n, k,
            tl.edge_up.shape[-1] if tl.edge_up is not None else 0, tl.horizon, replicas or 1,
            which)
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
        _raise(err, "realize_slot_round")

    return SlotRound(live, w, w_self, active), launch


def realize_slot_round(t, tables: SlotTables, timeline: Optional[RoundTimeline] = None, *,
                       weights: torch.dtype = torch.float32,
                       degree_total: Optional[torch.Tensor] = None,
                       replicas: Optional[int] = None) -> SlotRound:
    """One round of the matrix-free fault form at the counter ``t`` over the
    table of ``tables``, its states read from ``timeline`` at
    ``timeline_row(t, T)`` (every node and slot up without one): a slot is
    live iff it is real, both ends are up and its edge is up; ``w`` =
    live / (1 + max(d_i, d_nbr)), d the live-slot counts, and ``w_self`` = 1
    − Σ_s w, in ``weights``; the round's degree count is added to
    ``degree_total`` (float64) where given. On the replica axis
    (``replicas`` R; ``[R, T, ...]`` timeline states; ``degree_total [R]``)
    every output gains a leading ``[R]``, in one launch pair. On the card
    two launches (``SLOT_ROUND_LAUNCHES``: the live pass, then the weight
    pass)."""
    _check_slot_round(t, tables, timeline, weights, degree_total, replicas)
    if tables.mask is not None:
        raise ValueError("realize_slot_round takes a table whose real slots come first in "
                         "each row (no mask); slot_liveness takes a caller's mask")
    if tables.nbr.device.type == "cpu":
        if replicas is None:
            return realize_slot_round_plain(t, tables, timeline, weights=weights,
                                            degree_total=degree_total)
        rounds = [realize_slot_round_plain(
            t, tables, timeline.replica(r) if timeline is not None else None, weights=weights,
            degree_total=degree_total[r:r + 1] if degree_total is not None else None)
            for r in range(replicas)]
        return SlotRound(*(torch.stack(parts) for parts in zip(*rounds)))
    out, launch = _slot_launch(t, tables, timeline, weights, degree_total, replicas,
                               LIVE_PASS | WEIGHT_PASS)
    launch(LIVE_PASS | WEIGHT_PASS)
    return out


def slot_liveness(t, tables: SlotTables, timeline: Optional[RoundTimeline] = None, *,
                  replicas: Optional[int] = None) -> torch.Tensor:
    """The float32 liveness ``[N, k]`` (``[R, N, k]`` on the replica axis) of
    each slot of any caller's table at ``t``: its mask (1 on the first
    cnt[i] slots without one) times [both ends up and the slot's edge up],
    the JAX package's ``mask · edge_up[t][slots] · m[i] · m[nbr]``. On the
    card one launch, the slot round's live pass."""
    _check_slot_round(t, tables, timeline, torch.float32, None, replicas)
    if tables.nbr.device.type == "cpu":
        if replicas is None:
            return slot_liveness_plain(t, tables, timeline)
        return torch.stack([slot_liveness_plain(t, tables, timeline.replica(r)
                                                if timeline is not None else None)
                            for r in range(replicas)])
    out, launch = _slot_launch(t, tables, timeline, torch.float32, None, replicas, LIVE_PASS)
    launch(LIVE_PASS)
    return out.live


def slot_round_passes(t, tables: SlotTables, timeline: Optional[RoundTimeline] = None, *,
                      weights: torch.dtype = torch.float32,
                      degree_total: Optional[torch.Tensor] = None):
    """For measuring the two passes apart on the card: ``(out, live_pass,
    weight_pass)``, the round's outputs and two zero-argument calls that
    launch one pass each over them (the weight pass reads the counts and
    bits the live pass last wrote). Launching both in turn is one
    ``realize_slot_round``."""
    _check_slot_round(t, tables, timeline, weights, degree_total, None)
    if tables.nbr.device.type != "cpu" and tables.mask is None:
        out, launch = _slot_launch(t, tables, timeline, weights, degree_total, None,
                                   LIVE_PASS | WEIGHT_PASS)
        return out, (lambda: launch(LIVE_PASS)), (lambda: launch(WEIGHT_PASS))
    raise ValueError("slot_round_passes takes a maskless table on a card")


# --- the timeline ------------------------------------------------------------------


def _chains_plain(u: torch.Tensor, init: float, enter: float, stay: float):
    """Unroll two-state chains over the draws u [T, M]: up iff u >= the
    threshold (init at t = 0, then enter after up, stay after down)."""
    ups = torch.empty(u.shape, dtype=torch.bool, device=u.device)
    up = torch.ones(u.shape[1], dtype=torch.bool, device=u.device)
    th_init, th_enter, th_stay = (torch.tensor(v, dtype=torch.float32, device=u.device)
                                  for v in (init, enter, stay))
    for s in range(u.shape[0]):
        thresh = th_init if s == 0 else torch.where(up, th_enter, th_stay)
        up = u[s] >= thresh
        ups[s] = up
    return ups


# A chain's round as a map of its states {down = 0, up = 1} to themselves:
# bit 0 the image of down, bit 1 the image of up (csrc/draw_kernels.cu).
_IDENTITY = 2


def _then(f: torch.Tensor, g) -> torch.Tensor:
    """The map f, then g (uint8 maps, broadcast)."""
    return ((g >> (f & 1)) & 1) | (((g >> (f >> 1)) & 1) << 1)


def _apply(f: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The state after the map f from ``state`` (uint8 0 or 1)."""
    return (f >> state) & 1


def _chains_scan(u: torch.Tensor, init: float, enter: float, stay: float, tile: int):
    """``_chains_plain`` as ``fault_timeline``'s kernels compute it, in torch
    ops: each round's map of the states (at t = 0 both images u >= init,
    then up -> u >= enter and down -> u >= stay), each tile of ``tile``
    rounds composed into its summary, the maps entering each tile by a scan
    over the summaries, and the apply pass over each tile's rounds from the
    state its carry gives up. For the CPU tests; no run takes it."""
    T, M = u.shape
    th = {k: torch.tensor(v, dtype=torch.float32, device=u.device)
          for k, v in (("init", init), ("enter", enter), ("stay", stay))}
    first = torch.arange(T, device=u.device)[:, None] == 0
    up = torch.where(first, u >= th["init"], u >= th["enter"]).to(torch.uint8)
    down = torch.where(first, u >= th["init"], u >= th["stay"]).to(torch.uint8)
    tiles = -(-T // tile)
    maps = torch.full((tiles * tile, M), _IDENTITY, dtype=torch.uint8, device=u.device)
    maps[:T] = down | (up << 1)
    maps = maps.reshape(tiles, tile, M)
    summary = torch.full((tiles, M), _IDENTITY, dtype=torch.uint8, device=u.device)
    for j in range(tile):
        summary = _then(summary, maps[:, j])
    entering = torch.empty_like(summary)
    carry = torch.full((M,), _IDENTITY, dtype=torch.uint8, device=u.device)
    for k in range(tiles):
        entering[k] = carry
        carry = _then(carry, summary[k])
    state = _apply(entering, torch.ones_like(entering))  # every chain is up before t = 0
    ups = torch.empty((tiles, tile, M), dtype=torch.uint8, device=u.device)
    for j in range(tile):
        state = _apply(maps[:, j], state)
        ups[:, j] = state
    return ups.reshape(tiles * tile, M)[:T].bool()


def _edge_counters(n: int, edges: Optional[torch.Tensor], n_edges: Optional[int], device):
    """Each edge's counter: i·N + j of its [E, 2] pair, or e on the per-edge
    stream (``edges`` None, ``n_edges`` E); None without edges."""
    if edges is not None:
        return edges[:, 0].to(torch.int64) * n + edges[:, 1].to(torch.int64)
    if n_edges:
        return torch.arange(n_edges, dtype=torch.int64, device=device)
    return None


def fault_timeline_plain(keys, n: int, edges: Optional[torch.Tensor], horizon: int,
                         edge_chain=None, node_chain=None, p_out=None, *, device,
                         n_edges: Optional[int] = None, tile: Optional[int] = None):
    """The plain version of ``fault_timeline``; with ``tile``, its chains
    unrolled by the kernels' decomposition over tiles of that many rounds
    (``_chains_scan``) instead of round by round."""
    fault_key, node_key, part_key = keys
    chains = _chains_plain if tile is None else functools.partial(_chains_scan, tile=tile)
    ts = torch.arange(horizon, dtype=torch.int64, device=device)
    nodes = torch.arange(n, dtype=torch.int64, device=device)
    out = {"edge_up": None, "node_up": None, "rejoin": None, "part_up": None}
    counters = _edge_counters(n, edges, n_edges, device)
    if counters is not None:
        u = prng.uniform_at(prng.fold_in(fault_key, ts), counters)
        out["edge_up"] = chains(u, *edge_chain)
    if node_chain is not None:
        u = prng.uniform_at(prng.fold_in(node_key, ts), nodes)
        node_up = chains(u, *node_chain)
        prev = torch.cat([torch.ones_like(node_up[:1]), node_up[:-1]])
        out["node_up"], out["rejoin"] = node_up, node_up & ~prev
    if p_out is not None:
        u = prng.uniform_at(prng.fold_in(part_key, ts), nodes)
        out["part_up"] = u >= torch.tensor(p_out, dtype=torch.float32, device=device)
    return out


def timeline_thresholds(edge_chain, node_chain, p_out) -> "ctypes.Array":
    """The kernel's seven float32 thresholds: the edge chain's (init, enter,
    stay), the node chain's, p_out; 0 for a process that is off."""
    values = [*(edge_chain or (0.0,) * 3), *(node_chain or (0.0,) * 3),
              p_out if p_out is not None else 0.0]
    return (ctypes.c_float * 7)(*(_f32(v) for v in values))


def fault_timeline(keys, n: int, edges: Optional[torch.Tensor], horizon: int,
                   edge_chain=None, node_chain=None, p_out=None, *, device,
                   n_edges: Optional[int] = None):
    """The fault timeline over t = 0 … horizon−1 as bool tensors on
    ``device``: ``edge_up [T, E]``, ``node_up``, ``rejoin``, ``part_up`` [T,
    N], None for a process that is off. ``keys``: the fault, node and
    participation tag keys. ``edges``: the [E, 2] int32 edge list (counter
    i·N + j), or None with ``n_edges`` E for a matrix-free graph's per-edge
    stream (edge e at counter e, the JAX package's ``(E,)`` draw a round);
    ``edge_chain`` their float32 (init, enter, stay) thresholds;
    ``node_chain`` the node chain's; ``p_out`` the participation
    threshold."""
    device = torch.device(device)
    if edges is not None:
        if edges.dtype != torch.int32 or edges.dim() != 2 or edges.shape[1] != 2:
            raise ValueError("edges must be an int32 [E, 2] tensor")
        if n_edges is not None and n_edges != edges.shape[0]:
            raise ValueError(f"n_edges={n_edges} for an edge list of {edges.shape[0]} rows")
        edges = edges.to(device).contiguous()
        n_edges = edges.shape[0]
    if n_edges is not None and not 0 <= n_edges <= MAX_ROWS:
        raise ValueError(f"fault_timeline takes 0 <= E <= {MAX_ROWS}, got {n_edges}")
    if (n_edges or 0) > 0 and edge_chain is None:
        raise ValueError("edges need their chain's thresholds (edge_chain)")
    if device.type == "cpu":
        return fault_timeline_plain(keys, n, edges, horizon, edge_chain, node_chain, p_out,
                                    device=device, n_edges=n_edges)
    if horizon <= 0 or not 0 < n <= MAX_ROWS:
        raise ValueError(f"fault_timeline takes 0 < N <= {MAX_ROWS} and a positive horizon")
    n_edges = n_edges or 0
    n_nodes = 0 if node_chain is None else n
    n_part = 0 if p_out is None else n

    def buf(m):
        return torch.empty((horizon, max(m, 1)), dtype=torch.bool, device=device)

    edge_up, node_up, rejoin, part_up = buf(n_edges), buf(n_nodes), buf(n_nodes), buf(n_part)
    lib = _library()
    tiles = -(-horizon // lib.fault_timeline_tile())
    carry = torch.empty(max(tiles * (n_edges + n_nodes), 1), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fault_timeline(
            _words(*keys), n, edges.data_ptr() if edges is not None else None, n_edges,
            n_nodes, n_part, timeline_thresholds(edge_chain, node_chain, p_out), horizon,
            edge_up.data_ptr(), node_up.data_ptr(), rejoin.data_ptr(), part_up.data_ptr(),
            carry.data_ptr(), stream)
    _raise(err, "fault_timeline")
    return {"edge_up": edge_up if n_edges else None,
            "node_up": node_up if n_nodes else None,
            "rejoin": rejoin if n_nodes else None,
            "part_up": part_up if n_part else None}


# --- the large-noise payload -------------------------------------------------------------


def large_noise_plain(key, t, byzantine: torch.Tensor, x: torch.Tensor, scale: float):
    """The plain version of ``large_noise``: ``prng.normal`` at
    ``fold_in(key, t)`` and ``torch.where``."""
    z = prng.normal(prng.fold_in(key, t.reshape(())), x.shape, x.dtype)
    s = torch.tensor(scale, dtype=x.dtype, device=x.device)
    return torch.where(byzantine.bool()[:, None], x + s * z, x)


def large_noise_rows_plain(key, t, rows, x_rows: torch.Tensor, d: int, scale: float):
    """Rows ``rows`` of ``large_noise_plain`` for Byzantine rows, drawn
    alone: ``x_rows`` (those rows of x, [len(rows), d]) plus ``scale`` times
    the normal at the 64-bit counters i·d + j of each row i, without the rest
    of the stack. For tests of stacks too large for the plain version."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=x_rows.device)
    counters = rows[:, None] * d + torch.arange(d, dtype=torch.int64, device=x_rows.device)
    z = prng.normal_at(prng.fold_in(key, t.reshape(()).to(x_rows.device)), counters, x_rows.dtype)
    return x_rows + torch.tensor(scale, dtype=x_rows.dtype, device=x_rows.device) * z


def large_noise(key, t, byzantine: torch.Tensor, x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` with its Byzantine rows (``byzantine``: uint8 [N]) replaced by
    ``x + scale · normal(fold_in(key, t), x.shape)``, in x's dtype. On the
    replica axis, ``key`` an int64 ``[R, 2]`` tensor of tag keys on x's
    device, ``byzantine [R, N]`` and ``x [R, N, d]``: each replica's stack
    under its own key and flags, in one launch."""
    batched = isinstance(key, torch.Tensor)
    # The stack's [N, d] checks, on replica 0's rows on the replica axis.
    _cuda_build.check_stack(x[0] if batched and x.dim() == 3 else x)
    if batched and (x.dim() != 3 or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous [R, N, d] stack, got {tuple(x.shape)}")
    _check_counter(t, x.device)
    lead = x.shape[:-1]  # (N,), or (R, N) on the replica axis
    if batched and (key.dtype != torch.int64 or key.shape != (lead[0], 2)
                    or key.device != x.device or not key.is_contiguous()
                    or not 1 <= lead[0] <= 65535):
        raise ValueError(f"keys must be a contiguous int64 [{lead[0]}, 2] tensor on x's device "
                         "(1 <= R <= 65,535)")
    if byzantine.dtype != torch.uint8 or byzantine.shape != lead \
            or byzantine.device != x.device or not byzantine.is_contiguous():
        raise ValueError(f"byzantine must be a contiguous uint8 {list(lead)} mask on x's device")
    if x.device.type == "cpu":
        if not batched:
            return large_noise_plain(key, t, byzantine, x, scale)
        # The single plain version once a replica.
        return torch.stack([large_noise_plain(tuple(key[r].tolist()), t, byzantine[r], x[r],
                                              scale) for r in range(lead[0])])
    out = torch.empty_like(x)
    if batched:
        _cuda_build.call(_library(), "large_noise_batch", x, t.data_ptr(), key.data_ptr(),
                         lead[0], byzantine.data_ptr(), x.data_ptr(), float(scale),
                         out.data_ptr(), *lead[1:], x.shape[-1])
    else:
        _cuda_build.call(_library(), "large_noise", x, t.data_ptr(), key[0] & 0xFFFFFFFF,
                         key[1] & 0xFFFFFFFF, byzantine.data_ptr(), x.data_ptr(), float(scale),
                         out.data_ptr(), *x.shape)
    return out
