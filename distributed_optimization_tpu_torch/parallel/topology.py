"""Communication graphs and their mixing matrices.

The port's copy of ``distributed_optimization_tpu/parallel/topology.py``,
host-side numpy, in its two representations:

- **dense** (``build_topology(..., impl='dense')``): ``adjacency[i, j] = 1``
  iff j sends to i. Undirected graphs (ring, periodic grid, fully
  connected, Erdős–Rényi, chain, star) carry MH weights ``W_ij = 1 / (1 +
  max(deg_i, deg_j))`` on edges and the remainder on the diagonal; directed
  graphs (directed ring, directed Erdős–Rényi) carry the column-stochastic
  uniform-out weights of push-sum;
- **matrix-free** (``impl='neighbor'``, ``build_neighbor_topology``): ring,
  grid, chain and Erdős–Rényi as the padded ``[N, k_max]`` neighbour table
  alone (``nbr_idx``, ``nbr_mask``; ``adjacency`` and ``mixing_matrix``
  None), the table ``neighbor_table`` derives from the dense adjacency bit
  for bit. Its spectral gap is the ring's or torus's closed form, else
  power iteration on the gather-form operator.

The random graphs draw from ``np.random.default_rng(seed)`` exactly as the
JAX package's builders do, so the same (n, p, seed) gives the same graph
bit for bit in both representations. Erdős–Rényi also has the sparse
sampler (``sampler='sparse'``, O(N·k_max) draws): the same G(n, p) law, a
different realization, the JAX package's for N past 65,536. Also here: the
padded neighbour table the gather forms read, its MH weights a slot, and
each slot's edge id (``incident_edge_slots``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from distributed_optimization_tpu_torch.config import NEIGHBOR_TOPOLOGIES

# The power iteration's budget for a matrix-free spectral gap.
_POWER_ITERS = 500


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    n: int
    # [N, N] 0/1, zero diagonal; row i = i's in-edges. None when matrix-free.
    adjacency: Optional[np.ndarray]
    # Out-degrees (column sums), which equal the degrees of an undirected
    # graph: how many neighbours each node sends to a round.
    degrees: np.ndarray  # [N]
    # [N, N]: MH (doubly stochastic) or, when directed, column-stochastic.
    # None when matrix-free.
    mixing_matrix: Optional[np.ndarray]
    grid_shape: Optional[tuple[int, int]] = None  # (rows, cols), set for 'grid'
    directed: bool = False
    # The matrix-free neighbour table (None on the dense representation):
    # row i's neighbours ascending, padded slots pointing at i, mask False.
    nbr_idx: Optional[np.ndarray] = None   # [N, k_max] int32
    nbr_mask: Optional[np.ndarray] = None  # [N, k_max] bool
    # The Erdős–Rényi sampler that drew the table: 'dense' (the [N, N]
    # stream's graph) or 'sparse'; 'dense' for every other graph.
    sampler: str = "dense"

    @property
    def is_matrix_free(self) -> bool:
        return self.adjacency is None

    @property
    def spectral_gap(self) -> float:
        """1 − ρ, ρ the second-largest |eigenvalue| of W (its modulus for a
        directed graph, whose W is not symmetric); the closed form on a
        square torus of side >= 3 (0.2764 at side 5). A matrix-free graph
        never builds W: the ring's and torus's closed forms, else power
        iteration on the gather-form operator (``_power_iteration_gap``)."""
        if self.n < 2:
            return 1.0
        if self.is_matrix_free:
            if self.name == "ring" and self.n >= 3:
                return ring_spectral_gap_closed_form(self.n)
            if (self.name == "grid" and self.grid_shape is not None
                    and self.grid_shape[0] == self.grid_shape[1]
                    and min(self.grid_shape) >= 3):
                return torus_spectral_gap_closed_form(self.grid_shape[0])
            return self._power_iteration_gap()
        if (self.grid_shape is not None and self.grid_shape[0] == self.grid_shape[1]
                and min(self.grid_shape) >= 3):
            return torus_spectral_gap_closed_form(self.grid_shape[0])
        if self.directed:
            eigs = np.sort(np.abs(np.linalg.eigvals(self.mixing_matrix)))
        else:
            eigs = np.sort(np.abs(np.linalg.eigvalsh(self.mixing_matrix)))
        return float(1.0 - eigs[-2])

    def _power_iteration_gap(self) -> float:
        """ρ ≈ ‖B v‖ for the normalised iterate v of B = W − (1/n)𝟙𝟙ᵀ, from
        ``default_rng(0)``'s normal start vector, ``_POWER_ITERS`` steps: the
        JAX package's estimate, with W v as a sparse product of the
        gather-form weights (the slots added in another order: the estimate
        agrees to rounding)."""
        import scipy.sparse

        w_nbr, w_self = gather_mixing_weights(self.nbr_idx, self.nbr_mask, self.degrees)
        n, k = self.nbr_idx.shape
        cols = np.concatenate([np.arange(n)[:, None], self.nbr_idx], axis=1).reshape(-1)
        vals = np.concatenate([w_self[:, None], w_nbr], axis=1).reshape(-1)
        W = scipy.sparse.csr_matrix((vals, (np.repeat(np.arange(n), k + 1), cols)),
                                    shape=(n, n))
        v = np.random.default_rng(0).standard_normal(self.n)
        v -= v.mean()
        v /= np.linalg.norm(v)
        rho = 0.0
        for _ in range(_POWER_ITERS):
            v = W @ v
            v -= v.mean()
            rho = np.linalg.norm(v)
            if rho < 1e-300:  # W is exact averaging
                return 1.0
            v /= rho
        return float(1.0 - rho)

    @property
    def floats_per_iteration(self) -> float:
        """Σ_i deg_i: floats sent per gossip round per model coordinate (for
        a directed graph each directed edge once)."""
        return float(np.sum(self.degrees))

    def validate(self) -> None:
        """The JAX package's invariant checks: of a dense topology, W
        nonnegative, columns summing to 1 when directed (mass conservation),
        else rows summing to 1 and W symmetric; of a matrix-free one, the
        table's (indices in range, padded slots pointing at their row,
        degrees the mask's, every slot i → j with its twin j → i)."""
        if self.is_matrix_free:
            idx, mask = self.nbr_idx, self.nbr_mask
            if idx is None or mask is None or idx.shape != mask.shape:
                raise AssertionError(
                    f"matrix-free topology needs matching nbr_idx/nbr_mask "
                    f"tables ({self.name})"
                )
            if idx.min() < 0 or idx.max() >= self.n:
                raise AssertionError(f"neighbor indices out of range ({self.name})")
            if not np.all(idx[~mask] == np.nonzero(~mask)[0]):
                raise AssertionError(f"padded neighbor slots must self-point ({self.name})")
            if not np.array_equal(mask.sum(axis=1), self.degrees):
                raise AssertionError(f"degrees disagree with the neighbor mask ({self.name})")
            ii = np.broadcast_to(np.arange(self.n, dtype=np.int64)[:, None], idx.shape)[mask]
            jj = idx[mask].astype(np.int64)
            if not np.array_equal(np.sort(ii * self.n + jj), np.sort(jj * self.n + ii)):
                raise AssertionError(f"neighbor table must be symmetric ({self.name})")
            return
        W = self.mixing_matrix
        if np.any(W < -1e-12):
            raise AssertionError(f"Mixing matrix must be nonnegative ({self.name})")
        if self.directed:
            if not np.allclose(W.sum(axis=0), 1.0):
                raise AssertionError(
                    f"Directed mixing matrix columns must sum to 1 ({self.name})"
                )
            return
        if not np.allclose(W.sum(axis=1), 1.0):
            raise AssertionError(f"Mixing matrix rows must sum to 1 ({self.name})")
        if not np.allclose(W, W.T):
            raise AssertionError(f"Mixing matrix must be symmetric ({self.name})")


def _ring_adjacency(n: int) -> np.ndarray:
    adj = np.zeros((n, n))
    ids = np.arange(n)
    adj[ids, (ids + 1) % n] = 1.0
    adj[ids, (ids - 1) % n] = 1.0
    np.fill_diagonal(adj, 0.0)  # n == 1, 2 edge cases
    return adj


def _chain_adjacency(n: int) -> np.ndarray:
    adj = np.zeros((n, n))
    ids = np.arange(n - 1)
    adj[ids, ids + 1] = 1.0
    adj[ids + 1, ids] = 1.0
    return adj


def _star_adjacency(n: int) -> np.ndarray:
    adj = np.zeros((n, n))
    adj[0, 1:] = 1.0
    adj[1:, 0] = 1.0
    return adj


def _torus_adjacency(rows: int, cols: int) -> np.ndarray:
    """Periodic 2-D grid. Worker (r, c) sits at index r*cols + c (row-major);
    on an axis of length 1 or 2 the two neighbours along it collapse into
    one (or none)."""
    n = rows * cols
    adj = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                j = (rr % rows) * cols + (cc % cols)
                if j != i:
                    adj[i, j] = 1.0
    return adj


def _erdos_renyi_adjacency(n: int, p: float, seed: int) -> np.ndarray:
    """Connected Erdős–Rényi G(n, p): one ``rng.random((n, n))`` a try, its
    strict upper triangle below p mirrored, resampled until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((n, n)) < p
        adj = np.triu(upper, k=1).astype(float)
        adj = adj + adj.T
        if _is_connected(adj):
            return adj
    raise RuntimeError(f"Could not sample a connected G({n}, {p}) in 1000 tries")


def _directed_ring_adjacency(n: int) -> np.ndarray:
    """Each node receives from its predecessor: edge (i-1) → i."""
    adj = np.zeros((n, n))
    ids = np.arange(n)
    adj[ids, (ids - 1) % n] = 1.0
    np.fill_diagonal(adj, 0.0)  # n == 1
    return adj


def _directed_erdos_renyi_adjacency(n: int, p: float, seed: int) -> np.ndarray:
    """Strongly connected directed G(n, p): each ordered pair (j → i) draws
    independently, resampled until node 0 reaches every node along the
    edges and along the reversed edges."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        adj = (rng.random((n, n)) < p).astype(float)
        np.fill_diagonal(adj, 0.0)
        if _is_connected_directed(adj) and _is_connected_directed(adj.T):
            return adj
    raise RuntimeError(
        f"Could not sample a strongly connected directed G({n}, {p}) in 1000 tries"
    )


def _is_connected_directed(adj: np.ndarray) -> bool:
    """All nodes reachable from node 0 following edges j → i (adj[i, j])."""
    n = adj.shape[0]
    if n == 0:
        return False
    reached = np.zeros(n, dtype=bool)
    frontier = [0]
    reached[0] = True
    while frontier:
        j = frontier.pop()
        for i in np.nonzero(adj[:, j])[0]:
            if not reached[i]:
                reached[i] = True
                frontier.append(int(i))
    return bool(reached.all())


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    if n == 0:
        return False
    reached = np.zeros(n, dtype=bool)
    frontier = [0]
    reached[0] = True
    while frontier:
        i = frontier.pop()
        for j in np.nonzero(adj[i])[0]:
            if not reached[j]:
                reached[j] = True
                frontier.append(int(j))
    return bool(reached.all())


def ring_spectral_gap_closed_form(n: int) -> float:
    """Closed-form spectral gap of the MH ring (weights 1/3): the
    eigenvalues of W are (1 + 2cos(2πk/n))/3; 0.0209 at n = 25."""
    if n < 3:
        return 1.0
    lambdas = (1.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(1, n) / n)) / 3.0
    return float(1.0 - np.max(np.abs(lambdas)))


def directed_ring_spectral_gap_closed_form(n: int) -> float:
    """Closed-form spectral gap of the uniform-out directed ring: W = (I +
    P)/2 with P the cyclic shift has eigenvalues of modulus cos(πk/n), so
    the gap is 1 − cos(π/n)."""
    if n < 2:
        return 1.0
    return float(1.0 - np.cos(np.pi / n))


def torus_spectral_gap_closed_form(side: int) -> float:
    """Closed-form spectral gap of the MH torus (degree 4, weights 1/5): the
    eigenvalues of W are (1 + 2cos(2πj/s) + 2cos(2πk/s))/5 over j, k."""
    js = np.arange(side)
    cj = 2.0 * np.cos(2.0 * np.pi * js / side)
    lam = (1.0 + cj[:, None] + cj[None, :]) / 5.0
    lam_sorted = np.sort(np.abs(lam.ravel()))
    return float(1.0 - lam_sorted[-2])


def metropolis_hastings_weights(adjacency: np.ndarray) -> np.ndarray:
    degrees = adjacency.sum(axis=1)
    pairwise_max = np.maximum(degrees[:, None], degrees[None, :])
    W = adjacency / (1.0 + pairwise_max)
    np.fill_diagonal(W, 0.0)
    np.fill_diagonal(W, 1.0 - W.sum(axis=1))
    return W


def column_stochastic_weights(adjacency: np.ndarray) -> np.ndarray:
    """Uniform-out-weight column-stochastic mixing matrix (push-sum): node j
    splits its mass equally over its out-neighbours and itself,
    A_ij = 1/(1 + outdeg_j) on every edge j → i and on the diagonal."""
    out_degrees = adjacency.sum(axis=0)
    A = adjacency / (1.0 + out_degrees[None, :])
    np.fill_diagonal(A, 1.0 / (1.0 + out_degrees))
    return A


def gather_mixing_weights(
    nbr_idx: np.ndarray, nbr_mask: np.ndarray, degrees: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """MH weights a slot of the neighbour table: ``(w_nbr [N, k_max],
    w_self [N])`` float64, ``w_nbr[i, s] = 1/(1 + max(deg_i,
    deg_{nbr[i, s]}))`` on live slots (0 on padding) and ``w_self = 1 −
    Σ_s w_nbr``, the values of ``metropolis_hastings_weights`` read at
    (i, nbr[i, s]) and (i, i)."""
    deg = np.asarray(degrees, dtype=np.float64)
    pair = np.maximum(deg[:, None], deg[nbr_idx])
    w_nbr = np.where(nbr_mask, 1.0 / (1.0 + pair), 0.0)
    w_self = 1.0 - w_nbr.sum(axis=1)
    return w_nbr, w_self


def build_topology(name: str, n: int, *, erdos_renyi_p: float = 0.4,
                   seed: int = 0, impl: str = "dense", sampler: str = "dense") -> Topology:
    """The named graph over ``n`` workers. ``erdos_renyi_p`` and ``seed``
    draw the two Erdős–Rényi graphs (the config's
    ``resolved_topology_seed()``); the other graphs ignore them. ``impl``:
    'dense' builds the [N, N] matrices, 'neighbor' the matrix-free table
    (``build_neighbor_topology``); ``sampler`` picks the matrix-free
    Erdős–Rényi sampler (the config's ``resolved_topology_impl()`` and
    ``resolved_topology_sampler()``)."""
    if impl == "neighbor":
        return build_neighbor_topology(name, n, erdos_renyi_p=erdos_renyi_p, seed=seed,
                                       sampler=sampler)
    if impl != "dense":
        raise ValueError(f"Unknown topology impl: {impl!r}")
    if sampler != "dense":
        raise ValueError(
            "the dense [N, N] representation replays its own uniform "
            f"stream — sampler={sampler!r} only exists on the matrix-free "
            "path (impl='neighbor')"
        )
    if name in ("directed_ring", "directed_erdos_renyi"):
        adj = (_directed_ring_adjacency(n) if name == "directed_ring"
               else _directed_erdos_renyi_adjacency(n, erdos_renyi_p, seed))
        topo = Topology(
            name=name, n=n, adjacency=adj, degrees=adj.sum(axis=0),
            mixing_matrix=column_stochastic_weights(adj), directed=True,
        )
        topo.validate()
        return topo
    grid_shape = None
    if name == "ring":
        adj = _ring_adjacency(n)
    elif name == "grid":
        side = math.isqrt(n)
        if side * side != n:
            raise ValueError(f"grid topology requires a perfect square, got {n}")
        adj = _torus_adjacency(side, side)
        grid_shape = (side, side)
    elif name == "fully_connected":
        adj = np.ones((n, n)) - np.eye(n)
    elif name == "erdos_renyi":
        adj = _erdos_renyi_adjacency(n, erdos_renyi_p, seed)
    elif name == "chain":
        adj = _chain_adjacency(n)
    elif name == "star":
        adj = _star_adjacency(n)
    else:
        raise ValueError(f"Unknown topology: {name!r}")
    topo = Topology(
        name=name, n=n, adjacency=adj, degrees=adj.sum(axis=1),
        mixing_matrix=metropolis_hastings_weights(adj), grid_shape=grid_shape,
    )
    topo.validate()
    return topo


# The JAX package's ceiling on a padded neighbour table's cells: a graph
# whose table would hold more has no degree bound for the gather form to
# exploit (``ops/mixing.py``'s 'auto' keeps the dense product there).
NEIGHBOR_TABLE_MAX_CELLS = 64_000_000


def neighbor_table(adjacency: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Padded neighbour table of an undirected 0/1 adjacency.

    ``(nbr_idx [N, k_max] int32, nbr_mask [N, k_max] bool)``: row i lists
    i's neighbours in ascending index order; padded slots point at i itself
    with mask False. ``k_max`` is the largest degree (at least 1).
    """
    A = np.asarray(adjacency)
    if not np.array_equal(A, A.T):
        raise ValueError(
            "neighbor_table expects an undirected (symmetric) adjacency; "
            "the degree-bounded gather path has no directed form"
        )
    n = A.shape[0]
    k_max = max(int(A.sum(axis=1).max()), 1) if n else 1
    nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k_max))
    nbr_mask = np.zeros((n, k_max), dtype=bool)
    for i in range(n):
        nbrs = np.nonzero(A[i])[0]
        nbr_idx[i, : len(nbrs)] = nbrs
        nbr_mask[i, : len(nbrs)] = True
    return nbr_idx, nbr_mask


def neighbor_tables_for(topo: Topology) -> tuple[np.ndarray, np.ndarray]:
    """The (nbr_idx, nbr_mask) tables of an undirected topology: a
    matrix-free graph's own, else ``neighbor_table`` of the adjacency (the
    same layout)."""
    if topo.nbr_idx is not None:
        return topo.nbr_idx, topo.nbr_mask
    return neighbor_table(topo.adjacency)


def pair_edge_ids(lo: np.ndarray, hi: np.ndarray, valid: np.ndarray,
                  edge_index: np.ndarray, n: int) -> np.ndarray:
    """int32 row of ``edge_index`` ([E, 2]) holding each valid pair (lo, hi)
    (arrays of one shape), −1 where not valid; a valid pair missing from the
    list raises KeyError. A sort and a search, O((E + pairs) log E)."""
    keys = edge_index[:, 0].astype(np.int64) * n + edge_index[:, 1].astype(np.int64)
    if not len(keys):
        if valid.any():
            raise KeyError("a pair of the tables has no row in the edge list")
        return np.full(np.shape(lo), -1, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    want = np.asarray(lo, dtype=np.int64) * n + np.asarray(hi, dtype=np.int64)
    pos = np.minimum(np.searchsorted(sorted_keys, want), len(keys) - 1)
    if not np.all((sorted_keys[pos] == want)[valid]):
        raise KeyError("a pair of the tables has no row in the edge list")
    return np.where(valid, order[pos], -1).astype(np.int32)


def incident_edge_slots(nbr_idx: np.ndarray, nbr_mask: np.ndarray,
                        edge_index: np.ndarray) -> np.ndarray:
    """[N, k_max] int32: the id in ``edge_index`` (the [E, 2] i < j edge list
    a fault timeline indexes) of each slot's edge {i, nbr_idx[i, s]}, so
    both ends of an edge read the same id; padded slots map to 0. The JAX
    package's map, by ``pair_edge_ids`` instead of a loop."""
    rows = np.broadcast_to(np.arange(nbr_idx.shape[0], dtype=np.int64)[:, None], nbr_idx.shape)
    ids = pair_edge_ids(np.minimum(rows, nbr_idx), np.maximum(rows, nbr_idx), nbr_mask,
                        np.asarray(edge_index).reshape(-1, 2), nbr_idx.shape[0])
    return np.where(nbr_mask, ids, 0).astype(np.int32)


def _pad_neighbor_lists(nbrs: list[np.ndarray], n: int):
    """Per-node neighbour lists as the padded table (``neighbor_table``'s
    layout: each row ascending, padded slots pointing at the row, mask
    False)."""
    k_max = max(max((len(v) for v in nbrs), default=0), 1)
    nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k_max))
    nbr_mask = np.zeros((n, k_max), dtype=bool)
    for i, v in enumerate(nbrs):
        nbr_idx[i, : len(v)] = np.sort(v).astype(np.int32)
        nbr_mask[i, : len(v)] = True
    return nbr_idx, nbr_mask


def _ring_neighbor_lists(n: int) -> list[np.ndarray]:
    if n <= 1:
        return [np.empty(0, dtype=np.int64) for _ in range(n)]
    if n == 2:
        return [np.array([1]), np.array([0])]
    return [np.unique(np.array([(i - 1) % n, (i + 1) % n])) for i in range(n)]


def _chain_neighbor_lists(n: int) -> list[np.ndarray]:
    return [np.asarray([j for j in (i - 1, i + 1) if 0 <= j < n], dtype=np.int64)
            for i in range(n)]


def _torus_neighbor_lists(rows: int, cols: int) -> list[np.ndarray]:
    """``_torus_adjacency``'s neighbour sets (short axes collapse)."""
    out = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            js = {(rr % rows) * cols + (cc % cols)
                  for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1))}
            js.discard(i)
            out.append(np.asarray(sorted(js), dtype=np.int64))
    return out


def _erdos_renyi_neighbor_lists(n: int, p: float, seed: int) -> list[np.ndarray]:
    """Connected G(n, p) without the [N, N] draw: ``random(n)`` a row walks
    the values ``_erdos_renyi_adjacency``'s ``random((n, n))`` holds, in
    the same order, so the same (seed, try) gives the same graph in both
    representations; union-find over the edges as they are drawn."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        nbrs: list[list[int]] = [[] for _ in range(n)]
        parent = list(range(n))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        comps = n
        for i in range(n):
            row = rng.random(n)
            for j in np.nonzero(row[i + 1:] < p)[0]:
                j = int(i + 1 + j)
                nbrs[i].append(j)
                nbrs[j].append(i)
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
                    comps -= 1
        if comps == 1:
            return [np.asarray(v, dtype=np.int64) for v in nbrs]
    raise RuntimeError(f"Could not sample a connected G({n}, {p}) in 1000 tries")


def _ring_neighbor_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``_ring_neighbor_lists`` + ``_pad_neighbor_lists`` for n >= 3, with no
    per-row loop (the million-worker ring)."""
    ids = np.arange(n, dtype=np.int64)
    left, right = (ids - 1) % n, (ids + 1) % n
    nbr_idx = np.stack([np.minimum(left, right), np.maximum(left, right)], axis=1)
    return nbr_idx.astype(np.int32), np.ones((n, 2), dtype=bool)


def _chain_neighbor_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``_chain_neighbor_lists`` + ``_pad_neighbor_lists`` for n >= 3."""
    ids = np.arange(n, dtype=np.int32)
    nbr_idx = np.tile(ids[:, None], (1, 2))
    nbr_mask = np.zeros((n, 2), dtype=bool)
    nbr_idx[1:-1, 0] = ids[1:-1] - 1
    nbr_idx[1:-1, 1] = ids[1:-1] + 1
    nbr_mask[1:-1] = True
    nbr_idx[0, 0] = 1
    nbr_mask[0, 0] = True
    nbr_idx[-1, 0] = n - 2
    nbr_mask[-1, 0] = True
    return nbr_idx, nbr_mask


def _torus_neighbor_tables(side: int) -> tuple[np.ndarray, np.ndarray]:
    """``_torus_neighbor_lists`` + ``_pad_neighbor_lists`` for a square
    torus of side >= 3 (four distinct neighbours a row, ascending)."""
    r = np.repeat(np.arange(side, dtype=np.int64), side)
    c = np.tile(np.arange(side, dtype=np.int64), side)
    stacked = np.stack([((r - 1) % side) * side + c, ((r + 1) % side) * side + c,
                        r * side + (c - 1) % side, r * side + (c + 1) % side], axis=1)
    return np.sort(stacked, axis=1).astype(np.int32), np.ones((side * side, 4), dtype=bool)


def _pack_neighbor_tables(src: np.ndarray, dst: np.ndarray,
                          n: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward edges (src < dst, unique) as the padded table
    (``_pad_neighbor_lists``'s layout), vectorized."""
    si = np.concatenate([src, dst])
    di = np.concatenate([dst, src])
    order = np.lexsort((di, si))
    si, di = si[order], di[order]
    deg = np.bincount(si, minlength=n)
    k_max = max(int(deg.max()) if n else 0, 1)
    nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k_max))
    nbr_mask = np.zeros((n, k_max), dtype=bool)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    col = np.arange(si.size, dtype=np.int64) - offs[si]
    nbr_idx[si, col] = di.astype(np.int32)
    nbr_mask[si, col] = True
    return nbr_idx, nbr_mask


def _edges_connected(src: np.ndarray, dst: np.ndarray, n: int) -> bool:
    """Connectivity of an undirected edge list: min-label propagation over
    closed neighbourhoods with pointer jumping (``lab[lab]``) to a fixed
    point; connected iff every label is node 0's."""
    if n == 0:
        return False
    lab = np.arange(n, dtype=np.int64)
    for _ in range(10_000):
        nxt = lab.copy()
        np.minimum.at(nxt, src, lab[dst])
        np.minimum.at(nxt, dst, lab[src])
        nxt = nxt[nxt]
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    return bool((lab == 0).all())


# The sparse sampler's dedupe-and-top-up rounds: each redraws only the
# forward edges lost to duplicate draws; the bound makes a pathological
# (n, p) fail loudly.
_SPARSE_TOPUP_ROUNDS = 200


def _erdos_renyi_forward_edges_sparse(n: int, p: float,
                                      seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Connected G(n, p) in O(N·k_max) draws, the JAX package's sampler draw
    for draw: node i's forward degree is Binomial(n−1−i, p), its partners
    uniform over {i+1, …, n−1} drawn with replacement, duplicates redrawn
    in bounded top-up rounds; connectivity by ``_edges_connected``. The
    forward edge list ``(src, dst)``, src < dst, unique."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    tail = (n - 1) - ids
    for _ in range(1000):
        counts = rng.binomial(tail, p)
        src = np.repeat(ids, counts)
        dst = src + 1 + np.floor(rng.random(src.size) * tail[src]).astype(np.int64)
        keys = np.unique(src * n + dst)
        for _ in range(_SPARSE_TOPUP_ROUNDS):
            deficit = counts - np.bincount(keys // n, minlength=n)
            if not (deficit > 0).any():
                break
            src2 = np.repeat(ids, np.maximum(deficit, 0))
            dst2 = src2 + 1 + np.floor(rng.random(src2.size) * tail[src2]).astype(np.int64)
            keys = np.unique(np.concatenate([keys, src2 * n + dst2]))
        else:
            raise RuntimeError(
                f"sparse G({n}, {p}) top-up did not converge in "
                f"{_SPARSE_TOPUP_ROUNDS} rounds"
            )
        src_f, dst_f = keys // n, keys % n
        if _edges_connected(src_f, dst_f, n):
            return src_f, dst_f
    raise RuntimeError(f"Could not sample a connected G({n}, {p}) in 1000 tries")


def _guard_table_size(k_max: int, n: int) -> None:
    """The matrix-free path's two degree guards, with the JAX package's
    messages: a k_max reaching N − 1 has no degree bound, and the table's
    cells are capped at NEIGHBOR_TABLE_MAX_CELLS."""
    if n > 2 and k_max >= n - 1:
        raise ValueError(
            f"realized max degree {k_max} at N={n} leaves no degree bound "
            "to exploit — the neighbor table would match the dense "
            "adjacency's footprint; use the dense representation"
        )
    if max(k_max, 1) * n > NEIGHBOR_TABLE_MAX_CELLS:
        raise ValueError(
            f"neighbor table would hold {max(k_max, 1) * n:,} cells "
            f"(k_max={k_max}, N={n}) > NEIGHBOR_TABLE_MAX_CELLS "
            f"({NEIGHBOR_TABLE_MAX_CELLS:,}) — this graph is too dense "
            "for the degree-bounded path; use the dense representation "
            "or a sparser graph"
        )


def build_neighbor_topology(name: str, n: int, *, erdos_renyi_p: float = 0.4, seed: int = 0,
                            sampler: str = "dense") -> Topology:
    """The matrix-free graph: the [N, k_max] neighbour table alone, for
    ``NEIGHBOR_TOPOLOGIES``. fully_connected and star (k_max = N − 1)
    and any draw past the degree guards raise, with the JAX package's
    messages. ``sampler``: Erdős–Rényi's 'dense' sampler (the [N, N]
    stream's graph, drawn a row at a time) or 'sparse'
    (``_erdos_renyi_forward_edges_sparse``); the other graphs ignore it."""
    if name in ("fully_connected", "star"):
        raise ValueError(
            f"topology {name!r} has k_max = N-1: its neighbor table IS the "
            "dense [N, N] object the matrix-free path avoids — use the "
            "dense representation (impl='dense')"
        )
    if sampler not in ("dense", "sparse"):
        raise ValueError(f"unknown topology sampler {sampler!r} (expected 'dense' or 'sparse')")
    grid_shape: Optional[tuple[int, int]] = None
    sampler_used = "dense"
    if name == "ring":
        tables = (_ring_neighbor_tables(n) if n > 2
                  else _pad_neighbor_lists(_ring_neighbor_lists(n), n))
    elif name == "chain":
        tables = (_chain_neighbor_tables(n) if n > 2
                  else _pad_neighbor_lists(_chain_neighbor_lists(n), n))
    elif name == "grid":
        side = math.isqrt(n)
        if side * side != n:
            raise ValueError(f"grid topology requires a perfect square, got {n}")
        tables = (_torus_neighbor_tables(side) if side >= 3
                  else _pad_neighbor_lists(_torus_neighbor_lists(side, side), n))
        grid_shape = (side, side)
    elif name == "erdos_renyi":
        sampler_used = sampler
        if sampler == "sparse":
            src, dst = _erdos_renyi_forward_edges_sparse(n, erdos_renyi_p, seed)
            # The degree guard before the table, its largest allocation.
            deg = np.bincount(np.concatenate([src, dst]), minlength=max(n, 1))
            _guard_table_size(int(deg.max()) if n else 0, n)
            tables = _pack_neighbor_tables(src, dst, n)
        else:
            nbrs = _erdos_renyi_neighbor_lists(n, erdos_renyi_p, seed)
            _guard_table_size(max((len(v) for v in nbrs), default=0), n)
            tables = _pad_neighbor_lists(nbrs, n)
    else:
        raise ValueError(
            f"no matrix-free constructor for topology {name!r} "
            f"(supported: {NEIGHBOR_TOPOLOGIES})"
        )
    nbr_idx, nbr_mask = tables
    _guard_table_size(int(nbr_mask.sum(axis=1).max()) if n else 0, n)
    topo = Topology(
        name=name, n=n, adjacency=None, degrees=nbr_mask.sum(axis=1).astype(np.float64),
        mixing_matrix=None, grid_shape=grid_shape, nbr_idx=nbr_idx, nbr_mask=nbr_mask,
        sampler=sampler_used,
    )
    topo.validate()
    return topo
