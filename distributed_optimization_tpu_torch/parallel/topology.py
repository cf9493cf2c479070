"""Communication graphs and their mixing matrices.

The port's copy of the dense representation of
``distributed_optimization_tpu/parallel/topology.py``: host-side numpy,
``adjacency[i, j] = 1`` iff j sends to i. Undirected graphs (ring,
periodic grid, fully connected, Erdős–Rényi, chain, star) carry MH weights
``W_ij = 1 / (1 + max(deg_i, deg_j))`` on edges and the remainder on the
diagonal; directed graphs (directed ring, directed Erdős–Rényi) carry the
column-stochastic uniform-out weights of push-sum. The random graphs draw
from ``np.random.default_rng(seed)`` exactly as the JAX package's builders
do, so the same (n, p, seed) gives the same graph bit for bit. Also here:
the padded neighbour table the gather forms read, and its MH weights a slot.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    n: int
    adjacency: np.ndarray  # [N, N] 0/1, zero diagonal; row i = i's in-edges
    # Out-degrees (column sums), which equal the degrees of an undirected
    # graph: how many neighbours each node sends to a round.
    degrees: np.ndarray  # [N]
    # [N, N]: MH (doubly stochastic) or, when directed, column-stochastic.
    mixing_matrix: np.ndarray
    grid_shape: Optional[tuple[int, int]] = None  # (rows, cols), set for 'grid'
    directed: bool = False

    @property
    def spectral_gap(self) -> float:
        """1 − ρ, ρ the second-largest |eigenvalue| of W (its modulus for a
        directed graph, whose W is not symmetric); the closed form on a
        square torus of side >= 3 (0.2764 at side 5)."""
        if self.n < 2:
            return 1.0
        if (self.grid_shape is not None and self.grid_shape[0] == self.grid_shape[1]
                and min(self.grid_shape) >= 3):
            return torus_spectral_gap_closed_form(self.grid_shape[0])
        if self.directed:
            eigs = np.sort(np.abs(np.linalg.eigvals(self.mixing_matrix)))
        else:
            eigs = np.sort(np.abs(np.linalg.eigvalsh(self.mixing_matrix)))
        return float(1.0 - eigs[-2])

    @property
    def floats_per_iteration(self) -> float:
        """Σ_i deg_i: floats sent per gossip round per model coordinate (for
        a directed graph each directed edge once)."""
        return float(np.sum(self.degrees))

    def validate(self) -> None:
        """The JAX package's invariant checks of a dense topology: W
        nonnegative; columns summing to 1 when directed (mass
        conservation), else rows summing to 1 and W symmetric."""
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
                   seed: int = 0) -> Topology:
    """The named graph over ``n`` workers, dense. ``erdos_renyi_p`` and
    ``seed`` draw the two Erdős–Rényi graphs (the config's
    ``resolved_topology_seed()``); the other graphs ignore them."""
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
    """The (nbr_idx, nbr_mask) tables of an undirected topology (every
    topology of the port is dense, so they come from its adjacency)."""
    return neighbor_table(topo.adjacency)
