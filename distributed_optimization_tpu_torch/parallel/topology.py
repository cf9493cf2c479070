"""Communication graphs and their Metropolis–Hastings mixing matrices.

The port's copy of the ring, periodic grid and fully-connected parts of
``distributed_optimization_tpu/parallel/topology.py``: host-side numpy,
``adjacency[i, j] = 1`` iff j sends to i, MH weights
``W_ij = 1 / (1 + max(deg_i, deg_j))`` on edges and the remainder on the
diagonal; and the padded neighbour table the robust screens gather through.
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
    adjacency: np.ndarray  # [N, N] 0/1, zero diagonal
    degrees: np.ndarray  # [N]
    mixing_matrix: np.ndarray  # [N, N] doubly stochastic
    grid_shape: Optional[tuple[int, int]] = None  # (rows, cols), set for 'grid'

    @property
    def spectral_gap(self) -> float:
        """1 − ρ, ρ the second-largest |eigenvalue| of W; the closed form on
        a square torus of side >= 3 (0.2764 at side 5)."""
        if self.n < 2:
            return 1.0
        if (self.grid_shape is not None and self.grid_shape[0] == self.grid_shape[1]
                and min(self.grid_shape) >= 3):
            return torus_spectral_gap_closed_form(self.grid_shape[0])
        eigs = np.sort(np.abs(np.linalg.eigvalsh(self.mixing_matrix)))
        return float(1.0 - eigs[-2])

    @property
    def floats_per_iteration(self) -> float:
        """Σ_i deg_i: floats sent per gossip round per model coordinate."""
        return float(np.sum(self.degrees))


def _ring_adjacency(n: int) -> np.ndarray:
    adj = np.zeros((n, n))
    ids = np.arange(n)
    adj[ids, (ids + 1) % n] = 1.0
    adj[ids, (ids - 1) % n] = 1.0
    np.fill_diagonal(adj, 0.0)  # n == 1, 2 edge cases
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


def build_topology(name: str, n: int) -> Topology:
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
    else:
        raise ValueError(
            f"topology={name!r}: the PyTorch port does not have it yet"
        )
    return Topology(
        name=name, n=n, adjacency=adj, degrees=adj.sum(axis=1),
        mixing_matrix=metropolis_hastings_weights(adj), grid_shape=grid_shape,
    )


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
    """The (nbr_idx, nbr_mask) tables of a topology (every topology of the
    port is dense, so they come from its adjacency)."""
    return neighbor_table(topo.adjacency)
