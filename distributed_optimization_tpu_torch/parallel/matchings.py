"""Deterministic round-robin matching schedules.

The port's host numpy copy of ``distributed_optimization_tpu/parallel/matchings.py``.

The third gossip schedule (besides synchronous all-neighbor averaging and
one-peer *randomized* matchings, ``parallel/faults.py``): cycle through a
fixed sequence of matchings that together cover the topology's edge set —
the deterministic time-varying-graph setting (every edge is exercised every
P iterations, so the union graph over any window of P steps is the full
topology, the connectivity condition of Koloskova et al. '20 / Nedić-Olshevsky
time-varying analyses).

Phases (each phase is a partner involution; unpaired nodes idle):

- **ring** (any N ≥ 3): 2 phases — even pairs (0,1)(2,3)…, odd pairs
  (1,2)(3,4)…; for even N the odd phase wraps (N−1, 0).
- **chain**: same 2 phases without the wrap.
- **grid** (toroidal, even side lengths): 4 phases — horizontal even/odd
  column pairs, vertical even/odd row pairs (the classic torus edge
  4-coloring).

Every W_t = ½(I + P_t) is symmetric and doubly stochastic.
"""

from __future__ import annotations

import numpy as np

from distributed_optimization_tpu_torch.parallel.topology import Topology


def _pair_phase(n: int, start: int, wrap: bool) -> np.ndarray:
    """Partner array pairing (i, i+1 mod n) for i = start, start+2, …"""
    p = np.arange(n)
    stop = n if wrap else n - 1
    for i in range(start, stop, 2):
        j = (i + 1) % n
        p[i], p[j] = j, i
    return p


def round_robin_partners(topo: Topology) -> np.ndarray:
    """[P, N] partner involutions cycling through the topology's edges."""
    n = topo.n
    if topo.name in ("ring", "chain"):
        wrap = topo.name == "ring" and n % 2 == 0
        phases = [_pair_phase(n, 0, wrap=False), _pair_phase(n, 1, wrap=wrap)]
        if topo.name == "ring" and n % 2 == 1:
            # Odd cycles have chromatic index 3: the wrap edge (n−1, 0)
            # needs its own phase.
            p = np.arange(n)
            p[n - 1], p[0] = 0, n - 1
            phases.append(p)
        return np.stack(phases)
    if topo.name == "grid":
        rows, cols = topo.grid_shape  # type: ignore[misc]
        if rows % 2 or cols % 2:
            raise ValueError(
                "round_robin on a toroidal grid needs even side lengths "
                f"(got {rows}x{cols}): odd sides admit no 4-phase edge "
                "coloring with wraparound"
            )
        idx = np.arange(n).reshape(rows, cols)
        phases = []
        for axis, start in ((1, 0), (1, 1), (0, 0), (0, 1)):
            p = np.arange(n).reshape(rows, cols).copy()
            if axis == 1:
                for c in range(start, cols, 2):
                    c2 = (c + 1) % cols
                    p[:, c], p[:, c2] = idx[:, c2], idx[:, c]
            else:
                for r in range(start, rows, 2):
                    r2 = (r + 1) % rows
                    p[r, :], p[r2, :] = idx[r2, :], idx[r, :]
            phases.append(p.reshape(n))
        return np.stack(phases)
    raise ValueError(
        f"round_robin matchings are defined for ring/chain/grid topologies, "
        f"not {topo.name!r}"
    )


def validate_partners(partners: np.ndarray, topo: Topology) -> None:
    """Invariants: involutions, edges of the graph, full edge coverage."""
    n = topo.n
    idx = np.arange(n)
    covered = set()
    for p in partners:
        assert np.array_equal(p[p], idx), "phase is not an involution"
        matched = p != idx
        assert np.all(topo.adjacency[idx[matched], p[matched]] == 1), (
            "phase pairs a non-edge"
        )
        covered.update(
            (min(i, j), max(i, j)) for i, j in zip(idx[matched], p[matched])
        )
    edges = {
        (i, j)
        for i in range(n)
        for j in range(i + 1, n)
        if topo.adjacency[i, j]
    }
    assert covered == edges, "phases do not cover the edge set exactly"
