"""Gossip operators x -> W x and neighbour sums x -> A x.

The port of ``distributed_optimization_tpu/ops/mixing.py``, in five forms:

- ``stencil``: the graphs whose weights are uniform by symmetry, as shifts:
  the ring as two ``roll``s (weights 1/3), the directed ring as one
  (weights 1/2), the grid as four ``roll``s of its [rows, cols, d] view
  (weights 1/5), the fully-connected graph as the column mean;
- ``dense``: a product with the [N, N] matrix, ``torch.matmul`` as the JAX
  package leaves it to XLA; any graph;
- ``gather``: the undirected graphs over the padded ``[N, k_max]``
  neighbour table with the MH weight of each slot, O(N·k_max·d);
- ``sparse``: the edge list of any graph, directed ones included, as a
  table of each node's in-edges in the adjacency's row-major order with
  the weight W_ij of each edge, padded to the largest in-degree;
- ``pallas``: the hand-written CUDA kernels of ``ops/ring_kernels.py``
  (ring of N >= 3) and ``ops/fc_kernels.py`` (fully connected). The name
  is kept so that configs carry across; any other graph raises, as in the
  JAX package.

Every form acts on the worker axis at −2, so a state with a leading
replica axis ``[R, N, d]`` (``torch_backend.run_batch``) mixes each
replica's stack as the single run mixes its own.

The gather and sparse forms sum over the slot axis in slot order
(``robust_aggregation.slot_sum``): no atomics, so a replay of a captured
graph adds the same values in the same order, and no size is read back to
the host. ``auto`` resolves as the JAX package does: the stencil where the
graph embeds as shifts; the gather form on a matrix-free graph, and on an
undirected graph of N >= MATRIX_FREE_AUTO_N whose table is degree-bounded;
else dense. A matrix-free graph has no [N, N] matrix, so ``dense``,
``sparse`` and ``pallas`` raise on it, with the JAX package's message.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

import numpy as np

from distributed_optimization_tpu_torch.backends.base import resolve_device
from distributed_optimization_tpu_torch.config import MATRIX_FREE_AUTO_N
from distributed_optimization_tpu_torch.ops import fc_kernels, ring_kernels
from distributed_optimization_tpu_torch.ops.robust_aggregation import slot_sum
from distributed_optimization_tpu_torch.ops.rounding import scalar
from distributed_optimization_tpu_torch.parallel.topology import (
    NEIGHBOR_TABLE_MAX_CELLS,
    Topology,
    gather_mixing_weights,
    neighbor_tables_for,
)

MixFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MixingOp:
    """``apply``: x [N, d] -> W x; ``neighbor_sum``: x [N, d] -> A x."""

    topology_name: str
    impl: str
    apply: MixFn
    neighbor_sum: MixFn


def _supports_stencil(topo: Topology) -> bool:
    if topo.name == "fully_connected":
        return True
    if topo.name in ("ring", "directed_ring"):
        return topo.n >= 3
    if topo.name == "grid":
        return topo.grid_shape is not None and min(topo.grid_shape) >= 3
    return False


def _grid_stencil(topo: Topology) -> MixingOp:
    """W x and A x on the torus: degree 4 everywhere, so every MH weight is
    1/5; worker i sits at (i // cols, i % cols). The four shifts are added
    in the JAX package's order."""
    rows, cols = topo.grid_shape
    w = 1.0 / 5.0

    def shifts(x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(*x.shape[:-2], rows, cols, x.shape[-1])
        s = (torch.roll(g, 1, -3) + torch.roll(g, -1, -3)
             + torch.roll(g, 1, -2) + torch.roll(g, -1, -2))
        return s.reshape(x.shape)

    return MixingOp(topo.name, "stencil", lambda x: scalar(w, x.dtype) * (x + shifts(x)), shifts)


def _resolve_auto(topo: Topology) -> str:
    """The JAX package's 'auto': the stencil where the graph embeds as
    shifts; the gather form on a matrix-free graph, and on an undirected
    graph at N >= MATRIX_FREE_AUTO_N whose table is degree-bounded (k_max +
    1 < N and at most NEIGHBOR_TABLE_MAX_CELLS cells); else the dense
    product."""
    if _supports_stencil(topo):
        return "stencil"
    if topo.is_matrix_free:
        return "gather"
    if not topo.directed and topo.n >= MATRIX_FREE_AUTO_N:
        k_max = int(np.asarray(topo.degrees).max())
        if k_max + 1 < topo.n and max(k_max, 1) * topo.n <= NEIGHBOR_TABLE_MAX_CELLS:
            return "gather"
    return "dense"


def _slot_form(topo: Topology, impl: str, idx, w_slot, w_self, mask, *, device,
               dtype) -> MixingOp:
    """W x = w_self ⊙ x + Σ_s w_slot[:, s] ⊙ x[idx[:, s]] and A x = Σ_s
    mask[:, s] ⊙ x[idx[:, s]], each sum over the slots in slot order; the
    [N, k] tables go to the device once. In bfloat16 the gather form sums
    its slots' float32 products in float32 and rounds once (the JAX
    package's ``jnp.sum`` over the slot axis, its product fused), the
    sparse form in bfloat16, an addition at a time (its ``segment_sum``)."""
    acc = torch.promote_types(torch.float32, dtype) if impl == "gather" else dtype

    def sum_slots(a, b):
        """Σ_s a ⊙ b: in bfloat16 the gather form's products in float32,
        unrounded, summed there (XLA fuses the product into the sum)."""
        return slot_sum(a.to(acc) * b.to(acc)).to(dtype)

    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    idx = torch.tensor(np.asarray(idx), dtype=torch.int64, device=device)
    w_slot, mask = put(w_slot)[:, :, None], put(mask)[:, :, None]
    w_self = put(w_self)[:, None]

    def apply(x):
        return w_self * x + sum_slots(w_slot, x[..., idx, :])

    def neighbor_sum(x):
        return sum_slots(mask, x[..., idx, :])

    return MixingOp(topo.name, impl, apply, neighbor_sum)


def _in_edge_table(topo: Topology):
    """Each node's in-edges in the adjacency's row-major order (the JAX
    package's ``np.nonzero`` edge list, sorted by destination), padded to
    the largest in-degree: (src [N, k_in], w [N, k_in], mask [N, k_in]);
    padded slots point at the node itself with weight 0."""
    dst, src = np.nonzero(topo.adjacency)
    if dst.size == 0:
        raise ValueError(
            f"sparse mixing needs at least one edge ({topo.name}, n={topo.n})"
        )
    n = topo.n
    counts = np.bincount(dst, minlength=n)
    slot = np.arange(dst.size) - np.repeat(np.cumsum(counts) - counts, counts)
    table = np.tile(np.arange(n)[:, None], (1, int(counts.max())))
    weights = np.zeros(table.shape)
    mask = np.zeros(table.shape)
    table[dst, slot] = src
    weights[dst, slot] = topo.mixing_matrix[dst, src]
    mask[dst, slot] = 1.0
    return table, weights, mask


def make_mixing_op(
    topo: Topology,
    impl: str = "auto",
    *,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> MixingOp:
    """Build the mixing operator of ``topo``; ``device``/``dtype`` place the
    matrices and tables of the dense, gather and sparse forms. ``cuda``
    raises when no card is visible."""
    device = resolve_device(device)
    if impl == "auto":
        impl = _resolve_auto(topo)
    if impl not in ("stencil", "dense", "pallas", "gather", "sparse"):
        raise ValueError(
            f"mixing_impl={impl!r}: the PyTorch port does not have it yet"
        )
    if impl == "stencil" and not _supports_stencil(topo):
        raise ValueError(f"stencil mixing unsupported for {topo.name} (n={topo.n})")
    if topo.is_matrix_free and impl not in ("stencil", "gather"):
        raise ValueError(
            f"mixing_impl={impl!r} consumes the dense [N, N] matrices a "
            f"matrix-free topology ({topo.name}, n={topo.n}) never "
            "materializes — use 'gather' (or 'stencil' where the graph "
            "embeds as shifts)"
        )

    if impl == "pallas":
        if topo.name == "ring" and topo.n >= 3:
            return MixingOp(
                topo.name, "pallas", ring_kernels.ring_mix,
                ring_kernels.ring_neighbor_sum,
            )
        if topo.name == "fully_connected":
            return MixingOp(
                topo.name, "pallas", fc_kernels.fc_mix, fc_kernels.fc_neighbor_sum,
            )
        raise ValueError(
            f"pallas mixing supports ring (n>=3) and fully_connected, "
            f"not {topo.name} (n={topo.n})"
        )

    if impl == "gather":
        if topo.directed:
            raise ValueError(
                "gather mixing is undirected-only (MH weights per slot); "
                f"directed topology {topo.name!r} has no gather form"
            )
        nbr_idx, nbr_mask = neighbor_tables_for(topo)
        w_nbr, w_self = gather_mixing_weights(nbr_idx, nbr_mask, topo.degrees)
        return _slot_form(topo, "gather", nbr_idx, w_nbr, w_self, nbr_mask,
                          device=device, dtype=dtype)

    if impl == "sparse":
        src, w_edge, mask = _in_edge_table(topo)
        return _slot_form(topo, "sparse", src, w_edge, np.diag(topo.mixing_matrix), mask,
                          device=device, dtype=dtype)

    if impl == "dense":
        W = torch.as_tensor(topo.mixing_matrix, dtype=dtype, device=device)
        A = torch.as_tensor(topo.adjacency, dtype=dtype, device=device)
        return MixingOp(
            topo.name, "dense", lambda x: torch.matmul(W, x),
            lambda x: torch.matmul(A, x),
        )

    if topo.name == "fully_connected":
        return MixingOp(
            topo.name, "stencil", fc_kernels.fc_mix_plain, fc_kernels.fc_neighbor_sum_plain,
        )
    if topo.name == "grid":
        return _grid_stencil(topo)
    if topo.name == "directed_ring":
        # Out-degree 1 everywhere: weights 1/2 on the self-loop and the
        # edge from the predecessor, one roll.
        return MixingOp(topo.name, "stencil", lambda x: 0.5 * (x + torch.roll(x, 1, -2)),
                        lambda x: torch.roll(x, 1, -2))
    return MixingOp(
        topo.name, "stencil", ring_kernels.ring_mix_plain,
        ring_kernels.ring_neighbor_sum_plain,
    )
