"""Gossip operators x -> W x and neighbour sums x -> A x.

The port of ``distributed_optimization_tpu/ops/mixing.py`` for the ring, the
periodic grid and the fully-connected graph, in three forms:

- ``stencil``: the ring as ``roll``s (all MH weights are 1/3), the grid as
  four ``roll``s of its [rows, cols, d] view (all weights 1/5), the
  fully-connected graph as the column mean;
- ``dense``: a product with the [N, N] matrix, ``torch.matmul`` as the JAX
  package leaves it to XLA;
- ``pallas``: the hand-written CUDA kernels of ``ops/ring_kernels.py``
  (ring of N >= 3) and ``ops/fc_kernels.py`` (fully connected). The name
  is kept so that configs carry across. The grid has no kernel, here as in
  the JAX package, and ``pallas`` on it raises.

``auto`` resolves to ``stencil``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from distributed_optimization_tpu_torch.backends.base import resolve_device
from distributed_optimization_tpu_torch.ops import fc_kernels, ring_kernels
from distributed_optimization_tpu_torch.parallel.topology import Topology

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
    if topo.name == "ring":
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
        g = x.reshape(rows, cols, *x.shape[1:])
        s = (torch.roll(g, 1, 0) + torch.roll(g, -1, 0)
             + torch.roll(g, 1, 1) + torch.roll(g, -1, 1))
        return s.reshape(x.shape)

    return MixingOp(topo.name, "stencil", lambda x: w * (x + shifts(x)), shifts)


def make_mixing_op(
    topo: Topology,
    impl: str = "auto",
    *,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> MixingOp:
    """Build the mixing operator of ``topo``; ``device``/``dtype`` place the
    dense form's matrices. ``cuda`` raises when no card is visible."""
    device = resolve_device(device)
    if impl == "auto":
        impl = "stencil" if _supports_stencil(topo) else "dense"
    if impl not in ("stencil", "dense", "pallas"):
        raise ValueError(
            f"mixing_impl={impl!r}: the PyTorch port does not have it yet"
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

    if impl == "dense":
        W = torch.as_tensor(topo.mixing_matrix, dtype=dtype, device=device)
        A = torch.as_tensor(topo.adjacency, dtype=dtype, device=device)
        return MixingOp(
            topo.name, "dense", lambda x: torch.matmul(W, x),
            lambda x: torch.matmul(A, x),
        )

    if not _supports_stencil(topo):
        raise ValueError(f"stencil mixing unsupported for {topo.name} (n={topo.n})")
    if topo.name == "fully_connected":
        return MixingOp(
            topo.name, "stencil", fc_kernels.fc_mix_plain, fc_kernels.fc_neighbor_sum_plain,
        )
    if topo.name == "grid":
        return _grid_stencil(topo)
    return MixingOp(
        topo.name, "stencil", ring_kernels.ring_mix_plain,
        ring_kernels.ring_neighbor_sum_plain,
    )
