"""Fully-connected gossip kernels: hand-written CUDA for Hopper, and their
plain twins.

Ports of the Pallas TPU kernels in
``distributed_optimization_tpu/ops/pallas_kernels.py``:

- ``fc_mix(x)`` ← ``fc_mix`` (:172): W x on the fully-connected graph, the
  column mean broadcast to every row;
- ``fc_neighbor_sum(x)`` ← ``fc_neighbor_sum`` (:183): A x, the column sum
  minus the row itself.

Each takes a contiguous ``[N, d]`` float32 or float64 tensor. For a CUDA
tensor it launches the kernel of ``csrc/fc_kernels.cu`` on the current
stream, or raises; for a CPU tensor it runs the plain PyTorch version
(``*_plain``). The column sum is a reduction with no fixed order, so the
kernel agrees with the plain version to N·ε·max|x|, not bitwise.

``LAUNCHES`` counts kernel launches per wrapper; the plain versions do not
count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "fc_kernels.cu"
KERNELS = ("fc_mix", "fc_neighbor_sum")
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# --- plain PyTorch versions ---------------------------------------------------


def fc_mix_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0, keepdim=True).expand_as(x)


def fc_neighbor_sum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0, keepdim=True).expand_as(x) - x


# --- build, load and launch ---------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in KERNELS:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ptr, ptr, i64, i64, ptr]
            fn.restype = ctypes.c_int
    return lib


def _run(name: str, x: torch.Tensor, plain) -> torch.Tensor:
    _cuda_build.check_stack(x)
    if x.device.type == "cpu":
        return plain(x)
    out = torch.empty_like(x)
    _cuda_build.call(_library(), name, x, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    LAUNCHES[name] += 1
    return out


def fc_mix(x: torch.Tensor) -> torch.Tensor:
    """W x for the fully-connected graph: the column mean on every row."""
    return _run("fc_mix", x, fc_mix_plain)


def fc_neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """A x for the fully-connected graph: column sums minus the row."""
    return _run("fc_neighbor_sum", x, fc_neighbor_sum_plain)
