"""Ring gossip kernels: hand-written CUDA for Hopper, and their plain twins.

Ports of the Pallas TPU kernels in
``distributed_optimization_tpu/ops/pallas_kernels.py``:

- ``fused_ring_dsgd_step(x, g, eta)`` ← ``fused_ring_dsgd_step`` (:143):
  the whole D-SGD update ``(x + roll(x,+1) + roll(x,−1))·⅓ − η·g``;
- ``ring_mix(x)`` ← ``ring_mix`` (:137): W x on the MH ring;
- ``ring_neighbor_sum(x)`` ← ``ring_neighbor_sum`` (:177): A x on the ring.

Each takes a contiguous ``[N, d]`` float32 or float64 tensor with N >= 3.
For a CUDA tensor it launches the kernel of ``csrc/ring_kernels.cu`` on the
current stream, or raises; for a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), which the kernel matches bit for bit.

The shared library is built at first use by ``ops/_cuda_build.py`` (nvcc
for ``sm_90a`` into ``_build/``, loaded with ``ctypes``).

``LAUNCHES`` counts kernel launches per wrapper; the plain versions do not
count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build

THIRD = 1.0 / 3.0

SOURCE = _cuda_build.CSRC / "ring_kernels.cu"

KERNELS = ("fused_ring_dsgd_step", "ring_mix", "ring_neighbor_sum")
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# --- plain PyTorch versions (the contract the kernels are held to) ---------


def ring_mix_plain(x: torch.Tensor) -> torch.Tensor:
    return (x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0)) * THIRD


def fused_ring_dsgd_step_plain(x: torch.Tensor, g: torch.Tensor, eta) -> torch.Tensor:
    return ring_mix_plain(x) - eta * g


def ring_neighbor_sum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, 1, 0) + torch.roll(x, -1, 0)


# --- build and load ----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for suffix in ("f32", "f64"):
        fused = getattr(lib, f"fused_ring_dsgd_step_{suffix}")
        fused.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
        fused.restype = ctypes.c_int
        for name in ("ring_mix", "ring_neighbor_sum"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ptr, ptr, i64, i64, ptr]
            fn.restype = ctypes.c_int
    return lib


# --- wrappers ----------------------------------------------------------------


def _check_state(x: torch.Tensor, what: str = "x") -> None:
    _cuda_build.check_stack(x, what)
    if x.shape[0] < 3:
        raise ValueError(f"the ring kernels need N >= 3 workers, got {x.shape[0]}")


def _launch(name: str, x: torch.Tensor, *args: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    _cuda_build.call(_library(), name, x, *(a.data_ptr() for a in (x, *args)),
                     out.data_ptr(), x.shape[0], x.shape[1])
    LAUNCHES[name] += 1
    return out


def fused_ring_dsgd_step(x: torch.Tensor, g: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """W x − η g on the ring. ``eta`` is a one-element tensor in x's dtype
    on x's device (a Python float is accepted for a CPU tensor)."""
    _check_state(x)
    _cuda_build.check_like(g, x, "g")
    if g.shape != x.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_ring_dsgd_step_plain(x, g, eta)
    _cuda_build.check_scalar(eta, x, "eta")
    return _launch("fused_ring_dsgd_step", x, g, eta)


def ring_mix(x: torch.Tensor) -> torch.Tensor:
    """W x for the MH ring: (x + roll(x,+1) + roll(x,−1))·⅓."""
    _check_state(x)
    if x.device.type == "cpu":
        return ring_mix_plain(x)
    return _launch("ring_mix", x)


def ring_neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """A x for the ring: roll(x,+1) + roll(x,−1)."""
    _check_state(x)
    if x.device.type == "cpu":
        return ring_neighbor_sum_plain(x)
    return _launch("ring_neighbor_sum", x)
