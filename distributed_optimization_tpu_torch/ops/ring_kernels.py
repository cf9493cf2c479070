"""Ring gossip kernels: hand-written CUDA for Hopper, and their plain twins.

Ports of the Pallas TPU kernels in
``distributed_optimization_tpu/ops/pallas_kernels.py``:

- ``fused_ring_dsgd_step(x, g, eta)`` ← ``fused_ring_dsgd_step`` (:143):
  the whole D-SGD update ``(x + roll(x,+1) + roll(x,−1))·⅓ − η·g``;
- ``ring_mix(x)`` ← ``ring_mix`` (:137): W x on the MH ring;
- ``ring_neighbor_sum(x)`` ← ``ring_neighbor_sum`` (:177): A x on the ring.

Each takes a contiguous ``[N, d]`` float32, float64 or bfloat16 tensor
with N >= 3.
For a CUDA tensor it launches the kernel of ``csrc/ring_kernels.cu`` on the
current stream, or raises; for a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), which the kernel matches bit for bit.

The three share one kernel, a flat stencil: on the row-major array,
``roll(x, ±1, 0)`` is a shift by ∓d over the N·d elements, wrapping at
the ends, so element e reads e − d and e + d (each moved by N·d where it
falls outside) with no integer division; ``ring_neighbor_sum`` reads only
those two, the other two x_e as well. A thread takes 4 float32, 2
float64 or 8 bfloat16 elements as one 16-byte load and store; the neighbours are vectors
too when d is a multiple of that width, else one scalar load per element,
each with its own wrap. A tensor whose address is not 16-byte aligned (a
view at an odd offset) takes the one-element instance of the same kernel.
The grid takes up to 64 full waves (8 blocks of 256 a multiprocessor) and
loops beyond that; stores are evict-first; indices are 32-bit below 2³¹
elements and 64-bit above. The sums keep the plain version's order,
``((x_e + x_prev) + x_next)·⅓`` then ``− (η·g_e)``, each rounded on its
own, and ``x_prev + x_next`` for the neighbour sum. In bfloat16 each
operation is computed in float32 and rounded to bfloat16 at once, ⅓ and
η·g included (⅓ is bfloat16(1/3), as the JAX package's weak-typed ``1/3``
rounds): PyTorch's bfloat16 operations, and the JAX package's on the CPU,
round so. A tensor-core form
would sum the three products in another order, so there is none.

``launch_floor`` launches an empty kernel through the same interface, so
that a measurement can see what a launch alone costs; it counts nothing
and is on no path.

The shared library is built at first use by ``ops/_cuda_build.py`` (nvcc
for ``sm_90a`` into ``_build/``, loaded with ``ctypes``).

``LAUNCHES`` maps each kernel to its launches on the card, which the kernel
counts where it runs (``_cuda_build.LaunchCounts``): graph replays count;
the plain versions do not.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build
from distributed_optimization_tpu_torch.ops.rounding import scalar

THIRD = 1.0 / 3.0
# The kernels' instances (csrc/ring_kernels.cu).
SUFFIX = _cuda_build.SUFFIX_BF16

SOURCE = _cuda_build.CSRC / "ring_kernels.cu"

# In the order of the kernels' launch-count slots (csrc/ring_kernels.cu).
KERNELS = ("fused_ring_dsgd_step", "ring_mix", "ring_neighbor_sum")


# --- plain PyTorch versions (the contract the kernels are held to) ---------


def ring_mix_plain(x: torch.Tensor) -> torch.Tensor:
    """The worker axis is −2, so a leading replica axis passes through."""
    return (x + torch.roll(x, 1, -2) + torch.roll(x, -1, -2)) * scalar(THIRD, x.dtype)


def fused_ring_dsgd_step_plain(x: torch.Tensor, g: torch.Tensor, eta) -> torch.Tensor:
    if not isinstance(eta, torch.Tensor):
        eta = scalar(eta, x.dtype)
    return ring_mix_plain(x) - eta * g


def ring_neighbor_sum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, 1, -2) + torch.roll(x, -1, -2)


# --- build and load ----------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the three kernels' C functions."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for suffix in SUFFIX.values():
        fused = getattr(lib, f"fused_ring_dsgd_step_{suffix}")
        fused.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
        fused.restype = ctypes.c_int
        for name in ("ring_mix", "ring_neighbor_sum"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ptr, ptr, i64, i64, ptr]
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = bind(_cuda_build.load(SOURCE))
    lib.ring_launch_floor.argtypes = [ctypes.c_void_p]
    lib.ring_launch_floor.restype = ctypes.c_int
    return lib


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


# --- wrappers ----------------------------------------------------------------


def _check_state(x: torch.Tensor, what: str = "x") -> None:
    _cuda_build.check_stack(x, what, SUFFIX)
    if x.shape[0] < 3:
        raise ValueError(f"the ring kernels need N >= 3 workers, got {x.shape[0]}")


def launch(lib: ctypes.CDLL, name: str, x: torch.Tensor, *args: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` of ``lib`` (as ``bind`` declares it) on x and
    ``args``; returns its output. Checks nothing."""
    out = torch.empty_like(x)
    _cuda_build.call(lib, name, x, *(a.data_ptr() for a in (x, *args)),
                     out.data_ptr(), x.shape[0], x.shape[1], suffixes=SUFFIX)
    return out


def _launch(name: str, x: torch.Tensor, *args: torch.Tensor) -> torch.Tensor:
    return launch(_library(), name, x, *args)


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


def launch_floor(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream. For measuring
    what a launch through this interface costs; it counts nothing."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.ring_launch_floor(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_launch_floor failed: CUDA error {err}")
