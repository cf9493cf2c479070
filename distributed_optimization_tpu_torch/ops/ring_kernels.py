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

The shared library is built at first use with ``nvcc`` for ``sm_90a`` into
``_build/`` inside the package, named after a hash of the source, and
loaded with ``ctypes``. A failed build raises with nvcc's output.

``LAUNCHES`` counts kernel launches per wrapper; the plain versions do not
count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

THIRD = 1.0 / 3.0

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "ring_kernels.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

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


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the ring kernels are built from "
            f"{SOURCE} at first use and need the CUDA toolkit"
        )
    return found


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"ring_kernels-{digest}.so"


def build() -> pathlib.Path:
    """Compile the shared library unless this source's build exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {SOURCE}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(partial, target)
    return target


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
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

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_state(x: torch.Tensor, what: str = "x") -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what} must be float32 or float64, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what} must be [N, d], got shape {tuple(x.shape)}")
    if x.shape[0] < 3:
        raise ValueError(f"the ring kernels need N >= 3 workers, got {x.shape[0]}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} lies on {x.device}; the ring kernels take cpu or cuda")


def _check_like(t: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if t.dtype != x.dtype or t.device != x.device:
        raise ValueError(
            f"{what} must match x in dtype and device "
            f"({t.dtype} on {t.device} vs {x.dtype} on {x.device})"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(name: str, x: torch.Tensor, *args: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    fn = getattr(_library(), f"{name}_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(a.data_ptr() for a in (x, *args)), out.data_ptr(),
                 x.shape[0], x.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def fused_ring_dsgd_step(x: torch.Tensor, g: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """W x − η g on the ring. ``eta`` is a one-element tensor in x's dtype
    on x's device (a Python float is accepted for a CPU tensor)."""
    _check_state(x)
    _check_like(g, x, "g")
    if g.shape != x.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_ring_dsgd_step_plain(x, g, eta)
    _check_like(eta, x, "eta")
    if eta.numel() != 1:
        raise ValueError(f"eta must hold one element, got {eta.numel()}")
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
