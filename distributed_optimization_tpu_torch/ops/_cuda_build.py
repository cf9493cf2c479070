"""Build a ``csrc/*.cu`` source into a shared library at first use, and load it.

Each source is compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` inside
the package, under a name that hashes the source and the flags, so a
changed source builds anew and an unchanged one is reused. The library
has a plain C interface and is loaded with ``ctypes``. A failed build
raises with nvcc's output. ``build_all`` starts one nvcc per source at once.

The argument checks every kernel wrapper shares live here too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found: the CUDA kernels are built from {CSRC} at "
            "first use and need the CUDA toolkit"
        )
    return found


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def _start(source: pathlib.Path):
    """Start nvcc for ``source`` unless its build exists: (target, partial
    output, command, process or None)."""
    target = library_path(source)
    if target.exists():
        return target, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return target, partial, cmd, proc


def _finish(source, target, partial, cmd, proc) -> str:
    """Wait for the build; the error text of a failed one, else ''."""
    if proc is None:
        return ""
    out, err = proc.communicate()
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        return (f"nvcc failed (exit {proc.returncode}) building {source}:\n"
                f"{' '.join(cmd)}\n{out}{err}")
    os.replace(partial, target)
    return ""


def build_all(sources) -> list[pathlib.Path]:
    """Build every source, one nvcc each, all started together; every
    process is waited for before a failure raises."""
    started = [(src, *_start(src)) for src in sources]
    errors = [e for e in (_finish(*s) for s in started) if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [s[1] for s in started]


def build(source: pathlib.Path) -> pathlib.Path:
    return build_all([source])[0]


def load(source: pathlib.Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))


# --- the wrappers' shared argument checks -------------------------------------

SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def check_stack(x, what: str = "x") -> None:
    """A contiguous [N, d] float32 or float64 tensor on the CPU or a card."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    if x.dtype not in SUFFIX:
        raise TypeError(f"{what} must be float32 or float64, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what} must be [N, d], got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} lies on {x.device}; the kernels take cpu or cuda")


def check_like(t, x: torch.Tensor, what: str, dtype=None) -> None:
    """``t`` is a contiguous tensor on x's device, in ``dtype`` (x's by
    default)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    want = x.dtype if dtype is None else dtype
    if t.dtype != want or t.device != x.device:
        raise ValueError(
            f"{what} must match x in dtype and device "
            f"({t.dtype} on {t.device} vs {want} on {x.device})"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_scalar(t, x: torch.Tensor, what: str) -> None:
    """A one-element tensor in x's dtype on x's device, whose address the
    kernel reads."""
    check_like(t, x, what)
    if t.numel() != 1:
        raise ValueError(f"{what} must hold one element, got {t.numel()}")


def call(lib: ctypes.CDLL, name: str, x: torch.Tensor, *args) -> None:
    """Call ``name_<f32|f64>(*args, stream)`` on x's device and raise on a
    non-zero CUDA error code."""
    fn = getattr(lib, f"{name}_{SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
