"""Build a ``csrc/*.cu`` source into a shared library at first use, and load it.

Each source is compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` inside
the package, under a name that hashes the source and the flags, so a
changed source builds anew and an unchanged one is reused. The library
has a plain C interface and is loaded with ``ctypes``. A failed build
raises with nvcc's output. ``build_all`` starts one nvcc per source at once.
The headers of ``csrc/`` (``launch_counts.cuh``, ``threefry.cuh``) are on
the include path and in the hash.

The argument checks every kernel wrapper shares live here too, and
``LaunchCounts``, the wrappers' view of the launch counts their kernels keep
on the card.
"""

from __future__ import annotations

import collections.abc
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(partial), str(source)]
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

# The C entry points' suffix for each dtype a kernel has an instance in:
# float32 and float64 for every kernel; bfloat16 too for the ring, fc,
# sampling, robust and compression kernels, whose wrappers pass
# SUFFIX_BF16. A wrapper given a tensor of another dtype raises a TypeError
# naming it.
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
SUFFIX_BF16 = {**SUFFIX, torch.bfloat16: "bf16"}
# What a launcher returns when it refuses its arguments.
CUDA_ERROR_INVALID_VALUE = 1


def check_dtype(dtype: torch.dtype, suffixes=SUFFIX, what: str = "x") -> None:
    """``dtype`` is one the kernel has an instance in (``suffixes``)."""
    if dtype not in suffixes:
        names = " or ".join(str(d).removeprefix("torch.") for d in suffixes)
        raise TypeError(f"{what} must be {names}, got {dtype}: this kernel has no "
                        f"{str(dtype).removeprefix('torch.')} instance")


def check_stack(x, what: str = "x", suffixes=SUFFIX) -> None:
    """A contiguous [N, d] tensor, in a dtype of ``suffixes``, on the CPU or
    a card."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor")
    check_dtype(x.dtype, suffixes, what)
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


def call(lib: ctypes.CDLL, name: str, x: torch.Tensor, *args,
         invalid: str | None = None, suffixes=SUFFIX) -> None:
    """Call ``name_<suffix of x's dtype>(*args, stream)`` on x's device and
    raise on a non-zero CUDA error code: a ValueError saying ``invalid``,
    where given, when the launcher refuses its arguments
    (cudaErrorInvalidValue); a TypeError for a dtype ``suffixes`` lacks."""
    check_dtype(x.dtype, suffixes, name)
    fn = getattr(lib, f"{name}_{suffixes[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err == CUDA_ERROR_INVALID_VALUE and invalid is not None:
        raise ValueError(invalid)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --- launch counts -------------------------------------------------------------


class LaunchCounts(collections.abc.Mapping):
    """Launches of each kernel of one library on the current card, by name,
    as the kernels count them: slot i of the library's device array
    (``csrc/launch_counts.cuh``) is ``names[i]``. A count rises where the
    kernel runs, once for an eager launch and once for each replay of a CUDA
    graph that holds it; a CPU tensor's plain version counts nothing.
    Reading or resetting synchronises the device, so neither belongs inside
    a capture. Until ``library`` (a cached loader) has loaded the kernels,
    every count reads 0 and nothing is built."""

    def __init__(self, names, library):
        self._names = tuple(names)
        self._library = library

    def _loaded(self):
        if self._library.cache_info().currsize == 0:
            return None
        lib = self._library()
        lib.launch_counts_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        lib.launch_counts_read.restype = ctypes.c_int
        lib.launch_counts_reset.argtypes = []
        lib.launch_counts_reset.restype = ctypes.c_int
        return lib

    def _read(self) -> tuple[int, ...]:
        lib = self._loaded()
        if lib is None:
            return (0,) * len(self._names)
        slots = (ctypes.c_ulonglong * len(self._names))()
        err = lib.launch_counts_read(slots, len(self._names))
        if err != 0:
            raise RuntimeError(f"reading the launch counts failed: CUDA error {err}")
        return tuple(slots)

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return self._read()[self._names.index(name)]

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(zip(self._names, self._read())))

    def reset(self) -> None:
        """Set every count to 0."""
        lib = self._loaded()
        if lib is not None:
            err = lib.launch_counts_reset()
            if err != 0:
                raise RuntimeError(f"resetting the launch counts failed: CUDA error {err}")
