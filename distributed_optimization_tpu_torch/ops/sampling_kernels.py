"""The card's mini-batch sampler: one hand-written CUDA kernel a gradient call.

No Pallas kernel stands behind it: it is the counterpart of the XLA code
that ``distributed_optimization_tpu/ops/sampling.py`` compiles to, on the
JAX package's random stream. ``sample_worker_batch_weights`` (the dense
form, ``[N, L]`` weights) and ``sample_batch_indices`` (the gather form,
``[N, b]`` indices and weights) take the slot key (two host words), the
iteration counter ``t`` and the shard sizes. For CUDA tensors each launches
its kernel of ``csrc/sampling_kernels.cu`` on the current stream, or raises;
for CPU tensors it calls the plain version of ``ops/sampling.py``, which
the kernel matches bit for bit. On the card ``t`` is the int64 counter of
one element that the run loop advances in place: the kernel reads it from
device memory, so a captured CUDA graph replays with the current ``t``.

The kernel derives the keys of ``fold_in(fold_in(slot_key, t), worker)``,
draws each row's uniform bits, ranks a worker's rows on their mantissas in
shared memory (one block a worker) and writes the weights, or the indices
and weights. A shard takes ``L·4`` (float32) or ``L·8`` (float64) bytes of
shared memory, plus ``min(b, L)·4`` in the gather form, up to 227 KB.

The shared library is built at first use by ``ops/_cuda_build.py``.
``LAUNCHES`` maps each kernel to its launches on the card, which the kernel
counts where it runs (``_cuda_build.LaunchCounts``); the plain versions
count nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build, sampling

SOURCE = _cuda_build.CSRC / "sampling_kernels.cu"

# In the order of the kernels' launch-count slots (csrc/sampling_kernels.cu).
KERNELS = ("sample_worker_batch_weights", "sample_batch_indices")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"sample_weights_{suffix}")
        fn.argtypes = [ptr, u32, u32, ptr, i64, i64, i64, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"sample_indices_{suffix}")
        fn.argtypes = [ptr, u32, u32, ptr, i64, i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    return lib


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def _check(slot_key, t, n_valid: torch.Tensor, n_local: int, batch_size: int,
           dtype: torch.dtype) -> None:
    """What the kernel takes: a slot key of two words, ``t`` an int64
    one-element tensor and ``n_valid`` a contiguous int64 ``[N]`` tensor,
    both on the card. Whether the shard fits in shared memory is the
    launcher's check (csrc/sampling_kernels.cu)."""
    if isinstance(slot_key, torch.Tensor) or len(slot_key) != 2:
        raise TypeError("the slot key must be two host words (ints)")
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.numel() != 1:
        raise TypeError("t must be an int64 tensor of one element on the card")
    if t.device != n_valid.device:
        raise ValueError(f"t lies on {t.device}, n_valid on {n_valid.device}")
    if n_valid.dtype != torch.int64 or n_valid.dim() != 1 or not n_valid.is_contiguous():
        raise ValueError("n_valid must be a contiguous int64 [N] tensor")
    if dtype not in _cuda_build.SUFFIX:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if n_local < 1 or batch_size < 1:
        raise ValueError(f"the shard length ({n_local}) and batch ({batch_size}) must be positive")


def _call(name: str, out: torch.Tensor, slot_key, t, n_valid, n_local, batch_size, *ptrs):
    k0, k1 = slot_key
    _cuda_build.call(_library(), name, out, t.data_ptr(), k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF,
                     n_valid.data_ptr(), n_valid.shape[0], n_local, batch_size, *ptrs,
                     invalid=f"{name} refuses a shard of {n_local} rows with a batch of "
                     f"{batch_size} in {out.dtype}: a worker's scores must fit in the shared "
                     f"memory of one block")


def sample_worker_batch_weights(slot_key, t, n_valid: torch.Tensor, n_local: int,
                                batch_size: int, dtype: torch.dtype) -> torch.Tensor:
    """``[N, L]`` weights: 1/b_eff on each worker's sampled rows, else 0."""
    if n_valid.device.type == "cpu":
        return sampling.sample_worker_batch_weights(slot_key, t, n_valid, n_local, batch_size,
                                                    dtype)
    _check(slot_key, t, n_valid, n_local, batch_size, dtype)
    w = torch.empty((n_valid.shape[0], n_local), dtype=dtype, device=n_valid.device)
    _call("sample_weights", w, slot_key, t, n_valid, n_local, batch_size, w.data_ptr())
    return w


def sample_batch_indices(slot_key, t, n_valid: torch.Tensor, n_local: int, batch_size: int,
                         dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indices [N, b] int64, weights [N, b])`` of each worker's batch."""
    if n_valid.device.type == "cpu":
        return sampling.sample_batch_indices(slot_key, t, n_valid, n_local, batch_size, dtype)
    _check(slot_key, t, n_valid, n_local, batch_size, dtype)
    n = n_valid.shape[0]
    idx = torch.empty((n, batch_size), dtype=torch.int64, device=n_valid.device)
    w = torch.empty((n, batch_size), dtype=dtype, device=n_valid.device)
    _call("sample_indices", w, slot_key, t, n_valid, n_local, batch_size, idx.data_ptr(),
          w.data_ptr())
    return idx, w
