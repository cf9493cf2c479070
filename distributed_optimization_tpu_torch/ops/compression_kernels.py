"""The card's error-feedback compression: one hand-written CUDA kernel an exchange.

No Pallas kernel stands behind it: it is the counterpart of the XLA code
that ``distributed_optimization_tpu/ops/compression.py`` compiles to, the
estimate update ``memory + Q(v − memory)`` of one compressed gossip
exchange. ``ef_compress(compressor, draw, v, memory)`` takes the operator
(``ops/compression.py::make_compressor``), the exchange's ``Draw`` (the tag
key's two host words, the counter ``t`` and the round) and the ``[N, d]``
stacks. For CUDA tensors it launches ``csrc/compression_kernels.cu`` on the
current stream, or raises; for CPU tensors it runs the plain version
``compression.ef_compress_plain``, which the kernel matches bit for bit.
``compression='none'`` is the identity: it launches nothing on either
device. On the card ``t`` is the run's int64 counter of one element, read
from device memory, so a captured CUDA graph replays with the current ``t``.

The kernel has float32, float64 and bfloat16 instances; a bfloat16 row
rounds as ``ops/compression.py`` sets out (float32 uniforms, qsgd's
float32 sum rounded once), and the kernel equals that twin bit for bit.

top_k and random_k keep each row's k top scores, ties to the lower column:
a warp a row ranks them by counting up to 128 columns, and a block a row
finds the k-th by a radix select past that, at any width; qsgd takes a warp
a row at every width and sums the row's squares in
``compression.row_norm``'s order. The kernel takes N and d below 2³¹;
element (r, c) draws at the 64-bit counter r·d + c, split into its two
words as JAX splits the flat index. ``ef_levels`` runs the same kernel and
also returns each element's mask bit (top_k, random_k) or qsgd level, for
the tests; it counts nothing. ``levels_plain`` gives the same from the
plain version.

The shared library is built at first use by ``ops/_cuda_build.py``.
``LAUNCHES`` maps the kernel to its launches on the card, which it counts
where it runs (``_cuda_build.LaunchCounts``); the plain version counts
nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build, compression, prng

SOURCE = _cuda_build.CSRC / "compression_kernels.cu"

# In the order of the kernel's launch-count slots (csrc/compression_kernels.cu).
KERNELS = ("compress_exchange",)
# The kernel's operator codes.
MODES = {"top_k": 0, "random_k": 1, "qsgd": 2}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    # (v, memory, out, [levels,] N, d, mode, k, t, k0, k1, round, omega, stream)
    tail = [i64, i64, i64, i64, ptr, u32, u32, u32, ctypes.c_double, ptr]
    for suffix in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"ef_compress_{suffix}")
        fn.argtypes = [ptr, ptr, ptr] + tail
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"ef_levels_{suffix}")
        fn.argtypes = [ptr, ptr, ptr, ptr] + tail
        fn.restype = ctypes.c_int
    return lib


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def _check(compressor, draw, v: torch.Tensor, memory: torch.Tensor) -> None:
    """What the kernel takes: v and memory contiguous ``[N, d]`` stacks of one
    dtype on one card, N and d below 2³¹, and for the random
    operators a draw whose t is an int64 tensor of one element on that card.
    k's range is the launcher's check (csrc/compression_kernels.cu)."""
    _cuda_build.check_stack(v, "v", suffixes=_cuda_build.SUFFIX_BF16)
    _cuda_build.check_like(memory, v, "memory")
    if memory.shape != v.shape:
        raise ValueError(f"memory {tuple(memory.shape)} and v {tuple(v.shape)} differ")
    n, d = v.shape
    if n >= 2**31 or d >= 2**31:
        raise ValueError(f"the compression kernel takes N < 2³¹ and d < 2³¹, "
                         f"got N={n}, d={d}")
    if compressor.name not in MODES:
        raise ValueError(f"no compression kernel for {compressor.name!r}")
    if compressor.name != "top_k":
        if not isinstance(draw, compression.Draw):
            raise TypeError(f"{compressor.name} needs a compression.Draw")
        t = draw.t
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.numel() != 1:
            raise TypeError("the draw's t must be an int64 tensor of one element on the card")
        if t.device != v.device:
            raise ValueError(f"t lies on {t.device}, v on {v.device}")


def _launch(name: str, compressor, draw, v, memory, *extra) -> torch.Tensor:
    out = torch.empty_like(v)
    if draw is None:
        t_ptr, (k0, k1), rnd = None, (0, 0), 0
    else:
        t_ptr = draw.t.data_ptr() if isinstance(draw.t, torch.Tensor) else None
        (k0, k1), rnd = draw.tag_key, draw.round
    n, d = v.shape
    _cuda_build.call(_library(), name, v, v.data_ptr(), memory.data_ptr(), out.data_ptr(),
                     *extra, n, d, MODES[compressor.name], compressor.k, t_ptr,
                     k0 & prng.MASK32, k1 & prng.MASK32, rnd & prng.MASK32,
                     float(compressor.delta), suffixes=_cuda_build.SUFFIX_BF16,
                     invalid=f"{name} refuses N={n}, d={d}, {compressor.name} k={compressor.k}")
    return out


def ef_compress(compressor, draw, v: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """``memory + Q(v − memory)``: the estimate after one exchange."""
    if compressor.name == "none" or v.device.type == "cpu":
        return compression.ef_compress_plain(compressor, draw, v, memory)
    _check(compressor, draw, v, memory)
    return _launch("ef_compress", compressor, draw, v, memory)


def ef_levels(compressor, draw, v: torch.Tensor, memory: torch.Tensor):
    """The kernel's ``(memory⁺, levels [N, d] int32)`` on the card: each
    element's mask bit (top_k, random_k) or qsgd level low + (u < p_up).
    For the tests; counts no launch."""
    _check(compressor, draw, v, memory)
    levels = torch.empty(v.shape, dtype=torch.int32, device=v.device)
    out = _launch("ef_levels", compressor, draw, v, memory, levels.data_ptr())
    return out, levels


def levels_plain(compressor, draw, v: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """What ``ef_levels`` returns as levels, from the plain version."""
    diff = v - memory
    if compressor.name == "top_k":
        mask = compression.top_scored_mask(diff.abs(), compressor.k)
    else:
        u = compression.uniforms(draw.key(), v)
        if compressor.name == "random_k":
            mask = compression.top_scored_mask(u, compressor.k)
        else:
            mask = compression.qsgd_levels(diff, u, float(2 ** compressor.k))[1]
    return mask.to(torch.int32)
