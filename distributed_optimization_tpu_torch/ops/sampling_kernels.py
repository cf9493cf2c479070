"""The card's mini-batch sampler: one hand-written CUDA kernel a gradient call.

No Pallas kernel stands behind it: it is the counterpart of the XLA code
that ``distributed_optimization_tpu/ops/sampling.py`` compiles to, on the
JAX package's random stream. ``sample_worker_batch_weights`` (the dense
form, ``[N, L]`` weights), ``sample_worker_batches`` (the gather form: the
batch's rows ``Xb [N, b, d]``, ``yb [N, b]`` and weights ``[N, b]``, as the
JAX function of that name returns them) and ``sample_batch_indices`` (the
gather form's indices and weights) take the slot key (two host words), the
iteration counter ``t`` and the shard sizes. For CUDA tensors each launches
a kernel of ``csrc/sampling_kernels.cu`` on the current stream, or raises;
for CPU tensors it calls the plain version of ``ops/sampling.py``, which the
kernels match bit for bit. On the card ``t`` is the int64 counter of one
element that the run loop advances in place: the kernel reads it from device
memory, so a captured CUDA graph replays with the current ``t``.

The kernels derive the keys of ``fold_in(fold_in(slot_key, t), worker)``
and draw each row's uniform bits. The dense form (a shard of at most 64
rows) ranks a worker's rows in one warp; the gather form, and the dense
form of a longer shard, select each worker's top rows by a radix select on
one key a row (the score's mantissa above the reversed row index) in one
block or a thread block cluster, the keys held in registers up to 65,536 rows
and recomputed at each radix pass past that; the gather form then copies the
rows. A worker's survivors, min(b, L) + ``SURVIVOR_SLACK`` keys and rows,
live in one block's shared memory where they fit, else in a global-memory
workspace (``workspace_for``), with the same selection and the same bits;
the wrapper allocates it with its outputs (inside a captured graph, once at
capture from the graph's pool).

``select_mirror`` repeats that selection in PyTorch ops on integer scores,
for the tests; ``_select`` runs the kernel's selection on given scores on the
card. Nothing on a run's path calls either.

A bfloat16 run draws as a float32 run (its key is no x64 key): float32
scores, the float32 weight cast to bfloat16, rows copied as 2-byte values;
the weights and gather forms have bfloat16 instances, the event mode has
none. Labels go along as their bits: the run dtype's, or softmax's int32
class indices (int32 in every run dtype).

The shared library is built at first use by ``ops/_cuda_build.py``.
``LAUNCHES`` maps each kernel to its launches on the card, which the kernel
counts where it runs (``_cuda_build.LaunchCounts``); the gather form counts
under ``sample_worker_batches`` whether it writes rows or indices; the plain
versions count nothing.

The replica axis: each of the three wrappers also takes an int64 ``[R,
2]`` stack of R replicas' slot keys on the card (``prng.keys``) in place
of the two host words, and launches once for all R (the ``*_batch`` entry
points, the replica on the grid's y axis), writing ``[R, N, ...]``
outputs from the shared shards; replica r's are the single launch's with
slot key r, bit for bit, and on the CPU the plain versions take the same
stack. The workspace then holds R·N workers' survivors.

The asynchronous event clock (``backends/async_scan.py``) draws the
batches of a block of B events at the block's head: ``sample_event_block``
(the rows ``Xb [B, τ, b, d]``, ``yb [B, τ, b]`` and weights ``[B, τ, b]``
of events cursor … cursor + B − 1, τ local descents each) takes the event
clock's base key (two host words, ``sampling.event_key``), the event cursor
(an int64 one-element tensor) and the schedule's int64 ``[E]`` worker and
step arrays, and writes into a buffer of the run (``event_block_buffer``),
whose event e, descent m is a static view. An event's batch depends on its
worker, its step and the descent alone, never on the models, so the block
is drawn before its first event. On the card one launch of the gather
kernel's event mode, a block of the grid a draw: each reads the cursor,
its event's worker and step, derives the key and selects and gathers the
rows, the bits of one launch an event. ``sample_event_batch`` (``[1, b,
d]``, ``[1, b]``, ``[1, b]``) and ``event_batch_indices`` (the indices and
weights ``[b]``) are the block entry at B = 1. All count under
``sample_event_block``. On the CPU the plain versions of
``ops/sampling.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build, sampling

SOURCE = _cuda_build.CSRC / "sampling_kernels.cu"

# In the order of the kernels' launch-count slots (csrc/sampling_kernels.cu).
KERNELS = ("sample_worker_batch_weights", "sample_worker_batches", "sample_event_block")

# The kernels' constants (csrc/sampling_kernels.cu).
BINS = 256              # a radix digit of 8 bits
SURVIVOR_SLACK = 128    # survivors beyond k that end the radix passes
# Bits of the selection key's score, the mantissa plus one: 2^23 (float32)
# and 2^52 (float64) at most. They follow the key, not the run dtype: a
# bfloat16 run draws float32 scores.
SCORE_BITS = {torch.float32: 24, torch.float64: 53, torch.bfloat16: 24}
# The C entry points' instances: the weights and gather forms in three
# dtypes, the event mode in float32 and float64.
SUFFIX = _cuda_build.SUFFIX_BF16
EVENT_SUFFIX = _cuda_build.SUFFIX
# The label dtypes besides the run dtype: softmax's int32 class indices.
LABEL_DTYPES = (torch.int32,)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    head = [ptr, u32, u32, ptr, i64, i64, i64]  # t, k0, k1, n_valid, N, L, b
    batch_head = [ptr, ptr, i64, ptr, i64, i64, i64]  # t, keys, R, n_valid, N, L, b
    for suffix in SUFFIX.values():
        # sample_batches: ..., d, X, y, w, Xb, yb, y_bytes
        for name, rest in (("sample_weights", [ptr]), ("sample_indices", [ptr, ptr]),
                           ("sample_batches", [i64, ptr, ptr, ptr, ptr, ptr, i64])):
            for form, first in (("", head), ("_batch", batch_head)):
                fn = getattr(lib, f"{name}{form}_{suffix}")
                fn.argtypes = first + rest + [ptr, ptr]  # ..., workspace, stream
                fn.restype = ctypes.c_int
        if suffix in EVENT_SUFFIX.values():
            fn = getattr(lib, f"sample_event_{suffix}")
            # cursor, workers, steps, n_events, events, tau, descent, k0, k1,
            # n_valid, L, b, d, X, y, idx, w, Xb, yb, y_bytes, xstride,
            # vstride, workspace, stream
            fn.argtypes = ([ptr] * 3 + [i64] * 4 + [u32, u32, ptr] + [i64] * 3 + [ptr] * 6
                           + [i64, i64, i64, ptr, ptr])
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"select_top_{suffix}")
        fn.argtypes = [ptr, i64, i64, i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"select_workspace_bytes_{suffix}")
        fn.argtypes = [i64, i64, i64]
        fn.restype = ctypes.c_int64
    return lib


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def _check(slot_key, t, n_valid: torch.Tensor, n_local: int, batch_size: int,
           dtype: torch.dtype) -> None:
    """What the kernels take: a slot key of two words (or a contiguous int64
    ``[R, 2]`` stack of them on the card, 1 <= R <= 65,535), ``t`` an int64
    one-element tensor and ``n_valid`` a contiguous int64 ``[N]`` tensor,
    both on the card."""
    if sampling.stacked(slot_key):
        if (slot_key.dtype != torch.int64 or slot_key.shape[1] != 2
                or not 1 <= slot_key.shape[0] <= 65535 or not slot_key.is_contiguous()
                or slot_key.device != n_valid.device):
            raise ValueError("a stack of slot keys must be a contiguous int64 [R, 2] tensor "
                             "(1 <= R <= 65,535) on n_valid's card")
    elif isinstance(slot_key, torch.Tensor) or len(slot_key) != 2:
        raise TypeError("the slot key must be two host words (ints) or an [R, 2] stack")
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.numel() != 1:
        raise TypeError("t must be an int64 tensor of one element on the card")
    if t.device != n_valid.device:
        raise ValueError(f"t lies on {t.device}, n_valid on {n_valid.device}")
    if n_valid.dtype != torch.int64 or n_valid.dim() != 1 or not n_valid.is_contiguous():
        raise ValueError("n_valid must be a contiguous int64 [N] tensor")
    _cuda_build.check_dtype(dtype, SUFFIX, "the sampler's dtype")
    if n_local < 1 or batch_size < 1:
        raise ValueError(f"the shard length ({n_local}) and batch ({batch_size}) must be positive")


def workspace_for(n: int, n_local: int, batch_size: int, dtype: torch.dtype,
                  device) -> torch.Tensor | None:
    """The global-memory workspace that a launch over ``n`` workers of
    ``n_local`` rows and batch ``batch_size`` needs on ``device`` (a card),
    or None where every worker's survivors fit in shared memory. Each
    wrapper allocates it with its outputs."""
    size = _workspace_bytes(n, n_local, batch_size, dtype)
    return torch.empty(size, dtype=torch.uint8, device=device) if size else None


@functools.lru_cache(maxsize=64)
def _workspace_bytes(n: int, n_local: int, batch_size: int, dtype: torch.dtype) -> int:
    if n < 1 or n_local < 1 or batch_size < 1:
        return 0
    return getattr(_library(), f"select_workspace_bytes_{SUFFIX[dtype]}")(
        n, n_local, batch_size)


def _lead(slot_key) -> tuple:
    """The outputs' leading shape: (R,) for a stack of slot keys, else ()."""
    return (slot_key.shape[0],) if sampling.stacked(slot_key) else ()


def _call(name: str, out: torch.Tensor, slot_key, t, n_valid, n_local, batch_size, *args):
    replicas = _lead(slot_key)
    workspace = workspace_for(math.prod(replicas) * n_valid.shape[0], n_local, batch_size,
                              out.dtype, n_valid.device)
    if replicas:
        name, words = name + "_batch", (slot_key.data_ptr(), replicas[0])
    else:
        words = (slot_key[0] & 0xFFFFFFFF, slot_key[1] & 0xFFFFFFFF)
    _cuda_build.call(_library(), name, out, t.data_ptr(), *words,
                     n_valid.data_ptr(), n_valid.shape[0], n_local, batch_size, *args,
                     workspace.data_ptr() if workspace is not None else None,
                     invalid=f"{name} refuses a shard of {n_local} rows with a batch of "
                             f"{batch_size} in {out.dtype}", suffixes=SUFFIX)


def sample_worker_batch_weights(slot_key, t, n_valid: torch.Tensor, n_local: int,
                                batch_size: int, dtype: torch.dtype) -> torch.Tensor:
    """``[N, L]`` weights: 1/b_eff on each worker's sampled rows, else 0
    (``[R, N, L]`` for a stack of R slot keys)."""
    if n_valid.device.type == "cpu":
        return sampling.sample_worker_batch_weights(slot_key, t, n_valid, n_local, batch_size,
                                                    dtype)
    _check(slot_key, t, n_valid, n_local, batch_size, dtype)
    w = torch.empty(_lead(slot_key) + (n_valid.shape[0], n_local), dtype=dtype,
                    device=n_valid.device)
    _call("sample_weights", w, slot_key, t, n_valid, n_local, batch_size, w.data_ptr())
    return w


def sample_batch_indices(slot_key, t, n_valid: torch.Tensor, n_local: int, batch_size: int,
                         dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indices [N, b] int64, weights [N, b])`` of each worker's batch
    (each ``[R, N, b]`` for a stack of R slot keys)."""
    if n_valid.device.type == "cpu":
        return sampling.sample_batch_indices(slot_key, t, n_valid, n_local, batch_size, dtype)
    _check(slot_key, t, n_valid, n_local, batch_size, dtype)
    shape = _lead(slot_key) + (n_valid.shape[0], batch_size)
    idx = torch.empty(shape, dtype=torch.int64, device=n_valid.device)
    w = torch.empty(shape, dtype=dtype, device=n_valid.device)
    _call("sample_indices", w, slot_key, t, n_valid, n_local, batch_size, idx.data_ptr(),
          w.data_ptr())
    return idx, w


def sample_worker_batches(slot_key, t, X: torch.Tensor, y: torch.Tensor, n_valid: torch.Tensor,
                          batch_size: int):
    """``(Xb [N, b, d], yb [N, b], weights [N, b])``: each worker's batch,
    its rows gathered from the shards ``X [N, L, d]`` and ``y [N, L]``
    (``[R, N, ...]`` for a stack of R slot keys, from the same shards)."""
    if n_valid.device.type == "cpu":
        return sampling.sample_worker_batches(slot_key, t, X, y, n_valid, batch_size)
    _check_shards(X, y, n_valid)
    n, n_local, d = X.shape
    _check(slot_key, t, n_valid, n_local, batch_size, X.dtype)
    lead = _lead(slot_key)
    Xb = torch.empty(lead + (n, batch_size, d), dtype=X.dtype, device=X.device)
    yb = torch.empty(lead + (n, batch_size), dtype=y.dtype, device=X.device)
    w = torch.empty(lead + (n, batch_size), dtype=X.dtype, device=X.device)
    _call("sample_batches", w, slot_key, t, n_valid, n_local, batch_size, d,
          X.data_ptr(), y.data_ptr(), w.data_ptr(), Xb.data_ptr(), yb.data_ptr(),
          y.element_size())
    return Xb, yb, w


def _check_event(base_key, cursor, workers, steps, n_valid: torch.Tensor, n_local: int,
                 batch_size: int, dtype: torch.dtype, events: int, descents) -> None:
    """What the event mode takes: a base key of two host words, the cursor
    an int64 one-element tensor and the schedule's worker and step arrays
    contiguous int64 [E] tensors, all on n_valid's card; B >= 1 events and
    descents None or (first, count)."""
    if isinstance(base_key, torch.Tensor) or len(base_key) != 2:
        raise TypeError("the event clock's base key must be two host words (ints)")
    for name, v in (("cursor", cursor), ("workers", workers), ("steps", steps)):
        if (not isinstance(v, torch.Tensor) or v.dtype != torch.int64 or v.dim() != 1
                or not v.is_contiguous() or v.device != n_valid.device):
            raise ValueError(f"{name} must be a contiguous int64 [E] tensor on n_valid's card")
    if cursor.numel() != 1 or workers.shape != steps.shape:
        raise ValueError("the cursor holds one element; workers and steps one an event")
    if n_valid.dtype != torch.int64 or n_valid.dim() != 1 or not n_valid.is_contiguous():
        raise ValueError("n_valid must be a contiguous int64 [N] tensor")
    _cuda_build.check_dtype(dtype, EVENT_SUFFIX, "the event sampler's dtype")
    if n_local < 1 or batch_size < 1:
        raise ValueError(f"the shard length ({n_local}) and batch ({batch_size}) must be positive")
    first, count = (-1, 1) if descents is None else descents
    if events < 1 or count < 1 or events * count >= 2**31:
        raise ValueError(f"a block takes 1 <= B·τ < 2^31 draws, got B={events}, τ={count}")
    if descents is not None and not 0 <= first <= 2**31 - 1 - count:
        raise ValueError(f"descents must lie in [0, 2^31), got {first} … {first + count - 1}")


# Each draw's outputs in an event block start this many bytes apart at least,
# the alignment a fresh tensor of its own has (cuBLAS picks its kernel by it).
EVENT_ALIGN = 256


class EventBlock(NamedTuple):
    """A block's batches, ``Xb [B, τ, b, d]``, ``yb [B, τ, b]`` and ``w [B,
    τ, b]``: views of padded storage, each draw's rows EVENT_ALIGN-aligned
    (``Xb[e, m]`` is a contiguous [b, d]); yb in the labels' dtype, its
    draws as many elements apart as w's."""

    Xb: torch.Tensor
    yb: torch.Tensor
    w: torch.Tensor


def _padded(width: int, dtype: torch.dtype) -> int:
    """Elements from one draw's output of ``width`` elements to the next."""
    per = EVENT_ALIGN // torch.empty((), dtype=dtype).element_size()
    return -(-width // per) * per


def event_block_buffer(events: int, tau: int, batch_size: int, d: int, dtype: torch.dtype,
                       device, label_dtype: torch.dtype | None = None) -> EventBlock:
    """The buffer a run's blocks of ``events`` events at ``tau`` draws each
    write into (allocated once a run); the labels in ``label_dtype``
    (``dtype`` by default)."""
    draws = events * tau

    def part(width, shape, kind=dtype):
        store = torch.empty((draws, _padded(width, dtype)), dtype=kind, device=device)
        return store[:, :width].view(events, tau, *shape)

    return EventBlock(part(batch_size * d, (batch_size, d)),
                      part(batch_size, (batch_size,), label_dtype or dtype),
                      part(batch_size, (batch_size,)))


def _event_launch(base_key, cursor, workers, steps, X, y, n_valid, n_local, batch_size, d,
                  events, descents, idx, w, Xb, yb, xstride, vstride):
    first, count = (-1, 1) if descents is None else descents
    workspace = workspace_for(events * count, n_local, batch_size, w.dtype, n_valid.device)
    _cuda_build.call(_library(), "sample_event", w, cursor.data_ptr(), workers.data_ptr(),
                     steps.data_ptr(), workers.shape[0], events, count, first,
                     base_key[0] & 0xFFFFFFFF, base_key[1] & 0xFFFFFFFF, n_valid.data_ptr(),
                     n_local, batch_size, d, *(v.data_ptr() if v is not None else None
                                               for v in (X, y, idx, w, Xb, yb)),
                     y.element_size() if y is not None else 0, xstride, vstride,
                     workspace.data_ptr() if workspace is not None else None,
                     invalid=f"sample_event refuses a shard of {n_local} rows with a batch of "
                             f"{batch_size} in {w.dtype}", suffixes=EVENT_SUFFIX)


def _check_shards(X: torch.Tensor, y: torch.Tensor, n_valid: torch.Tensor) -> None:
    """X a contiguous [N, L, d] stack; y contiguous [N, L] labels in X's
    dtype or int32 (softmax's class indices), on X's device."""
    if X.dim() != 3 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous [N, L, d] tensor, got shape {tuple(X.shape)}")
    _cuda_build.check_like(y, X, "y", dtype=y.dtype if y.dtype in LABEL_DTYPES else None)
    n, n_local, _ = X.shape
    if y.shape != (n, n_local) or n_valid.shape[0] != n or X.device != n_valid.device:
        raise ValueError(f"X {tuple(X.shape)}, y {tuple(y.shape)} and n_valid "
                         f"{tuple(n_valid.shape)} must share N and L and lie on one card")


def _check_buffer(out: EventBlock, events: int, tau: int, b: int, d: int, X, y) -> None:
    """``out`` is ``event_block_buffer(events, tau, b, d)`` of X's dtype (its
    labels of y's) on X's device: each draw's Xb a contiguous [b, d], every
    draw ``stride(0) / tau`` elements after the one before (yb's and w's
    alike)."""
    ok = all(part.dtype == kind and part.device == X.device and part.stride(0) % tau == 0
             and (tau == 1 or part.stride(1) * tau == part.stride(0))
             for part, kind in zip(out, (X.dtype, y.dtype, X.dtype)))
    ok = ok and out.Xb.shape == (events, tau, b, d) and out.Xb.stride()[2:] == (d, 1)
    ok = ok and all(part.shape == (events, tau, b) and part.stride(2) == 1
                    for part in out[1:]) and out.yb.stride(0) == out.w.stride(0)
    if not ok:
        raise ValueError(f"out must be event_block_buffer({events}, {tau}, {b}, {d}, "
                         f"{X.dtype}) on {X.device}")


def sample_event_block(base_key, cursor, workers, steps, X: torch.Tensor, y: torch.Tensor,
                       n_valid: torch.Tensor, batch_size: int, events: int,
                       descents: int | None = None, out: EventBlock | None = None) -> EventBlock:
    """The batches of events ``cursor`` … ``cursor + events − 1`` (B =
    ``events``), each gathered from its worker's shard of ``X [N, L, d]``,
    ``y [N, L]``: ``descents`` None draws once an event with no descent
    folded in (τ = 1), an int τ draws descents 0 … τ − 1; into ``out``
    (``event_block_buffer``, else a new one). Event e, descent m is
    ``sample_event_batch`` at cursor + e (descent m), bit for bit. One
    launch on the card; the block must lie within the schedule."""
    tau = 1 if descents is None else int(descents)
    d = X.shape[-1]
    if n_valid.device.type != "cpu":
        _check_shards(X, y, n_valid)
        _check_event(base_key, cursor, workers, steps, n_valid, X.shape[1], batch_size, X.dtype,
                     events, None if descents is None else (0, tau))
    if out is None:
        out = event_block_buffer(events, tau, batch_size, d, X.dtype, X.device, y.dtype)
    _check_buffer(out, events, tau, batch_size, d, X, y)
    if n_valid.device.type == "cpu":
        for part, plain in zip(out, sampling.sample_event_block(
                base_key, cursor, workers, steps, X, y, n_valid, batch_size, events, descents)):
            part.copy_(plain)
        return out
    _event_launch(base_key, cursor, workers, steps, X, y, n_valid, X.shape[1], batch_size, d,
                  events, None if descents is None else (0, tau), None, out.w, out.Xb, out.yb,
                  out.Xb.stride(0) // tau, out.w.stride(0) // tau)
    return out


def event_batch_indices(base_key, cursor, workers, steps, n_valid: torch.Tensor, n_local: int,
                        batch_size: int, dtype: torch.dtype, descent: int | None = None):
    """``(indices [b] int64, weights [b])`` of event ``cursor``'s batch, on
    its worker's and step's key (``descent`` folded in after, where given):
    the block entry at B = 1, with no rows gathered."""
    if n_valid.device.type == "cpu":
        return sampling.event_batch_indices(base_key, cursor, workers, steps, n_valid, n_local,
                                            batch_size, dtype, descent)
    descents = None if descent is None else (descent, 1)
    _check_event(base_key, cursor, workers, steps, n_valid, n_local, batch_size, dtype, 1,
                 descents)
    idx = torch.empty(batch_size, dtype=torch.int64, device=n_valid.device)
    w = torch.empty(batch_size, dtype=dtype, device=n_valid.device)
    _event_launch(base_key, cursor, workers, steps, None, None, n_valid, n_local, batch_size, 0,
                  1, descents, idx, w, None, None, 0, batch_size)
    return idx, w


def sample_event_batch(base_key, cursor, workers, steps, X: torch.Tensor, y: torch.Tensor,
                       n_valid: torch.Tensor, batch_size: int, descent: int | None = None):
    """``(Xb [1, b, d], yb [1, b], weights [1, b])``: event ``cursor``'s
    batch gathered from its worker's shard of ``X [N, L, d]``, ``y [N, L]``
    (the block entry at B = 1: one launch on the card)."""
    if n_valid.device.type == "cpu":
        return sampling.sample_event_batch(base_key, cursor, workers, steps, X, y, n_valid,
                                           batch_size, descent)
    _check_shards(X, y, n_valid)
    n, n_local, d = X.shape
    descents = None if descent is None else (descent, 1)
    _check_event(base_key, cursor, workers, steps, n_valid, n_local, batch_size, X.dtype, 1,
                 descents)
    Xb = torch.empty((1, batch_size, d), dtype=X.dtype, device=X.device)
    yb = torch.empty((1, batch_size), dtype=y.dtype, device=X.device)
    w = torch.empty((1, batch_size), dtype=X.dtype, device=X.device)
    _event_launch(base_key, cursor, workers, steps, X, y, n_valid, n_local, batch_size, d, 1,
                  descents, None, w, Xb, yb, batch_size * d, batch_size)
    return Xb, yb, w


def _select(scores: torch.Tensor, batch_size: int, dtype: torch.dtype,
            cluster: int = 0) -> torch.Tensor:
    """The gather kernel's selection on given integer ``scores [N, L]`` (0 on
    padding rows, at most 2^(SCORE_BITS − 1)): the top min(b, L) rows of each
    worker, tiled to ``[N, b]``, under the launcher's plan or, with
    ``cluster`` 2, 4 or 8, a thread block cluster of that many blocks a
    worker. For the tests and the plan's measurement; counts no launch."""
    if scores.dtype != torch.int64 or scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous int64 [N, L] tensor")
    n, n_local = scores.shape
    idx = torch.empty((n, batch_size), dtype=torch.int64, device=scores.device)
    like = torch.empty(0, dtype=dtype, device=scores.device)
    workspace = workspace_for(n, n_local, batch_size, dtype, scores.device)
    _cuda_build.call(_library(), "select_top", like, scores.data_ptr(), n, n_local, batch_size,
                     cluster, idx.data_ptr(),
                     workspace.data_ptr() if workspace is not None else None,
                     invalid=f"select_top refuses N={n}, L={n_local}, b={batch_size}, "
                             f"cluster {cluster}", suffixes=SUFFIX)
    return idx


# --- a mirror of the kernels' selection, in PyTorch ops --------------------------

_LIMB = 0xFFFFFFFF


def draw_scores(slot_key, t, n_valid: torch.Tensor, n_local: int, dtype) -> torch.Tensor:
    """The kernels' integer scores ``[N, L]``: the draw's mantissa plus one
    (m = u·2^23 in float32, u·2^52 in float64, exact), 0 on padding rows."""
    u = sampling.masked_scores(slot_key, t, n_valid, n_local, dtype)
    m = (torch.where(torch.isinf(u), 0.0, u) * 2.0 ** (SCORE_BITS[dtype] - 1)).long()
    return torch.where(torch.isinf(u), 0, m + 1)


def _limb(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Bits 0..31 of ``x << shift`` (a right shift where negative), x ≥ 0."""
    if shift >= 32 or shift <= -63:
        return torch.zeros_like(x)
    if shift >= 0:
        return (x & (_LIMB >> shift)) << shift
    return (x >> -shift) & _LIMB


def selection_keys(scores: torch.Tensor, dtype) -> tuple[list[torch.Tensor], int]:
    """The key of each row, score above L − 1 − row in ⌈log2 L⌉ bits,
    left-aligned in a word of 64 bits (128 where they do not fit, float64
    past L = 2,048): (the word's 32-bit limbs, least significant first, as
    int64 tensors; the width)."""
    n_local = scores.shape[-1]
    score_bits, row_bits = SCORE_BITS[dtype], (n_local - 1).bit_length()
    width = 64 if score_bits + row_bits <= 64 else 128
    rev = (n_local - 1 - torch.arange(n_local, device=scores.device)).expand_as(scores)
    limbs = [_limb(scores, width - score_bits - 32 * j) | _limb(rev, width - score_bits
                                                               - row_bits - 32 * j)
             for j in range(width // 32)]
    return limbs, width


def _greater(limbs_a, limbs_b) -> torch.Tensor:
    """a > b for keys given by limbs (most significant compared first)."""
    gt = torch.zeros(torch.broadcast_shapes(limbs_a[0].shape, limbs_b[0].shape), dtype=torch.bool)
    eq = torch.ones_like(gt)
    for a, b in zip(reversed(limbs_a), reversed(limbs_b)):
        gt |= eq & (a > b)
        eq &= a == b
    return gt


def _select_worker(limbs, width: int, need: int, valid: int) -> tuple[torch.Tensor, int]:
    """One worker's top ``need`` rows among its first ``valid`` in order,
    and the radix passes taken (0 where nothing is selected)."""
    if need == 0:
        return torch.empty(0, dtype=torch.int64), 0
    n_local = limbs[0].shape[0]
    candidate = torch.arange(n_local) < valid
    above_mask = torch.zeros(n_local, dtype=torch.bool)
    krem, p, passes = need, width - 8, 0
    while True:
        passes += 1
        digit = (limbs[p // 32] >> (p % 32)) & 0xFF
        hist = torch.bincount(digit[candidate], minlength=BINS)
        from_top = hist.flip(0).cumsum(0).flip(0)  # candidates in bins >= B
        B = int(torch.nonzero(from_top >= krem).max())
        above = int(from_top[B] - hist[B])
        survivors = need - krem + int(from_top[B])
        if survivors <= need + SURVIVOR_SLACK or p == 0:
            chosen = above_mask | (candidate & (digit >= B))
            break
        above_mask |= candidate & (digit > B)
        candidate &= digit == B
        krem -= above
        p -= 8
    rows = torch.nonzero(chosen).flatten()
    keys = [limb[rows] for limb in limbs]
    rank = _greater([k[None, :] for k in keys], [k[:, None] for k in keys]).sum(1)
    top = torch.empty(need, dtype=torch.int64)
    keep = rank < need
    top[rank[keep]] = rows[keep]
    return top, passes


def select_mirror(scores: torch.Tensor, batch_size: int, dtype,
                  n_valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather kernel's selection repeated in PyTorch ops on integer
    ``scores [N, L]`` (CPU): ``(indices [N, b], radix passes [N])``, the
    top k = min(b, L) rows of each worker tiled up to b. With ``n_valid``
    (the draw's case, ``draw_scores``), only a worker's first n_valid rows
    are selected among, and its padding rows follow in ascending order;
    without it (``_select``'s case) every row takes part."""
    n, n_local = scores.shape
    k = min(batch_size, n_local)
    limbs, width = selection_keys(scores, dtype)
    tops, passes = [], []
    for i in range(n):
        valid = n_local if n_valid is None else max(0, min(int(n_valid[i]), n_local))
        need = min(k, valid)
        top, taken = _select_worker([limb[i] for limb in limbs], width, need, valid)
        tops.append(torch.cat([top, torch.arange(need, k)]))
        passes.append(taken)
    indices = torch.stack(tops)[:, torch.arange(batch_size) % k]
    return indices, torch.tensor(passes)
