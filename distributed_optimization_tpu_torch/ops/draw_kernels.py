"""The card's fault and noise draws: three hand-written CUDA kernels.

No Pallas kernel stands behind them: they are the counterparts of the XLA
code that ``jax.random`` compiles to in the JAX package's fault layer
(``distributed_optimization_tpu/parallel/faults.py``) and its large-noise
attack (``parallel/adversary.py``). A draw there is a Threefry stream at
``fold_in(tag key, t)``; the twin of ``jax.random`` in ``ops/prng.py``
spends about 350 elementwise launches on one such draw inside a captured
graph, so the card takes each as one kernel:

- ``realize_round``: one round's realized graph at the device counter
  ``t``: the float32 ``A_t [N, N]`` (the surviving edges, the node mask
  applied), ``active [N]``, and where asked the one-peer proposal scores
  ``u · A_t``; or, given an ``A_t`` (the timeline's), only the scores;
- ``fault_timeline``: the per-edge Gilbert-Elliott chains, the
  crash-recovery node chains (with their rejoin rounds) and the
  participation stream over a horizon, as ``[T, E]`` / ``[T, N]`` bool;
- ``large_noise``: ``x + s·√2·erf_inv(u)`` on the Byzantine rows, ``u``
  ``jax.random.normal``'s uniform at counter i·d + j.

For CUDA tensors (``realize_round``, ``large_noise``) or a CUDA ``device``
(``fault_timeline``) each launches its kernel of ``csrc/draw_kernels.cu``
on the current stream, or raises; on the CPU it runs its plain version
(``*_plain``, in torch ops on ``ops/prng.py``), which the kernel matches
bit for bit on the card. ``t`` is the run's int64 counter of one element,
read from device memory, so a captured CUDA graph replays with the current
t. Keys are two host words each.

The shared library is built at first use by ``ops/_cuda_build.py``.
``LAUNCHES`` maps each kernel to its launches on the card, which it counts
where it runs (``_cuda_build.LaunchCounts``); the plain versions count
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from distributed_optimization_tpu_torch.ops import _cuda_build, prng

SOURCE = _cuda_build.CSRC / "draw_kernels.cu"

# In the order of the kernels' launch-count slots (csrc/draw_kernels.cu).
KERNELS = ("realize_round", "fault_timeline", "large_noise")
# The realization kernel's largest N (a grid row a block of 8 rows).
MAX_NODES = 65535


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.realize_round.argtypes = [ptr, ptr, ptr, ptr, i64, f32, f32, i32, i32, i32, ptr, ptr,
                                  ptr, ptr]
    lib.realize_round.restype = ctypes.c_int
    lib.fault_timeline.argtypes = [ptr, i64, ptr, i64, i64, i64, ptr, i64, ptr, ptr, ptr, ptr,
                                   ptr]
    lib.fault_timeline.restype = ctypes.c_int
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"large_noise_{suffix}")
        fn.argtypes = [ptr, ctypes.c_uint32, ctypes.c_uint32, ptr, ptr, ctypes.c_double, ptr,
                       i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def _words(*keys) -> "ctypes.Array":
    flat = [w & 0xFFFFFFFF for k in keys for w in k]
    return (ctypes.c_uint32 * len(flat))(*flat)


def _check_counter(t, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.numel() != 1:
        raise TypeError("t must be an int64 tensor of one element")
    if t.device != device:
        raise ValueError(f"t lies on {t.device}, the draw's tensors on {device}")


def _raise(err: int, name: str) -> None:
    if err == _cuda_build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name} refuses its arguments")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _f32(v: float) -> float:
    """A threshold as the float32 the JAX package compares in."""
    return float(np.float32(v))


# --- one round -------------------------------------------------------------------


def realize_round_plain(t, keys, base: torch.Tensor, *, drop_prob: float,
                        straggler_prob: float, directed: bool, scores: bool = False,
                        given: Optional[torch.Tensor] = None):
    """The plain version of ``realize_round``, in torch ops on ``prng``."""
    fault_key, node_key, match_key = keys
    n = base.shape[0]
    dev = base.device
    tt = t.reshape(())
    counters = torch.arange(n * n, dtype=torch.int64, device=dev).reshape(n, n)
    active = None
    if given is not None:
        a = given
    else:
        a = base.to(torch.float32)
        if drop_prob > 0.0:
            u = prng.uniform_at(prng.fold_in(fault_key, tt), counters)
            if not directed:
                u = torch.triu(u, 1)
                u = u + u.T
            a = torch.where(u >= _f32(drop_prob), a, torch.zeros_like(a))
        active = torch.ones(n, dtype=torch.float32, device=dev)
        if straggler_prob > 0.0:
            un = prng.uniform_at(prng.fold_in(node_key, tt), counters[0])
            active = (un >= _f32(straggler_prob)).to(torch.float32)
            a = a * active[:, None] * active[None, :]
    s = None
    if scores:
        s = prng.uniform_at(prng.fold_in(match_key, tt), counters) * a
    return a, active, s


def realize_round(t, keys, base: torch.Tensor, *, drop_prob: float, straggler_prob: float,
                  directed: bool, scores: bool = False, given: Optional[torch.Tensor] = None):
    """``(A_t [N, N] float32, active [N] float32, scores [N, N] float32 or
    None)`` at the counter ``t``. ``keys``: the fault, node and match tag
    keys. ``base``: the [N, N] uint8 adjacency. ``given``: a realized A_t
    (float32, contiguous) to score instead of drawing one; ``active`` is
    then None and A_t is ``given``."""
    if base.dtype != torch.uint8 or base.dim() != 2 or not base.is_contiguous():
        raise ValueError("base must be a contiguous uint8 [N, N] adjacency")
    _check_counter(t, base.device)
    if base.device.type == "cpu":
        return realize_round_plain(t, keys, base, drop_prob=drop_prob,
                                   straggler_prob=straggler_prob, directed=directed,
                                   scores=scores, given=given)
    n = base.shape[0]
    if given is not None:
        _cuda_build.check_like(given, base, "given", dtype=torch.float32)
        a, active = given, None
    else:
        a = torch.empty((n, n), dtype=torch.float32, device=base.device)
        active = torch.empty(n, dtype=torch.float32, device=base.device)
    s = torch.empty((n, n), dtype=torch.float32, device=base.device) if scores else None
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        err = _library().realize_round(
            t.data_ptr(), _words(*keys), base.data_ptr(),
            given.data_ptr() if given is not None else None, n, _f32(drop_prob),
            _f32(straggler_prob), int(drop_prob > 0.0), int(straggler_prob > 0.0),
            int(directed), None if given is not None else a.data_ptr(),
            None if given is not None else active.data_ptr(),
            s.data_ptr() if s is not None else None, stream)
    _raise(err, "realize_round")
    return a, active, s


# --- the timeline ------------------------------------------------------------------


def _chains_plain(u: torch.Tensor, init: float, enter: float, stay: float):
    """Unroll two-state chains over the draws u [T, M]: up iff u >= the
    threshold (init at t = 0, then enter after up, stay after down)."""
    ups = torch.empty(u.shape, dtype=torch.bool, device=u.device)
    up = torch.ones(u.shape[1], dtype=torch.bool, device=u.device)
    th_init, th_enter, th_stay = (torch.tensor(v, dtype=torch.float32, device=u.device)
                                  for v in (init, enter, stay))
    for s in range(u.shape[0]):
        thresh = th_init if s == 0 else torch.where(up, th_enter, th_stay)
        up = u[s] >= thresh
        ups[s] = up
    return ups


def fault_timeline_plain(keys, n: int, edges: Optional[torch.Tensor], horizon: int,
                         edge_chain=None, node_chain=None, p_out=None, *, device):
    """The plain version of ``fault_timeline``."""
    fault_key, node_key, part_key = keys
    ts = torch.arange(horizon, dtype=torch.int64, device=device)
    nodes = torch.arange(n, dtype=torch.int64, device=device)
    out = {"edge_up": None, "node_up": None, "rejoin": None, "part_up": None}
    if edges is not None:
        counters = edges[:, 0].to(torch.int64) * n + edges[:, 1].to(torch.int64)
        u = prng.uniform_at(prng.fold_in(fault_key, ts), counters)
        out["edge_up"] = _chains_plain(u, *edge_chain)
    if node_chain is not None:
        u = prng.uniform_at(prng.fold_in(node_key, ts), nodes)
        node_up = _chains_plain(u, *node_chain)
        prev = torch.cat([torch.ones_like(node_up[:1]), node_up[:-1]])
        out["node_up"], out["rejoin"] = node_up, node_up & ~prev
    if p_out is not None:
        u = prng.uniform_at(prng.fold_in(part_key, ts), nodes)
        out["part_up"] = u >= torch.tensor(p_out, dtype=torch.float32, device=device)
    return out


def fault_timeline(keys, n: int, edges: Optional[torch.Tensor], horizon: int,
                   edge_chain=None, node_chain=None, p_out=None, *, device):
    """The fault timeline over t = 0 … horizon−1 as bool tensors on
    ``device``: ``edge_up [T, E]``, ``node_up``, ``rejoin``, ``part_up`` [T,
    N], None for a process that is off. ``keys``: the fault, node and
    participation tag keys. ``edges``: the [E, 2] int32 edge list (counter
    i·N + j), with ``edge_chain`` its float32 (init, enter, stay)
    thresholds; ``node_chain`` the node chain's; ``p_out`` the
    participation threshold."""
    device = torch.device(device)
    if edges is not None:
        if edges.dtype != torch.int32 or edges.dim() != 2 or edges.shape[1] != 2:
            raise ValueError("edges must be an int32 [E, 2] tensor")
        edges = edges.to(device).contiguous()
    if device.type == "cpu":
        return fault_timeline_plain(keys, n, edges, horizon, edge_chain, node_chain, p_out,
                                    device=device)
    if horizon <= 0 or not 0 < n <= MAX_NODES:
        raise ValueError(f"fault_timeline takes 0 < N <= {MAX_NODES} and a positive horizon")
    n_edges = 0 if edges is None else edges.shape[0]
    n_nodes = 0 if node_chain is None else n
    n_part = 0 if p_out is None else n

    def buf(m):
        return torch.empty((horizon, max(m, 1)), dtype=torch.bool, device=device)

    edge_up, node_up, rejoin, part_up = buf(n_edges), buf(n_nodes), buf(n_nodes), buf(n_part)
    thresholds = [_f32(v) for v in (edge_chain or (0.0,) * 3)]
    thresholds += [_f32(v) for v in (node_chain or (0.0,) * 3)]
    thresholds.append(_f32(p_out if p_out is not None else 0.0))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().fault_timeline(
            _words(*keys), n, edges.data_ptr() if edges is not None else None, n_edges,
            n_nodes, n_part, (ctypes.c_float * 7)(*thresholds), horizon, edge_up.data_ptr(),
            node_up.data_ptr(), rejoin.data_ptr(), part_up.data_ptr(), stream)
    _raise(err, "fault_timeline")
    return {"edge_up": edge_up if n_edges else None,
            "node_up": node_up if n_nodes else None,
            "rejoin": rejoin if n_nodes else None,
            "part_up": part_up if n_part else None}


# --- the large-noise payload -------------------------------------------------------------


def large_noise_plain(key, t, byzantine: torch.Tensor, x: torch.Tensor, scale: float):
    """The plain version of ``large_noise``: ``prng.normal`` at
    ``fold_in(key, t)`` and ``torch.where``."""
    z = prng.normal(prng.fold_in(key, t.reshape(())), x.shape, x.dtype)
    s = torch.tensor(scale, dtype=x.dtype, device=x.device)
    return torch.where(byzantine.bool()[:, None], x + s * z, x)


def large_noise(key, t, byzantine: torch.Tensor, x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` with its Byzantine rows (``byzantine``: uint8 [N]) replaced by
    ``x + scale · normal(fold_in(key, t), x.shape)``, in x's dtype."""
    _cuda_build.check_stack(x)
    _check_counter(t, x.device)
    if byzantine.dtype != torch.uint8 or byzantine.shape != (x.shape[0],) \
            or byzantine.device != x.device:
        raise ValueError("byzantine must be a uint8 [N] mask on x's device")
    if x.device.type == "cpu":
        return large_noise_plain(key, t, byzantine, x, scale)
    out = torch.empty_like(x)
    _cuda_build.call(_library(), "large_noise", x, t.data_ptr(), key[0] & 0xFFFFFFFF,
                     key[1] & 0xFFFFFFFF, byzantine.data_ptr(), x.data_ptr(), float(scale),
                     out.data_ptr(), x.shape[0], x.shape[1],
                     invalid=f"large_noise takes N·d <= 2^32, got {tuple(x.shape)}")
    return out
