"""Fused robust gossip kernels: hand-written CUDA for Hopper, and their plain
twins.

Ports of the Pallas TPU kernels in
``distributed_optimization_tpu/ops/pallas_kernels.py``:

- ``make_fused_robust_aggregator`` (:410) → ``aggregate(live, x)``: gather
  the neighbours through the static ``[N, k_max]`` table, screen the closed
  neighbourhood (trimmed mean, median or self-centred clipping) and mix,
  in one kernel;
- ``make_fused_robust_dsgd_step`` (:430) → ``step(live, x, g, eta)``: the
  same, then ``− η·g``: the whole robust D-SGD update.

For a CUDA tensor the returned function launches the kernel of
``csrc/robust_kernels.cu`` on the current stream, or raises; for a CPU
tensor it runs ``fused_robust_plain``, which follows the Pallas body
(``_fused_robust_body`` :263) term for term in torch ops: the odd-even
transposition network in ``torch.minimum``/``torch.maximum``, one-hot rank
picks, and sums over the slot axis as loops in slot order. The kernel
sorts a column without NaN by Batcher's odd-even merge network instead
(``merge_network`` is its compare-exchange list) and a column with one by
the transposition network; it matches the plain version bit for bit for
the count rules all the same. Clipping's norm is a reduction over d with
no fixed order, so there the two agree to a tolerance.

bfloat16 rows (``fused_robust_bf16``) screen in float32, as the Pallas
body does (promote(float32, bfloat16)): the twin widens them, runs the
float32 screen, rounds the aggregate once to bfloat16, and the D-SGD form
subtracts ``eta * g`` in bfloat16, each operation rounded; τ stays
float32 and η is bfloat16. The kernel rounds the same way, bit for bit for
the count rules.

The factories run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise when no card is visible. ``LAUNCHES`` maps each factory name to
its kernel's launches on the card, which the kernel counts where it runs
(``_cuda_build.LaunchCounts``): graph replays count; the plain versions do
not.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from distributed_optimization_tpu_torch.backends.base import resolve_device
from distributed_optimization_tpu_torch.ops import _cuda_build
from distributed_optimization_tpu_torch.ops.robust_aggregation import check_rule, is_adaptive

SOURCE = _cuda_build.CSRC / "robust_kernels.cu"
# In the order of the kernels' launch-count slots (csrc/robust_kernels.cu).
KERNELS = ("make_fused_robust_aggregator", "make_fused_robust_dsgd_step")

# The widest sort network the count rules (closed neighbourhood, k_max + 1)
# and the adaptive radius (k_max norms) may take: the JAX package's bound;
# the count-rule kernel holds the column in a register array.
FUSED_MAX_SORT_WIDTH = 16
COUNT_RULES = ("trimmed_mean", "median")
_RULE_CODE = {"trimmed_mean": 0, "median": 1, "clipped_gossip": 2}
# Clipping tables wider than a warp take one block a row, with four [k_max]
# arrays of the working type and the [k_max] indices in shared memory; room
# for five leaves a margin within the 48 KiB a launch gets without opting in.
_MAX_CLIP_SLOTS = (48 * 1024 - 16) // (5 * 8 + 4)


def fused_robust_supported(name: str, k_max: int, clip_tau=0.0) -> bool:
    """Does the fused kernel take ``name`` at this maximum degree? The count
    rules need k_max + 1 <= FUSED_MAX_SORT_WIDTH; adaptive clipping ranks
    k_max norms, held to the same bound; fixed clipping ranks nothing."""
    if name not in _RULE_CODE:
        return False
    if name == "clipped_gossip":
        return not is_adaptive(name, clip_tau) or k_max <= FUSED_MAX_SORT_WIDTH
    return (k_max + 1) <= FUSED_MAX_SORT_WIDTH


def merge_network(width: int) -> list[tuple[int, int]]:
    """Batcher's odd-even merge sort network for ``width`` values as a list
    of compare-exchanges (lo, hi): the Python mirror of the list the CUDA
    kernel generates at compile time (63 at width 16)."""
    pairs = []
    p = 1
    while p < width:
        k = p
        while k >= 1:
            for j in range(k % p, width - k, 2 * k):
                for i in range(min(k, width - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


# --- plain PyTorch version ------------------------------------------------------


def sort_columns(v: torch.Tensor) -> torch.Tensor:
    """Ascending sort along dim 1 by the odd-even transposition network:
    ``width`` passes of compare-exchanges in torch.minimum/maximum."""
    cols = list(v.unbind(1))
    width = len(cols)
    for parity in range(width):
        for i in range(parity % 2, width - 1, 2):
            lo = torch.minimum(cols[i], cols[i + 1])
            hi = torch.maximum(cols[i], cols[i + 1])
            cols[i], cols[i + 1] = lo, hi
    return torch.stack(cols, dim=1)


def _pick(sel_positions: torch.Tensor, cols) -> torch.Tensor:
    """Σ_s where(position == s, col_s, 0) in slot order: a one-hot pick."""
    out = torch.zeros_like(cols[0])
    for s, col in enumerate(cols):
        out = out + torch.where(sel_positions == s, col, 0.0)
    return out


def _adaptive_tau(lv, norms, budget: int, k_max: int) -> torch.Tensor:
    """The (deg−b)-th smallest masked norm per row (0 where deg ≤ b), ranked
    by the network and picked one-hot (``_kernel_adaptive_clip_tau``)."""
    deg = torch.sum(lv, dim=1)
    ranked = sort_columns(torch.where(lv > 0, norms, torch.inf))
    k = torch.clamp(deg - budget - 1.0, 0.0, float(k_max - 1))
    kth = _pick(k, ranked.unbind(1))
    return torch.where(deg - budget >= 1.0, kth, 0.0)


def fused_robust_plain(
    name: str,
    budget: int,
    nbr: torch.Tensor,
    live: torch.Tensor,
    x: torch.Tensor,
    tau: torch.Tensor,
    *,
    adaptive: bool,
    g: Optional[torch.Tensor] = None,
    eta: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The screen (and, with ``g``, the D-SGD update) of
    ``_fused_robust_body`` in torch ops. ``nbr`` [N, k_max] int64."""
    acc = torch.promote_types(torch.float32, x.dtype)
    xa = x.to(acc)
    lv = live.to(acc)
    k_max = nbr.shape[1]
    if name in COUNT_RULES:
        vals = torch.where(lv[:, :, None] > 0, xa[nbr], torch.inf)
        cols = sort_columns(torch.cat([xa[:, None, :], vals], dim=1)).unbind(1)
        counts = torch.sum(lv, dim=1) + 1.0
        if name == "trimmed_mean":
            upper = counts - budget
            kept = torch.clamp(counts - 2 * budget, min=0.0)
            total = torch.zeros_like(xa)
            for s, col in enumerate(cols):
                keep = (upper > s) & (s >= budget)
                total = total + torch.where(keep[:, None], col, 0.0)
            mean = total / torch.clamp(kept, min=1.0)[:, None]
            agg = torch.where((kept >= 1.0)[:, None], mean, xa)
        else:
            lo = torch.clamp(torch.floor((counts - 1.0) / 2.0), min=0.0)
            hi = torch.clamp(torch.floor(counts / 2.0), min=0.0)
            agg = 0.5 * (_pick(lo[:, None], cols) + _pick(hi[:, None], cols))
    else:
        diffs = xa[nbr] - xa[:, None, :]
        norms = torch.sqrt(torch.sum(diffs * diffs, dim=-1))
        deg = torch.sum(lv, dim=1)
        if adaptive:
            tau_row = _adaptive_tau(lv, norms, budget, k_max)
        else:
            tau_row = tau.to(acc).expand(x.shape[0])
        w = lv / (1.0 + torch.maximum(deg[:, None], deg[nbr]))
        one = torch.ones((), dtype=acc, device=x.device)
        factor = torch.minimum(one, tau_row[:, None] / torch.clamp(norms, min=torch.finfo(acc).tiny))
        moved = torch.zeros_like(xa)
        for s in range(k_max):
            moved = moved + (w[:, s, None] * diffs[:, s]) * factor[:, s, None]
        agg = xa + moved
    out = agg.to(x.dtype)
    if g is not None:
        out = out - eta * g
    return out


# --- build, load and launch -------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of ``fused_robust_f32``/``_f64``/``_bf16``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for suffix in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"fused_robust_{suffix}")
        fn.argtypes = [i32, i32, i32, i32] + [ptr] * 7 + [i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_cuda_build.load(SOURCE))


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, _library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def launch(lib: ctypes.CDLL, name: str, budget: int, adaptive: bool, nbr32, live, x, tau,
           g=None, eta=None) -> torch.Tensor:
    """Launch the screen ``name`` of ``lib`` (as ``bind`` declares it) on
    CUDA tensors, with ``g`` and ``eta`` for the D-SGD step; returns its
    output. Checks nothing."""
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() if t is not None else None for t in (nbr32, live, x, tau, g, eta, out)]
    _cuda_build.call(lib, "fused_robust", x, _RULE_CODE[name], budget, int(adaptive),
                     nbr32.shape[1], *ptrs, x.shape[0], x.shape[1],
                     suffixes=_cuda_build.SUFFIX_BF16)
    return out


def _make_fused_robust(name: str, budget: int, nbr_idx, clip_tau, *, with_sgd: bool,
                       device: torch.device | str):
    check_rule(name, budget)
    nbr_host = np.asarray(nbr_idx, dtype=np.int32)
    if nbr_host.ndim != 2 or nbr_host.size == 0:
        raise ValueError(f"nbr_idx must be a non-empty [N, k_max] table, got {nbr_host.shape}")
    if nbr_host.min() < 0 or nbr_host.max() >= nbr_host.shape[0]:
        raise ValueError(f"nbr_idx entries must lie in [0, N={nbr_host.shape[0]})")
    k_max = nbr_host.shape[1]
    if not fused_robust_supported(name, k_max, clip_tau):
        raise ValueError(
            f"robust_impl='fused' cannot screen {name!r} at k_max={k_max}: "
            f"the in-kernel sort network is bounded at width "
            f"{FUSED_MAX_SORT_WIDTH} (the closed neighborhood for the "
            "count rules; the adaptive-radius norm ranking for clipping) "
            "— use robust_impl='gather', or a fixed clip_tau for clipping"
        )
    if name == "clipped_gossip" and k_max > _MAX_CLIP_SLOTS:
        raise ValueError(
            f"the clipping kernel keeps k_max={k_max} slots in one block's "
            f"shared memory, which holds at most {_MAX_CLIP_SLOTS} — use "
            "robust_impl='gather'"
        )
    adaptive = is_adaptive(name, clip_tau)
    tau_val = 0.0 if adaptive else float(clip_tau)
    dev = resolve_device(device)
    nbr32 = torch.as_tensor(nbr_host, device=dev)
    nbr64 = nbr32.to(torch.int64)
    # τ in each working type, on the device now: a copy from the host inside
    # a call would synchronise, which a CUDA graph capture does not allow.
    taus = {acc: torch.full((1,), tau_val, dtype=acc, device=dev)
            for acc in (torch.float32, torch.float64)}

    def call(live, x, g=None, eta=None):
        _cuda_build.check_stack(x, suffixes=_cuda_build.SUFFIX_BF16)
        _cuda_build.check_like(live, x, "live", dtype=torch.float32)
        if x.device != nbr32.device:
            raise ValueError(f"x lies on {x.device}, the neighbour table on {nbr32.device}")
        if tuple(live.shape) != (x.shape[0], k_max) or nbr32.shape[0] != x.shape[0]:
            raise ValueError(
                f"live {tuple(live.shape)} and the [{nbr32.shape[0]}, {k_max}] "
                f"table must have N={x.shape[0]} rows"
            )
        tau = taus[torch.promote_types(torch.float32, x.dtype)]
        if with_sgd:
            _cuda_build.check_like(g, x, "g")
            if g.shape != x.shape:
                raise ValueError(f"g has shape {tuple(g.shape)}, x {tuple(x.shape)}")
        if x.device.type == "cpu":
            return fused_robust_plain(name, budget, nbr64, live, x, tau,
                                      adaptive=adaptive, g=g, eta=eta)
        if with_sgd:
            _cuda_build.check_scalar(eta, x, "eta")
        return launch(_library(), name, budget, adaptive, nbr32, live, x, tau, g, eta)

    return call


def make_fused_robust_aggregator(
    name: str, budget: int, nbr_idx, clip_tau=0.0, *, device: torch.device | str = "cuda",
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``aggregate(live, x) -> x_new``: gather + screen + mix in one kernel.
    ``live`` is [N, k_max] float32 0/1 on the table's ``device``."""
    call = _make_fused_robust(name, budget, nbr_idx, clip_tau, with_sgd=False, device=device)
    return lambda live, x: call(live, x)


def make_fused_robust_dsgd_step(
    name: str, budget: int, nbr_idx, clip_tau=0.0, *, device: torch.device | str = "cuda",
) -> Callable[..., torch.Tensor]:
    """``step(live, x, g, eta) -> x_new``: the whole robust D-SGD update
    (gather + screen + mix − η·g) in one kernel. ``eta`` is a one-element
    tensor in x's dtype on x's device."""
    call = _make_fused_robust(name, budget, nbr_idx, clip_tau, with_sgd=True, device=device)
    return lambda live, x, g, eta: call(live, x, g=g, eta=eta)
