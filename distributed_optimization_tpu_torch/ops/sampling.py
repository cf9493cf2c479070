"""Per-worker mini-batch sampling from one counter-based random stream.

The port of ``distributed_optimization_tpu/ops/sampling.py``. Each worker's
ranking score for a row is a pure function of ``(seed, slot, t, worker,
row)``: the first word of Threefry-2x32 (20 rounds) with key
``(seed mod 2³², slot)`` and counter ``(t, worker·L + row)``, computed on the
tensor's device with integer tensor ops. Draws therefore depend on no
order of evaluation, and the CPU and a CUDA card give the same bits. The
bits are not ``jax.random``'s; parity with the JAX package rests on
injected batch schedules.

The iteration counter ``t`` is a Python int or an int64 tensor of one
element on the tensor's device; the run loop passes the tensor, which it
advances in place, so that one captured CUDA graph serves every iteration.
Both give the same bits.

Both forms select the same subsets, as in the JAX package: a worker takes
the ``b_eff = min(b, n_valid, L)`` valid rows of highest score, ties going
to the lower row index (a stable descending sort). Padding rows score −1,
below every valid row. The dense form returns ``[N, L]`` weights carrying
``1/b_eff`` on the chosen rows; the gather form returns the chosen rows.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_KS_PARITY = 0x1BD11BDA


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key0: int, key1: int, c0: int | torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11), the generator
    behind ``jax.random``, for the counters (c0, c1[k]). Words are held in
    int64 tensors in [0, 2³²); ``c0`` is a Python int or an int64 tensor
    that broadcasts over ``c1``."""
    ks = (key0 & _MASK32, key1 & _MASK32,
          (key0 ^ key1 ^ _KS_PARITY) & _MASK32)
    if isinstance(c0, torch.Tensor):
        x0 = ((c0 + ks[0]) & _MASK32).expand_as(c1)
    else:
        x0 = torch.full_like(c1, (c0 + ks[0]) & _MASK32)
    x1 = (c1 + ks[1]) & _MASK32
    for group in range(5):
        for r in _ROTATIONS[4 * (group % 2): 4 * (group % 2) + 4]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK32
    return x0, x1


def row_scores(
    seed: int, slot: int, t: int | torch.Tensor, n_valid: torch.Tensor, n_local: int
) -> torch.Tensor:
    """``[N, L]`` int64 ranking scores in [0, 2³²); −1 on padding rows."""
    n = n_valid.shape[0]
    rows = torch.arange(n_local, device=n_valid.device, dtype=torch.int64)
    flat = torch.arange(n, device=n_valid.device, dtype=torch.int64)[:, None] * n_local + rows
    scores, _ = threefry2x32(seed, slot, t, flat)
    return torch.where(rows[None, :] < n_valid[:, None].long(), scores, -1)


def _effective_batch(batch_size: int, n_valid: torch.Tensor, n_local: int):
    """min(batch_size, n_valid, L) per worker, int64."""
    return torch.clamp(n_valid.long(), max=min(batch_size, n_local))


def sample_worker_batch_weights(
    seed: int,
    slot: int,
    t: int | torch.Tensor,
    n_valid: torch.Tensor,  # [N] true shard sizes
    n_local: int,  # L, the padded shard length
    batch_size: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """``[N, L]`` weights: 1/b_eff on each worker's sampled rows, else 0.

    A row is sampled when its stable descending rank is below b_eff:
    rank[l] = #{m : u_m > u_l, or u_m == u_l and m < l}.
    """
    u = row_scores(seed, slot, t, n_valid, n_local)
    idx = torch.arange(n_local, device=u.device)
    ui, um = u[:, :, None], u[:, None, :]
    beats = (um > ui) | ((um == ui) & (idx[None, :] < idx[:, None]))
    rank = beats.sum(dim=-1)
    effective = _effective_batch(batch_size, n_valid, n_local)
    sel = (rank < effective[:, None]) & (idx[None, :] < n_valid[:, None].long())
    inv = 1.0 / torch.clamp(effective, min=1).to(dtype)
    return torch.where(sel, inv[:, None], torch.zeros((), dtype=dtype, device=u.device))


def sample_batch_indices(
    seed: int, slot: int, t: int | torch.Tensor, n_valid: torch.Tensor, n_local: int,
    batch_size: int, dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indices [N, b] int64, weights [N, b])`` of each worker's batch.

    The top ``min(b, L)`` rows by a stable descending sort, tiled up to b
    when the shard is shorter than the batch; weights are 1/b_eff on the
    first b_eff draws and 0 on the surplus.
    """
    u = row_scores(seed, slot, t, n_valid, n_local)
    order = torch.sort(u, dim=-1, descending=True, stable=True).indices
    top = order[:, : min(batch_size, n_local)]
    reps = -(-batch_size // top.shape[1])
    indices = top.repeat(1, reps)[:, :batch_size]
    effective = _effective_batch(batch_size, n_valid, n_local)
    real = torch.arange(batch_size, device=u.device)[None, :] < effective[:, None]
    inv = 1.0 / torch.clamp(effective, min=1).to(dtype)
    weights = torch.where(real, inv[:, None], torch.zeros((), dtype=dtype, device=u.device))
    return indices, weights


def sample_worker_batches(
    seed: int,
    slot: int,
    t: int | torch.Tensor,
    X: torch.Tensor,  # [N, L, d]
    y: torch.Tensor,  # [N, L]
    n_valid: torch.Tensor,  # [N]
    batch_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(Xb [N, b, d], yb [N, b], weights [N, b])`` for iteration ``t``."""
    idx, weights = sample_batch_indices(
        seed, slot, t, n_valid, X.shape[1], batch_size, X.dtype
    )
    Xb = torch.take_along_dim(X, idx[:, :, None], dim=1)
    yb = torch.take_along_dim(y, idx, dim=1)
    return Xb, yb, weights
