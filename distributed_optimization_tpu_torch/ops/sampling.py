"""Per-worker mini-batch sampling on the JAX package's random stream.

The port of ``distributed_optimization_tpu/ops/sampling.py``, drawing the
JAX package's batches bit for bit through ``ops/prng.py``, the twin of
``jax.random``. The key chain is the JAX package's: the run's key
``key(seed)`` folds in the draw's slot on the host (the slot key), then
the iteration ``t``, then the worker (``worker_keys``); each worker scores
its L rows with ``uniform(worker_key, (L,))`` in the run dtype, −inf on
padding rows (``masked_scores``). A float64 run draws 64-bit uniforms, as
the JAX package does under its float64 runs' ``enable_x64``; a bfloat16
run is no x64 run and draws the float32 run's uniforms (``score_dtype``).

These are the plain versions. The run loop goes through
``ops/sampling_kernels.py``, which launches the card's sampling kernel on a
CUDA tensor and calls these on a CPU tensor.

The replica axis: a slot key may also be an int64 ``[R, 2]`` stack of R
replicas' slot keys (``prng.keys``). Every function then returns its
outputs with a leading ``[R]``, replica r's equal to the single call with
slot key r, bit for bit; the shards (``X``, ``y``, ``n_valid``) stay
shared.

The iteration counter ``t`` is a Python int or an int64 tensor of one
element on the tensor's device; the run loop passes the tensor, which it
advances in place, so that one captured CUDA graph serves every iteration.
Both give the same bits.

Both forms select the same subsets, as in the JAX package: a worker takes
the ``b_eff = min(b, n_valid, L)`` valid rows of highest score, ties going
to the lower row index (a stable descending sort). The dense form returns
``[N, L]`` weights carrying ``1/b_eff`` on the chosen rows; the gather form
returns the chosen rows' indices, which ``gather_batches`` takes
(``sample_worker_batches`` does both). The
weight is ``1/b_eff`` computed in the score dtype, rounded to float32 and
cast to the run dtype, as the JAX package's sampler returns float32
weights that its backend casts to the run dtype.
"""

from __future__ import annotations

import torch

from distributed_optimization_tpu_torch.ops import prng
from distributed_optimization_tpu_torch.ops.prng import threefry2x32  # noqa: F401

# The event clock's stream tag, folded into the run's key.
ASYNC_BATCH_TAG = 0xA57E


def score_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a run of ``dtype`` draws its scores in: the key's, float64
    under x64 (float64 runs), else float32 (bfloat16 runs too)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def stacked(slot_key) -> bool:
    """Whether ``slot_key`` is an ``[R, 2]`` stack of replicas' keys."""
    return isinstance(slot_key, torch.Tensor) and slot_key.dim() == 2


def worker_keys(slot_key, t: int | torch.Tensor, n_workers: int, device) -> torch.Tensor:
    """``[N, 2]`` keys ``fold_in(fold_in(slot_key, t), worker)`` (``[R, N,
    2]`` for a stack of R slot keys)."""
    step_key = prng.fold_in(slot_key, t)
    if stacked(slot_key):
        step_key = step_key.unsqueeze(-2)
    return prng.fold_in(step_key, torch.arange(n_workers, dtype=torch.int64, device=device))


def masked_scores(
    slot_key, t: int | torch.Tensor, n_valid: torch.Tensor, n_local: int, dtype: torch.dtype
) -> torch.Tensor:
    """``[N, L]`` uniform ranking scores in ``score_dtype(dtype)`` (``[R,
    N, L]`` for R slot keys); −inf on padding rows."""
    keys = worker_keys(slot_key, t, n_valid.shape[0], n_valid.device)
    scores = prng.uniform(keys, (n_local,), score_dtype(dtype))
    rows = torch.arange(n_local, device=n_valid.device)
    return torch.where(rows[None, :] < n_valid[:, None], scores, float("-inf"))


def _effective_batch(batch_size: int, n_valid: torch.Tensor, n_local: int):
    """min(batch_size, n_valid, L) per worker, int64."""
    return torch.clamp(n_valid.long(), max=min(batch_size, n_local))


def batch_weight(effective: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """1/max(b_eff, 1) in the score dtype, rounded through float32, in
    ``dtype``."""
    inv = 1.0 / torch.clamp(effective, min=1).to(score_dtype(dtype))
    return inv.to(torch.float32).to(dtype)


def sample_worker_batch_weights(
    slot_key,
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
    u = masked_scores(slot_key, t, n_valid, n_local, dtype)
    idx = torch.arange(n_local, device=u.device)
    ui, um = u[..., :, None], u[..., None, :]
    beats = (um > ui) | ((um == ui) & (idx[None, :] < idx[:, None]))
    rank = beats.sum(dim=-1)
    effective = _effective_batch(batch_size, n_valid, n_local)
    sel = (rank < effective[:, None]) & (idx[None, :] < n_valid[:, None].long())
    inv = batch_weight(effective, dtype)
    return torch.where(sel, inv[:, None], torch.zeros((), dtype=dtype, device=u.device))


def sample_batch_indices(
    slot_key, t: int | torch.Tensor, n_valid: torch.Tensor, n_local: int,
    batch_size: int, dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indices [N, b] int64, weights [N, b])`` of each worker's batch
    (each ``[R, N, b]`` for R slot keys).

    The top ``min(b, L)`` rows by a stable descending sort, tiled up to b
    when the shard is shorter than the batch; weights are 1/b_eff on the
    first b_eff draws and 0 on the surplus.
    """
    u = masked_scores(slot_key, t, n_valid, n_local, dtype)
    order = torch.sort(u, dim=-1, descending=True, stable=True).indices
    k = min(batch_size, n_local)
    indices = order[..., torch.arange(batch_size, device=u.device) % k]
    effective = _effective_batch(batch_size, n_valid, n_local)
    real = torch.arange(batch_size, device=u.device)[None, :] < effective[:, None]
    inv = batch_weight(effective, dtype)
    weights = torch.where(real, inv[:, None], torch.zeros((), dtype=dtype, device=u.device))
    return indices, weights.expand(indices.shape)


def gather_batches(X: torch.Tensor, y: torch.Tensor, indices: torch.Tensor):
    """``(Xb [N, b, d], yb [N, b])``: each worker's rows at ``indices``
    (``[R, N, b, d]``, ``[R, N, b]`` for indices ``[R, N, b]``)."""
    if indices.dim() == 3:
        rows = torch.arange(X.shape[0], device=X.device)[:, None]
        return X[rows, indices], y[rows, indices]
    return torch.take_along_dim(X, indices[:, :, None], dim=1), torch.take_along_dim(y, indices, dim=1)


def sample_worker_batches(slot_key, t: int | torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                          n_valid: torch.Tensor, batch_size: int):
    """``(Xb [N, b, d], yb [N, b], weights [N, b])``: each worker's batch
    drawn by ``sample_batch_indices`` and gathered from the shards ``X [N, L,
    d]``, ``y [N, L]``, as the JAX package's function of that name returns
    it (its weights cast to X's dtype)."""
    indices, weights = sample_batch_indices(slot_key, t, n_valid, X.shape[1], batch_size,
                                            X.dtype)
    return (*gather_batches(X, y, indices), weights)


def event_key(seed: int, *, x64: bool) -> tuple[int, int]:
    """The event clock's base key ``fold_in(key(seed), 0xA57E)`` (two host
    words); ``x64`` as the run's ``prng.key``."""
    return prng.fold_in(prng.key(seed, x64=x64), ASYNC_BATCH_TAG)


def _at(values: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    return values.index_select(0, cursor.reshape(1))


def event_batch_indices(base_key, cursor: torch.Tensor, workers: torch.Tensor,
                        steps: torch.Tensor, n_valid: torch.Tensor, n_local: int,
                        batch_size: int, dtype: torch.dtype, descent: int | None = None):
    """``(indices [b] int64, weights [b])`` of event ``cursor``'s batch (an
    int64 tensor of one element indexing the schedule's ``workers`` and
    ``steps``, int64 ``[E]``): key ``fold_in(fold_in(base_key, worker),
    step)``, and ``descent`` folded in after where given; the worker's
    scores, top ``min(b, L)`` rows tiled to b and weights as
    ``sample_batch_indices``. The worker and step are read to the host and
    the key folded there (ints), as this runs on the CPU."""
    worker = _at(workers, cursor)
    key = prng.fold_in(prng.fold_in(base_key, int(worker)), int(_at(steps, cursor)))
    if descent is not None:
        key = prng.fold_in(key, descent)
    nv = n_valid.index_select(0, worker)
    scores = prng.uniform(key, (n_local,), score_dtype(dtype)).to(n_valid.device)
    rows = torch.arange(n_local, device=n_valid.device)
    u = torch.where(rows[None, :] < nv[:, None], scores, float("-inf"))
    order = torch.sort(u[0], descending=True, stable=True).indices
    k = min(batch_size, n_local)
    indices = order[torch.arange(batch_size, device=u.device) % k]
    effective = _effective_batch(batch_size, nv, n_local)
    real = torch.arange(batch_size, device=u.device) < effective
    weights = torch.where(real, batch_weight(effective, dtype),
                          torch.zeros((), dtype=dtype, device=u.device))
    return indices, weights


def sample_event_batch(base_key, cursor: torch.Tensor, workers: torch.Tensor,
                       steps: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                       n_valid: torch.Tensor, batch_size: int, descent: int | None = None):
    """``(Xb [1, b, d], yb [1, b], weights [1, b])``: event ``cursor``'s
    batch (``event_batch_indices``) gathered from its worker's shard of
    ``X [N, L, d]``, ``y [N, L]``, shaped as one worker's gradient call
    takes it."""
    indices, weights = event_batch_indices(base_key, cursor, workers, steps, n_valid,
                                           X.shape[1], batch_size, X.dtype, descent)
    worker = _at(workers, cursor)
    Xb = X.index_select(0, worker)[:, indices]
    yb = y.index_select(0, worker)[:, indices]
    return Xb, yb, weights[None, :]


def sample_event_block(base_key, cursor: torch.Tensor, workers: torch.Tensor,
                       steps: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                       n_valid: torch.Tensor, batch_size: int, events: int,
                       descents: int | None = None):
    """``(Xb [B, τ, b, d], yb [B, τ, b], weights [B, τ, b])``: the batches
    of events ``cursor`` … ``cursor + B − 1`` (B = ``events``), each
    ``sample_event_batch`` at its event, with no descent folded in
    (``descents`` None, τ = 1) or at descents 0 … τ − 1 (an int τ),
    stacked."""
    draws = [[sample_event_batch(base_key, cursor + e, workers, steps, X, y, n_valid,
                                 batch_size, m)
              for m in ((None,) if descents is None else range(descents))]
             for e in range(events)]
    return tuple(torch.stack([torch.cat([one[part] for one in event]) for event in draws])
                 for part in range(3))
