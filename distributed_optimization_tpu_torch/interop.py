"""Carry state and data across from the JAX package, as plain numpy arrays.

Nothing here imports the JAX package: callers pass the arrays its objects
hold (``BackendRunResult.final_state`` from ``jax_backend.run(...,
return_state=True)``, or a ``HostDataset``'s fields).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_optimization_tpu_torch.utils.data import HostDataset


def state_from_reference(
    state: dict[str, np.ndarray],
    device: torch.device | str,
    dtype: torch.dtype,
    *,
    replicas: int | None = None,
) -> dict[str, torch.Tensor]:
    """The JAX package's state dict of ``[N, d_model]`` arrays as the port's
    tensors (contiguous copies on ``device`` in ``dtype``). ``d_model`` is
    the flat parameter's length: the feature count, or d·K for softmax,
    whose [d, K] matrices both packages flatten d-major. D-SGD's state,
    with or without a Byzantine layer, is ``x`` alone: the attack and the
    screen carry no state across iterations. ADMM's is ``x``, the duals
    ``alpha`` and the carried neighbour sum ``nbr_x`` (A x). Push-sum's is
    ``x`` (the de-biased estimates num / w), the numerators ``num`` and the
    mass ``w``, which is ``[N, 1]``. Gradient tracking's ``y``, ADMM's
    ``nbr_x`` and push-sum's ``num`` are ``[N, d_model]`` like ``x``. The
    async event clock's carry (``execution='async'``) is ``x`` and the read
    snapshots ``x_read``, with gradient tracking's ``y`` and last gradients
    ``g_prev``, each ``[N, d_model]``: ``async_scan.run_async``'s
    ``state0``.
    A bfloat16 state (ml_dtypes arrays) is taken bit for bit.
    ``replicas=R`` takes a replica batch's stacked state (the JAX package's
    ``BatchRunResult.final_states``): every leaf ``[R, N, ...]``, as
    ``torch_backend.run_batch``'s ``state0`` takes it."""
    if "x" not in state:
        raise ValueError("a state needs its per-worker models under 'x'")
    lead = () if replicas is None else (replicas,)
    out = {}
    for key, value in state.items():
        arr = np.asarray(value)
        if arr.ndim != 2 + len(lead) or arr.shape[:len(lead)] != lead:
            want = "[N, d_model] or [N, 1]" if not lead else \
                f"[{replicas}, N, d_model] or [{replicas}, N, 1]"
            raise ValueError(f"state[{key!r}] must be {want}, got shape {arr.shape}")
        out[key] = _tensor(arr).to(dtype=dtype, device=device).contiguous()
    return out


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr``'s values. A bfloat16 array (ml_dtypes', which
    the JAX package's bfloat16 runs return; torch takes no such array) is
    carried through its raw 16-bit view, without importing ml_dtypes."""
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(arr)


def dataset_from_reference(
    X_full: np.ndarray,
    y_full: np.ndarray,
    shard_indices: list[np.ndarray],
    problem_type: str,
) -> HostDataset:
    """The port's ``HostDataset`` from the JAX package's dataset fields."""
    X = np.asarray(X_full, dtype=np.float64)
    y = np.asarray(y_full, dtype=np.float64)
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"X_full [n, d] and y_full [n] disagree: {X.shape}, {y.shape}")
    return HostDataset(
        X_full=X, y_full=y,
        shard_indices=[np.asarray(s) for s in shard_indices],
        problem_type=problem_type,
    )
