"""Run history and the study's metrics: suboptimality gap, consensus error,
floats transmitted, iterations to a threshold, and a replica batch's mean
± std of them (``summarize_replicates``).

The port's copy of the parts of ``distributed_optimization_tpu/metrics.py``
this slice uses, with the same definitions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from distributed_optimization_tpu_torch.parallel.topology import Topology


@dataclasses.dataclass
class RunHistory:
    """Per-eval history of one training run (host numpy arrays)."""

    objective: np.ndarray  # suboptimality gap f(x̄_t) − f(x*), [n_evals]
    consensus_error: Optional[np.ndarray]  # [n_evals] or None (centralized)
    time: np.ndarray  # seconds since the steady loop started, [n_evals]
    eval_iterations: np.ndarray  # 1-based iteration of each row
    total_floats_transmitted: float
    iters_per_second: float = float("nan")
    compile_seconds: float = 0.0  # warm-up step, kernel build included
    spectral_gap: Optional[float] = None
    # True for per-eval clock samples (``measure_timestamps=True``); False
    # when ``time`` spreads the run's total wall clock over the evals.
    time_measured: bool = False
    # Seconds spent unrolling the fault timeline (within compile_seconds).
    fault_setup_seconds: float = 0.0
    # Seconds spent building the communication graph on the host (not
    # within compile_seconds; 0 for the centralized pattern), and under the
    # async event clock its event schedule too.
    topology_setup_seconds: float = 0.0
    # Seconds capturing the async event clock's CUDA graphs (within
    # compile_seconds; 0 elsewhere).
    capture_seconds: float = 0.0


def consensus_error(models: np.ndarray) -> float:
    """(1/N) Σ_i ‖x_i − x̄‖² for an [N, d] model stack."""
    mean = models.mean(axis=0)
    return float(np.mean(np.sum((models - mean) ** 2, axis=1)))


def iterations_to_threshold(objective_history: np.ndarray, threshold: float,
                            eval_iterations: Optional[np.ndarray] = None) -> int:
    """First (1-based) iteration whose gap is <= threshold, or -1."""
    if objective_history.size == 0:
        return -1
    below = np.nonzero(objective_history <= threshold)[0]
    if below.size == 0:
        return -1
    first = int(below[0])
    if eval_iterations is not None:
        return int(eval_iterations[first])
    return first + 1


@dataclasses.dataclass
class ReplicateStats:
    """Seed-variance summary of a replica batch (``torch_backend.run_batch``).

    Every scalar the single-run report quotes becomes a (mean, std) pair
    over the R replicas. ``iterations_to_threshold_*`` aggregate over the
    replicas that reached the threshold (``n_reached`` of ``n_replicas``);
    both are NaN when none did. Stds are population (ddof=0) over the
    replicas aggregated.
    """

    n_replicas: int
    seeds: list
    final_gap_mean: float
    final_gap_std: float
    consensus_mean: Optional[float]  # None when consensus was not tracked
    consensus_std: Optional[float]
    iterations_to_threshold_mean: float
    iterations_to_threshold_std: float
    n_reached: int
    per_replica_iterations: list  # -1 = that replica never reached ε
    aggregate_iters_per_second: float


def summarize_replicates(
    objective: np.ndarray,  # [R, n_evals] per-replica suboptimality gaps
    consensus: Optional[np.ndarray],  # [R, n_evals] or None
    eval_iterations: np.ndarray,
    threshold: float,
    seeds: list,
    aggregate_iters_per_second: float,
) -> ReplicateStats:
    """Reduce a batch's [R, n_evals] histories to mean ± std statistics."""
    R = objective.shape[0]
    finals = objective[:, -1]
    per_rep = [
        iterations_to_threshold(objective[r], threshold, eval_iterations)
        for r in range(R)
    ]
    reached = np.asarray([it for it in per_rep if it > 0], dtype=np.float64)
    return ReplicateStats(
        n_replicas=R,
        seeds=list(seeds),
        final_gap_mean=float(np.mean(finals)),
        final_gap_std=float(np.std(finals)),
        consensus_mean=(
            float(np.mean(consensus[:, -1])) if consensus is not None else None
        ),
        consensus_std=(
            float(np.std(consensus[:, -1])) if consensus is not None else None
        ),
        iterations_to_threshold_mean=(
            float(reached.mean()) if reached.size else float("nan")
        ),
        iterations_to_threshold_std=(
            float(reached.std()) if reached.size else float("nan")
        ),
        n_reached=int(reached.size),
        per_replica_iterations=per_rep,
        aggregate_iters_per_second=aggregate_iters_per_second,
    )


def centralized_floats_per_iteration(n_workers: int, n_features: int) -> float:
    """2·N·d: N gradient uploads plus N model broadcasts."""
    return 2.0 * n_workers * n_features


def decentralized_floats_per_iteration(
    topo: Topology, n_features: int, gossip_rounds: int = 1
) -> float:
    """Σ_i deg_i · d floats per gossip round, times the rounds."""
    return topo.floats_per_iteration * n_features * gossip_rounds
