"""Run one experiment on the PyTorch port and print its summary.

    python -m distributed_optimization_tpu_torch --problem-type logistic \\
        --topology ring --n-workers 256 --mixing-impl pallas

The single-run part of ``distributed_optimization_tpu/cli.py``: the
dataset is generated, the optimum is solved for on the host, and the run
goes on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``). ``--replicas R`` (seeds seed … seed+R−1) or ``--seeds
S1,S2,...`` run the seeds as one replica batch
(``torch_backend.run_batch``) and print each quantity as mean ± std over
the replicas, as the JAX CLI does. ``--execution async`` (with
``--latency-model``, ``--latency-mean``, ``--latency-tail``) runs the
asynchronous event clock; its iterations are rounds of N events.
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_optimization_tpu_torch.config import (
    AGGREGATIONS,
    ALGORITHMS,
    ATTACKS,
    COMPRESSIONS,
    DTYPES,
    EXECUTIONS,
    GOSSIP_SCHEDULES,
    LATENCY_MODELS,
    LR_SCHEDULES,
    MATMUL_PRECISIONS,
    MATRIX_FREE_AUTO_N,
    MIXING_IMPLS,
    PARTITIONS,
    PROBLEM_TYPES,
    REJOINS,
    ROBUST_IMPLS,
    SAMPLING_IMPLS,
    TOPOLOGIES,
    TOPOLOGY_IMPLS,
    TOPOLOGY_SAMPLERS,
    ExperimentConfig,
)

_DEFAULTS = ExperimentConfig()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_optimization_tpu_torch",
        description="One decentralized-optimization run on the PyTorch port.",
    )
    p.add_argument("--algorithm", choices=ALGORITHMS, default=_DEFAULTS.algorithm)
    p.add_argument("--topology", choices=TOPOLOGIES, default=_DEFAULTS.topology,
                   help="directed_ring and directed_erdos_renyi take --algorithm push_sum")
    p.add_argument("--erdos-renyi-p", type=float, default=_DEFAULTS.erdos_renyi_p,
                   help="edge probability of the two Erdős–Rényi graphs")
    p.add_argument("--topology-seed", type=int, default=_DEFAULTS.topology_seed,
                   help="seed of the random graphs (-1 follows --seed)")
    p.add_argument("--problem-type", choices=PROBLEM_TYPES, default=_DEFAULTS.problem_type)
    p.add_argument("--n-classes", type=int, default=_DEFAULTS.n_classes,
                   help="class count K for --problem-type softmax (the "
                        "compute-bound [d,K]-matrix-parameter family)")
    p.add_argument("--huber-delta", type=float, default=_DEFAULTS.huber_delta,
                   help="Huber transition point δ (problem huber only; "
                        "default = the synthetic data's noise scale)")
    p.add_argument("--n-workers", type=int, default=_DEFAULTS.n_workers)
    p.add_argument("--n-samples", type=int, default=_DEFAULTS.n_samples)
    p.add_argument("--n-features", type=int, default=_DEFAULTS.n_features)
    p.add_argument("--n-informative-features", type=int,
                   default=_DEFAULTS.n_informative_features)
    p.add_argument("--classification-sep", type=float,
                   default=_DEFAULTS.classification_sep)
    p.add_argument("--n-iterations", type=int, default=_DEFAULTS.n_iterations)
    p.add_argument("--local-batch-size", type=int, default=_DEFAULTS.local_batch_size)
    p.add_argument("--learning-rate-eta0", type=float, default=_DEFAULTS.learning_rate_eta0)
    p.add_argument("--l2-lambda", type=float, default=_DEFAULTS.l2_regularization_lambda)
    p.add_argument("--lr-schedule", choices=LR_SCHEDULES, default=_DEFAULTS.lr_schedule)
    p.add_argument("--admm-c", type=float, default=_DEFAULTS.admm_c)
    p.add_argument("--admm-rho", type=float, default=_DEFAULTS.admm_rho)
    p.add_argument("--compression", choices=COMPRESSIONS, default=_DEFAULTS.compression,
                   help="error-feedback gossip compression operator "
                        "(choco, dsgd, gradient_tracking)")
    p.add_argument("--compression-k", type=int, default=_DEFAULTS.compression_k,
                   help="coordinates kept (top_k/random_k) or quantization bits (qsgd)")
    p.add_argument("--choco-gamma", type=float, default=_DEFAULTS.choco_gamma,
                   help="consensus step size γ of the compressed exchange")
    p.add_argument("--seed", type=int, default=_DEFAULTS.seed)
    p.add_argument("--replicas", type=int, default=_DEFAULTS.replicas,
                   help="run this many seed replicates (seed, seed+1, ...) as one "
                        "batch and report mean ± std over the replica axis")
    p.add_argument("--seeds", metavar="S1,S2,...", default=None,
                   help="explicit comma-separated replica seed list (overrides "
                        "--replicas/--seed's arithmetic progression); implies a "
                        "replica batch")
    p.add_argument("--data-seed", type=int, default=_DEFAULTS.data_seed)
    p.add_argument("--eval-every", type=int, default=_DEFAULTS.eval_every)
    p.add_argument("--local-steps", type=int, default=_DEFAULTS.local_steps,
                   help="τ local descents a gossip round (dsgd, gradient_tracking)")
    p.add_argument("--suboptimality-threshold", type=float,
                   default=_DEFAULTS.suboptimality_threshold)
    p.add_argument("--mixing-impl", choices=MIXING_IMPLS, default=_DEFAULTS.mixing_impl,
                   help="'pallas' selects the hand-written CUDA ring and fc kernels; "
                        "'gather' the neighbour table (undirected graphs), 'sparse' "
                        "the in-edge lists (any graph)")
    p.add_argument("--topology-impl", choices=TOPOLOGY_IMPLS, default=_DEFAULTS.topology_impl,
                   help="topology representation: 'neighbor' builds the matrix-free "
                        "padded [N, k_max] neighbor table (ring/grid/chain/erdos_renyi; "
                        "the only form that fits N >= 10k), 'dense' the [N, N] "
                        f"matrices; 'auto' = neighbor from {MATRIX_FREE_AUTO_N} workers "
                        "when no dense-only feature is requested")
    p.add_argument("--topology-sampler", choices=TOPOLOGY_SAMPLERS,
                   default=_DEFAULTS.topology_sampler,
                   help="Erdős–Rényi graph sampler: 'dense' replays the [N, N] uniform "
                        "stream bit-for-bit (O(N²) draws), 'sparse' draws O(N·k_max) — "
                        "the million-worker path, a different realization of the same "
                        "G(n, p) law. 'auto' = dense below N=65,536 on the matrix-free "
                        "ER path, sparse above")
    p.add_argument("--sampling-impl", choices=SAMPLING_IMPLS, default=_DEFAULTS.sampling_impl)
    p.add_argument("--dtype", choices=DTYPES, default=_DEFAULTS.dtype)
    p.add_argument("--matmul-precision", choices=MATMUL_PRECISIONS,
                   default=_DEFAULTS.matmul_precision,
                   help="float32 products on the card: 'highest' in full FP32, "
                        "'high' and 'default' in TF32")
    p.add_argument("--partition", choices=PARTITIONS, default=_DEFAULTS.partition,
                   help="worker data split: 'sorted' (non-IID) or 'shuffled' (IID)")
    p.add_argument("--attack", choices=ATTACKS, default=_DEFAULTS.attack,
                   help="Byzantine payload the n-byzantine workers send")
    p.add_argument("--n-byzantine", type=int, default=_DEFAULTS.n_byzantine)
    p.add_argument("--attack-scale", type=float, default=_DEFAULTS.attack_scale,
                   help="sign-flip multiplier, large-noise sigma or ALIE's z")
    p.add_argument("--aggregation", choices=AGGREGATIONS, default=_DEFAULTS.aggregation,
                   help="robust rule honest workers screen received models with")
    p.add_argument("--robust-b", type=int, default=_DEFAULTS.robust_b,
                   help="per-neighbourhood attack budget; 0 is plain gossip")
    p.add_argument("--clip-tau", type=float, default=_DEFAULTS.clip_tau,
                   help="fixed clipping radius for clipped_gossip (0 = adaptive)")
    p.add_argument("--robust-impl", choices=ROBUST_IMPLS, default=_DEFAULTS.robust_impl,
                   help="'fused' runs the hand-written CUDA robust kernels, 'gather' "
                        "torch ops; 'auto' takes fused where the kernel can")
    p.add_argument("--edge-drop-prob", type=float, default=_DEFAULTS.edge_drop_prob,
                   help="failure injection: per-iteration probability that each "
                        "topology edge drops (gossip reweights on the surviving graph)")
    p.add_argument("--straggler-prob", type=float, default=_DEFAULTS.straggler_prob,
                   help="per-iteration probability that a node sits the round out "
                        "(no exchange, no local step)")
    p.add_argument("--burst-len", type=float, default=_DEFAULTS.burst_len,
                   help="bursty link failures (Gilbert-Elliott): mean burst-length "
                        "multiplier at the same marginal --edge-drop-prob; 0 = "
                        "memoryless drops, 1 reduces bitwise to them")
    p.add_argument("--mttf", type=float, default=_DEFAULTS.mttf,
                   help="crash-recovery churn: mean up-time (rounds), >= 1, with --mttr")
    p.add_argument("--mttr", type=float, default=_DEFAULTS.mttr,
                   help="crash-recovery churn: mean outage length (rounds), >= 1")
    p.add_argument("--rejoin", choices=REJOINS, default=_DEFAULTS.rejoin,
                   help="after an outage: 'frozen' (the stale state) or "
                        "'neighbor_restart' (the realized neighbours' average)")
    p.add_argument("--participation-rate", type=float,
                   default=_DEFAULTS.participation_rate,
                   help="per-round client sampling: each worker participates with "
                        "this probability (1.0 = everyone)")
    p.add_argument("--gossip-schedule", choices=GOSSIP_SCHEDULES,
                   default=_DEFAULTS.gossip_schedule,
                   help="'one_peer' = randomized pairwise gossip; 'round_robin' = "
                        "deterministic matchings covering the edge set")
    p.add_argument("--execution", choices=EXECUTIONS, default=_DEFAULTS.execution,
                   help="'async' runs a precomputed EVENT schedule (AD-PSGD-style "
                        "bounded-staleness gossip: one worker's stale-read local step "
                        "+ a pairwise exchange per event; stragglers are latency, not "
                        "drops). n_iterations then counts per-worker gradient steps (N "
                        "events per round); dsgd and gradient_tracking")
    p.add_argument("--latency-model", choices=LATENCY_MODELS,
                   default=_DEFAULTS.latency_model,
                   help="per-worker compute-time distribution of the async event "
                        "schedule (all matched to mean --latency-mean; async only)")
    p.add_argument("--latency-mean", type=float, default=_DEFAULTS.latency_mean,
                   help="mean compute time per gradient step in virtual seconds "
                        "(async only)")
    p.add_argument("--latency-tail", type=float, default=_DEFAULTS.latency_tail,
                   help="heavy-tail straggler knob: lognormal log-std (> 0) or pareto "
                        "shape alpha (> 1); 0 for constant/exponential (async only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--json", action="store_true", help="print the summary as JSON")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        algorithm=args.algorithm,
        topology=args.topology,
        erdos_renyi_p=args.erdos_renyi_p,
        topology_seed=args.topology_seed,
        problem_type=args.problem_type,
        n_classes=args.n_classes,
        huber_delta=args.huber_delta,
        n_workers=args.n_workers,
        n_samples=args.n_samples,
        n_features=args.n_features,
        n_informative_features=args.n_informative_features,
        classification_sep=args.classification_sep,
        n_iterations=args.n_iterations,
        local_batch_size=args.local_batch_size,
        learning_rate_eta0=args.learning_rate_eta0,
        l2_regularization_lambda=args.l2_lambda,
        strong_convexity_mu=args.l2_lambda,
        lr_schedule=args.lr_schedule,
        admm_c=args.admm_c,
        admm_rho=args.admm_rho,
        compression=args.compression,
        compression_k=args.compression_k,
        choco_gamma=args.choco_gamma,
        seed=args.seed,
        replicas=args.replicas,
        data_seed=args.data_seed,
        eval_every=args.eval_every,
        local_steps=args.local_steps,
        suboptimality_threshold=args.suboptimality_threshold,
        mixing_impl=args.mixing_impl,
        topology_impl=args.topology_impl,
        topology_sampler=args.topology_sampler,
        sampling_impl=args.sampling_impl,
        dtype=args.dtype,
        matmul_precision=args.matmul_precision,
        partition=args.partition,
        attack=args.attack,
        n_byzantine=args.n_byzantine,
        attack_scale=args.attack_scale,
        aggregation=args.aggregation,
        robust_b=args.robust_b,
        clip_tau=args.clip_tau,
        robust_impl=args.robust_impl,
        edge_drop_prob=args.edge_drop_prob,
        straggler_prob=args.straggler_prob,
        burst_len=args.burst_len,
        mttf=args.mttf,
        mttr=args.mttr,
        rejoin=args.rejoin,
        participation_rate=args.participation_rate,
        gossip_schedule=args.gossip_schedule,
        execution=args.execution,
        latency_model=args.latency_model,
        latency_mean=args.latency_mean,
        latency_tail=args.latency_tail,
    )


def _seed_list(args: argparse.Namespace):
    """``--seeds`` as a list (it sets ``--replicas`` and anchors ``--seed``
    on its first seed, as the JAX CLI does), or None."""
    if not args.seeds:
        return None
    try:
        seeds = [int(x) for x in args.seeds.split(",") if x.strip()]
    except ValueError:
        raise SystemExit(
            f"--seeds must be a comma-separated integer list, got {args.seeds!r}"
        )
    if not seeds:
        raise SystemExit("--seeds needs at least one seed")
    args.replicas = len(seeds)
    args.seed = seeds[0]
    return seeds


def _mean_std(mean, std) -> str:
    return "None" if mean is None else f"{mean} ± {std}"


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    seeds = _seed_list(args)
    cfg = config_from_args(args)

    from distributed_optimization_tpu_torch.backends import torch_backend
    from distributed_optimization_tpu_torch.backends.base import resolve_device
    from distributed_optimization_tpu_torch.metrics import iterations_to_threshold
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    device = resolve_device(args.device)  # fail before the host-side work
    dataset = generate_synthetic_dataset(cfg)
    _, f_opt = compute_reference_optimum(dataset, cfg.reg_param, huber_delta=cfg.huber_delta,
                                         n_classes=cfg.n_classes)
    if cfg.replicas > 1 or seeds is not None:
        return _report_batch(args, cfg, torch_backend.run_batch(
            cfg, dataset, f_opt, seeds=seeds, device=device), device)
    result = torch_backend.run(cfg, dataset, f_opt, device=device)
    h = result.history
    summary = {
        "device": str(device),
        "algorithm": cfg.algorithm,
        "topology": cfg.topology,
        "topology_impl": cfg.resolved_topology_impl(),
        "topology_sampler": cfg.resolved_topology_sampler(),
        "n_workers": cfg.n_workers,
        "problem_type": cfg.problem_type,
        "mixing_impl": cfg.mixing_impl,
        "compression": cfg.compression,
        "attack": cfg.attack,
        "aggregation": cfg.aggregation,
        "gossip_schedule": cfg.gossip_schedule,
        "execution": cfg.execution,
        # Under an attack the gap and consensus are over the honest rows.
        "gap_over": "honest workers" if cfg.attack != "none" else "all workers",
        "iterations_to_threshold": iterations_to_threshold(
            h.objective, cfg.suboptimality_threshold, h.eval_iterations
        ),
        "threshold": cfg.suboptimality_threshold,
        "final_gap": float(h.objective[-1]),
        "final_consensus": (
            float(h.consensus_error[-1]) if h.consensus_error is not None else None
        ),
        "total_floats_transmitted": h.total_floats_transmitted,
        "iters_per_second": h.iters_per_second,
        "warmup_seconds": h.compile_seconds,
    }
    _print(args, summary)
    return 0


def _print(args: argparse.Namespace, summary: dict) -> None:
    if args.json:
        print(json.dumps(summary))
    else:
        for key, value in summary.items():
            print(f"{key:>26}: {value}")


def _report_batch(args, cfg, batch, device) -> int:
    """A replica batch's summary: each quantity as mean ± std over the
    replicas (``metrics.summarize_replicates``), the seeds, each replica's
    iterations to ε and the aggregate iters/s."""
    import numpy as np

    from distributed_optimization_tpu_torch.metrics import summarize_replicates

    h0 = batch.results[0].history
    stats = summarize_replicates(batch.objective, batch.consensus_error, h0.eval_iterations,
                                 cfg.suboptimality_threshold, batch.seeds,
                                 batch.aggregate_iters_per_second)
    floats = [r.history.total_floats_transmitted for r in batch.results]
    summary = {
        "device": str(device),
        "algorithm": cfg.algorithm,
        "topology": cfg.topology,
        "topology_impl": cfg.resolved_topology_impl(),
        "topology_sampler": cfg.resolved_topology_sampler(),
        "n_workers": cfg.n_workers,
        "problem_type": cfg.problem_type,
        "replicas": stats.n_replicas,
        "seeds": stats.seeds,
        "gap_over": "honest workers" if cfg.attack != "none" else "all workers",
        "threshold": cfg.suboptimality_threshold,
        "final_gap": _mean_std(stats.final_gap_mean, stats.final_gap_std),
        "final_consensus": _mean_std(stats.consensus_mean, stats.consensus_std),
        "iterations_to_threshold": _mean_std(
            None if np.isnan(stats.iterations_to_threshold_mean)
            else stats.iterations_to_threshold_mean, stats.iterations_to_threshold_std),
        "n_reached": f"{stats.n_reached}/{stats.n_replicas}",
        "per_replica_iterations": stats.per_replica_iterations,
        "total_floats_transmitted": _mean_std(float(np.mean(floats)), float(np.std(floats))),
        "aggregate_iters_per_second": stats.aggregate_iters_per_second,
        "warmup_seconds": batch.compile_seconds,
    }
    if args.json:
        summary["replicates"] = {
            "n": stats.n_replicas, "seeds": stats.seeds,
            "final_gap_mean": stats.final_gap_mean, "final_gap_std": stats.final_gap_std,
            "consensus_mean": stats.consensus_mean, "consensus_std": stats.consensus_std,
            "iterations_to_threshold_mean": (None if np.isnan(stats.iterations_to_threshold_mean)
                                             else stats.iterations_to_threshold_mean),
            "iterations_to_threshold_std": (None if np.isnan(stats.iterations_to_threshold_std)
                                            else stats.iterations_to_threshold_std),
            "n_reached": stats.n_reached,
            "objective_mean": np.mean(batch.objective, axis=0).tolist(),
            "objective_std": np.std(batch.objective, axis=0).tolist(),
        }
    else:
        print(f"[R={stats.n_replicas}] seeds {stats.seeds}")
    _print(args, summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
