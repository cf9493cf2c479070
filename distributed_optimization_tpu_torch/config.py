"""Typed experiment configuration for the PyTorch/CUDA port.

A cut-down copy of ``distributed_optimization_tpu/config.py``: the same
field names and defaults for every field this slice reads, so a config
written for the JAX package carries across unchanged. Values the port does
not implement yet raise ``ValueError`` naming what is missing, instead of
being accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

# What this slice of the port implements. The JAX package accepts more;
# each value outside these lists is refused below.
ALGORITHMS = ("centralized", "dsgd", "gradient_tracking", "extra", "admm", "choco",
              "push_sum")
TOPOLOGIES = ("ring", "grid", "fully_connected", "erdos_renyi", "chain", "star",
              "directed_ring", "directed_erdos_renyi")
# Column-stochastic mixing: only push_sum, which divides out the tracked
# mass, converges to the true average on them.
DIRECTED_TOPOLOGIES = ("directed_ring", "directed_erdos_renyi")
# The graphs drawn from ``resolved_topology_seed()``.
RANDOM_TOPOLOGIES = ("erdos_renyi", "directed_erdos_renyi")
PROBLEM_TYPES = ("logistic", "quadratic", "huber", "softmax")
MIXING_IMPLS = ("auto", "stencil", "dense", "pallas", "gather", "sparse")
SAMPLING_IMPLS = ("auto", "dense", "gather")
DTYPES = ("float32", "float64", "bfloat16")
# The JAX package's jax.default_matmul_precision values. On a card, float32
# products run in full FP32 under 'highest' and in TF32 under 'high' and
# 'default' (what XLA does with those precisions on an NVIDIA GPU).
MATMUL_PRECISIONS = ("default", "high", "highest")
LR_SCHEDULES = ("auto", "sqrt_decay", "constant")
PARTITIONS = ("sorted", "shuffled")
# The JAX package's rules that accept local_steps > 1; the rest are
# refused with the JAX message.
LOCAL_STEP_ALGORITHMS = ("dsgd", "gradient_tracking")
# Gossip-compression operators (ops/compression.py) and the rules whose
# gossip goes through the error-feedback exchange when compression is on.
COMPRESSIONS = ("none", "top_k", "random_k", "qsgd")
COMPRESSED_ALGORITHMS = ("choco", "dsgd", "gradient_tracking")
# The JAX package's full lists; the values this slice lacks raise below.
ATTACKS = ("none", "sign_flip", "large_noise", "alie")
AGGREGATIONS = ("gossip", "trimmed_mean", "median", "clipped_gossip")
ROBUST_IMPLS = ("auto", "dense", "gather", "fused")
TOPOLOGY_IMPLS = ("auto", "dense", "neighbor")
# Rejoin policies after a crash-recovery outage (parallel/faults.py takes
# this constant as its REJOIN_POLICIES) and the gossip schedules: every
# (surviving) neighbour a round, one mutually proposed random peer, or the
# deterministic matchings of parallel/matchings.py.
REJOINS = ("frozen", "neighbor_restart")
GOSSIP_SCHEDULES = ("synchronous", "one_peer", "round_robin")
TOPOLOGY_SAMPLERS = ("auto", "dense", "sparse")
# The JAX package's graphs with a matrix-free (neighbour-table) builder,
# and the N at which topology_impl='auto' builds them matrix-free
# (parallel/topology.py::build_neighbor_topology).
NEIGHBOR_TOPOLOGIES = ("ring", "grid", "chain", "erdos_renyi")
MATRIX_FREE_AUTO_N = 4096
# The N past which topology_sampler='auto' draws a matrix-free Erdős–Rényi
# graph with the sparse O(N·k_max) sampler, another realization of G(n, p).
SPARSE_SAMPLER_AUTO_N = 65_536
# Huber's transition point δ: the synthetic regression data's noise scale
# (make_regression noise=10.0, utils/data.py), so the kink sits at ~1σ of
# the residuals at the optimum. The port's copy of the JAX package's
# DEFAULT_HUBER_DELTA.
DEFAULT_HUBER_DELTA = 10.0
# The per-replica scalars ``torch_backend.run_batch`` sweeps beside the
# seeds (replica r behaves exactly like a sequential run of
# ``config.replace(seed=seeds[r], **{field: values[r]})``): each enters the
# captured program as device data. Structural fields change the program
# and are refused.
SWEEPABLE_FIELDS = ("learning_rate_eta0", "clip_tau", "edge_drop_prob")
# Execution modes: the bulk-synchronous round loop, or the asynchronous
# event clock (backends/async_scan.py over parallel/events.py's schedule),
# and the latency models of its per-worker compute-time draws
# (parallel/events.py takes this tuple as its LATENCY_MODELS).
EXECUTIONS = ("sync", "async")
LATENCY_MODELS = ("constant", "exponential", "lognormal", "pareto")


def _not_yet(field: str, value: Any, allowed: tuple) -> ValueError:
    return ValueError(
        f"{field}={value!r}: the PyTorch port does not have it yet "
        f"(this slice implements {allowed})"
    )


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Hyperparameters of one experiment (the fields this slice reads)."""

    n_workers: int = 25
    local_batch_size: int = 16
    n_iterations: int = 10_000
    learning_rate_eta0: float = 0.05
    l2_regularization_lambda: float = 1e-4
    strong_convexity_mu: float = 1e-4
    problem_type: str = "quadratic"
    n_samples: int = 12_500
    n_features: int = 80
    n_informative_features: int = 50
    classification_sep: float = 0.7
    suboptimality_threshold: float = 0.08

    algorithm: str = "dsgd"
    topology: str = "ring"
    # LR schedule: 'auto' = eta0/sqrt(t+1) for the SGD-family rules,
    # constant eta0 for admm (its linear-convergence regime).
    lr_schedule: str = "auto"
    admm_c: float = 0.5  # ADMM edge-penalty coefficient
    # DLM proximal-linearization weight; must dominate the loss gradient's
    # Lipschitz constant for stability (L ≈ 4 for the standardized quadratic
    # data here, ≈ 0.25 for logistic). 5.0 is safe for both study problems.
    admm_rho: float = 5.0
    # Compressed gossip: the operator applied to each transmitted difference
    # (COMPRESSIONS), its parameter (coordinates kept for top_k/random_k,
    # quantization bits for qsgd) and the consensus step size γ.
    compression: str = "none"
    compression_k: int = 0
    choco_gamma: float = 0.3
    # Class count of the softmax family: its parameter is a [n_features,
    # n_classes] matrix, flattened (d-major) to d·K for the mixing and
    # algorithm layers.
    n_classes: int = 10
    # Huber transition point δ (problem_type='huber' only).
    huber_delta: float = DEFAULT_HUBER_DELTA
    seed: int = 203
    data_seed: int = -1
    # Seed replicates of one config run as one program over a leading [R]
    # axis (``torch_backend.run_batch``): seeds seed … seed + replicas − 1.
    replicas: int = 1
    eval_every: int = 1
    local_steps: int = 1
    # 'pallas' keeps its name so configs carry across; in the port it
    # selects the hand-written CUDA ring kernels (ops/ring_kernels.py).
    mixing_impl: str = "auto"
    sampling_impl: str = "auto"
    dtype: str = "float32"
    # The float32 matmul precision of a run on a card (MATMUL_PRECISIONS).
    matmul_precision: str = "highest"
    record_consensus: bool = True
    # 'sorted': the study's sort-by-target split; 'shuffled': a
    # seed-deterministic IID split (the Byzantine benches use it).
    partition: str = "sorted"
    # Byzantine injection: n_byzantine workers (a static seeded set) send
    # an attack payload in place of their model each gossip round.
    attack: str = "none"
    n_byzantine: int = 0
    attack_scale: float = 1.0
    # Robust aggregation: the screen honest workers apply to what they
    # receive, its per-neighbourhood budget b, and a fixed clipping radius
    # (0 = adaptive). robust_b == 0 is plain MH gossip.
    aggregation: str = "gossip"
    robust_b: int = 0
    clip_tau: float = 0.0
    # Execution form of the robust rule: 'dense' (the closed neighbourhood
    # sorted over the node axis, [N, N, d]), 'gather' (torch ops over the
    # [N, k_max] neighbour table) or 'fused' (the hand-written CUDA kernels
    # of ops/robust_kernels.py); 'auto' takes dense on the fully-connected
    # graph, else gather promoted to fused where the kernel takes the rule.
    robust_impl: str = "auto"
    # Edge probability of the two Erdős–Rényi graphs, and the seed they are
    # drawn from (-1 follows ``seed``).
    erdos_renyi_p: float = 0.4
    topology_seed: int = -1
    # The graph's representation: 'dense' ([N, N] matrices), 'neighbor' (the
    # matrix-free [N, k_max] table, ring/grid/chain/erdos_renyi) or 'auto'
    # (neighbor from MATRIX_FREE_AUTO_N workers when nothing dense-only is
    # asked for); and the matrix-free Erdős–Rényi sampler: 'dense' (the
    # [N, N] stream's graph), 'sparse' (O(N·k_max) draws) or 'auto' (sparse
    # past SPARSE_SAMPLER_AUTO_N).
    topology_impl: str = "auto"
    topology_sampler: str = "auto"
    # Failure injection (parallel/faults.py), the JAX package's fields and
    # defaults: per-round iid edge drops and stragglers; bursty edges (a
    # Gilbert-Elliott chain per edge at the same marginal rate, mean burst
    # burst_len/(1 - p); 0 = the memoryless sampler, 1 reduces to it bit
    # for bit); crash-recovery churn (mean up-time mttf, mean outage mttr
    # rounds) and what a node resumes with; per-round client sampling.
    edge_drop_prob: float = 0.0
    straggler_prob: float = 0.0
    burst_len: float = 0.0
    mttf: float = 0.0
    mttr: float = 0.0
    rejoin: str = "frozen"
    participation_rate: float = 1.0
    # 'synchronous' (all surviving neighbours), 'one_peer' (Boyd-style
    # randomized pairwise gossip) or 'round_robin' (deterministic
    # matchings covering the edge set).
    gossip_schedule: str = "synchronous"
    # 'sync' | 'async'. 'async' runs the asynchronous event clock (AD-PSGD):
    # a precomputed event schedule (parallel/events.py::build_event_timeline)
    # in place of rounds. n_iterations then counts each worker's gradient
    # steps (N events a round), eval_every keeps its round meaning, and
    # wall-clock comparisons use the schedule's virtual clock.
    execution: str = "sync"
    # The latency distribution of the per-worker compute-time draws
    # (LATENCY_MODELS), their mean in virtual seconds (every model is
    # matched-mean), and the tail knob: lognormal log-std (> 0) or pareto
    # shape alpha (> 1); 0 for constant and exponential. Async only.
    latency_model: str = "constant"
    latency_mean: float = 1.0
    latency_tail: float = 0.0

    def __post_init__(self) -> None:
        for field, allowed in (
            ("algorithm", ALGORITHMS),
            ("topology", TOPOLOGIES),
            ("problem_type", PROBLEM_TYPES),
            ("mixing_impl", MIXING_IMPLS),
            ("sampling_impl", SAMPLING_IMPLS),
            ("dtype", DTYPES),
            ("lr_schedule", LR_SCHEDULES),
        ):
            value = getattr(self, field)
            if value not in allowed:
                raise _not_yet(field, value, allowed)
        self._validate_compression()
        if self.huber_delta <= 0.0:
            raise ValueError(f"huber_delta must be positive, got {self.huber_delta}")
        if self.n_classes < 2:
            raise ValueError(
                f"n_classes must be >= 2, got {self.n_classes}"
            )
        if self.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"Unknown matmul precision: {self.matmul_precision}")
        self._validate_local_steps()
        self._validate_byzantine()
        self._validate_faults()
        self._validate_topology()
        self._validate_replicas()
        self._validate_bfloat16()
        if self.n_workers <= 0:
            raise ValueError("n_workers must be positive")
        if self.n_informative_features > self.n_features:
            raise ValueError(
                "n_informative_features cannot exceed n_features"
            )
        if self.local_batch_size <= 0:
            raise ValueError("local_batch_size must be positive")
        if self.eval_every <= 0:
            raise ValueError("eval_every must be positive")
        if self.n_iterations % self.eval_every != 0:
            raise ValueError(
                f"eval_every ({self.eval_every}) must divide n_iterations "
                f"({self.n_iterations})"
            )
        if self.topology == "grid":
            side = math.isqrt(self.n_workers)
            if side * side != self.n_workers:
                raise ValueError(
                    f"grid topology requires a perfect-square worker count, got {self.n_workers}"
                )

    def _validate_replicas(self) -> None:
        """The JAX package's checks of ``replicas``, with its messages (the
        port has no ``backend`` field, so that branch stays out)."""
        if self.replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {self.replicas}"
            )
        if self.replicas > 1:
            if self.mixing_impl in ("shard_map", "pallas"):
                raise ValueError(
                    f"replicas={self.replicas} is incompatible with "
                    f"mixing_impl={self.mixing_impl!r}: the replica axis "
                    "vmaps the whole compiled program, but shard_map "
                    "stencils pin a fixed device mesh and the pallas "
                    "kernels address unbatched VMEM blocks — use 'auto', "
                    "'dense', 'stencil', 'sparse', or 'gather' (the "
                    "sharded-gather worker_mesh route instead dispatches "
                    "replicas as sequential mesh runs — see "
                    "jax_backend.run_batch)"
                )
            if self.algorithm == "choco":
                raise ValueError(
                    "replicas > 1 is unsupported for 'choco': its step "
                    "rule derives the compressor stream from config.seed "
                    "internally, which a batched per-replica seed axis "
                    "cannot reach — replicas would silently share "
                    "compression draws; run seeds sequentially instead"
                )
            if self.compression != "none":
                raise ValueError(
                    "replicas > 1 is unsupported with compressed gossip: "
                    "the error-feedback step derives its compressor "
                    "stream from config.seed internally, which a batched "
                    "per-replica seed axis cannot reach — replicas would "
                    "silently share compression draws; run seeds "
                    "sequentially instead"
                )
            if self.robust_impl == "fused":
                raise ValueError(
                    "replicas > 1 is incompatible with "
                    "robust_impl='fused': the replica axis vmaps the "
                    "whole compiled program, but the fused pallas kernel "
                    "addresses unbatched VMEM blocks — use 'auto', "
                    "'gather', or 'dense'"
                )

    def _validate_bfloat16(self) -> None:
        """The compositions a bfloat16 run does not have yet: their kernels
        (the event entry of the sampler, the replica entries of the
        sampling, round and noise kernels) have no bfloat16 instance."""
        if self.dtype != "bfloat16":
            return
        for refused, what in (
            (self.execution == "async", "execution='async'"),
            (self.replicas > 1, f"replicas={self.replicas}"),
        ):
            if refused:
                raise ValueError(
                    f"dtype='bfloat16' with {what}: the PyTorch port does not "
                    "have it yet (bfloat16 runs the synchronous single run, "
                    "without the event clock or the replica axis)"
                )

    def _validate_topology(self) -> None:
        """The JAX package's checks of the graph fields, with its messages;
        the representations the port lacks raise."""
        if self.topology_impl not in TOPOLOGY_IMPLS:
            raise ValueError(f"Unknown topology impl: {self.topology_impl}")
        if self.topology_impl == "neighbor":
            self._validate_neighbor()
        self._validate_execution()
        if self.topology_sampler not in TOPOLOGY_SAMPLERS:
            raise ValueError(
                f"Unknown topology sampler: {self.topology_sampler!r} "
                "(expected 'auto', 'dense', or 'sparse')"
            )
        if self.topology_sampler != "auto" and self.topology != "erdos_renyi":
            raise ValueError(
                f"topology_sampler={self.topology_sampler!r} selects the "
                "matrix-free Erdős–Rényi constructor; topology="
                f"{self.topology!r} has exactly one realization and would "
                "silently ignore it — leave topology_sampler='auto'"
            )
        if self.topology_sampler == "sparse" and self.topology_impl == "dense":
            raise ValueError(
                "topology_sampler='sparse' only exists on the matrix-free "
                "path: topology_impl='dense' replays the [N, N] uniform "
                "stream as its own sampler — use topology_impl='auto' or "
                "'neighbor'"
            )
        if self.topology in DIRECTED_TOPOLOGIES and self.algorithm != "push_sum":
            raise ValueError(
                f"topology {self.topology!r} is directed: its mixing matrix "
                "is column-stochastic, not doubly stochastic, so "
                f"{self.algorithm!r} would converge to the graph's Perron "
                "weighting instead of the true average — use "
                "algorithm='push_sum', which debiases by the tracked "
                "push-sum mass"
            )
        if self.topology_seed < -1:
            raise ValueError(
                f"topology_seed must be -1 (follow seed) or >= 0, got "
                f"{self.topology_seed}"
            )

    def _validate_neighbor(self) -> None:
        """The JAX package's checks of ``topology_impl='neighbor'``, in its
        order and with its messages (the port has no ``backend`` or
        ``tp_degree`` field, so those checks stay out)."""
        if self.topology == "fully_connected":
            raise ValueError(
                "topology_impl='neighbor' with 'fully_connected' would "
                "allocate an [N, N-1] neighbor table — the quadratic "
                "object the matrix-free path exists to avoid; use "
                "topology_impl='dense' (k_max = N−1 leaves nothing "
                "for a degree-bounded route to win)"
            )
        if self.topology not in NEIGHBOR_TOPOLOGIES:
            raise ValueError(
                f"topology_impl='neighbor' supports "
                f"{NEIGHBOR_TOPOLOGIES}; {self.topology!r} has no "
                "matrix-free constructor"
            )
        if self.mixing_impl not in ("auto", "gather", "stencil"):
            raise ValueError(
                f"topology_impl='neighbor' never materializes the "
                f"[N, N] matrices that mixing_impl="
                f"{self.mixing_impl!r} consumes — use 'auto', "
                "'gather', or 'stencil'. To run the gather path over "
                "real collectives, shard the worker axis instead: "
                "worker_mesh >= 2 lowers gather mixing to a ppermute "
                "halo exchange (the sharded-gather path; "
                "docs/PERF.md §16) — mixing_impl='shard_map' is the "
                "dense-representation stencil form only"
            )
        if self.byzantine_active and self.robust_impl not in ("auto", "gather"):
            raise ValueError(
                f"topology_impl='neighbor' runs robust aggregation in "
                f"gather form over the [N, k_max] table; robust_impl="
                f"{self.robust_impl!r} materializes dense/VMEM objects "
                "the matrix-free path never builds — use 'auto' or "
                "'gather'"
            )
        if self.gossip_schedule != "synchronous":
            raise ValueError(
                "topology_impl='neighbor' requires "
                "gossip_schedule='synchronous' (matching schedules "
                "sample partners from the dense adjacency)"
            )

    def _validate_execution(self) -> None:
        """The JAX package's checks of ``execution`` and the latency fields,
        in its order and with its messages (the port has no ``backend`` or
        ``tp_degree`` field, so those clauses stay out)."""
        if self.execution not in EXECUTIONS:
            raise ValueError(f"Unknown execution mode: {self.execution}")
        if self.latency_model not in LATENCY_MODELS:
            raise ValueError(f"Unknown latency model: {self.latency_model}")
        if self.execution == "sync":
            if (
                self.latency_model != "constant"
                or self.latency_mean != 1.0
                or self.latency_tail != 0.0
            ):
                raise ValueError(
                    "latency_model/latency_mean/latency_tail shape the "
                    "asynchronous event schedule; execution='sync' would "
                    "silently ignore them — set execution='async'"
                )
            return
        if self.latency_mean <= 0.0:
            raise ValueError(
                f"latency_mean must be positive, got {self.latency_mean}"
            )
        if self.latency_model == "lognormal" and self.latency_tail <= 0.0:
            raise ValueError(
                "latency_model='lognormal' needs latency_tail > 0 "
                "(the log-std tail knob)"
            )
        if self.latency_model == "pareto" and self.latency_tail <= 1.0:
            raise ValueError(
                "latency_model='pareto' needs latency_tail > 1 (the "
                "shape alpha; alpha <= 1 has no finite mean)"
            )
        if (
            self.latency_model in ("constant", "exponential")
            and self.latency_tail != 0.0
        ):
            raise ValueError(
                f"latency_tail only shapes the lognormal/pareto tails; "
                f"latency_model={self.latency_model!r} would silently "
                "ignore it"
            )
        if self.algorithm not in ("dsgd", "gradient_tracking"):
            raise ValueError(
                f"execution='async' is unsupported for "
                f"{self.algorithm!r}: an event applies ONE worker's "
                "update at its realized staleness — only dsgd's "
                "pairwise-average descent and gradient tracking's "
                "per-event tracker telescoping have an event form; "
                "EXTRA/ADMM's static-W fixed points, CHOCO's shared "
                "estimates and push-sum's mass pair do not — use "
                "algorithm='dsgd' or 'gradient_tracking'"
            )
        if self.topology in DIRECTED_TOPOLOGIES:
            raise ValueError(
                "execution='async' realizes mutual pairwise exchanges; "
                f"directed topology {self.topology!r} has one-way links"
            )
        if self.attack != "none" or (
            self.aggregation != "gossip" and self.robust_b > 0
        ):
            raise ValueError(
                "execution='async' does not compose with Byzantine "
                "injection / robust aggregation: screening needs "
                "multiple received messages per aggregation, but an "
                "event delivers exactly one pairwise exchange — no "
                "trimming/clipping budget is realizable"
            )
        if self.compression != "none":
            raise ValueError(
                "execution='async' does not compose with compressed "
                "gossip: the error-feedback estimate exchange assumes "
                "synchronized rounds, which the event schedule removes"
            )
        if self.replicas > 1:
            raise ValueError(
                "execution='async' is a sequential scan over a totally "
                "ordered event schedule; the tensor-parallel mesh and "
                "the replica vmap axis have no event form — run "
                "tp_degree=1, replicas=1"
            )
        if self.topology_impl == "neighbor":
            raise ValueError(
                "execution='async' scans events over the dense-"
                "representation topology (its regime is modest N with "
                "long horizons, not the matrix-free 10k+ axis); use "
                "topology_impl='dense' or 'auto'"
            )

    def _validate_compression(self) -> None:
        """The JAX package's checks of the compression fields, in its order
        and with its messages (those against fault and schedule fields the
        port lacks stay out)."""
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"Unknown compression: {self.compression}")
        if self.compression != "none":
            if self.algorithm not in COMPRESSED_ALGORITHMS:
                raise ValueError(
                    f"compression={self.compression!r} only takes effect "
                    f"with the error-feedback gossip algorithms "
                    f"{COMPRESSED_ALGORITHMS}; other algorithms exchange "
                    "full vectors and would silently ignore it"
                )
            if self.compression_k <= 0:
                raise ValueError(
                    "compression_k (coordinates kept, or qsgd bits) must be "
                    f"positive when compression={self.compression!r}"
                )
            if (
                self.edge_drop_prob > 0.0
                or self.straggler_prob > 0.0
                or self.mttf > 0.0
                or self.gossip_schedule != "synchronous"
            ):
                raise ValueError(
                    "compressed gossip does not compose with time-varying "
                    "graphs: a dropped exchange leaves the neighbor's copy "
                    "of the shared error-feedback estimate stale, which "
                    "the single shared X̂ leaf cannot represent (per-edge "
                    "[N, N, d] staleness state would be needed) — run "
                    "faults uncompressed, or compression on a static graph"
                )
            if self.attack != "none" or self.aggregation != "gossip":
                raise ValueError(
                    "compressed gossip does not compose with Byzantine "
                    "injection / robust aggregation: screening operates "
                    "on transmitted models, but error-feedback exchanges "
                    "compressed DIFFERENCES against a shared estimate — "
                    "a screened-out update still mutates every neighbor's "
                    "X̂ copy, silently breaking the defense's contract"
                )
        if (
            self.algorithm == "choco" or self.compression != "none"
        ) and not 0.0 < self.choco_gamma <= 1.0:
            raise ValueError(
                f"choco_gamma must be in (0, 1], got {self.choco_gamma}"
            )

    def _validate_local_steps(self) -> None:
        """The JAX package's check of ``local_steps``, with its messages."""
        if self.local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {self.local_steps}")
        if self.local_steps > 1 and self.algorithm not in LOCAL_STEP_ALGORITHMS:
            raise ValueError(
                f"local_steps={self.local_steps} is unsupported for "
                f"{self.algorithm!r}: τ local descents between gossip "
                "exchanges only compose with the mix-based rules "
                f"{LOCAL_STEP_ALGORITHMS} (EXTRA/ADMM/CHOCO/push-sum "
                "pin a one-exchange-per-descent recursion that extra "
                "local steps would silently break)"
            )
        if self.local_steps > 1 and self.compression != "none":
            raise ValueError(
                "local_steps > 1 does not compose with compressed "
                "gossip: the error-feedback estimate exchange assumes "
                "one descent per transmitted difference — τ local "
                "steps between exchanges would leave the shared X̂ "
                "tracking a state it never saw"
            )

    def _validate_byzantine(self) -> None:
        """The JAX package's checks of the Byzantine fields, in its order
        and with its messages."""
        if self.partition not in PARTITIONS:
            raise ValueError(f"Unknown partition: {self.partition}")
        if self.attack not in ATTACKS:
            raise ValueError(f"Unknown attack: {self.attack}")
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"Unknown aggregation: {self.aggregation}")
        if self.n_byzantine < 0:
            raise ValueError(
                f"n_byzantine must be >= 0, got {self.n_byzantine}"
            )
        if (self.attack == "none") != (self.n_byzantine == 0):
            raise ValueError(
                f"attack={self.attack!r} and n_byzantine="
                f"{self.n_byzantine} must be set together: an attack needs "
                "attackers, and Byzantine workers need a payload to send"
            )
        if self.attack != "none":
            if self.n_byzantine >= self.n_workers:
                raise ValueError(
                    f"n_byzantine ({self.n_byzantine}) must leave at least "
                    f"one honest worker out of {self.n_workers}"
                )
            if self.attack_scale <= 0.0:
                raise ValueError(
                    f"attack_scale must be positive, got {self.attack_scale}"
                )
        elif self.attack_scale != 1.0:
            raise ValueError(
                f"attack_scale={self.attack_scale} only takes effect with "
                "an attack; attack='none' would silently ignore it"
            )
        if self.robust_b < 0:
            raise ValueError(f"robust_b must be >= 0, got {self.robust_b}")
        if self.robust_b > 0 and self.aggregation == "gossip":
            raise ValueError(
                f"robust_b={self.robust_b} only takes effect with a robust "
                "aggregation rule; plain 'gossip' has no screening step and "
                "would silently ignore it"
            )
        if self.robust_impl not in ROBUST_IMPLS:
            raise ValueError(f"Unknown robust impl: {self.robust_impl}")
        if self.robust_impl != "auto" and not self.robust_active:
            raise ValueError(
                f"robust_impl={self.robust_impl!r} selects the execution "
                "form of a robust aggregation rule; without one (a non-"
                "gossip aggregation and robust_b > 0) it would be silently "
                "ignored"
            )
        if self.clip_tau < 0.0:
            raise ValueError(f"clip_tau must be >= 0, got {self.clip_tau}")
        if self.clip_tau > 0.0 and self.aggregation != "clipped_gossip":
            raise ValueError(
                f"clip_tau only applies to aggregation='clipped_gossip'; "
                f"{self.aggregation!r} would silently ignore it"
            )
        if self.aggregation != "gossip" and self.gossip_schedule != "synchronous":
            raise ValueError(
                f"aggregation={self.aggregation!r} screens MULTIPLE received "
                "neighbor messages per round; matching schedules "
                f"({self.gossip_schedule!r}) deliver at most one, so no "
                "trimming/clipping budget is realizable — use 'synchronous'"
            )

    def _validate_faults(self) -> None:
        """The JAX package's checks of the fault and schedule fields, in its
        order and with its messages."""
        if not 0.0 <= self.edge_drop_prob < 1.0:
            raise ValueError(
                f"edge_drop_prob must be in [0, 1), got {self.edge_drop_prob}"
            )
        if not 0.0 <= self.straggler_prob < 1.0:
            raise ValueError(
                f"straggler_prob must be in [0, 1), got {self.straggler_prob}"
            )
        if self.burst_len != 0.0 and self.burst_len < 1.0:
            raise ValueError(
                f"burst_len must be 0 (iid edge drops) or >= 1 (mean burst "
                f"multiplier), got {self.burst_len}"
            )
        if self.burst_len != 0.0 and self.edge_drop_prob == 0.0:
            raise ValueError(
                f"burst_len={self.burst_len} shapes the edge-failure "
                "process and needs edge_drop_prob > 0; without a drop rate "
                "it would be silently ignored"
            )
        if (self.mttf > 0.0) != (self.mttr > 0.0):
            raise ValueError(
                f"mttf ({self.mttf}) and mttr ({self.mttr}) must be set "
                "together: crash-recovery churn needs both a mean up-time "
                "and a mean outage length"
            )
        if self.mttf < 0.0 or self.mttr < 0.0:
            raise ValueError(
                f"mttf/mttr must be >= 0, got ({self.mttf}, {self.mttr})"
            )
        if self.mttf > 0.0:
            if self.mttf < 1.0 or self.mttr < 1.0:
                raise ValueError(
                    "mttf/mttr are mean holding times in rounds and must "
                    f"be >= 1, got ({self.mttf}, {self.mttr})"
                )
            if self.straggler_prob > 0.0:
                raise ValueError(
                    "crash-recovery churn (mttf/mttr) replaces iid "
                    "stragglers; set straggler_prob=0 (the iid model is "
                    "churn at mttf=1/q, mttr=1/(1-q))"
                )
            if self.gossip_schedule != "synchronous":
                raise ValueError(
                    "crash-recovery churn requires "
                    "gossip_schedule='synchronous': rejoin policies act on "
                    "the realized neighborhood, which matching schedules "
                    f"({self.gossip_schedule!r}, at most one partner per "
                    "round) cannot supply"
                )
        if self.rejoin not in REJOINS:
            raise ValueError(f"Unknown rejoin policy: {self.rejoin}")
        if self.rejoin == "neighbor_restart" and self.byzantine_active:
            raise ValueError(
                "rejoin='neighbor_restart' does not compose with Byzantine "
                "injection / robust aggregation: the warm restart averages "
                "neighbors' raw model rows, bypassing both the attack "
                "payloads and the screening rule — it would model an "
                "unrealistically safe rejoin at exactly the moment an "
                "adversary controls the unscreened average. Use "
                "rejoin='frozen' under attack"
            )
        if self.rejoin != "frozen" and self.mttf == 0.0:
            raise ValueError(
                f"rejoin={self.rejoin!r} only takes effect with "
                "crash-recovery churn (mttf/mttr); without outages there "
                "are no rejoin rounds and it would be silently ignored"
            )
        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError(
                f"participation_rate must be in (0, 1], got "
                f"{self.participation_rate}"
            )
        if self.participation_rate < 1.0:
            if self.algorithm == "centralized":
                raise ValueError(
                    "participation_rate models per-round client sampling "
                    "of peer exchanges; the centralized pattern has no "
                    "peer edges — it applies to decentralized algorithms "
                    "only"
                )
            if self.gossip_schedule != "synchronous":
                raise ValueError(
                    "participation_rate < 1 requires "
                    "gossip_schedule='synchronous': the sampled subgraph "
                    "reweights the whole realized neighborhood, which "
                    f"matching schedules ({self.gossip_schedule!r}) "
                    "cannot supply"
                )
            if self.compression != "none":
                raise ValueError(
                    "participation_rate < 1 does not compose with "
                    "compressed gossip (same reason as edge faults: a "
                    "sampled-out round leaves neighbors' error-feedback "
                    "estimates stale) — sample participation uncompressed"
                )
        if self.gossip_schedule not in GOSSIP_SCHEDULES:
            raise ValueError(
                f"Unknown gossip schedule: {self.gossip_schedule}"
            )
        if self.gossip_schedule == "round_robin" and (
            self.edge_drop_prob > 0.0 or self.straggler_prob > 0.0
        ):
            raise ValueError(
                "round_robin is a deterministic schedule; combine failure "
                "injection with 'synchronous' or 'one_peer' instead"
            )
        if (
            self.topology in DIRECTED_TOPOLOGIES
            and self.gossip_schedule != "synchronous"
        ):
            raise ValueError(
                f"gossip_schedule={self.gossip_schedule!r} realizes mutual "
                "pairwise matchings, an undirected construction; directed "
                f"topology {self.topology!r} has one-way links — use "
                "'synchronous' (edge_drop_prob/straggler_prob compose with "
                "it via column-stochastic renormalization of surviving "
                "out-links)"
            )

    @property
    def faults_active(self) -> bool:
        """Any synchronous node or edge fault process (the JAX package's
        ``config_faults_active``)."""
        return (
            self.edge_drop_prob > 0.0
            or self.straggler_prob > 0.0
            or self.mttf > 0.0
            or self.participation_rate < 1.0
        )

    @property
    def time_varying(self) -> bool:
        """A fault process or a matching schedule: the round's graph changes
        with t (the JAX package's ``_build_faulty`` test)."""
        return self.faults_active or self.gossip_schedule != "synchronous"

    @property
    def robust_active(self) -> bool:
        """A robust rule with a positive budget screens the gossip."""
        return self.aggregation != "gossip" and self.robust_b > 0

    @property
    def byzantine_active(self) -> bool:
        """An attack to simulate or a robust rule to defend with."""
        return self.attack != "none" or self.robust_active

    def resolved_robust_impl(self, k_max: int, *, fused_eligible: bool = False) -> str:
        """Resolve robust_impl='auto' as the JAX package does: dense when
        k_max + 1 >= N (the fully-connected graph), else gather, promoted
        to fused when the backend reports the kernel eligible. An explicit
        robust_impl is kept."""
        if self.robust_impl != "auto":
            return self.robust_impl
        if k_max + 1 >= self.n_workers:
            return "dense"
        return "fused" if fused_eligible else "gather"

    def replica_seeds(self) -> list[int]:
        """The per-replica seed vector a replicated run sweeps: seed,
        seed+1, ..., seed+replicas−1 (length 1 for single runs)."""
        return [self.seed + r for r in range(self.replicas)]

    def resolved_topology_seed(self) -> int:
        """``topology_seed`` when pinned (>= 0), else ``seed``."""
        return self.topology_seed if self.topology_seed >= 0 else self.seed

    def resolved_topology_impl(self) -> str:
        """The JAX package's rule for an unsharded synchronous run: 'neighbor'
        at N >= MATRIX_FREE_AUTO_N for the graphs with a matrix-free builder
        when no dense-only feature is asked for (a mixing form that reads
        [N, N] matrices, an attack or a robust rule, a matching schedule,
        the async event clock), else 'dense'. Fault processes are not
        dense-only."""
        if self.topology_impl != "auto":
            return self.topology_impl
        dense_only = (
            self.topology not in NEIGHBOR_TOPOLOGIES
            or self.mixing_impl not in ("auto", "gather", "stencil")
            or self.attack != "none"
            or self.robust_active
            or self.gossip_schedule != "synchronous"
            or self.execution == "async"
        )
        if not dense_only and self.n_workers >= MATRIX_FREE_AUTO_N:
            return "neighbor"
        return "dense"

    def resolved_topology_sampler(self) -> str:
        """The JAX package's rule: the sparse Erdős–Rényi sampler past
        SPARSE_SAMPLER_AUTO_N workers on the matrix-free ER path, else the
        dense-stream sampler."""
        if self.topology_sampler != "auto":
            return self.topology_sampler
        if (self.topology == "erdos_renyi"
                and self.resolved_topology_impl() == "neighbor"
                and self.n_workers > SPARSE_SAMPLER_AUTO_N):
            return "sparse"
        return "dense"

    def resolved_data_seed(self) -> int:
        """``data_seed`` when pinned (>= 0), else ``seed``."""
        return self.data_seed if self.data_seed >= 0 else self.seed

    def resolved_sampling_impl(self, platform: str, n_local: int) -> str:
        """Resolve sampling_impl='auto' as the JAX package does: dense
        weights on an accelerator when the padded shard has at most 64
        rows, gather otherwise and always on the CPU."""
        if self.sampling_impl != "auto":
            return self.sampling_impl
        if platform != "cpu" and n_local <= 64:
            return "dense"
        return "gather"

    def resolved_lr_schedule(self) -> str:
        """The JAX package's rule: the SGD-family rules take the decaying
        step, the dual method its constant one."""
        if self.lr_schedule != "auto":
            return self.lr_schedule
        return (
            "sqrt_decay"
            if self.algorithm in ("centralized", "dsgd", "push_sum")
            else "constant"
        )

    @property
    def reg_param(self) -> float:
        """mu for the quadratic problem, lambda otherwise (logistic, huber,
        softmax)."""
        return (
            self.strong_convexity_mu
            if self.problem_type == "quadratic"
            else self.l2_regularization_lambda
        )

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)
