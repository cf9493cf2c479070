"""How far the port's bfloat16 runs on the CPU lie from the JAX package's.

    JAX_PLATFORMS=cpu python tests/torch_bfloat16_agreement.py [name ...]

Not a test (pytest collects ``test_*.py`` only): the measurement that
``tests/test_torch_bfloat16.py``, ``tests/test_torch_bfloat16_layers.py``
and PERF.md state their bfloat16 tolerances from. Each configuration (N = 8
workers, T = 300, an eval every
30, the data of the port's generator, f* of the port's oracle) runs through
``torch_backend.run(..., device="cpu")`` and through ``jax_backend.run``
twice: its measured chunk loop (``measure_timestamps=True``), whose eval
is a program of its own, and its default flat scan, inside which XLA fuses
the step's last operation into the eval. One line a configuration: whether
the final models are bitwise, their largest difference relative to the
largest |x|, and the largest gap difference against each JAX run in
bfloat16 ulps of f(x̄) = gap + f*. About 10 s a configuration.

XLA's CPU products sum in an order that depends on the host devices it is
given, and so do the JAX package's bfloat16 runs. The script gives XLA the
test suite's eight host devices (``tests/conftest.py``) unless XLA_FLAGS
already sets a count: ``XLA_FLAGS=--xla_force_host_platform_device_count=1``
measures against the one-device programs.

    JAX_PLATFORMS=cpu python tests/torch_bfloat16_agreement.py --split

shows, for the configurations whose trajectories part, the first T at which
they part on an injected batch schedule.
"""

from __future__ import annotations

import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import HostDataset as RefHostDataset
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.ops.rounding import scalar
from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

BASE = dict(n_workers=8, n_samples=320, n_features=8, n_informative_features=4,
            n_iterations=300, local_batch_size=8, problem_type="quadratic",
            algorithm="dsgd", topology="ring", eval_every=30, dtype="bfloat16")
SOFTMAX = dict(problem_type="softmax", n_classes=5, n_samples=400, n_features=12,
               n_informative_features=8)
CONFIGS = {
    "dsgd-quadratic": {},
    "dsgd-logistic": dict(problem_type="logistic"),
    "dsgd-huber": dict(problem_type="huber"),
    "dsgd-softmax": SOFTMAX,
    "gradient-tracking": dict(algorithm="gradient_tracking"),
    "extra": dict(algorithm="extra"),
    "admm": dict(algorithm="admm"),
    "centralized": dict(algorithm="centralized"),
    "push-sum-directed-ring": dict(algorithm="push_sum", topology="directed_ring"),
    "dsgd-logistic-pallas": dict(problem_type="logistic", mixing_impl="pallas"),
    "dsgd-edge-drop": dict(edge_drop_prob=0.2),
    "dsgd-fc-pallas": dict(topology="fully_connected", mixing_impl="pallas"),
    "dsgd-dense-sampling": dict(sampling_impl="dense"),
    "dsgd-er-gather": dict(topology="erdos_renyi", mixing_impl="gather"),
    "dsgd-er-sparse": dict(topology="erdos_renyi", mixing_impl="sparse"),
    "dsgd-grid": dict(topology="grid", n_workers=9, n_samples=360),
    "dsgd-one-peer": dict(gossip_schedule="one_peer"),
    "gradient-tracking-huber-pallas": dict(algorithm="gradient_tracking", problem_type="huber",
                                           mixing_impl="pallas"),
    "extra-logistic-small-step": dict(algorithm="extra", problem_type="logistic",
                                      learning_rate_eta0=0.0005),
    "admm-softmax": dict(algorithm="admm", **SOFTMAX),
    "centralized-logistic-dense-sampling": dict(algorithm="centralized",
                                                problem_type="logistic", sampling_impl="dense"),
    "dsgd-softmax-fc-pallas": dict(topology="fully_connected", mixing_impl="pallas", **SOFTMAX),
    "gradient-tracking-softmax-b16": dict(algorithm="gradient_tracking", local_batch_size=16,
                                          **SOFTMAX),
    "dsgd-huber-star-dense": dict(problem_type="huber", topology="star", mixing_impl="dense"),
    "dsgd-logistic-chain-stragglers": dict(problem_type="logistic", topology="chain",
                                           straggler_prob=0.1),
    "dsgd-round-robin": dict(gossip_schedule="round_robin"),
    "dsgd-logistic-chain": dict(problem_type="logistic", topology="chain"),
    "dsgd-logistic-stragglers": dict(problem_type="logistic", straggler_prob=0.1),
    "dsgd-chain-edge-drop": dict(problem_type="logistic", topology="chain", edge_drop_prob=0.2),
    "admm-full-batch": dict(algorithm="admm", local_batch_size=40),
}
# The Byzantine, compressed and matrix-free layers.
_SIGN_FLIP = dict(attack="sign_flip", n_byzantine=1)
_ER = dict(topology="erdos_renyi", erdos_renyi_p=0.5)
_NEIGHBOR = dict(topology_impl="neighbor")
_EF = dict(compression_k=3, choco_gamma=0.3)
CONFIGS.update({
    "trimmed-mean-fused-pallas": dict(**_SIGN_FLIP, aggregation="trimmed_mean", robust_b=1,
                                      robust_impl="fused", mixing_impl="pallas"),
    "median-fused-logistic": dict(**_SIGN_FLIP, aggregation="median", robust_b=1,
                                  robust_impl="fused", problem_type="logistic"),
    "alie-clipping-fused-huber": dict(attack="alie", n_byzantine=1,
                                      aggregation="clipped_gossip", robust_b=1,
                                      robust_impl="fused", problem_type="huber"),
    "large-noise-clipping-fused": dict(attack="large_noise", n_byzantine=1, attack_scale=5.0,
                                       aggregation="clipped_gossip", robust_b=1,
                                       robust_impl="fused"),
    "large-noise-median-gather-softmax": dict(attack="large_noise", n_byzantine=1,
                                              aggregation="median", robust_b=1,
                                              robust_impl="gather", **SOFTMAX),
    "gt-alie-median-fused-logistic": dict(algorithm="gradient_tracking", attack="alie",
                                          n_byzantine=1, aggregation="median", robust_b=1,
                                          robust_impl="fused", problem_type="logistic"),
    "trimmed-mean-gather-edge-drop": dict(**_SIGN_FLIP, aggregation="trimmed_mean",
                                          robust_b=1, robust_impl="gather", edge_drop_prob=0.2),
    "trimmed-mean-dense-fc": dict(**_SIGN_FLIP, aggregation="trimmed_mean", robust_b=1,
                                  robust_impl="dense", topology="fully_connected"),
    "trimmed-mean-fused-er": dict(**_SIGN_FLIP, **_ER, aggregation="trimmed_mean", robust_b=1,
                                  robust_impl="fused"),
    "choco-top-k": dict(algorithm="choco", compression="top_k", **_EF),
    "choco-top-k-logistic": dict(algorithm="choco", compression="top_k",
                                 problem_type="logistic", **_EF),
    "choco-qsgd-huber": dict(algorithm="choco", compression="qsgd", compression_k=4,
                             choco_gamma=0.3, problem_type="huber"),
    "choco-random-k-fc-pallas": dict(algorithm="choco", compression="random_k",
                                     topology="fully_connected", mixing_impl="pallas", **_EF),
    "dsgd-qsgd-4-bits": dict(compression="qsgd", compression_k=4, choco_gamma=0.3),
    "dsgd-top-k-softmax": dict(compression="top_k", **_EF, **SOFTMAX),
    "gt-random-k": dict(algorithm="gradient_tracking", compression="random_k", **_EF),
    "gt-qsgd-logistic": dict(algorithm="gradient_tracking", compression="qsgd",
                             compression_k=4, choco_gamma=0.3, problem_type="logistic"),
    "neighbor-ring": dict(**_NEIGHBOR),
    "neighbor-ring-edge-drop": dict(**_NEIGHBOR, edge_drop_prob=0.2),
    "neighbor-er-edge-drop-participation": dict(**_NEIGHBOR, **_ER, edge_drop_prob=0.2,
                                                participation_rate=0.5),
    "neighbor-grid-logistic-stragglers": dict(**_NEIGHBOR, topology="grid", n_workers=9,
                                              n_samples=360, problem_type="logistic",
                                              straggler_prob=0.1),
    "neighbor-er-gather-screen": dict(**_NEIGHBOR, **_ER, **_SIGN_FLIP,
                                      aggregation="trimmed_mean", robust_b=1,
                                      robust_impl="gather"),
    "neighbor-er-gt-edge-drop": dict(**_NEIGHBOR, **_ER, algorithm="gradient_tracking",
                                     edge_drop_prob=0.2),
    "neighbor-chain-huber-edge-drop": dict(**_NEIGHBOR, topology="chain", problem_type="huber",
                                           edge_drop_prob=0.2),
})


def _ulps(diff: np.ndarray, gap: np.ndarray, f_star: float) -> float:
    f = np.abs(gap + f_star)
    return float(np.max(np.abs(diff) / np.exp2(np.floor(np.log2(np.maximum(f, 2.0 ** -126)))
                                                - 7)))


def measure(name: str) -> str:
    fields = {**BASE, **CONFIGS[name]}
    ours = generate_synthetic_dataset(ExperimentConfig(**fields))
    ref = RefHostDataset(X_full=ours.X_full, y_full=ours.y_full,
                         shard_indices=ours.shard_indices, problem_type=ours.problem_type)
    f_opt = float(compute_reference_optimum(ours, ExperimentConfig(**fields).reg_param)[1])
    port = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu")
    chunk = jax_backend.run(RefConfig(**fields), ref, f_opt, measure_timestamps=True)
    flat = jax_backend.run(RefConfig(**fields), ref, f_opt)
    f_star = scalar(f_opt, torch.bfloat16)
    gp = port.history.objective
    parts = []
    for label, res in (("chunk loop", chunk), ("flat scan", flat)):
        gj = np.asarray(res.history.objective)
        models = np.asarray(res.final_models, dtype=np.float64)
        same = np.array_equal(models, port.final_models)
        rel = float(np.max(np.abs(port.final_models - models)) / np.max(np.abs(models)))
        parts.append(f"{label}: models {'bitwise' if same else f'{rel:.3e}'}, gap "
                     f"{_ulps(gp - gj, gj, f_star):.0f} ulps")
    return f"{name:38s} " + "; ".join(parts)


# The configurations whose trajectories the products' summation order
# splits (the chunk loop's models part): ``--split`` shows where.
SPLIT = ("dsgd-logistic-chain-stragglers", "admm-full-batch")


def split(name: str) -> str:
    """On an injected batch schedule (the same batches by construction), the
    first T whose final models part from the JAX chunk loop's (searched a
    window of the eval cadence at a time, then iteration by iteration), the
    elements that differ and the largest difference relative to the
    largest |x|."""
    fields = {**BASE, **CONFIGS[name]}
    ours = generate_synthetic_dataset(ExperimentConfig(**fields))
    ref = RefHostDataset(X_full=ours.X_full, y_full=ours.y_full,
                         shard_indices=ours.shard_indices, problem_type=ours.problem_type)
    n, b, every = fields["n_workers"], fields["local_batch_size"], fields["eval_every"]
    L = min(len(s) for s in ours.shard_indices)
    rng = np.random.default_rng(0)
    sched = np.stack([np.stack([rng.permutation(L)[:b] for _ in range(n)])
                      for _ in range(fields["n_iterations"])])

    def parted(T):
        cut = {**fields, "n_iterations": T, "eval_every": every if T % every == 0 else 1}
        port = torch_backend.run(ExperimentConfig(**cut), ours, 0.0, device="cpu",
                                 batch_schedule=sched[:T])
        chunk = jax_backend.run(RefConfig(**cut), ref, 0.0, measure_timestamps=True,
                                batch_schedule=sched[:T])
        models = np.asarray(chunk.final_models, dtype=np.float64)
        if np.array_equal(models, port.final_models):
            return None
        rel = float(np.max(np.abs(port.final_models - models)) / np.max(np.abs(models)))
        return int(np.sum(models != port.final_models)), rel

    for window in range(every, fields["n_iterations"] + 1, every):
        if parted(window) is not None:
            for T in range(window - every + 1, window + 1):
                found = parted(T)
                if found is not None:
                    return (f"{name:38s} injected batches: bitwise through T = {T - 1}, at T = "
                            f"{T} {found[0]} elements part, by {found[1]:.3e} of the largest |x|")
    return f"{name:38s} injected batches: bitwise through T = {fields['n_iterations']}"


if __name__ == "__main__":
    if sys.argv[1:2] == ["--split"]:
        for name in sys.argv[2:] or SPLIT:
            print(split(name), flush=True)
    else:
        for name in sys.argv[1:] or CONFIGS:
            print(measure(name), flush=True)
