"""How far the port's bfloat16 runs on the CPU lie from the JAX package's.

    JAX_PLATFORMS=cpu python tests/torch_bfloat16_agreement.py [name ...]

Not a test (pytest collects ``test_*.py`` only): the measurement that
``tests/test_torch_bfloat16.py`` and PERF.md state their bfloat16
tolerances from. Each configuration (N = 8 workers, T = 300, an eval every
30, the data of the port's generator, f* of the port's oracle) runs through
``torch_backend.run(..., device="cpu")`` and through ``jax_backend.run``
twice: its measured chunk loop (``measure_timestamps=True``), whose eval
is a program of its own, and its default flat scan, inside which XLA fuses
the step's last operation into the eval. One line a configuration: whether
the final models are bitwise, their largest difference relative to the
largest |x|, and the largest gap difference against each JAX run in
bfloat16 ulps of f(x̄) = gap + f*. About 10 s a configuration.

    JAX_PLATFORMS=cpu python tests/torch_bfloat16_agreement.py --split

shows, for the configurations whose trajectories part, the first T at which
they part on an injected batch schedule.
"""

from __future__ import annotations

import sys

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
