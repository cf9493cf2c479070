"""Failure injection in the port: whole runs held to the JAX package on the CPU.

D-SGD, gradient tracking and push-sum under edge drops, stragglers, both,
one-peer and round-robin gossip, bursty edges, crash-recovery churn under
both rejoin policies and participation sampling agree with
``jax_backend.run`` to 1e-12 in float64 on the JAX package's own batches,
with the floats transmitted exactly equal. The Byzantine screens under
faults are ``test_torch_fault_screens.py``; the timelines, rounds and
refusals ``test_torch_fault_rounds.py``.
"""

import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.parallel import faults, matchings
from distributed_optimization_tpu_torch.parallel.topology import build_topology

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=9, n_samples=450, n_features=10, n_informative_features=6,
             n_iterations=60, topology="ring", local_batch_size=16, dtype="float64",
             problem_type="logistic", eval_every=10)
BYZ = dict(n_workers=12, n_samples=480, partition="shuffled", attack="sign_flip",
           n_byzantine=2, attack_scale=2.0)

# name -> the fields each run sets over SMALL.
RUNS = {
    "dsgd-edges": dict(edge_drop_prob=0.2),
    "dsgd-stragglers": dict(straggler_prob=0.2),
    "dsgd-both": dict(edge_drop_prob=0.2, straggler_prob=0.1),
    "dsgd-one-peer": dict(gossip_schedule="one_peer"),
    "dsgd-one-peer-faulted": dict(gossip_schedule="one_peer", edge_drop_prob=0.3,
                                  straggler_prob=0.1),
    "dsgd-one-peer-bursty": dict(gossip_schedule="one_peer", edge_drop_prob=0.3,
                                 burst_len=3.0),
    "dsgd-round-robin": dict(gossip_schedule="round_robin"),
    "dsgd-round-robin-odd": dict(gossip_schedule="round_robin", n_workers=7),
    "dsgd-bursty": dict(edge_drop_prob=0.3, burst_len=4.0),
    "dsgd-churn-frozen": dict(mttf=10.0, mttr=4.0),
    "dsgd-churn-restart": dict(mttf=10.0, mttr=4.0, rejoin="neighbor_restart"),
    "dsgd-participation": dict(participation_rate=0.7),
    "dsgd-everything": dict(participation_rate=0.7, edge_drop_prob=0.2, burst_len=3.0,
                            mttf=8.0, mttr=3.0, rejoin="neighbor_restart"),
    "dsgd-er-edges": dict(topology="erdos_renyi", erdos_renyi_p=0.4, edge_drop_prob=0.25),
    "dsgd-grid-round-robin": dict(topology="grid", n_workers=16, n_samples=480,
                                  gossip_schedule="round_robin"),
    "dsgd-tau2-edges": dict(local_steps=2, edge_drop_prob=0.2, straggler_prob=0.1),
    "dsgd-pallas-edges": dict(mixing_impl="pallas", edge_drop_prob=0.2),
    "gt-both": dict(algorithm="gradient_tracking", edge_drop_prob=0.2, straggler_prob=0.1),
    "gt-one-peer": dict(algorithm="gradient_tracking", gossip_schedule="one_peer"),
    "gt-churn-restart": dict(algorithm="gradient_tracking", mttf=10.0, mttr=4.0,
                             rejoin="neighbor_restart"),
    "ps-edges": dict(algorithm="push_sum", topology="directed_ring", edge_drop_prob=0.2),
    "ps-er-both": dict(algorithm="push_sum", topology="directed_erdos_renyi",
                       erdos_renyi_p=0.3, edge_drop_prob=0.2, straggler_prob=0.1),
    "ps-bursty-participation": dict(algorithm="push_sum", topology="directed_ring",
                                    edge_drop_prob=0.2, burst_len=3.0,
                                    participation_rate=0.8),
}


@pytest.fixture(scope="module")
def datasets():
    """(dataset, port dataset, f_opt) by (n_samples, n_workers, partition, problem)."""
    cache = {}

    def get(fields):
        key = tuple(fields.get(k, "sorted") for k in
                    ("n_samples", "n_workers", "partition", "problem_type"))
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices,
                                          ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


def _both(datasets, **kw):
    fields = {**SMALL, **kw}
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    return ref, ours


def _assert_same_run(ref, ours):
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax_backend_under_faults(datasets, name):
    ref, ours = _both(datasets, **RUNS[name])
    _assert_same_run(ref, ours)
    assert np.all(np.isfinite(ours.history.objective))


def test_fault_free_and_round_robin_floats(datasets):
    """Fault-free floats are the analytic 2|E|·d·T; round-robin on an even
    ring realizes exactly half (each phase a perfect matching)."""
    ref, ours = _both(datasets, gossip_schedule="round_robin", n_workers=10, n_samples=500)
    _, free = _both(datasets, n_workers=10, n_samples=500)
    d, T = SMALL["n_features"] + 1, SMALL["n_iterations"]
    assert free.total_floats_transmitted == 2 * 10 * d * T
    assert ours.total_floats_transmitted == 0.5 * free.total_floats_transmitted
    assert ref.total_floats_transmitted == ours.total_floats_transmitted


def test_stragglers_freeze_every_leaf(datasets):
    """GT's tracking invariant mean(y) = mean(g_prev) survives stragglers,
    edge drops and churn: the freeze covers y and g_prev too."""
    for kw in (dict(straggler_prob=0.3, edge_drop_prob=0.2),
               dict(mttf=6.0, mttr=3.0, edge_drop_prob=0.2, burst_len=4.0)):
        fields = {**SMALL, "algorithm": "gradient_tracking", "lr_schedule": "constant",
                  "learning_rate_eta0": 0.02, **kw}
        ds, ours_ds, f_opt = datasets(fields)
        res = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                                return_state=True)
        y, g = res.final_state["y"], res.final_state["g_prev"]
        assert np.abs(y.mean(axis=0) - g.mean(axis=0)).max() < 1e-12


