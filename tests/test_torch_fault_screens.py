"""The Byzantine layer over per-round realized graphs, held to the JAX package.

The fused robust kernels' plain versions and the gather form on the
per-round liveness (gathered from A_t), and the dense form (the closed
neighbourhood sorted over the node axis; ``auto`` on the fully-connected
graph, explicit on the ring) over A_t, agree with ``jax_backend.run`` to
1e-12 in float64 under edge drops, stragglers, bursty edges and churn, the
floats transmitted exactly equal. One test recomputes one of
``chip_smoke.FAULT_ROWS`` (``examples/bench_faults.py``'s matrix: the JAX
package's iterations to ε, final gap and floats) with the JAX package.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.metrics import iterations_to_threshold
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
SCREENS = {
    "screen-fused-trimmed-edges": dict(BYZ, aggregation="trimmed_mean", robust_b=1,
                                       edge_drop_prob=0.2, robust_impl="fused"),
    "screen-gather-trimmed-edges": dict(BYZ, aggregation="trimmed_mean", robust_b=1,
                                        edge_drop_prob=0.2, robust_impl="gather"),
    "screen-fused-median-stragglers": dict(BYZ, aggregation="median", robust_b=1,
                                           straggler_prob=0.2, robust_impl="fused"),
    "screen-auto-median-bursty": dict(BYZ, aggregation="median", robust_b=1,
                                      edge_drop_prob=0.2, burst_len=4.0),
    "screen-fused-clip-edges": dict(BYZ, aggregation="clipped_gossip", robust_b=1,
                                    edge_drop_prob=0.2, robust_impl="fused"),
    "screen-gt-fused-trimmed-churn": dict(BYZ, algorithm="gradient_tracking",
                                          aggregation="trimmed_mean", robust_b=1,
                                          robust_impl="fused", mttf=10.0, mttr=4.0),
    "screen-dense-trimmed-fc": dict(BYZ, aggregation="trimmed_mean", robust_b=2,
                                    topology="fully_connected"),
    "screen-dense-median-fc-edges": dict(BYZ, aggregation="median", robust_b=1,
                                         topology="fully_connected", edge_drop_prob=0.2),
    "screen-dense-clip-fc-edges": dict(BYZ, aggregation="clipped_gossip", robust_b=1,
                                       topology="fully_connected", edge_drop_prob=0.2),
    "screen-dense-ring-explicit": dict(BYZ, aggregation="trimmed_mean", robust_b=1,
                                       robust_impl="dense", straggler_prob=0.1),
    "alie-stragglers": dict(BYZ, attack="alie", attack_scale=1.0, straggler_prob=0.2),
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


@pytest.mark.parametrize("name", sorted(SCREENS))
def test_screened_run_matches_jax_backend_under_faults(datasets, name):
    ref, ours = _both(datasets, **SCREENS[name])
    _assert_same_run(ref, ours)
    assert np.all(np.isfinite(ours.history.objective))


# --- chip_smoke.FAULT_ROWS -------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_fault_rows_are_the_jax_package_s(smoke):
    """One of the twelve rows (each takes about 30 s here), recomputed: the
    JAX package's iterations to ε, final gap and floats transmitted in
    ``examples/bench_faults.py``'s configuration (logistic N=64 ring,
    T=20,000, b=16, float32, eval every iteration)."""
    base = RefConfig(**smoke.FAULTS_BASE)
    ds = ref_generate(base)
    _, f_opt = ref_oracle(ds, base.reg_param)
    for name in ("edge20_straggler10",):
        fields, iters, gap, floats = smoke.FAULT_ROWS[name]
        cfg = base.replace(**fields)
        h = jax_backend.run(cfg, ds, f_opt, use_mesh=False).history
        assert iterations_to_threshold(h.objective, cfg.suboptimality_threshold,
                                       h.eval_iterations) == iters
        assert float(h.objective[-1]) == gap
        assert float(h.total_floats_transmitted) == floats
