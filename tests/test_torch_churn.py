"""``examples/bench_churn.py``'s gates on the port, on the CPU.

Its configuration: quadratic, N=16 ring, n=1,600 samples of 10 features,
b=16, eval every 100. The gates: the ``burst_len=1`` run is bitwise the iid
run at p=0.3 (the timeline path against the per-round draws); the windowed
connectivity B̂ grows with the burst length at a matched marginal drop rate
(and equals the JAX package's, timeline for timeline); gradient tracking
under churn with bursty edges keeps mean(y) = mean(g_prev) to 1e-9 in
float64 (and agrees with ``jax_backend.run`` to 1e-12); after long outages
``neighbor_restart`` ends at or below ``frozen``'s consensus error. Also the
iid churn point (mttf = 1/q, mttr = 1/(1 − q)) is bitwise the straggler run.
"""

import numpy as np
import pytest

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.parallel import build_topology as ref_build
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.topology import build_topology

BASE = dict(problem_type="quadratic", algorithm="dsgd", topology="ring", n_workers=16,
            n_samples=1600, n_features=10, n_informative_features=6, n_iterations=3000,
            local_batch_size=16, eval_every=100)
P = 0.3
BURSTS = (1.0, 4.0, 16.0, 48.0)


@pytest.fixture(scope="module")
def data():
    ds = ref_generate(RefConfig(**BASE))
    ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
    return ds, ours, ref_oracle(ds, RefConfig(**BASE).reg_param)[1]


def _run(data, **kw):
    _, ours, f_opt = data
    return torch_backend.run(ExperimentConfig(**{**BASE, **kw}), ours, f_opt, device="cpu",
                             return_state=True)


def test_burst_1_is_bitwise_the_iid_run(data):
    iid = _run(data, n_iterations=800, edge_drop_prob=P)
    burst = _run(data, n_iterations=800, edge_drop_prob=P, burst_len=1.0)
    assert np.array_equal(iid.history.objective, burst.history.objective)
    assert np.array_equal(iid.history.consensus_error, burst.history.consensus_error)
    assert iid.total_floats_transmitted == burst.total_floats_transmitted


def test_iid_churn_point_is_bitwise_the_straggler_run(data):
    q = 0.2
    mttf, mttr = faults.iid_equivalent_churn(q)
    strag = _run(data, n_iterations=600, straggler_prob=q)
    churn = _run(data, n_iterations=600, mttf=mttf, mttr=mttr)
    assert np.array_equal(strag.history.objective, churn.history.objective)
    assert np.array_equal(strag.final_models, churn.final_models)


def test_bhat_grows_with_burst_length():
    topo, ref_topo = build_topology("ring", 16), ref_build("ring", 16)
    bhat = []
    for B in BURSTS:
        ours = faults.build_fault_timeline(topo, BASE["n_iterations"], 203, edge_drop_prob=P,
                                           burst_len=B, device="cpu")
        want = ref_faults.build_fault_timeline(ref_topo, BASE["n_iterations"], 203,
                                               edge_drop_prob=P, burst_len=B)
        assert np.array_equal(ours.edge_up, want.edge_up)
        assert abs(float(1.0 - ours.edge_up.mean()) - P) < 0.02  # matched marginal
        bhat.append(faults.windowed_connectivity(ours, topo))
        assert bhat[-1] == ref_faults.windowed_connectivity(want, ref_topo)
    assert all(a <= b for a, b in zip(bhat, bhat[1:])) and bhat[0] < bhat[-1], bhat


def test_gt_tracking_invariant_survives_churn(data):
    gt = dict(algorithm="gradient_tracking", lr_schedule="constant", learning_rate_eta0=0.02,
              dtype="float64", n_iterations=1000, edge_drop_prob=0.2, burst_len=8.0,
              mttf=60.0, mttr=25.0)
    res = _run(data, **gt)
    y, g = res.final_state["y"], res.final_state["g_prev"]
    assert np.abs(y.mean(axis=0) - g.mean(axis=0)).max() < 1e-9
    ds, _, f_opt = data
    ref = jax_backend.run(RefConfig(**{**BASE, **gt}), ds, f_opt, use_mesh=False)
    np.testing.assert_allclose(res.history.objective, ref.history.objective,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(res.final_models, ref.final_models, rtol=1e-12, atol=1e-12)
    assert res.total_floats_transmitted == ref.total_floats_transmitted
    tl = faults.build_fault_timeline(build_topology("ring", 16), 1000, 203, edge_drop_prob=0.2,
                                     burst_len=8.0, mttf=60.0, mttr=25.0, device="cpu")
    assert faults.outage_stats(tl)["n_outages"] > 0


def test_neighbor_restart_ends_at_or_below_frozen(data):
    outage = dict(n_iterations=2000, mttf=400.0, mttr=150.0)
    frozen = _run(data, **outage)
    restart = _run(data, **outage, rejoin="neighbor_restart")
    tl = faults.build_fault_timeline(build_topology("ring", 16), 2000, 203, mttf=400.0,
                                     mttr=150.0, device="cpu")
    assert faults.outage_stats(tl)["max_outage_rounds"] >= 50
    assert restart.history.consensus_error[-1] <= frozen.history.consensus_error[-1]
