"""Fault timelines, rounds, matchings and refusals, held to the JAX package.

The fault timelines (iid, bursty, stragglers, churn, the iid churn point,
participation; undirected and directed graphs) equal
``build_fault_timeline``'s bit for bit, as do the host diagnostics; each
round's realized A_t, active mask, one-peer partners and gather-form
liveness equal ``make_faulty_mixing``'s at several t, W_t too (to float32's
ulp at 1 where the realized row sums add more than two weights), and the
mixes, neighbour sums and warm restarts agree to 1e-12 in float64; the
round-robin matchings are the same arrays; every refusal raises the JAX
message.
"""


import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.parallel import build_topology as ref_build
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu.parallel import matchings as ref_matchings
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.algorithms import get_algorithm
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


# --- timelines and rounds, bit for bit ------------------------------------------

TIMELINES = {
    "iid": dict(edge_drop_prob=0.3),
    "bursty": dict(edge_drop_prob=0.3, burst_len=4.0),
    "stragglers": dict(straggler_prob=0.2),
    "churn": dict(mttf=8.0, mttr=3.0, edge_drop_prob=0.2, burst_len=2.0),
    "churn-iid-point": dict(mttf=1 / 0.2, mttr=1 / 0.8),
    "participation": dict(participation_rate=0.6, straggler_prob=0.1),
}


@pytest.mark.parametrize("graph", [("ring", 12), ("erdos_renyi", 16),
                                   ("directed_erdos_renyi", 14)])
@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_timeline_is_the_jax_package_s(graph, name):
    topo_name, n = graph
    kw = TIMELINES[name]
    ours = faults.build_fault_timeline(build_topology(topo_name, n, erdos_renyi_p=0.4, seed=3),
                                       300, 203, device="cpu", **kw)
    want = ref_faults.build_fault_timeline(ref_build(topo_name, n, erdos_renyi_p=0.4, seed=3),
                                           300, 203, **kw)
    for field in ("edge_index", "edge_up", "node_up", "rejoin", "part_up"):
        a, b = getattr(ours, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a, np.asarray(b)), field
    assert ours.directed == want.directed


def test_diagnostics_are_the_jax_package_s():
    topo, ref_topo = build_topology("ring", 10), ref_build("ring", 10)
    kw = dict(edge_drop_prob=0.3, burst_len=4.0, mttf=12.0, mttr=4.0, participation_rate=0.9)
    ours = faults.build_fault_timeline(topo, 400, 7, device="cpu", **kw)
    want = ref_faults.build_fault_timeline(ref_topo, 400, 7, **kw)
    np.testing.assert_array_equal(faults.node_downtime(ours), ref_faults.node_downtime(want))
    assert faults.outage_stats(ours) == ref_faults.outage_stats(want)
    assert faults.windowed_connectivity(ours, topo) == \
        ref_faults.windowed_connectivity(want, ref_topo)
    assert faults.iid_equivalent_churn(0.25) == ref_faults.iid_equivalent_churn(0.25)
    for cfg in (ExperimentConfig(edge_drop_prob=0.1), ExperimentConfig(),
                ExperimentConfig(participation_rate=0.5)):
        assert faults.config_faults_active(cfg) == cfg.faults_active


ROUNDS = {
    "edges": dict(drop_prob=0.3),
    "stragglers": dict(drop_prob=0.0, straggler_prob=0.25),
    "both": dict(drop_prob=0.3, straggler_prob=0.2),
    "bursty-churn": dict(drop_prob=0.3, burst_len=3.0, mttf=6.0, mttr=3.0, horizon=40),
    "participation": dict(drop_prob=0.2, participation_rate=0.7, horizon=40),
    "one-peer": dict(drop_prob=0.0, one_peer=True),
    "one-peer-faulted": dict(drop_prob=0.3, straggler_prob=0.1, one_peer=True),
    "one-peer-bursty": dict(drop_prob=0.3, burst_len=2.0, one_peer=True, horizon=40),
}


@pytest.mark.parametrize("graph", [("ring", 10), ("erdos_renyi", 16), ("directed_ring", 8),
                                   ("directed_erdos_renyi", 12)])
@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_round_is_the_jax_package_s(graph, name):
    """A_t, active and (one-peer) partners at several t, bit for bit; W_t
    bit for bit where a row holds at most two off-diagonal weights (the ring,
    the directed ring), else to float32's ulp at 1 (the diagonal is 1 minus
    the row or column sum, which XLA and torch add in different orders);
    the mixes to 1e-12 in float64."""
    topo_name, n = graph
    kw = ROUNDS[name]
    directed = topo_name.startswith("directed")
    if directed and kw.get("one_peer"):
        with pytest.raises(ValueError, match="one_peer gossip is a mutual-matching"):
            faults.make_faulty_mixing(build_topology(topo_name, n), seed=5, device="cpu", **kw)
        return
    topo = build_topology(topo_name, n, erdos_renyi_p=0.4, seed=1)
    ref_topo = ref_build(topo_name, n, erdos_renyi_p=0.4, seed=1)
    ours = faults.make_faulty_mixing(topo, seed=5, device="cpu", **kw)
    ref = ref_faults.make_faulty_mixing(ref_topo, seed=5, **kw)
    match_key = jax.random.fold_in(jax.random.key(5), 0x3A7C4)
    x = np.random.default_rng(0).standard_normal((n, 4))
    rule = ref_faults.column_stochastic_weights if directed else \
        ref_faults.metropolis_hastings_weights
    for t in (0, 2, 23):
        want_active = np.asarray(ref.active(t))
        np.testing.assert_array_equal(ours.active(t).numpy(), want_active)
        if kw.get("one_peer"):
            adj = ref_faults.make_faulty_mixing(ref_topo, seed=5, **{
                k: v for k, v in kw.items() if k != "one_peer"}).realized_adjacency(t)
            partner = ref_faults.sample_one_peer_matching(jax.random.fold_in(match_key, t), adj)
            np.testing.assert_array_equal(ours.partner(t).numpy(), np.asarray(partner))
        else:
            A = np.asarray(ref.realized_adjacency(t))
            np.testing.assert_array_equal(ours.realized_adjacency(t).numpy(), A)
            W = np.asarray(rule(jnp.asarray(A)))
            rnd = ours.realize(torch.tensor([t]))
            if topo_name.endswith("ring"):
                np.testing.assert_array_equal(rnd.weights(torch.float32).numpy(), W)
            else:
                np.testing.assert_allclose(rnd.weights(torch.float32).numpy(), W, rtol=0,
                                           atol=2.0**-23)
            assert float(ours.realized_degree_sum(t)) == float(ref.realized_degree_sum(t))
        with jax.enable_x64(True):
            want_mix = np.asarray(ref.mix(t, jnp.asarray(x)))
            want_nbr = np.asarray(ref.neighbor_sum(t, jnp.asarray(x)))
        np.testing.assert_allclose(ours.mix(t, torch.from_numpy(x)).numpy(), want_mix, **TOL)
        np.testing.assert_allclose(ours.neighbor_sum(t, torch.from_numpy(x)).numpy(), want_nbr,
                                   **TOL)


def test_liveness_gathers_the_realized_adjacency():
    """The gather form's liveness, A_t at each table slot, is the JAX
    package's ``make_neighbor_liveness`` bit for bit."""
    from distributed_optimization_tpu.parallel.topology import neighbor_tables_for

    for kw in (dict(drop_prob=0.3, straggler_prob=0.2),
               dict(drop_prob=0.3, burst_len=3.0, mttf=5.0, mttr=2.0, horizon=20)):
        topo, ref_topo = build_topology("erdos_renyi", 16, seed=2), \
            ref_build("erdos_renyi", 16, seed=2)
        nbr_idx, nbr_mask = neighbor_tables_for(ref_topo)
        live = ref_faults.make_faulty_mixing(ref_topo, seed=9, **kw).make_neighbor_liveness(
            nbr_idx, nbr_mask)
        ours = faults.make_faulty_mixing(topo, seed=9, device="cpu", **kw)
        nbr = torch.as_tensor(nbr_idx, dtype=torch.int64)
        mask = torch.as_tensor(nbr_mask, dtype=torch.float32)
        for t in (0, 3, 11, 19):
            got = ours.realize(torch.tensor([t])).live(nbr, mask).numpy()
            np.testing.assert_array_equal(got, np.asarray(live(t)))


def test_warm_restart_is_the_jax_package_s():
    kw = dict(drop_prob=0.2, mttf=4.0, mttr=3.0, rejoin="neighbor_restart", horizon=60)
    ours = faults.make_faulty_mixing(build_topology("ring", 10), seed=4, device="cpu", **kw)
    ref = ref_faults.make_faulty_mixing(ref_build("ring", 10), seed=4, **kw)
    assert ours.timeline.rejoin.any()
    x = np.random.default_rng(1).standard_normal((10, 3))
    for t in np.nonzero(ours.timeline.rejoin.any(axis=1))[0][:6]:
        with jax.enable_x64(True):
            want = np.asarray(ref.rejoin_restart(int(t), jnp.asarray(x)))
        got = ours.rejoin_restart(int(t), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("graph", [("ring", 10), ("ring", 9), ("chain", 8), ("grid", 16),
                                   ("grid", 36)])
def test_round_robin_partners_are_the_jax_package_s(graph):
    name, n = graph
    got = matchings.round_robin_partners(build_topology(name, n))
    want = ref_matchings.round_robin_partners(ref_build(name, n))
    np.testing.assert_array_equal(got, want)
    matchings.validate_partners(got, build_topology(name, n))


def test_round_robin_refuses_as_the_jax_package_does():
    for name, n in (("grid", 25), ("star", 6)):
        with pytest.raises(ValueError) as want:
            ref_matchings.round_robin_partners(ref_build(name, n))
        with pytest.raises(ValueError) as got:
            matchings.round_robin_partners(build_topology(name, n))
        assert str(got.value) == str(want.value)


# --- refusals --------------------------------------------------------------------


def _message(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


REFUSED = [
    dict(edge_drop_prob=1.0), dict(edge_drop_prob=-0.1), dict(straggler_prob=1.0),
    dict(burst_len=0.5, edge_drop_prob=0.1), dict(burst_len=2.0),
    dict(mttf=5.0), dict(mttr=5.0), dict(mttf=-1.0, mttr=-1.0), dict(mttf=0.5, mttr=2.0),
    dict(mttf=5.0, mttr=2.0, straggler_prob=0.1),
    dict(mttf=5.0, mttr=2.0, gossip_schedule="one_peer"),
    dict(rejoin="warm"), dict(rejoin="neighbor_restart"),
    dict(rejoin="neighbor_restart", mttf=5.0, mttr=2.0, attack="sign_flip", n_byzantine=1),
    dict(participation_rate=0.0), dict(participation_rate=1.5),
    dict(participation_rate=0.5, algorithm="centralized"),
    dict(participation_rate=0.5, gossip_schedule="round_robin"),
    dict(participation_rate=0.5, compression="top_k", compression_k=2),
    dict(gossip_schedule="gossip"),
    dict(gossip_schedule="round_robin", edge_drop_prob=0.1),
    dict(gossip_schedule="round_robin", straggler_prob=0.1),
    dict(gossip_schedule="one_peer", topology="directed_ring", algorithm="push_sum"),
    dict(gossip_schedule="one_peer", aggregation="median", robust_b=1),
    dict(edge_drop_prob=0.1, compression="top_k", compression_k=2),
    dict(gossip_schedule="one_peer", compression="qsgd", compression_k=4),
]


@pytest.mark.parametrize("fields", REFUSED, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_config_refuses_with_the_jax_message(fields):
    want = _message(lambda: RefConfig(**fields))
    assert want is not None
    assert _message(lambda: ExperimentConfig(**fields)) == want


@pytest.mark.parametrize("fields", [
    dict(edge_drop_prob=0.1, algorithm="extra"), dict(straggler_prob=0.1, algorithm="admm"),
    dict(gossip_schedule="one_peer", algorithm="choco"),
    dict(mttf=5.0, mttr=2.0, algorithm="push_sum", topology="directed_ring"),
    dict(edge_drop_prob=0.1, algorithm="centralized"),
    dict(gossip_schedule="round_robin", topology="star"),
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_run_refuses_with_the_jax_message(datasets, fields):
    full = {**SMALL, **fields}
    ds, ours_ds, f_opt = datasets(full)
    want = _message(lambda: jax_backend.run(RefConfig(**full), ds, f_opt, use_mesh=False))
    assert want is not None
    assert _message(lambda: torch_backend.run(ExperimentConfig(**full), ours_ds, f_opt,
                                              device="cpu")) == want


def test_fault_factories_refuse_with_the_jax_message():
    topo, ref_topo = build_topology("ring", 8), ref_build("ring", 8)
    for kw in (dict(drop_prob=1.2), dict(drop_prob=0.1, straggler_prob=1.0),
               dict(drop_prob=0.1, burst_len=0.5), dict(drop_prob=0.1, rejoin="x"),
               dict(drop_prob=0.0, mttf=3.0, mttr=2.0, one_peer=True),
               dict(drop_prob=0.0, participation_rate=0.5, one_peer=True),
               dict(drop_prob=0.0, participation_rate=1.5),
               dict(drop_prob=0.1, burst_len=2.0)):
        want = _message(lambda: ref_faults.make_faulty_mixing(ref_topo, seed=1, **kw))
        assert want is not None
        assert _message(lambda: faults.make_faulty_mixing(topo, seed=1, device="cpu",
                                                          **kw)) == want
    for kw in (dict(horizon=0), dict(horizon=5, burst_len=0.5),
               dict(horizon=5, mttf=2.0), dict(horizon=5, mttf=0.5, mttr=0.5),
               dict(horizon=5, mttf=2.0, mttr=2.0, straggler_prob=0.1),
               dict(horizon=5, participation_rate=0.0)):
        horizon = kw.pop("horizon")
        want = _message(lambda: ref_faults.build_fault_timeline(ref_topo, horizon, 1, **kw))
        assert want is not None
        assert _message(lambda: faults.build_fault_timeline(topo, horizon, 1,
                                                             device="cpu", **kw)) == want


FAULT_ENTRY_POINTS = {
    "build_fault_timeline": (faults.build_fault_timeline, lambda **kw: faults.build_fault_timeline(
        build_topology("ring", 10), 20, 1, edge_drop_prob=0.2, burst_len=2.0, **kw)),
    "timeline_for_config": (faults.timeline_for_config, lambda **kw: faults.timeline_for_config(
        ExperimentConfig(edge_drop_prob=0.2, burst_len=2.0), build_topology("ring", 10), 20,
        **kw)),
    "make_faulty_mixing": (faults.make_faulty_mixing, lambda **kw: faults.make_faulty_mixing(
        build_topology("ring", 10), drop_prob=0.2, seed=1, **kw)),
    "make_round_robin_mixing": (faults.make_round_robin_mixing,
                                lambda **kw: faults.make_round_robin_mixing(
                                    build_topology("ring", 10), **kw)),
}


@pytest.mark.parametrize("name", sorted(FAULT_ENTRY_POINTS))
def test_fault_entry_points_run_on_cuda_unless_asked(name, monkeypatch):
    """Without ``device`` the fault entry points take the card, and without
    a card they raise rather than draw on the CPU; ``device='cpu'`` builds."""
    function, call = FAULT_ENTRY_POINTS[name]
    assert inspect.signature(function).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' was asked for"):
        call()
    assert call(device="cpu") is not None


def test_matrix_free_fault_form_raises_not_yet():
    # The matrix-free fault form is ported: a faulted config at N = 4,096
    # resolves to it, and an explicit 'dense' keeps the dense form.
    assert ExperimentConfig(n_workers=4096, edge_drop_prob=0.1).resolved_topology_impl() \
        == "neighbor"
    cfg = ExperimentConfig(n_workers=4096, edge_drop_prob=0.1, topology_impl="dense")
    assert cfg.time_varying and cfg.resolved_topology_impl() == "dense"


def test_algorithm_flags_are_the_jax_package_s():
    from distributed_optimization_tpu.algorithms import get_algorithm as ref_get

    for name in ("centralized", "dsgd", "gradient_tracking", "extra", "admm", "choco",
                 "push_sum"):
        ours, ref = get_algorithm(name), ref_get(name)
        assert (ours.supports_edge_faults, ours.supports_churn) == \
            (ref.supports_edge_faults, ref.supports_churn), name


def test_auto_stays_on_gather_under_faults():
    cfg = ExperimentConfig(**BYZ, aggregation="trimmed_mean", robust_b=1)
    topo = build_topology("ring", 12)
    assert torch_backend.resolve_robust_impl(cfg, topo) == "fused"
    assert torch_backend.resolve_robust_impl(cfg.replace(edge_drop_prob=0.1), topo) == "gather"
    assert torch_backend.resolve_robust_impl(cfg.replace(robust_impl="fused",
                                                         edge_drop_prob=0.1), topo) == "fused"
    fc = cfg.replace(topology="fully_connected")
    assert torch_backend.resolve_robust_impl(fc, build_topology("fully_connected", 12)) == \
        "dense"




@pytest.mark.parametrize("fields", [dict(edge_drop_prob=0.2), dict(edge_drop_prob=0.2, burst_len=0.0),
                                    dict(edge_drop_prob=0.3, burst_len=5.0, mttf=9.0, mttr=3.0),
                                    dict(straggler_prob=0.1, participation_rate=0.8)],
                         ids=["iid", "iid-burst-0", "bursty-churn", "stragglers-participation"])
def test_timeline_for_config_is_the_jax_package_s(fields):
    """The config mapping: burst_len 0 clamped to 1, stragglers off under
    churn, the participation stream."""
    ours = faults.timeline_for_config(ExperimentConfig(**fields), build_topology("ring", 10), 120,
                                       device="cpu")
    want = ref_faults.timeline_for_config(RefConfig(**fields), ref_build("ring", 10), 120)
    for field in ("edge_up", "node_up", "rejoin", "part_up"):
        a, b = getattr(ours, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a, np.asarray(b)), field
