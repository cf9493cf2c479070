"""Matrix-free runs in the port, held to ``jax_backend.run`` and ``run_batch``.

A config whose topology resolves to 'neighbor' builds the [N, k_max]
neighbour table alone, mixes in gather form, screens on its own table and
realizes a faulted round as the slot round (``parallel/faults.py``'s gather
form). Here, in float64 on the CPU, each matrix-free run agrees with the
JAX package's to 1e-12 (gaps, consensus errors, final models) with the
floats transmitted exactly equal; these are the port's counterparts of
``tests/test_federated.py``'s and ``tests/test_matrix_free_faults.py``'s
matrix-free runs (the neighbour trajectories against dense, the faulted
ones, the replica batches, the Byzantine gather screens). And a table of
algorithm × attack × screen combinations on a faulted matrix-free graph:
each runs to the JAX package's trajectory, or raises its message.
"""

import numpy as np
import pytest

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference

TOL = dict(rtol=1e-12, atol=1e-12)
# tests/test_federated.py's config (injected batches) and
# tests/test_matrix_free_faults.py's (the packages' own batches).
FEDERATED = dict(n_workers=8, n_samples=200, n_features=10, n_informative_features=6,
                 problem_type="quadratic", n_iterations=40, topology="ring", algorithm="dsgd",
                 local_batch_size=8, dtype="float64", eval_every=10)
MFF = dict(n_workers=16, n_iterations=24, eval_every=8, n_samples=480, n_features=10,
           n_informative_features=6, dtype="float64", local_batch_size=6,
           problem_type="quadratic", algorithm="dsgd", topology="ring")


@pytest.fixture(scope="module")
def data():
    """(JAX dataset, port dataset, f*, batch schedule or None) by base."""
    out = {}
    for name, base in (("federated", FEDERATED), ("mff", MFF)):
        cfg = RefConfig(**base)
        ds = ref_generate(cfg)
        _, f_opt = ref_oracle(ds, cfg.reg_param)
        ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
        sched = None
        if name == "federated":
            rng = np.random.default_rng(0)
            sizes = [len(i) for i in ds.shard_indices]
            sched = np.stack([[rng.choice(sizes[i], size=base["local_batch_size"], replace=False)
                               for i in range(base["n_workers"])]
                              for _ in range(base["n_iterations"])])
        out[name] = (ds, ours, f_opt, sched)
    return out


def _run(data, base, fields):
    """(the JAX package's run, the port's) of ``base`` over ``fields``."""
    ds, ours_ds, f_opt, sched = data[base]
    fields = {**(FEDERATED if base == "federated" else MFF), **fields}
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, batch_schedule=sched, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, batch_schedule=sched,
                             device="cpu")
    return ref, ours


def _same(ref, ours):
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error,
                               **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    assert abs(ours.history.spectral_gap - ref.history.spectral_gap) <= 1e-12


@pytest.mark.parametrize("topology", ["erdos_renyi", "chain", "ring"])
def test_neighbor_trajectory_matches_dense(data, topology):
    ref, ours = _run(data, "federated", dict(topology=topology, topology_impl="neighbor"))
    _same(ref, ours)
    _, dense = _run(data, "federated", dict(topology=topology, topology_impl="dense"))
    np.testing.assert_allclose(ours.final_models, dense.final_models, **TOL)
    assert ours.total_floats_transmitted == dense.total_floats_transmitted


def test_run_records_the_graph_s_set_up_seconds(data):
    """The run times its own graph build (outside compile_seconds); the
    centralized pattern builds none."""
    _, ours_ds, f_opt, sched = data["federated"]
    for impl in ("neighbor", "dense"):
        cfg = ExperimentConfig(**dict(FEDERATED, topology="erdos_renyi", topology_impl=impl))
        h = torch_backend.run(cfg, ours_ds, f_opt, batch_schedule=sched, device="cpu").history
        assert 0.0 < h.topology_setup_seconds < 60.0
    cfg = ExperimentConfig(**dict(FEDERATED, algorithm="centralized"))
    h = torch_backend.run(cfg, ours_ds, f_opt, batch_schedule=sched, device="cpu").history
    assert h.topology_setup_seconds == 0.0


def test_neighbor_faulty_trajectory_matches_dense(data):
    """Participation and churn with neighbor_restart (node streams shared
    by both forms): the port's matrix-free run is the JAX package's and the
    port's dense run, floats equal."""
    kw = dict(topology="erdos_renyi", participation_rate=0.5, mttf=8.0, mttr=3.0,
              rejoin="neighbor_restart")
    ref, ours = _run(data, "federated", dict(kw, topology_impl="neighbor"))
    _same(ref, ours)
    _, dense = _run(data, "federated", dict(kw, topology_impl="dense"))
    np.testing.assert_allclose(ours.final_models, dense.final_models, **TOL)
    assert ours.total_floats_transmitted == dense.total_floats_transmitted


def _batch_same(ref, ours, seq=None):
    np.testing.assert_allclose(ours.objective, ref.objective, **TOL)
    for r in range(len(ref.seeds)):
        np.testing.assert_allclose(ours.results[r].final_models, ref.results[r].final_models,
                                   **TOL)
        assert (ours.results[r].history.total_floats_transmitted
                == ref.results[r].history.total_floats_transmitted)
        if seq is not None:
            np.testing.assert_allclose(ours.results[r].final_models, seq[r].final_models, **TOL)
            assert (ours.results[r].history.total_floats_transmitted
                    == seq[r].history.total_floats_transmitted)


def test_neighbor_batch_replicas(data):
    ds, ours_ds, f_opt, _ = data["federated"]
    fields = dict(FEDERATED, topology="erdos_renyi", topology_impl="neighbor",
                  participation_rate=0.6, replicas=2)
    ref = jax_backend.run_batch(RefConfig(**fields), ds, f_opt)
    cfg = ExperimentConfig(**fields)
    ours = torch_backend.run_batch(cfg, ours_ds, f_opt, device="cpu")
    seq = [torch_backend.run(cfg.replace(seed=s, replicas=1,
                                         topology_seed=cfg.resolved_topology_seed()),
                             ours_ds, f_opt, device="cpu") for s in ours.seeds]
    _batch_same(ref, ours, seq)


def test_bursty_edges_batch_matches_sequential(data):
    ds, ours_ds, f_opt, _ = data["mff"]
    fields = dict(MFF, topology_impl="neighbor", edge_drop_prob=0.3, burst_len=3.0)
    seeds = [203, 204]
    ref = jax_backend.run_batch(RefConfig(**fields), ds, f_opt, seeds=seeds)
    cfg = ExperimentConfig(**fields)
    ours = torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=seeds, device="cpu")
    seq = [torch_backend.run(cfg.replace(seed=s), ours_ds, f_opt, device="cpu") for s in seeds]
    _batch_same(ref, ours, seq)


def test_edge_drop_sweep_batch(data):
    """A swept edge_drop_prob on the matrix-free graph: each replica its own
    per-edge timeline at its own rate, as the JAX package's batch."""
    ds, ours_ds, f_opt, _ = data["mff"]
    fields = dict(MFF, topology_impl="neighbor", edge_drop_prob=0.2, straggler_prob=0.1)
    sweep = {"edge_drop_prob": [0.1, 0.3]}
    ref = jax_backend.run_batch(RefConfig(**fields), ds, f_opt, seeds=[5, 6], sweep=sweep)
    ours = torch_backend.run_batch(ExperimentConfig(**fields), ours_ds, f_opt, seeds=[5, 6],
                                   sweep=sweep, device="cpu")
    _batch_same(ref, ours)


@pytest.mark.parametrize("extra", [dict(attack="sign_flip", n_byzantine=2, attack_scale=1.0),
                                   dict()], ids=["sign_flip", "defense-only"])
def test_byzantine_gather_matrix_free_matches_dense(data, extra):
    fields = dict(topology_impl="neighbor", aggregation="trimmed_mean", robust_b=1,
                  partition="shuffled", **extra)
    ref, ours = _run(data, "mff", fields)
    _same(ref, ours)
    _, dense = _run(data, "mff", dict(fields, topology_impl="dense", robust_impl="gather"))
    np.testing.assert_allclose(ours.final_models, dense.final_models, **TOL)


def test_byzantine_gather_composes_with_matrix_free_faults(data):
    fields = dict(topology_impl="neighbor", aggregation="clipped_gossip", robust_b=1,
                  clip_tau=5.0, attack="sign_flip", n_byzantine=2, participation_rate=0.8,
                  partition="shuffled")
    ref, ours = _run(data, "mff", fields)
    _same(ref, ours)
    _, dense = _run(data, "mff", dict(fields, topology_impl="dense", robust_impl="gather"))
    np.testing.assert_allclose(ours.final_models, dense.final_models, **TOL)


# Algorithm × attack × screen on a matrix-free ring under 20% iid drops and
# 10% stragglers: the JAX package runs each or raises; the port the same.
_SCREENS = {
    "none": {},
    "signflip-trimmed": dict(attack="sign_flip", n_byzantine=2, aggregation="trimmed_mean",
                             robust_b=1, partition="shuffled"),
    "alie-median": dict(attack="alie", n_byzantine=2, aggregation="median", robust_b=1,
                        partition="shuffled"),
    "noise-clipped": dict(attack="large_noise", n_byzantine=2, attack_scale=3.0,
                          aggregation="clipped_gossip", robust_b=1, partition="shuffled"),
}
_ALGORITHMS = {
    "dsgd": {}, "dsgd-tau2": dict(local_steps=2),
    "gt": dict(algorithm="gradient_tracking"),
    "gt-tau2": dict(algorithm="gradient_tracking", local_steps=2),
    "extra": dict(algorithm="extra"), "admm": dict(algorithm="admm"),
    "choco": dict(algorithm="choco", compression="top_k", compression_k=3),
    "push_sum": dict(algorithm="push_sum"),
}
COMBINATIONS = [(a, s) for a in ("dsgd", "dsgd-tau2", "gt", "gt-tau2") for s in _SCREENS] + [
    (a, "none") for a in ("extra", "admm", "choco", "push_sum")] + [
    ("extra", "signflip-trimmed"), ("push_sum", "signflip-trimmed")]


def _outcome(make):
    try:
        return make(), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("algorithm,screen", COMBINATIONS,
                         ids=[f"{a}-{s}" for a, s in COMBINATIONS])
def test_accepted_and_rejected_combinations(data, algorithm, screen):
    ds, ours_ds, f_opt, _ = data["mff"]
    fields = dict(MFF, topology_impl="neighbor", edge_drop_prob=0.2, straggler_prob=0.1,
                  n_iterations=16, **_ALGORITHMS[algorithm], **_SCREENS[screen])
    ref, ref_err = _outcome(lambda: jax_backend.run(RefConfig(**fields), ds, f_opt,
                                                     use_mesh=False))
    ours, ours_err = _outcome(lambda: torch_backend.run(ExperimentConfig(**fields), ours_ds,
                                                        f_opt, device="cpu"))
    assert ours_err == ref_err
    if ref is not None:
        _same(ref, ours)
        assert np.all(np.isfinite(ours.history.objective))


def test_chip_smoke_er_100k_digest_is_the_jax_package_s():
    """``chip_smoke.py``'s federated phase holds the card machine's build of
    cell (ii)'s table to ``ER_100K_DIGEST``: the JAX package's sparse
    sampler's table, recomputed here, and the port's build of it."""
    import hashlib
    import importlib.util
    import pathlib

    from distributed_optimization_tpu.parallel import topology as ref_topology
    from distributed_optimization_tpu_torch.parallel import topology

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cell = smoke.ER_100K
    kw = dict(erdos_renyi_p=cell["erdos_renyi_p"], seed=cell["topology_seed"], sampler="sparse")
    for topo in (ref_topology.build_neighbor_topology("erdos_renyi", cell["n_workers"], **kw),
                 topology.build_topology("erdos_renyi", cell["n_workers"], impl="neighbor",
                                         **kw)):
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(topo.nbr_idx).tobytes())
        h.update(np.ascontiguousarray(topo.nbr_mask).tobytes())
        assert h.hexdigest()[:16] == smoke.ER_100K_DIGEST == smoke._table_digest(topo)
    cfg = ExperimentConfig(**smoke.FEDERATED_BASE, **cell)
    assert cfg.resolved_topology_impl() == "neighbor"
    assert cfg.resolved_topology_sampler() == "sparse"
