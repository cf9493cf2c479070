"""The matrix-free representation in the port, held to the JAX package on the CPU.

The port's ``parallel/topology.py`` builds ring, grid, chain and Erdős–Rényi
as the padded [N, k_max] neighbour table alone (``build_neighbor_topology``,
``build_topology(..., impl='neighbor')``), with the JAX package's builders,
samplers, guards and messages:

- every table, degree vector and floats count bitwise the JAX package's,
  the spectral gap (closed forms, or power iteration) within 1e-12;
- the sparse Erdős–Rényi sampler's edges at N = 100,000, p = 16/N, seed 1
  bitwise the JAX package's;
- ``incident_edge_slots`` and the table branch of ``_edge_list`` bitwise;
- the degree guards, the config's checks of 'neighbor' and 'sparse' and
  its 'auto' rules (``tests/test_federated.py`` and
  ``tests/test_matrix_free_faults.py``; the backend and cpp cases, which
  the port has no field for, left out), with the JAX package's messages;
- ``ops/mixing.py``'s routing on a matrix-free graph and its refusals.
"""

import numpy as np
import pytest
import torch

from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_make_mixing_op
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu.parallel import topology as ref_topology
from distributed_optimization_tpu_torch.config import (
    MATRIX_FREE_AUTO_N,
    NEIGHBOR_TOPOLOGIES,
    ExperimentConfig,
)
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel import faults, topology

SIZES = (2, 3, 16, 64)
# tests/test_federated.py's small config.
BASE = dict(n_workers=8, n_samples=200, n_features=10, n_informative_features=6,
            problem_type="quadratic", n_iterations=40, topology="ring", algorithm="dsgd",
            local_batch_size=8, dtype="float64", eval_every=10)


def _message(make):
    try:
        make()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _builds(name, n, **kw):
    kw = dict(kw)
    if name == "erdos_renyi":
        kw.setdefault("erdos_renyi_p", 0.3)
        kw.setdefault("seed", 7)
    return kw


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NEIGHBOR_TOPOLOGIES)
def test_neighbor_tables_are_the_jax_package_s(name, n):
    kw = _builds(name, n)
    want = _message(lambda: ref_topology.build_neighbor_topology(name, n, **kw))
    assert _message(lambda: topology.build_neighbor_topology(name, n, **kw)) == want
    if want is not None:
        return
    ref = ref_topology.build_neighbor_topology(name, n, **kw)
    ours = topology.build_neighbor_topology(name, n, **kw)
    assert ours.is_matrix_free and ours.adjacency is None and ours.mixing_matrix is None
    for field in ("nbr_idx", "nbr_mask", "degrees"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert ours.floats_per_iteration == ref.floats_per_iteration
    assert ours.grid_shape == ref.grid_shape and ours.sampler == ref.sampler
    assert abs(ours.spectral_gap - ref.spectral_gap) <= 1e-12
    # The same graph through build_topology's dispatch.
    same = topology.build_topology(name, n, impl="neighbor", **kw)
    assert np.array_equal(same.nbr_idx, ours.nbr_idx)
    assert topology.neighbor_tables_for(ours)[0] is ours.nbr_idx


@pytest.mark.parametrize("name,n,p", [("erdos_renyi", 64, 0.1), ("chain", 64, None),
                                      ("grid", 144, None), ("erdos_renyi", 300, 8 / 300)])
def test_spectral_gap_by_power_iteration_or_closed_form(name, n, p):
    kw = dict(erdos_renyi_p=p, seed=3) if p else {}
    ref = ref_topology.build_neighbor_topology(name, n, **kw)
    ours = topology.build_neighbor_topology(name, n, **kw)
    assert abs(ours.spectral_gap - ref.spectral_gap) <= 1e-12
    assert 0.0 < ours.spectral_gap <= 1.0


def test_sparse_sampler_is_the_jax_package_s_at_100k():
    n, p = 100_000, 16 / 100_000
    src, dst = topology._erdos_renyi_forward_edges_sparse(n, p, 1)
    ref_src, ref_dst = ref_topology._erdos_renyi_forward_edges_sparse(n, p, 1)
    assert np.array_equal(src, ref_src) and np.array_equal(dst, ref_dst)
    idx, mask = topology._pack_neighbor_tables(src, dst, n)
    ref_idx, ref_mask = ref_topology._pack_neighbor_tables(ref_src, ref_dst, n)
    assert np.array_equal(idx, ref_idx) and np.array_equal(mask, ref_mask)
    assert topology._edges_connected(src, dst, n)


def test_sparse_sampler_through_the_builder():
    kw = dict(erdos_renyi_p=12 / 2000, seed=5, sampler="sparse")
    ref = ref_topology.build_neighbor_topology("erdos_renyi", 2000, **kw)
    ours = topology.build_topology("erdos_renyi", 2000, impl="neighbor", **kw)
    assert ours.sampler == ref.sampler == "sparse"
    assert np.array_equal(ours.nbr_idx, ref.nbr_idx)
    assert np.array_equal(ours.nbr_mask, ref.nbr_mask)
    assert abs(ours.spectral_gap - ref.spectral_gap) <= 1e-12


@pytest.mark.parametrize("name,n", [("ring", 16), ("chain", 9), ("grid", 25),
                                    ("erdos_renyi", 24)])
def test_incident_edge_slots_and_edge_list_are_the_jax_package_s(name, n):
    kw = dict(erdos_renyi_p=0.3, seed=5) if name == "erdos_renyi" else {}
    ref = ref_topology.build_neighbor_topology(name, n, **kw)
    ours = topology.build_neighbor_topology(name, n, **kw)
    edges = faults._edge_list(ours)
    ref_edges = ref_faults._edge_list(ref)
    assert edges.dtype == ref_edges.dtype and np.array_equal(edges, ref_edges)
    # The dense graph's edge list is the same i < j rows.
    assert np.array_equal(faults._edge_list(topology.build_topology(name, n, **kw)), edges)
    got = topology.incident_edge_slots(ours.nbr_idx, ours.nbr_mask, edges)
    want = ref_topology.incident_edge_slots(ref.nbr_idx, ref.nbr_mask, ref_edges)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # Against a shuffled edge list too: each slot finds its edge's row.
    perm = np.random.default_rng(0).permutation(len(edges))
    got = topology.incident_edge_slots(ours.nbr_idx, ours.nbr_mask, edges[perm])
    want = ref_topology.incident_edge_slots(ref.nbr_idx, ref.nbr_mask, ref_edges[perm])
    assert np.array_equal(got, want)
    with pytest.raises(KeyError):
        topology.incident_edge_slots(ours.nbr_idx, ours.nbr_mask, edges[1:])


def test_kmax_blowup_guards():
    for make in (lambda m: m.build_neighbor_topology("fully_connected", 64),
                 lambda m: m.build_neighbor_topology("star", 64),
                 lambda m: m.build_neighbor_topology("erdos_renyi", 8, erdos_renyi_p=0.999,
                                                     seed=0),
                 lambda m: m.build_neighbor_topology("erdos_renyi", 16, sampler="csr"),
                 lambda m: m.build_neighbor_topology("directed_ring", 16),
                 lambda m: m.build_neighbor_topology("grid", 15),
                 lambda m: m._guard_table_size(40, 2_000_000),
                 lambda m: m.build_topology("ring", 16, impl="matrix_free"),
                 lambda m: m.build_topology("ring", 16, sampler="sparse")):
        want = _message(lambda: make(ref_topology))
        assert want is not None
        assert _message(lambda: make(topology)) == want


# tests/test_federated.py::test_rejections and the matrix-free Byzantine
# rejections of tests/test_matrix_free_faults.py, but the backend/cpp ones.
REJECTED = [
    dict(algorithm="extra", local_steps=2), dict(local_steps=0),
    dict(local_steps=2, compression="top_k", compression_k=3),
    dict(participation_rate=0.0), dict(algorithm="centralized", participation_rate=0.5),
    dict(participation_rate=0.5, gossip_schedule="one_peer"),
    dict(topology="fully_connected", topology_impl="neighbor"),
    dict(topology="star", topology_impl="neighbor"),
    dict(topology_impl="neighbor", aggregation="trimmed_mean", robust_b=1,
         robust_impl="dense"),
    dict(topology_impl="neighbor", aggregation="trimmed_mean", robust_b=1,
         robust_impl="fused"),
    dict(topology_impl="neighbor", mixing_impl="dense"),
    dict(topology_impl="neighbor", mixing_impl="sparse"),
    dict(topology_impl="neighbor", mixing_impl="pallas"),
    dict(topology_impl="neighbor", gossip_schedule="one_peer"),
    dict(topology_impl="neighbor", gossip_schedule="round_robin"),
    dict(topology_sampler="sparse"),
    dict(topology="erdos_renyi", topology_sampler="sparse", topology_impl="dense"),
]
ACCEPTED = [
    dict(topology_impl="neighbor", attack="sign_flip", n_byzantine=1,
         aggregation="trimmed_mean", robust_b=1),
    dict(topology_impl="neighbor", edge_drop_prob=0.1),
    dict(topology_impl="neighbor", topology="erdos_renyi", topology_sampler="sparse"),
    dict(topology_impl="neighbor", topology="erdos_renyi", topology_sampler="dense"),
    dict(topology_impl="neighbor", mixing_impl="stencil"),
    dict(topology_impl="neighbor", mixing_impl="gather", mttf=8.0, mttr=3.0,
         rejoin="neighbor_restart", participation_rate=0.5),
]


@pytest.mark.parametrize("fields", REJECTED, ids=lambda f: ",".join(f"{k}={v}" for k, v in
                                                                       f.items()))
def test_rejections(fields):
    cfg = dict(BASE, **fields)
    want = _message(lambda: RefConfig(**cfg))
    assert want is not None
    assert _message(lambda: ExperimentConfig(**cfg)) == want


@pytest.mark.parametrize("fields", ACCEPTED, ids=lambda f: ",".join(f"{k}={v}" for k, v in
                                                                       f.items()))
def test_accepted_matrix_free_configs(fields):
    cfg = dict(BASE, **fields)
    ours, theirs = ExperimentConfig(**cfg), RefConfig(**cfg)
    assert ours.resolved_topology_impl() == theirs.resolved_topology_impl() == "neighbor"
    assert ours.resolved_topology_sampler() == theirs.resolved_topology_sampler()


@pytest.mark.parametrize("fields", [
    dict(edge_drop_prob=0.1), dict(edge_drop_prob=0.2, burst_len=3.0),
    dict(straggler_prob=0.1), dict(mttf=8.0, mttr=3.0), dict(participation_rate=0.5),
    dict(aggregation="trimmed_mean", robust_b=1), dict(attack="sign_flip", n_byzantine=2),
    dict(topology="fully_connected"), dict(topology="star"), dict(mixing_impl="dense"),
    dict(gossip_schedule="one_peer"), dict(topology="erdos_renyi"),
    dict(topology="erdos_renyi", n_workers=65_537, erdos_renyi_p=1e-3),
    dict(topology="erdos_renyi", n_workers=65_536, erdos_renyi_p=1e-3),
    dict(n_workers=MATRIX_FREE_AUTO_N - 1),
])
def test_auto_stays_dense_for_dense_only_features(fields):
    """The 'auto' rules: fault processes are not dense-only; an attack, a
    robust rule, a matrix mixing form, a matching schedule and the graphs
    without a matrix-free builder are; ER past 65,536 takes the sparse
    sampler."""
    cfg = {**BASE, "n_workers": MATRIX_FREE_AUTO_N, **fields}
    ours, theirs = ExperimentConfig(**cfg), RefConfig(**cfg)
    assert ours.resolved_topology_impl() == theirs.resolved_topology_impl()
    assert ours.resolved_topology_sampler() == theirs.resolved_topology_sampler()


def test_auto_topology_impl_allows_edge_faults():
    cfg = dict(n_workers=8192, topology="ring", edge_drop_prob=0.2, burst_len=3.0,
               local_batch_size=4, n_samples=16384)
    assert ExperimentConfig(**cfg).resolved_topology_impl() == "neighbor"
    assert RefConfig(**cfg).resolved_topology_impl() == "neighbor"
    byz = dict(n_workers=8192, topology="ring", aggregation="trimmed_mean", robust_b=1,
               local_batch_size=4, n_samples=16384)
    assert ExperimentConfig(**byz).resolved_topology_impl() == "dense"
    # A swept edge_drop_prob's per-replica configs resolve as the base does.
    big = ExperimentConfig(**dict(BASE, n_workers=MATRIX_FREE_AUTO_N, topology="erdos_renyi"))
    assert big.resolved_topology_impl() == "neighbor"
    assert big.replace(edge_drop_prob=0.05).resolved_topology_impl() == "neighbor"


def test_mixing_auto_routes_gather():
    """auto → gather on a matrix-free graph, stencil where the graph embeds
    as shifts, dense on a small dense ER, gather on a large dense chain."""
    cases = (
        (dict(name="erdos_renyi", n=16, seed=1, impl="neighbor"), "gather"),
        (dict(name="ring", n=16, impl="neighbor"), "stencil"),
        (dict(name="grid", n=16, impl="neighbor"), "stencil"),
        (dict(name="chain", n=16, impl="neighbor"), "gather"),
        (dict(name="erdos_renyi", n=16, seed=1), "dense"),
        (dict(name="chain", n=MATRIX_FREE_AUTO_N), "gather"),
    )
    for kw, impl in cases:
        ours = topology.build_topology(**kw)
        ref = ref_topology.build_topology(**kw)
        assert make_mixing_op(ours, device="cpu").impl == impl == ref_make_mixing_op(ref).impl


def test_dense_mixing_rejected_on_matrix_free():
    for kw in (dict(name="erdos_renyi", n=16, seed=1, impl="neighbor"),
               dict(name="ring", n=16, impl="neighbor")):
        ours = topology.build_topology(**kw)
        ref = ref_topology.build_topology(**kw)
        for impl in ("dense", "sparse", "pallas"):
            want = _message(lambda: ref_make_mixing_op(ref, impl=impl))
            assert want is not None and "matrix-free" in want
            assert _message(lambda: make_mixing_op(ours, impl, device="cpu")) == want
    chain = topology.build_topology("chain", 16, impl="neighbor")
    ref_chain = ref_topology.build_topology("chain", 16, impl="neighbor")
    want = _message(lambda: ref_make_mixing_op(ref_chain, impl="stencil"))
    assert _message(lambda: make_mixing_op(chain, "stencil", device="cpu")) == want


@pytest.mark.parametrize("kw", [dict(name="erdos_renyi", n=24, erdos_renyi_p=0.3, seed=5),
                                dict(name="chain", n=9), dict(name="ring", n=16),
                                dict(name="grid", n=16)])
def test_gather_mixing_on_the_native_table(kw):
    """The gather operator over a matrix-free graph equals the JAX package's
    in float64, and the port's dense operator of the same graph."""
    import jax.numpy as jnp
    from distributed_optimization_tpu.parallel._compat import enable_x64

    ours = topology.build_topology(impl="neighbor", **kw)
    ref = ref_topology.build_topology(impl="neighbor", **kw)
    x = np.random.default_rng(1).standard_normal((ours.n, 5))
    op = make_mixing_op(ours, "gather", device="cpu", dtype=torch.float64)
    dense = make_mixing_op(topology.build_topology(**kw), "dense", device="cpu",
                           dtype=torch.float64)
    with enable_x64():
        ref_op = ref_make_mixing_op(ref, impl="gather", dtype=jnp.float64)
        want = np.asarray(ref_op.apply(jnp.asarray(x)))
        want_nbr = np.asarray(ref_op.neighbor_sum(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(op.apply(xt).numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.neighbor_sum(xt).numpy(), want_nbr, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.apply(xt).numpy(), dense.apply(xt).numpy(),
                               rtol=1e-12, atol=1e-12)
