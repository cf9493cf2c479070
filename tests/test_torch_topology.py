"""The port's graphs against the JAX package's ``build_topology``.

Every builder is held bit for bit (``np.array_equal``) on its adjacency,
degrees and mixing matrix: the random graphs draw from the same
``np.random.default_rng(seed)`` stream, try for try. Spectral gaps and the
closed forms agree to 1e-12 (one eigensolve of the same matrix on each
side, or a closed form against it). The config's checks of the graph
fields raise the JAX package's messages, and the representations the port
lacks raise that they are not ported yet.
"""

import re

import numpy as np
import pytest

from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.parallel import topology as ref
from distributed_optimization_tpu_torch.config import (
    DIRECTED_TOPOLOGIES,
    RANDOM_TOPOLOGIES,
    TOPOLOGIES,
    ExperimentConfig,
)
from distributed_optimization_tpu_torch.parallel import topology

TOL = 1e-12
# (name, n, erdos_renyi_p, seed): every builder at a few sizes and seeds,
# the random graphs at several densities.
GRAPHS = [
    *((name, n, 0.4, 0) for name in ("ring", "chain", "star", "fully_connected",
                                     "directed_ring") for n in (1, 2, 3, 7, 25)),
    *(("grid", n, 0.4, 0) for n in (1, 4, 9, 16, 25)),
    *(("erdos_renyi", n, p, seed) for n, p, seed in ((2, 0.9, 0), (12, 0.3, 3), (25, 0.4, 203),
                                                    (64, 0.1, 203), (64, 0.5, 203),
                                                    (256, 12 / 256, 203))),
    *(("directed_erdos_renyi", n, p, seed) for n, p, seed in ((3, 0.9, 1), (12, 0.3, 3),
                                                             (25, 0.4, 203),
                                                             (256, 12 / 256, 203))),
]


def _both(name, n, p, seed):
    return (topology.build_topology(name, n, erdos_renyi_p=p, seed=seed),
            ref.build_topology(name, n, erdos_renyi_p=p, seed=seed))


def test_the_port_has_every_graph_of_the_jax_package():
    from distributed_optimization_tpu import config as ref_config

    assert TOPOLOGIES == ref_config.TOPOLOGIES
    assert DIRECTED_TOPOLOGIES == ref_config.DIRECTED_TOPOLOGIES
    assert RANDOM_TOPOLOGIES == ref_config.RANDOM_TOPOLOGIES
    assert {name for name, *_ in GRAPHS} == set(TOPOLOGIES)


@pytest.mark.parametrize("name,n,p,seed", GRAPHS)
def test_builders_equal_the_jax_package_bitwise(name, n, p, seed):
    ours, theirs = _both(name, n, p, seed)
    assert (ours.name, ours.n, ours.directed, ours.grid_shape) == (
        theirs.name, theirs.n, theirs.directed, theirs.grid_shape)
    for field in ("adjacency", "degrees", "mixing_matrix"):
        assert np.array_equal(getattr(ours, field), getattr(theirs, field)), field
    assert ours.floats_per_iteration == theirs.floats_per_iteration
    if name not in ("grid",):  # the port's grid gap is the closed form
        assert abs(ours.spectral_gap - theirs.spectral_gap) <= TOL


@pytest.mark.parametrize("name,n,p,seed", [g for g in GRAPHS if g[1] >= 3])
def test_neighbour_tables_and_slot_weights_equal_the_jax_package(name, n, p, seed):
    ours, theirs = _both(name, n, p, seed)
    if ours.directed:
        np.testing.assert_array_equal(topology.column_stochastic_weights(ours.adjacency),
                                      ref.column_stochastic_weights(theirs.adjacency))
        if not np.array_equal(ours.adjacency, ours.adjacency.T):
            with pytest.raises(ValueError, match="undirected"):
                topology.neighbor_tables_for(ours)
        return
    idx, mask = topology.neighbor_tables_for(ours)
    ref_idx, ref_mask = ref.neighbor_tables_for(theirs)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(mask, ref_mask)
    for a, b in zip(topology.gather_mixing_weights(idx, mask, ours.degrees),
                    ref.gather_mixing_weights(ref_idx, ref_mask, theirs.degrees)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 25, 64, 257])
def test_closed_forms_equal_the_jax_package_and_the_eigensolve(n):
    assert topology.ring_spectral_gap_closed_form(n) == ref.ring_spectral_gap_closed_form(n)
    assert (topology.directed_ring_spectral_gap_closed_form(n)
            == ref.directed_ring_spectral_gap_closed_form(n))
    if n >= 3:
        assert abs(topology.ring_spectral_gap_closed_form(n)
                   - topology.build_topology("ring", n).spectral_gap) <= TOL
    if n >= 2:
        assert abs(topology.directed_ring_spectral_gap_closed_form(n)
                   - topology.build_topology("directed_ring", n).spectral_gap) <= TOL


def test_directed_graphs_keep_out_degrees_and_conserve_mass():
    topo = topology.build_topology("directed_erdos_renyi", 25, erdos_renyi_p=0.3, seed=7)
    assert topo.directed
    np.testing.assert_array_equal(topo.degrees, topo.adjacency.sum(axis=0))
    assert not np.array_equal(topo.adjacency, topo.adjacency.T)
    np.testing.assert_allclose(topo.mixing_matrix.sum(axis=0), 1.0, atol=TOL)
    assert topo.floats_per_iteration == topo.adjacency.sum()


@pytest.mark.parametrize("bad", ["negative", "rows", "asymmetric", "columns"])
def test_validate_refuses_what_the_jax_package_refuses(bad):
    n = 5
    ring = topology.build_topology("ring", n)
    W = ring.mixing_matrix.copy()
    directed = bad == "columns"
    if bad == "negative":
        W[0, 1] = -0.1
    elif bad == "rows":
        W[0, 0] += 0.1
    elif bad == "asymmetric":
        W[0, 1] += 0.1
        W[0, 0] -= 0.1
    else:
        W[0, 0] += 0.1
    fields = dict(name="ring", n=n, adjacency=ring.adjacency, degrees=ring.degrees,
                  mixing_matrix=W, directed=directed)
    ours = topology.Topology(**fields)
    theirs = ref.Topology(**fields)
    with pytest.raises(AssertionError) as want:
        theirs.validate()
    with pytest.raises(AssertionError, match=re.escape(str(want.value))):
        ours.validate()


def test_unknown_names_and_impossible_draws_raise_the_jax_messages():
    for args, kw in ((("hypercube", 8), {}),
                     (("erdos_renyi", 6), dict(erdos_renyi_p=0.0)),
                     (("directed_erdos_renyi", 4), dict(erdos_renyi_p=0.0))):
        with pytest.raises((ValueError, RuntimeError)) as want:
            ref.build_topology(*args, **kw)
        with pytest.raises(type(want.value)) as got:
            topology.build_topology(*args, **kw)
        assert str(got.value) == str(want.value)


def _message(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


# Each set of fields the JAX config refuses over the graph, with its message.
REFUSED = [
    dict(topology="directed_ring"),
    dict(topology="directed_erdos_renyi", algorithm="gradient_tracking"),
    dict(topology_seed=-2),
    dict(topology_sampler="dense"),
    dict(topology="erdos_renyi", topology_sampler="sparse", topology_impl="dense"),
    dict(topology_impl="matrix_free"),
    dict(topology_sampler="csr"),
]


@pytest.mark.parametrize("fields", REFUSED, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_config_refuses_with_the_jax_message(fields):
    want = _message(lambda: RefConfig(**fields))
    assert want is not None
    assert _message(lambda: ExperimentConfig(**fields)) == want


def test_the_representations_the_port_lacks_raise_not_yet():
    # Both representations and both samplers are ported: nothing raises.
    assert ExperimentConfig(topology_impl="neighbor").resolved_topology_impl() == "neighbor"
    assert ExperimentConfig(topology="erdos_renyi",
                            topology_sampler="sparse").resolved_topology_sampler() == "sparse"
    # Past SPARSE_SAMPLER_AUTO_N the JAX package's 'auto' draws ER with its
    # sparse sampler, and so does the port's.
    big = dict(topology="erdos_renyi", n_workers=65_537, erdos_renyi_p=1e-3)
    assert RefConfig(**big).resolved_topology_sampler() == "sparse"
    assert ExperimentConfig(**big).resolved_topology_sampler() == "sparse"
    at = dict(big, n_workers=65_536)
    assert RefConfig(**at).resolved_topology_sampler() == "dense"
    assert ExperimentConfig(**at).resolved_topology_sampler() == "dense"


@pytest.mark.parametrize("fields", [
    dict(), dict(n_workers=4096), dict(n_workers=4096, topology="chain"),
    dict(n_workers=4096, topology="erdos_renyi"), dict(n_workers=4096, topology="star"),
    dict(n_workers=4096, topology="erdos_renyi", mixing_impl="dense"),
    dict(n_workers=4096, topology="erdos_renyi", mixing_impl="sparse"),
    dict(n_workers=4096, topology="ring", aggregation="median", robust_b=1),
    dict(n_workers=4096, topology="grid", attack="sign_flip", n_byzantine=2),
    dict(n_workers=4095, topology="erdos_renyi"), dict(topology_impl="dense", n_workers=4096),
    dict(n_workers=5000, topology="directed_erdos_renyi", algorithm="push_sum"),
])
def test_resolved_topology_fields_match_the_jax_package(fields):
    ours, theirs = ExperimentConfig(**fields), RefConfig(**fields)
    assert ours.resolved_topology_impl() == theirs.resolved_topology_impl()
    assert ours.resolved_topology_sampler() == theirs.resolved_topology_sampler()
    for seed, topology_seed in ((203, -1), (203, 7), (5, 0)):
        a = ours.replace(seed=seed, topology_seed=topology_seed)
        b = theirs.replace(seed=seed, topology_seed=topology_seed)
        assert a.resolved_topology_seed() == b.resolved_topology_seed()
