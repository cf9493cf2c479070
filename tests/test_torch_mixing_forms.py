"""Every mixing form of the port against the JAX package's ``make_mixing_op``.

On each graph of the JAX package and for each form it builds there
(stencil, dense, gather, sparse, pallas), W x and A x agree with the JAX
operator to 1e-12 (rtol and atol) in float64, on a model stack [N, 5] and
on push-sum's mass [N, 1]; where the JAX package refuses a form, the port
raises its message. ``auto`` picks the JAX package's form, and at
N >= MATRIX_FREE_AUTO_N, where the JAX package builds the matrix-free
neighbour table, the port's table from its dense graph is that table bit
for bit. The JAX side runs under ``enable_x64``; its Pallas kernels in
interpret mode, as on any CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_mixing_op
from distributed_optimization_tpu.parallel import topology as ref_topology
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.config import MATRIX_FREE_AUTO_N
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel import topology

TOL = dict(rtol=1e-12, atol=1e-12)
FORMS = ("stencil", "dense", "gather", "sparse", "pallas")
# (name, n, erdos_renyi_p, seed): every graph of the JAX package.
GRAPHS = (("ring", 8, 0.4, 0), ("grid", 9, 0.4, 0), ("fully_connected", 6, 0.4, 0),
          ("erdos_renyi", 12, 0.3, 3), ("chain", 7, 0.4, 0), ("star", 7, 0.4, 0),
          ("directed_ring", 7, 0.4, 0), ("directed_erdos_renyi", 10, 0.3, 3),
          ("ring", 2, 0.4, 0), ("chain", 1, 0.4, 0))


def _graphs(name, n, p, seed):
    return (topology.build_topology(name, n, erdos_renyi_p=p, seed=seed),
            ref_topology.build_topology(name, n, erdos_renyi_p=p, seed=seed))


def _jax_op(topo, impl):
    """(op, None) or (None, the JAX package's refusal)."""
    try:
        with enable_x64():
            return ref_mixing_op(topo, impl=impl, dtype=jnp.float64), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("impl", ("auto", *FORMS))
@pytest.mark.parametrize("name,n,p,seed", GRAPHS)
def test_each_form_matches_the_jax_operator(name, n, p, seed, impl):
    ours_topo, ref_topo = _graphs(name, n, p, seed)
    ref_op, refusal = _jax_op(ref_topo, impl)
    if ref_op is None:
        with pytest.raises(ValueError) as got:
            make_mixing_op(ours_topo, impl, device="cpu", dtype=torch.float64)
        assert str(got.value) == refusal
        return
    op = make_mixing_op(ours_topo, impl, device="cpu", dtype=torch.float64)
    assert op.impl == ref_op.impl
    x = np.random.default_rng(n).standard_normal((n, 6))
    with enable_x64():
        want_w = np.asarray(ref_op.apply(jnp.asarray(x)))
        want_a = np.asarray(ref_op.neighbor_sum(jnp.asarray(x)))
    # W and A act column by column: the [N, 1] mass against the first column.
    for cols in (slice(1, 6), slice(0, 1)):
        tx = torch.from_numpy(np.ascontiguousarray(x[:, cols]))
        got_w, got_a = op.apply(tx), op.neighbor_sum(tx)
        assert got_w.dtype == torch.float64 and got_w.shape == tx.shape
        np.testing.assert_allclose(got_w.numpy(), want_w[:, cols], **TOL)
        np.testing.assert_allclose(got_a.numpy(), want_a[:, cols], **TOL)


@pytest.mark.parametrize("name,n,p,seed,impl", [
    (*g, impl) for g in GRAPHS if g[1] >= 3 for impl in ("gather", "sparse")
    if impl == "sparse" or not g[0].startswith("directed")])
def test_table_forms_are_bitwise_on_two_calls_and_keep_the_mass(name, n, p, seed, impl):
    topo, _ = _graphs(name, n, p, seed)
    op = make_mixing_op(topo, impl, device="cpu", dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 7)))
    assert torch.equal(op.apply(x), op.apply(x))
    assert torch.equal(op.neighbor_sum(x), op.neighbor_sum(x))
    ones = torch.ones((n, 1), dtype=torch.float64)
    # Column-stochastic (and doubly stochastic) W keeps Σ_i (W w)_i = N.
    assert abs(float(op.apply(ones).sum()) - n) <= 1e-12 * n


def test_the_sparse_table_lists_in_edges_in_the_jax_edge_order():
    from distributed_optimization_tpu_torch.ops.mixing import _in_edge_table

    topo = topology.build_topology("directed_erdos_renyi", 10, erdos_renyi_p=0.3, seed=3)
    src, w, mask = _in_edge_table(topo)
    dst_np, src_np = np.nonzero(topo.adjacency)
    live = mask > 0
    np.testing.assert_array_equal(src[live], src_np)
    np.testing.assert_array_equal(np.nonzero(live)[0], dst_np)
    np.testing.assert_array_equal(w[live], topo.mixing_matrix[dst_np, src_np])
    assert np.all(src[~live] == np.nonzero(~live)[0]) and np.all(w[~live] == 0.0)
    assert src.shape[1] == int(topo.adjacency.sum(axis=1).max())


# (name, n, p): graphs at the JAX package's matrix-free threshold, and
# one below it.
AUTO_AT_SCALE = (("chain", MATRIX_FREE_AUTO_N, 0.4), ("star", MATRIX_FREE_AUTO_N, 0.4),
                 ("erdos_renyi", MATRIX_FREE_AUTO_N, 12 / MATRIX_FREE_AUTO_N),
                 ("chain", MATRIX_FREE_AUTO_N - 1, 0.4))


@pytest.mark.parametrize("name,n,p", AUTO_AT_SCALE)
def test_auto_at_scale_takes_the_jax_form_and_its_tables(name, n, p):
    """The JAX run resolves topology_impl='auto' to its matrix-free builder
    for chain and ER from N = 4,096 and mixes there in gather form; the port
    builds the dense graph, whose auto form and neighbour table are the
    same. Star (k_max = N − 1) stays dense. The JAX operator is built on
    the port's dense matrices (the builders are bitwise equal above), or
    on the JAX package's own matrix-free graph."""
    ours = topology.build_topology(name, n, erdos_renyi_p=p, seed=203)
    op = make_mixing_op(ours, "auto", device="cpu", dtype=torch.float64)
    if name in ("chain", "erdos_renyi") and n >= MATRIX_FREE_AUTO_N:
        theirs = ref_topology.build_topology(name, n, erdos_renyi_p=p, seed=203,
                                             impl="neighbor")
        idx, mask = topology.neighbor_tables_for(ours)
        np.testing.assert_array_equal(idx, theirs.nbr_idx)
        np.testing.assert_array_equal(mask, theirs.nbr_mask)
        np.testing.assert_array_equal(ours.degrees, theirs.degrees)
    else:
        theirs = ref_topology.Topology(name=name, n=n, adjacency=ours.adjacency,
                                       degrees=ours.degrees, mixing_matrix=ours.mixing_matrix)
    ref_op, _ = _jax_op(theirs, "auto")
    assert op.impl == ref_op.impl == ("dense" if name == "star" or n < MATRIX_FREE_AUTO_N
                                      else "gather")
    x = np.random.default_rng(2).standard_normal((n, 3))
    with enable_x64():
        want = np.asarray(ref_op.apply(jnp.asarray(x)))
    np.testing.assert_allclose(op.apply(torch.from_numpy(x)).numpy(), want, **TOL)
