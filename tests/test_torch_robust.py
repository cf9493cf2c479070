"""The port's robust screens against the JAX package.

On the CPU the fused robust wrappers run their plain PyTorch version, held
here against the Pallas kernels in interpret mode, the JAX package's gather
form and its per-node numpy oracle, on numpy-built symmetric neighbour
tables with dead slots and a few rows scaled by 1e4. Tolerances: 1e-12
(rtol and atol) in float64; in float32 1 ulp for the count rules and 1e-5
of max|x| for clipping, whose norm is a reduction over d in another order.
Against the port's own gather form the count rules are bitwise equal. The
CUDA kernels are held against the plain version on the same instances by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.ops.robust_aggregation import (
    make_gather_robust_aggregator as ref_gather,
    robust_aggregate_np as ref_oracle,
)
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.parallel.topology import neighbor_table as ref_neighbor_table
from distributed_optimization_tpu_torch.ops import robust_kernels as rk
from distributed_optimization_tpu_torch.ops.robust_aggregation import (
    make_gather_robust_aggregator,
    robust_aggregate_np,
    validate_budget,
)
from distributed_optimization_tpu_torch.parallel.topology import build_topology, neighbor_table
from test_torch_cuda import COUNT_RULES, GRAPHS, SCREENS, symmetric_instance

TORCH = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    return symmetric_instance(**GRAPHS[request.param])


def _tols(dtype, rule, x):
    if dtype == np.float64:
        return dict(rtol=1e-12, atol=1e-12)
    if rule in COUNT_RULES:
        return dict(rtol=1.2e-7, atol=0.0)
    return dict(rtol=0.0, atol=1e-5 * float(np.abs(x).max()))


def _pallas(rule, ct, nbr, live, x, g=None, eta=None):
    with enable_x64():
        lv, xv = jnp.asarray(live), jnp.asarray(x)
        if g is None:
            return np.asarray(pk.make_fused_robust_aggregator(rule, 1, nbr, ct, interpret=True)(lv, xv))
        step = pk.make_fused_robust_dsgd_step(rule, 1, nbr, ct, interpret=True)
        return np.asarray(step(lv, xv, jnp.asarray(g), jnp.asarray(eta, dtype=x.dtype)))


def test_graphs_have_the_widths_they_claim(graph):
    nbr, live, _, _ = graph
    assert nbr.shape[1] in (4, 15)
    assert (live == 0).any(), "the instance must have dead slots"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rule,ct", SCREENS)
def test_plain_aggregator_matches_pallas_interpret(graph, rule, ct, dtype):
    nbr, live, _, x64 = graph
    x = x64.astype(dtype)
    want = _pallas(rule, ct, nbr, live, x)
    agg = rk.make_fused_robust_aggregator(rule, 1, nbr, ct, device="cpu")
    got = agg(torch.from_numpy(live), torch.from_numpy(x))
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.numpy(), want, **_tols(dtype, rule, x))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rule,ct", SCREENS)
def test_plain_dsgd_step_matches_pallas_interpret(graph, rule, ct, dtype):
    """The whole update; XLA may contract − η·g into one FMA where the plain
    version rounds twice, so the float32 count rules get 1 ulp of the
    operands, not of the result."""
    nbr, live, _, x64 = graph
    x = x64.astype(dtype)
    g = np.random.default_rng(21).standard_normal(x.shape).astype(dtype)
    eta = float(dtype(0.05))
    want = _pallas(rule, ct, nbr, live, x, g, eta)
    step = rk.make_fused_robust_dsgd_step(rule, 1, nbr, ct, device="cpu")
    got = step(torch.from_numpy(live), torch.from_numpy(x), torch.from_numpy(g),
               torch.tensor([eta], dtype=TORCH[dtype])).numpy()
    agg = rk.make_fused_robust_aggregator(rule, 1, nbr, ct, device="cpu")(
        torch.from_numpy(live), torch.from_numpy(x)).numpy()
    if dtype == np.float32 and rule in COUNT_RULES:
        assert np.all(np.abs(got - want) <= 1.2e-7 * (np.abs(agg) + np.abs(dtype(eta) * g)))
    else:
        np.testing.assert_allclose(got, want, **_tols(dtype, rule, x))
    np.testing.assert_array_equal(got, agg - dtype(eta) * g)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rule,ct", SCREENS)
def test_plain_matches_the_gather_forms_and_the_oracle(graph, rule, ct, dtype):
    nbr, live, realized, x64 = graph
    x = x64.astype(dtype)
    tl, tx = torch.from_numpy(live), torch.from_numpy(x)
    plain = rk.make_fused_robust_aggregator(rule, 1, nbr, ct, device="cpu")(tl, tx).numpy()
    ours = make_gather_robust_aggregator(rule, 1, nbr, ct, device="cpu")(tl, tx).numpy()
    tol = _tols(dtype, rule, x)
    if rule in COUNT_RULES:
        np.testing.assert_array_equal(plain, ours)
    else:
        np.testing.assert_allclose(plain, ours, **tol)
    with enable_x64():
        theirs = np.asarray(ref_gather(rule, 1, nbr, ct)(jnp.asarray(live), jnp.asarray(x)))
    np.testing.assert_allclose(ours, theirs, **tol)
    if dtype == np.float64:
        oracle = robust_aggregate_np(rule, realized, x, 1, ct)
        np.testing.assert_array_equal(oracle, ref_oracle(rule, realized, x, 1, ct))
        np.testing.assert_allclose(plain, oracle, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rule,ct", SCREENS)
def test_identity_row_degradation_on_a_damaged_ring(rule, ct):
    """Node 0 isolated and the edge 3–4 down: a closed neighbourhood of at
    most 2b values (deg ≤ b for clipping) keeps its own model, as in the
    Pallas kernel and the gather form."""
    topo = build_topology("ring", 10)
    x = np.random.default_rng(8).standard_normal((10, 4))
    A = np.array(topo.adjacency, copy=True)
    A[0, :] = A[:, 0] = 0.0
    A[3, 4] = A[4, 3] = 0.0
    nbr, mask = neighbor_table(topo.adjacency)
    live = (np.take_along_axis(A, nbr.astype(np.int64), axis=1) * mask).astype(np.float32)
    out = rk.make_fused_robust_aggregator(rule, 1, nbr, ct, device="cpu")(
        torch.from_numpy(live), torch.from_numpy(x)).numpy()
    if rule != "median":
        np.testing.assert_array_equal(out[0], x[0])
    gather = make_gather_robust_aggregator(rule, 1, nbr, ct, device="cpu")(
        torch.from_numpy(live), torch.from_numpy(x)).numpy()
    if rule in COUNT_RULES:
        np.testing.assert_array_equal(out, gather)
    else:
        np.testing.assert_allclose(out, gather, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out, _pallas(rule, ct, nbr, live, x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out, robust_aggregate_np(rule, A, x, 1, ct), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("width", [2, 3, 9, 16])
def test_sort_network_matches_torch_sort_with_inf_padding(width):
    rng = np.random.default_rng(width)
    v = rng.standard_normal((40, width, 6))
    v[rng.random(v.shape) < 0.2] = np.inf
    t = torch.from_numpy(v)
    assert torch.equal(rk.sort_columns(t), torch.sort(t, dim=1).values)
    with enable_x64():
        np.testing.assert_array_equal(rk.sort_columns(t).numpy(),
                                      np.asarray(pk._sort_columns(jnp.asarray(v))))


def test_fused_robust_supported_and_the_width_bound():
    for rule, k_max, ct in [("median", 23, 0.0), ("trimmed_mean", 15, 0.0),
                            ("trimmed_mean", 16, 0.0), ("clipped_gossip", 16, 0.0),
                            ("clipped_gossip", 17, 0.0), ("clipped_gossip", 23, 0.7),
                            ("gossip", 2, 0.0), ("krum", 2, 0.0)]:
        assert rk.fused_robust_supported(rule, k_max, ct) == pk.fused_robust_supported(
            rule, k_max, ct), (rule, k_max, ct)
    assert rk.FUSED_MAX_SORT_WIDTH == pk.FUSED_MAX_SORT_WIDTH
    nbr, _ = neighbor_table(build_topology("fully_connected", 24).adjacency)
    for rule in ("median", "clipped_gossip"):
        with pytest.raises(ValueError, match="sort network"):
            rk.make_fused_robust_aggregator(rule, 1, nbr, device="cpu")
        with pytest.raises(ValueError, match="sort network"):
            rk.make_fused_robust_dsgd_step(rule, 1, nbr, device="cpu")
    rk.make_fused_robust_aggregator("clipped_gossip", 1, nbr, clip_tau=0.7, device="cpu")
    with pytest.raises(ValueError, match="positive attack budget"):
        rk.make_fused_robust_aggregator("median", 0, nbr[:, :2], device="cpu")
    with pytest.raises(ValueError, match="no robust aggregator"):
        rk.make_fused_robust_aggregator("gossip", 1, nbr[:, :2], device="cpu")


@pytest.mark.parametrize("k_max,fits", [(1116, True), (1117, False)])
def test_fixed_radius_clipping_is_bounded_by_shared_memory(k_max, fits):
    # Fixed-τ clipping sorts nothing, so only the clipping kernel's shared
    # memory (within the 48 KiB default) bounds its k_max.
    nbr = np.zeros((2, k_max), dtype=np.int32)
    assert rk.fused_robust_supported("clipped_gossip", k_max, 0.7)
    if fits:
        rk.make_fused_robust_dsgd_step("clipped_gossip", 1, nbr, clip_tau=0.7, device="cpu")
    else:
        with pytest.raises(ValueError, match="shared memory, which holds at most 1116"):
            rk.make_fused_robust_dsgd_step("clipped_gossip", 1, nbr, clip_tau=0.7, device="cpu")


def test_validate_budget_and_the_neighbor_table_match_the_reference():
    for name, n in (("ring", 9), ("fully_connected", 6)):
        adj = build_topology(name, n).adjacency
        for ours, theirs in zip(neighbor_table(adj), ref_neighbor_table(adj)):
            np.testing.assert_array_equal(ours, theirs)
            assert ours.dtype == theirs.dtype
    with pytest.raises(ValueError, match="directed"):
        neighbor_table(np.triu(np.ones((4, 4)), 1))
    validate_budget(2, 1, "trimmed_mean")
    with pytest.raises(ValueError, match="2\\*b <= min degree"):
        validate_budget(2, 2, "median")


def test_cpu_wrappers_run_the_plain_version_and_count_nothing(graph):
    nbr, live, _, x = graph
    rk.reset_launch_counts()
    tl, tx = torch.from_numpy(live), torch.from_numpy(x)
    agg = rk.make_fused_robust_aggregator("trimmed_mean", 1, nbr, device="cpu")
    got = agg(tl, tx)
    want = rk.fused_robust_plain("trimmed_mean", 1, torch.from_numpy(nbr).long(), tl, tx,
                                 torch.zeros(1, dtype=tx.dtype), adaptive=False)
    assert torch.equal(got, want)
    assert rk.LAUNCHES == {name: 0 for name in rk.KERNELS}
    with pytest.raises(ValueError, match="match x"):
        agg(tl.double(), tx)
    with pytest.raises(ValueError, match="rows"):
        agg(tl[:-1], tx[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        agg(tl, tx.t().contiguous().t())
