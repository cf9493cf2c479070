"""The matrix-free fault form's draws and rounds, held to the JAX package on the CPU.

A matrix-free graph takes every fault process through the timeline, and
its edge chains draw one float32 uniform an edge a round, at counter e of
the round's ``(E,)`` draw (the per-edge stream of
``draw_kernels.fault_timeline``, its ``n_edges`` form). A round is the slot
round (``draw_kernels.realize_slot_round``; on the CPU its plain twin,
which the card's two launches equal bit for bit) over the [N, k_max]
table. Here:

- the per-edge timeline bitwise the JAX package's matrix-free
  ``build_fault_timeline``, iid and bursty, with churn and participation,
  keyed as a float32 and as a float64 run;
- the slot round's mix, neighbour sum, liveness, degree sum, ``active``
  and ``rejoin_restart`` against ``_make_gather_faulty_mixing``'s at every
  t of an injected timeline and past its horizon: within 1e-12 in float64,
  and in float32 the liveness, mask and degrees bitwise, the weights within
  an ulp of 1.0 (``test_torch_round_weights.py``'s bound);
- the replica axis's slot round, replica by replica the single one;
- the 64-bit edge counters: below 2¹⁶ nodes the dense form's draws are
  the 32-bit counter's bits, and ``realize_round_rows_plain`` gives the
  plain version's rows bitwise;
- ER at N = 100,000 through ``build_topology``, ``round_tables`` and one
  round of the fault form, with no [N, N] array.
"""

import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.parallel import build_topology as ref_build
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu_torch.ops import draw_kernels as dk
from distributed_optimization_tpu_torch.ops import prng
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.topology import build_topology

# (name, N, p): matrix-free graphs with k_max 2 … 10.
GRAPHS = [("ring", 16, None), ("chain", 9, None), ("grid", 16, None),
          ("erdos_renyi", 24, 0.3)]
# Timeline processes (over make_faulty_mixing's arguments).
MODES = {
    "iid-edges": dict(drop_prob=0.3),
    "bursty-edges": dict(drop_prob=0.3, burst_len=3.0),
    "stragglers": dict(drop_prob=0.0, straggler_prob=0.25),
    "edges-stragglers": dict(drop_prob=0.2, straggler_prob=0.2),
    "churn-restart": dict(drop_prob=0.3, burst_len=3.0, mttf=6.0, mttr=3.0,
                          rejoin="neighbor_restart"),
    "participation": dict(drop_prob=0.2, participation_rate=0.6),
}
H = 12
TS = (0, 1, 5, H - 1, H, H + 7)
TOL = dict(rtol=1e-12, atol=1e-12)


def _graph(name, n, p):
    kw = dict(erdos_renyi_p=p, seed=5) if p else {}
    return (build_topology(name, n, impl="neighbor", **kw),
            ref_build(name, n, impl="neighbor", **kw))


def _timeline_kw(kw):
    return dict(edge_drop_prob=kw.get("drop_prob", 0.0),
                burst_len=kw.get("burst_len", 1.0) or 1.0,
                straggler_prob=0.0 if kw.get("mttf") else kw.get("straggler_prob", 0.0),
                mttf=kw.get("mttf", 0.0), mttr=kw.get("mttr", 0.0),
                participation_rate=kw.get("participation_rate", 1.0))


@pytest.mark.parametrize("x64", [False, True], ids=["f32-keys", "f64-keys"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("graph", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_per_edge_timeline_is_the_jax_package_s(graph, mode, x64):
    ours_topo, ref_topo = _graph(*graph)
    kw = _timeline_kw(MODES[mode])
    ours = faults.build_fault_timeline(ours_topo, 40, 11, device="cpu", x64=x64, **kw)
    with jax.enable_x64(x64):
        ref = ref_faults.build_fault_timeline(ref_topo, 40, 11, **kw)
    for field in ("edge_index", "edge_up", "node_up", "rejoin", "part_up"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_per_edge_stream_is_counter_e():
    """The kernel's argument form: no edge list, E edges, edge e at counter
    e of fold_in(fault key, t); the dense form's pairs at i·N + j."""
    topo, _ = _graph("erdos_renyi", 24, 0.3)
    args, edge_index = faults.timeline_args(
        topo, 3, edge_drop_prob=0.3, burst_len=1.0, straggler_prob=0.0, mttf=0.0, mttr=0.0,
        participation_rate=1.0, device="cpu", x64=False)
    assert args["edges"] is None and args["n_edges"] == len(edge_index)
    out = dk.fault_timeline(horizon=5, device="cpu", **args)
    fault_key = args["keys"][0]
    for t in range(5):
        u = prng.uniform(prng.fold_in(fault_key, t), (len(edge_index),))
        assert torch.equal(out["edge_up"][t], u >= float(np.float32(0.3)))
    # The scan decomposition of the kernels gives the same chains.
    tiled = dk.fault_timeline_plain(horizon=5, device="cpu", tile=2, **args)
    assert torch.equal(tiled["edge_up"], out["edge_up"])
    dense = build_topology("erdos_renyi", 24, erdos_renyi_p=0.3, seed=5)
    dargs, _ = faults.timeline_args(
        dense, 3, edge_drop_prob=0.3, burst_len=1.0, straggler_prob=0.0, mttf=0.0, mttr=0.0,
        participation_rate=1.0, device="cpu", x64=False)
    assert dargs["n_edges"] is None and dargs["edges"].shape == (len(edge_index), 2)
    with pytest.raises(ValueError, match="n_edges"):
        dk.fault_timeline(horizon=5, device="cpu", **dict(dargs, n_edges=3))


def _ref_mixing(ref_topo, kw, x64):
    with jax.enable_x64(x64):
        return ref_faults.make_faulty_mixing(ref_topo, seed=11, horizon=H, **kw)


# (graph, mode, dtype): every mode in float64, two in float32.
ROUND_CASES = [(g, m, torch.float64) for g in GRAPHS for m in sorted(MODES)] + [
    (g, m, torch.float32) for g in GRAPHS for m in ("churn-restart", "edges-stragglers")]


@pytest.mark.parametrize("graph,mode,dtype", ROUND_CASES,
                         ids=[f"{g[0]}-{m}-{str(d)[6:]}" for g, m, d in ROUND_CASES])
def test_slot_round_is_the_gather_fault_form(graph, mode, dtype):
    ours_topo, ref_topo = _graph(*graph)
    kw = MODES[mode]
    x64 = dtype == torch.float64
    fm = faults.make_faulty_mixing(ours_topo, seed=11, horizon=H, device="cpu", x64=x64, **kw)
    ref = _ref_mixing(ref_topo, kw, x64)
    assert fm.timeline is not None and ref.realized_adjacency is None
    x = np.random.default_rng(3).standard_normal((ours_topo.n, 5))
    xt = torch.from_numpy(x).to(dtype)
    nbr, mask = ours_topo.nbr_idx, ours_topo.nbr_mask
    live_fn = fm.make_neighbor_liveness(nbr, mask)
    with jax.enable_x64(x64):
        xj = jnp.asarray(x, dtype=jnp.float64 if x64 else jnp.float32)
        ref_live = ref.make_neighbor_liveness(ref_topo.nbr_idx, ref_topo.nbr_mask)
        for t in TS:
            total = torch.zeros((), dtype=torch.float64)
            rnd = fm.realize(torch.tensor([t]), total)
            assert rnd.A is None and rnd.W is None
            assert float(total) == float(ref.realized_degree_sum(t))
            assert np.array_equal(rnd.active.numpy(), np.asarray(ref.active(t)))
            lv = rnd.live(fm.device_table(nbr, mask), torch.from_numpy(mask).float())
            assert np.array_equal(lv.numpy(), np.asarray(ref_live(t))), t
            assert torch.equal(live_fn(t), lv)
            if x64:
                np.testing.assert_allclose(rnd.mix(xt).numpy(), np.asarray(ref.mix(t, xj)),
                                           **TOL)
                np.testing.assert_allclose(rnd.neighbor_sum(xt).numpy(),
                                           np.asarray(ref.neighbor_sum(t, xj)), **TOL)
            else:
                # An ulp of each weight and of w_self (1.0's), times |x|.
                tol = 4 * 2.0**-23 * (1.0 + np.abs(x).max()) * (nbr.shape[1] + 1)
                np.testing.assert_allclose(rnd.mix(xt).numpy(), np.asarray(ref.mix(t, xj)),
                                           rtol=0, atol=tol)
                np.testing.assert_allclose(rnd.neighbor_sum(xt).numpy(),
                                           np.asarray(ref.neighbor_sum(t, xj)), rtol=0,
                                           atol=tol)
            if ref.rejoin_restart is not None:
                got = rnd.restart(xt).numpy()
                want = np.asarray(ref.rejoin_restart(t, xj))
                np.testing.assert_allclose(got, want, **(TOL if x64 else dict(
                    rtol=0, atol=4 * 2.0**-23 * (1.0 + np.abs(x).max()))))
            else:
                assert rnd.rejoin is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_slot_weights_are_the_jax_package_s(dtype):
    """w is 1 / (1 + max(d_i, d_nbr)) on live slots, bitwise the JAX
    package's per-slot weights; w_self within an ulp of 1.0 (float32) or
    1e-12 (float64) of 1 − Σ_s w as XLA sums it."""
    ours_topo, ref_topo = _graph("erdos_renyi", 24, 0.3)
    kw = MODES["churn-restart"]
    fm = faults.make_faulty_mixing(ours_topo, seed=11, horizon=H, device="cpu",
                                   x64=dtype == torch.float64, **kw)
    acc = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        ref = _ref_mixing(ref_topo, kw, dtype == torch.float64)
        live = ref.make_neighbor_liveness(ref_topo.nbr_idx, ref_topo.nbr_mask)
        nbr = jnp.asarray(ref_topo.nbr_idx)
        for t in TS:
            lv = live(t).astype(acc)
            deg = jnp.sum(lv, axis=1)
            w = np.asarray(lv / (1.0 + jnp.maximum(deg[:, None], deg[nbr])))
            w_self = np.asarray(1.0 - jnp.sum(jnp.asarray(w), axis=1))
            out = dk.realize_slot_round(torch.tensor([t]), fm._slots, fm._tl, weights=dtype)
            assert out.w.dtype == dtype and np.array_equal(out.w.numpy(), w)
            if dtype == torch.float32:
                np.testing.assert_allclose(out.w_self.numpy(), w_self, rtol=0, atol=2.0**-23)
            else:
                np.testing.assert_allclose(out.w_self.numpy(), w_self, **TOL)


def test_replica_axis_slot_round_is_each_replica_s():
    topo, _ = _graph("erdos_renyi", 24, 0.3)
    kw = dict(MODES["churn-restart"], participation_rate=0.7)
    seeds = [11, 12, 13]
    batch = faults.make_faulty_mixing(topo, seed=seeds, horizon=H, device="cpu", x64=True,
                                      **kw)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, topo.n, 5)))
    for t in (0, 5, H + 3):
        total = torch.zeros(3, dtype=torch.float64)
        rnd = batch.realize(torch.tensor([t]), total)
        assert rnd.active.shape == (3, topo.n)
        mixed = rnd.mix(x)
        for r, seed in enumerate(seeds):
            single = faults.make_faulty_mixing(topo, seed=seed, horizon=H, device="cpu",
                                               x64=True, **kw)
            one_total = torch.zeros((), dtype=torch.float64)
            one = single.realize(torch.tensor([t]), one_total)
            assert float(one_total) == float(total[r])
            assert torch.equal(one.active, rnd.active[r])
            assert torch.equal(one.mix(x[r]), mixed[r])
            assert torch.equal(one.neighbor_sum(x[r]), rnd.neighbor_sum(x)[r])
            assert torch.equal(one.restart(x[r]), rnd.restart(x)[r])


def test_matrix_free_refusals_are_the_jax_package_s():
    ours_topo, ref_topo = _graph("ring", 16, None)

    def message(make):
        try:
            make()
        except ValueError as e:
            return str(e)
        return None

    for kw in (dict(drop_prob=0.1, one_peer=True), dict(drop_prob=0.1)):
        want = message(lambda: ref_faults.make_faulty_mixing(ref_topo, seed=1, **kw))
        assert want is not None
        assert message(lambda: faults.make_faulty_mixing(ours_topo, seed=1, device="cpu",
                                                         **kw)) == want


# Caller tables over a matrix-free graph, each against the JAX package's
# make_neighbor_liveness over the same table.
FOREIGN_CASES = [(g, m) for g in (GRAPHS[0], GRAPHS[3])
                 for m in ("bursty-edges", "churn-restart", "participation")]


def _foreign_liveness_is_the_jax_package_s(graph, mode, table):
    """live(t) over the caller's table ``table(nbr_idx, nbr_mask)`` at every
    t of TS, in a float32 and a float64 run, bitwise the JAX package's, both
    through make_neighbor_liveness and through a round's live."""
    ours_topo, ref_topo = _graph(*graph)
    nbr, mask = table(ours_topo.nbr_idx.copy(), ours_topo.nbr_mask.copy())
    for x64 in (False, True):
        fm = faults.make_faulty_mixing(ours_topo, seed=11, horizon=H, device="cpu", x64=x64,
                                       **MODES[mode])
        live_fn = fm.make_neighbor_liveness(nbr, mask)
        device_table = fm.device_table(nbr, mask)
        assert isinstance(device_table, dk.SlotTables)
        with jax.enable_x64(x64):
            ref_live = _ref_mixing(ref_topo, MODES[mode], x64).make_neighbor_liveness(nbr, mask)
            for t in TS:
                want = np.asarray(ref_live(t))
                got = live_fn(t)
                assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want), t
                rnd = fm.realize(torch.tensor([t]))
                assert torch.equal(rnd.live(device_table, None), got)


@pytest.mark.parametrize("graph,mode", FOREIGN_CASES,
                         ids=[f"{g[0]}-{m}" for g, m in FOREIGN_CASES])
def test_liveness_over_a_table_with_permuted_slots(graph, mode):
    """The topology's neighbours in another slot order (each row's real
    slots reversed, still a prefix): the slots' edge ids follow them."""
    def reverse(nbr, mask):
        for i in range(nbr.shape[0]):
            c = int(mask[i].sum())
            nbr[i, :c] = nbr[i, :c][::-1]
        return nbr, mask

    _foreign_liveness_is_the_jax_package_s(graph, mode, reverse)


@pytest.mark.parametrize("graph,mode", FOREIGN_CASES,
                         ids=[f"{g[0]}-{m}" for g, m in FOREIGN_CASES])
def test_liveness_over_a_table_with_a_masked_hole(graph, mode):
    """Every third row's first real slot masked out (a hole before the
    real slots that follow, not a prefix), and a float mask of other
    weights than 0 and 1 on the others: the caller's mask times the
    liveness."""
    def hole(nbr, mask):
        weights = np.where(mask, 0.5 + np.arange(mask.shape[1])[None, :], 0.0)
        weights[::3, 0] = 0.0
        return nbr, weights.astype(np.float32)

    _foreign_liveness_is_the_jax_package_s(graph, mode, hole)


def test_own_table_keeps_the_slot_round_s_liveness():
    """The topology's own table is the slot round's own slots: the round's
    live tensor itself, and a zero mask is a table of no real slots."""
    topo, _ = _graph("ring", 16, None)
    fm = faults.make_faulty_mixing(topo, 0.2, 5, horizon=H, device="cpu")
    nbr, mask = topo.nbr_idx, topo.nbr_mask
    rnd = fm.realize(torch.tensor([3]))
    assert fm.device_table(nbr, mask) is fm._nbr
    assert rnd.live(fm.device_table(nbr, mask), None) is rnd._r.live
    assert torch.equal(rnd.live(fm.device_table(nbr, mask), None),
                       fm.make_neighbor_liveness(nbr, mask)(3))
    assert not fm.make_neighbor_liveness(nbr, np.zeros_like(mask))(3).any()
    with pytest.raises(TypeError, match="device_table"):
        rnd.live(torch.from_numpy(nbr).long(), torch.from_numpy(mask).float())


@pytest.mark.parametrize("n", [5, 16, 255, 65_535])
def test_dense_counters_below_two_to_the_16_are_the_32_bit_ones(n):
    """i·N + j < 2³² below N = 65,536: the 64-bit counter's high word is 0
    and its draws are the 32-bit counter's, so the parent's bits stand."""
    key = prng.fold_in(prng.key(203, x64=False), 7)
    i = torch.tensor([0, 1, n // 2, n - 2, n - 1], dtype=torch.int64)
    c = i[:, None] * n + i[None, :]
    got = prng.uniform_at(key, c)
    x0, x1 = prng.threefry2x32(key[0], key[1], torch.zeros_like(c), c & prng.MASK32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    assert torch.equal(got, bits.to(torch.int32).view(torch.float32) - 1.0)


def test_rows_plain_is_the_plain_version_s_rows():
    for name, n in (("ring", 40), ("erdos_renyi", 30)):
        topo = build_topology(name, n, erdos_renyi_p=0.3, seed=2)
        fm = faults.make_faulty_mixing(topo, 0.3, 5, straggler_prob=0.2, device="cpu")
        for t in (0, 9, 2**31 + 5):
            tt = torch.tensor([t])
            want = dk.realize_round_plain(tt, fm._keys, fm._tables, drop_prob=0.3,
                                          straggler_prob=0.2, weights=torch.float32)
            rows = [0, 3, n - 1]
            A, W, active = dk.realize_round_rows_plain(tt, fm._keys, fm._tables, rows,
                                                       drop_prob=0.3, straggler_prob=0.2)
            assert torch.equal(A, want.A[rows]) and torch.equal(W, want.W[rows])
            assert torch.equal(active, want.active[rows])


def test_rows_plain_past_two_to_the_32_draws_the_high_word():
    """At N = 65,537 row N − 1's counters pass 2³²: the draws there are
    Threefry's at (c >> 32, c mod 2³²), not at c mod 2³²."""
    n = 65_537
    topo = build_topology("ring", n, impl="neighbor")
    keys = faults._tag_keys(5, False, faults.FAULT_TAG, faults.NODE_TAG, faults.MATCH_TAG)
    # The dense round's tables, built from the matrix-free graph's own table.
    tables = faults.round_tables(topo, device="cpu")
    tt = torch.tensor([3])
    A, _, _ = dk.realize_round_rows_plain(tt, keys, tables, [n - 1], drop_prob=0.3,
                                          straggler_prob=0.0)
    # Row n − 1's neighbours are 0 and n − 2: edges (0, n − 1) below 2³²
    # and (n − 2, n − 1) at (n − 2)·n + n − 1 ≥ 2³².
    c = (n - 2) * n + n - 1
    assert c >= 2**32
    key = prng.fold_in(keys[0], 3)
    u = prng.uniform_at(key, torch.tensor([n - 1, c]))
    assert torch.equal(A[0, [0, n - 2]], (u >= float(np.float32(0.3))).float())
    assert prng.uniform_at(key, torch.tensor([c % 2**32]))[0] != u[1]


def test_er_at_100k_builds_and_realizes_with_no_square_array():
    """ER at N = 100,000 (p = 16/N, the sparse sampler 'auto' takes there):
    the graph, its round tables and one round of the fault form on the CPU,
    every host allocation O(N·k_max) (tracemalloc's peak below 1 GB, where
    one [N, N] float32 array is 40 GB) and every round operand [N, k_max]."""
    n = 100_000
    tracemalloc.start()
    try:
        topo = build_topology("erdos_renyi", n, erdos_renyi_p=16 / n, seed=1, impl="neighbor",
                              sampler="sparse")
        tables = faults.round_tables(topo, faults._edge_list(topo), device="cpu")
        fm = faults.make_faulty_mixing(topo, 0.1, 203, participation_rate=0.5, horizon=3,
                                       device="cpu")
        total = torch.zeros((), dtype=torch.float64)
        rnd = fm.realize(torch.tensor([1]), total)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    k = topo.nbr_idx.shape[1]
    assert topo.adjacency is None and topo.mixing_matrix is None
    assert tables.in_nbr.shape == (n, k) and tables.in_eid.shape == (n, k)
    assert rnd.A is None and rnd._r.live.shape == (n, k) and rnd._r.w.shape == (n, k)
    assert rnd.active.shape == (n,) and fm.timeline.edge_up.shape[0] == 3
    assert 0 < float(total) < topo.floats_per_iteration
    assert peak < 1 << 30
    x = torch.ones((n, 2))
    assert torch.allclose(rnd.mix(x), x)


@pytest.mark.parametrize("graph", GRAPHS[:2] + GRAPHS[3:], ids=["ring", "chain", "erdos_renyi"])
def test_diagnostics_take_a_matrix_free_topology(graph):
    """``windowed_connectivity`` (B̂) and ``outage_stats`` over a matrix-free
    graph's timeline, without an adjacency: the JAX package's values."""
    ours_topo, ref_topo = _graph(*graph)
    kw = dict(edge_drop_prob=0.4, burst_len=4.0, mttf=8.0, mttr=3.0, participation_rate=0.8)
    ours = faults.build_fault_timeline(ours_topo, 60, 7, device="cpu", **kw)
    ref = ref_faults.build_fault_timeline(ref_topo, 60, 7, **kw)
    assert faults.windowed_connectivity(ours, ours_topo) == \
        ref_faults.windowed_connectivity(ref, ref_topo)
    assert faults.outage_stats(ours) == ref_faults.outage_stats(ref)
    alive, edges = faults._realized_edge_alive(ours, ours_topo)
    ref_alive, ref_edges = ref_faults._realized_edge_alive(ref, ref_topo)
    assert np.array_equal(alive, ref_alive) and np.array_equal(edges, ref_edges)
