"""The replica axis's plain versions and layers on the CPU.

Each kernel that takes a replica axis has a plain version that takes it
too; R replicas' outputs equal R single plain calls, each with replica r's
keys and thresholds, bit for bit (R = 1 and 3): the sampler's two forms
(``ops/sampling.py``), the round (``ops/draw_kernels.realize_round`` with
``[R, 3, 2]`` keys, a drop threshold a replica and stacked timelines) and
the noise (``[R, 2]`` keys, ``[R, N]`` flags, a stack whose N·d is not a
multiple of the kernel's block). The layers above them take a leading [R]
and give each replica what the single run gives it: the mixing forms, the
robust screens (a clipping radius a replica), the adversary, the faulty
mixing and the losses against shared shards (to 1e-12 in float64: another
product). ``stack_fault_timelines`` stacks as the JAX package's does and
refuses with its message.
"""

import numpy as np
import pytest
import torch

from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu_torch.ops import draw_kernels as dk
from distributed_optimization_tpu_torch.ops import losses, prng, sampling
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.ops.robust_aggregation import (
    make_gather_robust_aggregator,
    make_robust_aggregator,
)
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.adversary import make_adversary
from distributed_optimization_tpu_torch.parallel.topology import (
    build_topology,
    neighbor_tables_for,
)

SEEDS = (203, 7, 2**31 - 1)
DTYPES = (torch.float32, torch.float64)


def _seeds(R):
    return list(SEEDS[:R])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("n, L, b", [(6, 7, 3), (5, 33, 16), (4, 65, 16), (3, 5, 9)])
def test_sampler_plain_stack_is_r_single_calls(n, L, b, R, dtype):
    x64 = dtype == torch.float64
    nv = torch.full((n,), L, dtype=torch.int64)
    nv[1], nv[2] = 0, min(3, L)
    gen = torch.Generator().manual_seed(L)
    X = torch.randn((n, L, 4), generator=gen, dtype=dtype)
    y = torch.randn((n, L), generator=gen, dtype=dtype)
    for slot in (0, 2):
        keys = prng.keys(_seeds(R), x64=x64, tags=(slot,))
        for t in (torch.tensor([5]), torch.tensor([2**31 + 1])):
            w = sampling.sample_worker_batch_weights(keys, t, nv, L, b, dtype)
            idx, wts = sampling.sample_batch_indices(keys, t, nv, L, b, dtype)
            Xb, yb, wb = sampling.sample_worker_batches(keys, t, X, y, nv, b)
            assert w.shape == (R, n, L) and idx.shape == wts.shape == (R, n, b)
            for r, seed in enumerate(_seeds(R)):
                key = prng.fold_in(prng.key(seed, x64=x64), slot)
                assert torch.equal(w[r], sampling.sample_worker_batch_weights(
                    key, t, nv, L, b, dtype))
                i1, w1 = sampling.sample_batch_indices(key, t, nv, L, b, dtype)
                assert torch.equal(idx[r], i1) and torch.equal(wts[r], w1)
                one = sampling.sample_worker_batches(key, t, X, y, nv, b)
                assert all(torch.equal(a[r], c) for a, c in zip((Xb, yb, wb), one))


def test_replica_keys_are_the_single_run_keys():
    for x64 in (False, True):
        keys = prng.keys([3, 2**40 + 5], x64=x64, tags=(0x0FA17, 9))
        for r, seed in enumerate([3, 2**40 + 5]):
            want = prng.fold_in(prng.fold_in(prng.key(seed, x64=x64), 0x0FA17), 9)
            assert tuple(keys[r].tolist()) == want


# Fault modes (make_faulty_mixing's arguments); "swept" takes a drop
# probability a replica.
MODES = {
    "drops": dict(drop_prob=0.2),
    "both": dict(drop_prob=0.2, straggler_prob=0.1),
    "bursty": dict(drop_prob=0.3, burst_len=4.0, horizon=20),
    "churn-restart": dict(drop_prob=0.1, mttf=6.0, mttr=3.0, rejoin="neighbor_restart",
                          horizon=20),
    "participation": dict(drop_prob=0.1, participation_rate=0.7, horizon=20),
    "one-peer": dict(drop_prob=0.2, straggler_prob=0.1, one_peer=True),
    "swept": dict(drop_prob=None),
    "swept-bursty": dict(drop_prob=None, burst_len=2.0, horizon=20),
}


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("graph, mode", [
    (g, m) for g in ("ring", "erdos_renyi", "directed_erdos_renyi") for m in sorted(MODES)
    if not (g.startswith("directed") and m == "one-peer")])
def test_round_plain_stack_is_r_single_calls(graph, mode, R):
    """The round's plain version over [R, 3, 2] keys (a threshold a replica,
    stacked timelines): each replica's A_t, W_t, mask, scores and degree
    count equal the single plain call's, and the faulty mixing's round
    operations equal each replica's single round's."""
    topo = build_topology(graph, 12, erdos_renyi_p=0.5, seed=3)
    kw = dict(MODES[mode])
    drops = [0.1 + 0.3 * r for r in range(R)] if kw["drop_prob"] is None \
        else [kw["drop_prob"]] * R
    del kw["drop_prob"]
    for dtype in DTYPES:
        kw["x64"] = dtype == torch.float64
        swept = MODES[mode]["drop_prob"] is None
        batch = faults.make_faulty_mixing(topo, drops if swept else drops[0], _seeds(R),
                                          device="cpu", **kw)
        singles = [faults.make_faulty_mixing(topo, drops[r], s, device="cpu", **kw)
                   for r, s in enumerate(_seeds(R))]
        x = torch.randn((R, 12, 3), dtype=dtype, generator=torch.Generator().manual_seed(1))
        for t in (0, 7, 19, 25):
            tt = torch.tensor([t])
            total = torch.full((R,), 2.0, dtype=torch.float64)
            rnd = batch.realize(tt, total)
            for r in range(R):
                one_total = torch.full((), 2.0, dtype=torch.float64)
                one = singles[r].realize(tt, one_total)
                assert float(total[r]) == float(one_total)
                assert torch.equal(rnd.active[r], one.active)
                if one.partner is not None:
                    assert torch.equal(rnd.partner[r], one.partner)
                else:
                    assert torch.equal(rnd.A[r], one.A) and torch.equal(rnd.W[r], one.W)
                    if one.rejoin is not None:
                        assert torch.equal(rnd.restart(x)[r], one.restart(x[r]))
                assert torch.equal(rnd.mix(x)[r], one.mix(x[r]))
                assert torch.equal(rnd.neighbor_sum(x)[r], one.neighbor_sum(x[r]))


def test_round_refuses_mismatched_replica_arguments():
    topo = build_topology("ring", 8)
    fm = faults.make_faulty_mixing(topo, [0.1, 0.2], [1, 2], device="cpu")
    t = torch.tensor([0])
    with pytest.raises(ValueError, match="one element"):
        fm.realize(t, torch.zeros((), dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        dk.realize_round(t, fm._keys, fm._tables,
                         drop_prob=torch.tensor([0.1, 0.2], dtype=torch.float64),
                         straggler_prob=0.0)
    with pytest.raises(TypeError, match="replica"):
        dk.realize_round(t, ((0, 1), (0, 2), (0, 3)), fm._tables,
                         drop_prob=torch.tensor([0.1, 0.2], dtype=torch.float32),
                         straggler_prob=0.0)
    with pytest.raises(ValueError, match="seed a replica"):
        faults.make_faulty_mixing(topo, [0.1, 0.2], 1, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("n, d", [(7, 11), (64, 11), (3, 1)])
def test_noise_plain_stack_is_r_single_calls(n, d, R, dtype):
    """N·d of 77, 704 and 3: never a multiple of the kernel's 256-thread
    block, so a block that straddled two replicas would fold the wrong key."""
    x64 = dtype == torch.float64
    keys = prng.keys(_seeds(R), x64=x64, tags=(0xBAD0,))
    gen = torch.Generator().manual_seed(n * d)
    x = torch.randn((R, n, d), generator=gen, dtype=dtype)
    byz = (torch.rand((R, n), generator=gen) < 0.4).to(torch.uint8)
    for t in (0, 9, 2**31 - 1):
        tt = torch.tensor([t])
        got = dk.large_noise(keys, tt, byz, x, 3.0)
        for r, seed in enumerate(_seeds(R)):
            key = prng.fold_in(prng.key(seed, x64=x64), 0xBAD0)
            assert torch.equal(got[r], dk.large_noise(key, tt, byz[r].contiguous(),
                                                      x[r].contiguous(), 3.0))


def test_noise_refuses_mismatched_replica_arguments():
    keys = prng.keys([1, 2], x64=False)
    x = torch.zeros((2, 4, 3))
    t = torch.tensor([0])
    with pytest.raises(ValueError, match="uint8"):
        dk.large_noise(keys, t, torch.zeros(4, dtype=torch.uint8), x, 1.0)
    with pytest.raises(ValueError, match="int64"):
        dk.large_noise(keys[:1], t, torch.zeros((2, 4), dtype=torch.uint8), x, 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attack", ["sign_flip", "alie", "large_noise"])
def test_adversary_stack_is_each_replica_s(attack, dtype):
    seeds = [3, 5, 203]
    adv = make_adversary(12, attack, 3, 1.5, seeds, device="cpu", dtype=dtype)
    x = torch.randn((3, 12, 5), dtype=dtype, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([7])
    got = adv.corrupt(x, t)
    for r, seed in enumerate(seeds):
        one = make_adversary(12, attack, 3, 1.5, seed, device="cpu", dtype=dtype)
        assert np.array_equal(adv.byzantine[r], one.byzantine)
        assert torch.equal(got[r], one.corrupt(x[r], t))


@pytest.mark.parametrize("impl, graph", [("stencil", "ring"), ("stencil", "grid"),
                                         ("stencil", "fully_connected"),
                                         ("stencil", "directed_ring"), ("dense", "erdos_renyi"),
                                         ("gather", "erdos_renyi"),
                                         ("sparse", "directed_erdos_renyi")])
def test_mixing_forms_act_on_the_worker_axis(impl, graph):
    topo = build_topology(graph, 16, erdos_renyi_p=0.4, seed=2)
    op = make_mixing_op(topo, impl, device="cpu", dtype=torch.float64)
    x = torch.randn((3, 16, 4), dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    mixed, summed = op.apply(x), op.neighbor_sum(x)
    for r in range(3):
        assert torch.equal(mixed[r], op.apply(x[r]))
        assert torch.equal(summed[r], op.neighbor_sum(x[r]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rule, tau", [("trimmed_mean", 0.0), ("median", 0.0),
                                       ("clipped_gossip", 0.0), ("clipped_gossip", "swept")])
def test_robust_screens_take_a_leading_replica_axis(rule, tau, dtype):
    topo = build_topology("erdos_renyi", 10, erdos_renyi_p=0.6, seed=3)
    nbr, mask = neighbor_tables_for(topo)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((3, 10, 4), dtype=dtype, generator=gen)
    live = (torch.rand((3, *nbr.shape), generator=gen) > 0.2).float() * torch.as_tensor(
        mask, dtype=torch.float32)
    A = torch.as_tensor(topo.adjacency, dtype=torch.float32) * (
        torch.rand((3, 10, 10), generator=gen) > 0.1).float()
    A = torch.minimum(A, A.transpose(-1, -2))
    taus = [0.3, 0.6, 0.9]
    radius = torch.tensor(taus, dtype=torch.float64) if tau == "swept" else tau
    gathered = make_gather_robust_aggregator(rule, 1, nbr, radius, device="cpu")(live, x)
    dense = make_robust_aggregator(rule, 1, radius)(A, x)
    for r in range(3):
        one = taus[r] if tau == "swept" else tau
        assert torch.equal(gathered[r], make_gather_robust_aggregator(
            rule, 1, nbr, one, device="cpu")(live[r], x[r]))
        assert torch.equal(dense[r], make_robust_aggregator(rule, 1, one)(A[r], x[r]))


@pytest.mark.parametrize("family", ["logistic", "quadratic", "huber", "softmax"])
def test_losses_against_shared_shards(family):
    """[R, N, d] parameters against the shared [N, L, d] shards (one skinny
    product a worker) and against per-replica batches [R, N, b, d]."""
    gen = torch.Generator().manual_seed(8)
    R, N, L, d, K = 3, 4, 6, 5, 3
    X = torch.randn((N, L, d), dtype=torch.float64, generator=gen)
    y = (torch.randint(0, K, (N, L), generator=gen).double() if family == "softmax"
         else torch.randn((N, L), dtype=torch.float64, generator=gen))
    dm = d * K if family == "softmax" else d
    w = torch.randn((R, N, dm), dtype=torch.float64, generator=gen)
    wts = torch.rand((R, N, L), dtype=torch.float64, generator=gen)
    extra = (10.0,) if family == "huber" else ()
    grad = getattr(losses, f"{family}_gradient_weighted")
    obj = getattr(losses, f"{family}_objective_weighted")
    g, o = grad(w, X, y, wts, 0.1, *extra), obj(w, X, y, wts, 0.1, *extra)
    assert g.shape == (R, N, dm) and g.is_contiguous() and o.shape == (R, N)
    Xb = X[None].expand(R, -1, -1, -1)
    gb = grad(w, Xb, y.expand(R, -1, -1), wts, 0.1, *extra)
    for r in range(R):
        torch.testing.assert_close(g[r], grad(w[r], X, y, wts[r], 0.1, *extra),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(o[r], obj(w[r], X, y, wts[r], 0.1, *extra),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gb[r], g[r], rtol=1e-12, atol=1e-12)


def _timelines(seeds, **kw):
    topo = build_topology("ring", 8)
    ours = [faults.build_fault_timeline(topo, 30, s, device="cpu", **kw) for s in seeds]
    from distributed_optimization_tpu.parallel import build_topology as ref_build

    ref = [ref_faults.build_fault_timeline(ref_build("ring", 8), 30, s, **kw) for s in seeds]
    return ours, ref


def test_stack_fault_timelines_is_the_jax_package_s():
    ours, ref = _timelines([3, 4, 5], edge_drop_prob=0.2, burst_len=3.0, mttf=6.0, mttr=2.0)
    got, want = faults.stack_fault_timelines(ours), ref_faults.stack_fault_timelines(ref)
    for field in ("edge_up", "node_up", "rejoin", "part_up", "edge_index"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b), field
    assert got.edge_up.shape == (3, 30, 8) and got.horizon == want.horizon == 30


def test_stack_fault_timelines_refuses_with_the_jax_package_s_messages():
    ours, ref = _timelines([3], edge_drop_prob=0.2, burst_len=3.0)
    other, ref_other = _timelines([4], mttf=6.0, mttr=2.0)
    for args, ref_args in (([], []), (ours + other, ref + ref_other)):
        with pytest.raises(ValueError) as a:
            faults.stack_fault_timelines(args)
        with pytest.raises(ValueError) as b:
            ref_faults.stack_fault_timelines(ref_args)
        assert str(a.value) == str(b.value)
