"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: tests/conftest.py configures JAX). Ring kernels (at every
vector-width residue of d and N·d, on misaligned views and past 2³¹
elements, each of the three) and the robust count rules are held bitwise; robust clipping to 1e-12 (rtol and
atol) in float64 and, in float32, to 1e-5 of the largest |x| over each
row's closed neighbourhood; fc kernels to N·ε·max|x| of the plain version
and bitwise to the mirror of their own summation order (ops/fc_kernels.py),
under the plan the wrapper picks, under other strips and row groups and on
misaligned views. The sampling kernels (both forms, both dtypes) bitwise
equal the plain twin of ops/sampling.py, which tests/test_torch_sampling.py
holds bitwise to the JAX package's sampler; the gather form's rows equal
gather_batches of the twin's indices, and its selection on given tie-heavy
scores equals ops/sampling_kernels.select_mirror, which
tests/test_torch_sampling_select.py holds to the stable sort.
The instances of the robust kernels are shared with tests/test_torch_robust.py,
which holds the plain versions against the JAX package on the CPU, and with
tests/test_torch_robust_network.py, which holds the count-rule kernel's
sort network and selections against the plain version on the CPU.
The compression kernel (top_k, random_k, qsgd; both dtypes) equals the plain
twin of ops/compression.py bit for bit, mask bits and qsgd levels included,
which tests/test_torch_compression.py holds to the JAX package. The robust
kernels are also held on an Erdős–Rényi table of rows of 3 to 13 neighbours;
the gather and sparse mixing forms replay bitwise in a CUDA graph and equal
the CPU bit for bit; push-sum's [N, 1] mass goes through ring_mix. The draw
kernels (ops/draw_kernels.py: one round's A_t, W_t in both dtypes, active
mask, degree count and one-peer scores in every fault mode; the fault
timeline, also across its kernels' segment and tile edges and at main's
shape, with its two launches a call counted; the large-noise payload, also
at 8 × 4,194,816 and 4,096 × 1,024 and past N·d = 2³² against the row-wise
plain version) equal their plain versions on the card bit for bit at N =
16, 64, 256 and 1,024, directed and undirected (and the round on the grid
and the fully-connected N=25), which
tests/test_torch_fault_rounds.py, test_torch_round_weights.py,
test_torch_large_noise.py, test_torch_timeline_scan.py and
test_torch_noise_rows.py hold to the JAX package on the CPU. The sampler
past a block's shared memory (b = L = 16,384) and the compression kernel
past N·d = 2³² match their twins. Both fused robust kernels on a liveness that changes
every round equal the gather form bit for bit (count rules); a faulted run
in the graph equals its measured run bit for bit with exact launch counts.
The replica axis: one sampler (both forms), round or noise launch over R =
1, 3 and 32 replicas' keys (a drop threshold a replica, stacked timelines,
flags a replica) gives each replica the single launch's bits, and a
``run_batch`` graph run equals its measured run with one sampler, round and
noise launch a step whatever R is. The matrix-free fault form: the slot
round (both launches) at ring N=256, ER N=1,024 and ER N=100,000, R = 1, 3,
4 and 8, its live pass alone over a caller's table (slots reordered, a
masked hole) and the timeline's per-edge stream bitwise their plain
versions; a
faulted matrix-free run's graph bitwise its measured run with two slot-round
launches a step; and the dense round at N = 65,537 (counters past 2³²)
bitwise the rows-only plain version. The async event clock: the event
sampler (the gather kernel's event mode, one launch a block of events, a
grid block a draw) bitwise its plain version in both dtypes, a block as B
per-event launches, which tests/test_torch_events.py and
tests/test_torch_event_block.py hold to the JAX package and the per-event
draws; and the event graph run bitwise the same events run eagerly,
float64 within 1e-12 of the CPU's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_optimization_tpu_torch.ops import compression
from distributed_optimization_tpu_torch.ops import compression_kernels as ck
from distributed_optimization_tpu_torch.ops import draw_kernels as dk
from distributed_optimization_tpu_torch.ops import fc_kernels as fk
from distributed_optimization_tpu_torch.ops import prng, sampling
from distributed_optimization_tpu_torch.ops import ring_kernels as rk
from distributed_optimization_tpu_torch.ops import robust_kernels as bk
from distributed_optimization_tpu_torch.ops import sampling_kernels as sk
from distributed_optimization_tpu_torch.parallel.topology import neighbor_table

COUNT_RULES = ("trimmed_mean", "median")
# (rule, clip_tau): the count rules, adaptive and fixed-radius clipping.
SCREENS = [("trimmed_mean", 0.0), ("median", 0.0), ("clipped_gossip", 0.0),
           ("clipped_gossip", 0.7)]


def symmetric_instance(n, offsets, seed, d=6, dead=0.2, matching=False):
    """A circulant graph over ``offsets`` (plus, with ``matching``, the edges
    i ↔ i + n/2), its neighbour table, liveness with about ``dead`` of the
    edges down (symmetrically), the realized adjacency, and x with two rows
    scaled by 1e4."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    ids = np.arange(n)
    for o in offsets:
        A[ids, (ids + o) % n] = A[(ids + o) % n, ids] = 1.0
    if matching:
        A[ids, (ids + n // 2) % n] = 1.0
    np.fill_diagonal(A, 0.0)
    nbr, mask = neighbor_table(A)
    realized = A.copy()
    ei, ej = np.nonzero(np.triu(A, 1))
    drop = rng.random(len(ei)) < dead
    realized[ei[drop], ej[drop]] = realized[ej[drop], ei[drop]] = 0.0
    live = np.take_along_axis(realized, nbr.astype(np.int64), axis=1) * mask
    x = rng.standard_normal((n, d))
    x[[1, 5]] *= 1e4
    return nbr, live.astype(np.float32), realized, x


def random_table(n, k_max, seed, d=6, dead=0.25, specials=True):
    """A table of any k_max (rows need not be symmetric): neighbours drawn
    at random, about ``dead`` of the slots down and padded to point at the
    row itself, and x with repeated values, +0, -0, +inf and -inf in about a
    third of its entries (``specials``)."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, size=(n, k_max)).astype(np.int32)
    live = (rng.random((n, k_max)) >= dead).astype(np.float32)
    nbr[live == 0] = np.arange(n, dtype=np.int32)[:, None].repeat(k_max, 1)[live == 0]
    x = rng.standard_normal((n, d))
    if specials:
        pick = rng.random(x.shape)
        x[pick < 0.15] = rng.choice([-1.5, 0.25, 2.0], size=int((pick < 0.15).sum()))
        x[(pick >= 0.15) & (pick < 0.22)] = 0.0
        x[(pick >= 0.22) & (pick < 0.29)] = -0.0
        x[(pick >= 0.29) & (pick < 0.31)] = np.inf
        x[(pick >= 0.31) & (pick < 0.33)] = -np.inf
    return nbr, live, x


GRAPHS = {
    # k_max = 4 with dead slots.
    "k4": dict(n=14, offsets=(1, 3), seed=3),
    # k_max = 15 (7 circulant offsets and a matching): the widest network.
    "k15": dict(n=40, offsets=(1, 2, 3, 5, 7, 11, 13), seed=5, matching=True),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    return symmetric_instance(**GRAPHS[request.param])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


# d % 4 (float32's vector width) over 0..3 and d % 2 (float64's) over 0..1,
# N·d not a multiple of the width ((3, 1), (7, 6), (9, 7), (11, 5)), every
# element at the wrap (3, 1), the path shapes, the JAX package's widest d at
# N=256, and the million-worker ring.
RING_SHAPES = [(3, 1), (5, 4), (7, 6), (9, 7), (11, 5), (37, 12), (256, 41), (256, 81),
               (256, 1024), (1_000_000, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", RING_SHAPES)
def test_cuda_kernels_bitwise_equal_their_plain_versions(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    g = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    eta = torch.tensor([0.013], dtype=dtype, device=cuda_device)
    rk.reset_launch_counts()
    assert torch.equal(rk.fused_ring_dsgd_step(x, g, eta),
                       rk.fused_ring_dsgd_step_plain(x, g, eta))
    assert torch.equal(rk.ring_mix(x), rk.ring_mix_plain(x))
    assert torch.equal(rk.ring_neighbor_sum(x), rk.ring_neighbor_sum_plain(x))
    assert rk.LAUNCHES == {name: 1 for name in rk.KERNELS}


def _offset_view(shape, dtype, device, gen, offset):
    """A contiguous [N, d] view that starts ``offset`` elements into its
    storage, so that it is not 16-byte aligned for an odd offset."""
    n, d = shape
    buf = torch.randn(n * d + offset, generator=gen, device=device, dtype=dtype)
    return buf[offset:].view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("misaligned", ["x", "g"])
@pytest.mark.parametrize("shape", [(9, 7), (256, 81), (256, 1024)])
def test_cuda_ring_kernels_on_a_misaligned_view(cuda_device, shape, misaligned, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = _offset_view(shape, dtype, cuda_device, gen, 1 if misaligned == "x" else 0)
    g = _offset_view(shape, dtype, cuda_device, gen, 1 if misaligned == "g" else 0)
    assert (x.data_ptr() % 16 != 0) == (misaligned == "x")
    assert (g.data_ptr() % 16 != 0) == (misaligned == "g")
    eta = torch.tensor([0.013], dtype=dtype, device=cuda_device)
    rk.reset_launch_counts()
    assert torch.equal(rk.fused_ring_dsgd_step(x, g, eta),
                       rk.fused_ring_dsgd_step_plain(x, g, eta))
    assert torch.equal(rk.ring_mix(x), rk.ring_mix_plain(x))
    assert rk.LAUNCHES["fused_ring_dsgd_step"] == rk.LAUNCHES["ring_mix"] == 1


@pytest.mark.cuda
def test_cuda_ring_mix_past_2_to_the_31_elements(cuda_device):
    # N·d = 2^31 + 2048 float32 elements (8.6 GB each for x and out): the
    # 64-bit instance. Held on the rows at the wrap and beside element 2^31,
    # each against the plain version on that row and its two neighbours.
    d = 1024
    n = (1 << 31) // d + 2
    edge = (1 << 31) // d  # the row that starts at element 2^31
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((n, d), generator=gen, device=cuda_device, dtype=torch.float32)
    rk.reset_launch_counts()
    out = rk.ring_mix(x)
    assert rk.LAUNCHES["ring_mix"] == 1
    for i in (0, 1, edge - 1, edge, n - 1):
        rows = x[[(i - 1) % n, i, (i + 1) % n]]
        assert torch.equal(out[i], rk.ring_mix_plain(rows)[1]), f"row {i}"
    del x, out
    torch.cuda.empty_cache()


# ring_neighbor_sum at each instance of the stencil: N=3 (every row at the
# wrap), d % 4 == 0 ((3, 8), (5, 4), (4096, 1024)), d % 4 == 2 ((7, 6)), d
# odd, the admm path's (256, 81), the robust cell's width and the
# million-worker ring; each on an aligned tensor and on a view at storage
# offset 1, which takes the one-element instance.
NEIGHBOR_SUM_SHAPES = [(3, 1), (3, 8), (5, 4), (7, 6), (9, 7), (256, 41), (256, 81),
                       (4096, 1024), (1_000_000, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", NEIGHBOR_SUM_SHAPES)
def test_cuda_ring_neighbor_sum_bitwise_at_every_instance(cuda_device, shape, offset, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = _offset_view(shape, dtype, cuda_device, gen, offset)
    assert (x.data_ptr() % 16 != 0) == (offset == 1)
    rk.reset_launch_counts()
    assert torch.equal(rk.ring_neighbor_sum(x), rk.ring_neighbor_sum_plain(x))
    assert rk.LAUNCHES["ring_neighbor_sum"] == 1


@pytest.mark.cuda
def test_cuda_ring_neighbor_sum_past_2_to_the_31_elements(cuda_device):
    # As for ring_mix: N·d = 2^31 + 2048 float32 elements, the 64-bit
    # instance, held on the rows at the wrap and beside element 2^31.
    d = 1024
    n = (1 << 31) // d + 2
    edge = (1 << 31) // d
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((n, d), generator=gen, device=cuda_device, dtype=torch.float32)
    rk.reset_launch_counts()
    out = rk.ring_neighbor_sum(x)
    assert rk.LAUNCHES["ring_neighbor_sum"] == 1
    for i in (0, 1, edge - 1, edge, n - 1):
        rows = x[[(i - 1) % n, i, (i + 1) % n]]
        assert torch.equal(out[i], rk.ring_neighbor_sum_plain(rows)[1]), f"row {i}"
    del x, out
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_a_host_eta(cuda_device):
    x = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(TypeError, match="eta must be a torch.Tensor"):
        rk.fused_ring_dsgd_step(x, x, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 3), (25, 81), (256, 41), (256, 81), (4096, 1024),
                                   (16384, 1024), (37, 1023), (4096, 1021)])
def test_cuda_fc_kernels_match_their_plain_versions(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    fk.reset_launch_counts()
    tol = shape[0] * torch.finfo(dtype).eps * float(x.abs().max())
    torch.testing.assert_close(fk.fc_mix(x), fk.fc_mix_plain(x), rtol=0, atol=tol)
    torch.testing.assert_close(fk.fc_neighbor_sum(x), fk.fc_neighbor_sum_plain(x), rtol=0, atol=tol)
    assert fk.LAUNCHES == {name: 1 for name in fk.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 3), (25, 81), (256, 41), (37, 1023), (4096, 1024),
                                   (4096, 1021), (16384, 1024)])
@pytest.mark.parametrize("name", fk.KERNELS)
def test_cuda_fc_kernels_equal_their_mirror_bitwise(cuda_device, name, shape, dtype):
    """At the plan the wrapper picks on this card: the mirror's order bit for
    bit, the same bits from two launches, and every row of fc_mix equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    kernel = getattr(fk, name)
    fk.reset_launch_counts()
    got, again = kernel(x), kernel(x)
    assert fk.LAUNCHES[name] == 2
    assert torch.equal(got, fk.MIRRORS[name](x, fk.plan_for(name, x)))
    assert torch.equal(got, again)
    if name == "fc_mix":
        assert torch.equal(got, got[:1].expand_as(got))


def _fc_plan(name, x, lanes, groups):
    """The wrapper's plan for x with another strip and row-group count."""
    n, d = x.shape
    p = fk.plan_for(name, x)
    registers = name == "fc_neighbor_sum" and -(-n // groups) <= fk.ROWS_PER_THREAD
    return fk.Plan(p.vec, lanes, groups, -(-d // (lanes * p.vec)),
                   "registers" if registers else "none")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes, groups", [(1, 1), (2, 16), (8, 4), (32, 8), (128, 8),
                                           (2, 512)])
@pytest.mark.parametrize("name", fk.KERNELS)
def test_cuda_fc_kernels_under_other_strips_and_blocks(cuda_device, name, lanes, groups, dtype):
    """Each strip and row-group count is a configuration of the same order:
    bitwise its mirror, row groups ragged (N = 61 is a multiple of none)."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((61, 1024), generator=gen, device=cuda_device, dtype=dtype)
    p = _fc_plan(name, x, lanes, groups)
    assert torch.equal(fk._launch(fk.library(), name, x, p), fk.MIRRORS[name](x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile", fk.TILES)
def test_cuda_fc_neighbor_sum_keeps_its_rows_anywhere(cuda_device, tile, dtype):
    """The rows kept in registers (one batch a thread) or nowhere (x read
    again) give the same bits: the mirror's."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((300, 64), generator=gen, device=cuda_device, dtype=dtype)
    p = dataclasses.replace(fk.plan_for("fc_neighbor_sum", x), tile=tile)
    assert torch.equal(fk._launch(fk.library(), "fc_neighbor_sum", x, p),
                       fk.fc_neighbor_sum_mirror(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(25, 81), (256, 1024), (4096, 1024)])
@pytest.mark.parametrize("name", fk.KERNELS)
def test_cuda_fc_kernels_on_a_misaligned_view(cuda_device, name, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = _offset_view(shape, dtype, cuda_device, gen, 1)
    assert x.data_ptr() % 16 != 0
    p = fk.plan_for(name, x)
    assert p.vec == 1
    fk.reset_launch_counts()
    assert torch.equal(getattr(fk, name)(x), fk.MIRRORS[name](x, p))
    assert fk.LAUNCHES[name] == 1


@pytest.mark.cuda
def test_cuda_fc_plan_the_kernel_cannot_run_raises(cuda_device):
    x = _offset_view((64, 1024), torch.float32, cuda_device, torch.Generator(device=cuda_device), 1)
    vectored = fk.plan("fc_mix", 64, 1024, 4, aligned=True)
    with pytest.raises(RuntimeError, match="fc_mix kernel launch failed"):
        fk._launch(fk.library(), "fc_mix", x, vectored)
    # More threads a block than the kernel takes, and rows kept in
    # registers beyond a thread's one batch.
    y = torch.zeros((65536, 32), device=cuda_device)
    unplaceable = fk.Plan(vec=4, lanes=8, groups=256, strips=1, tile="none")
    with pytest.raises(RuntimeError, match="fc_mix kernel launch failed"):
        fk._launch(fk.library(), "fc_mix", y, unplaceable)
    unplaceable = fk.Plan(vec=4, lanes=8, groups=32, strips=1, tile="registers")
    with pytest.raises(RuntimeError, match="fc_neighbor_sum kernel launch failed"):
        fk._launch(fk.library(), "fc_neighbor_sum", y, unplaceable)


def _nan_equal(a, b):
    return bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def _assert_clip_close(got, want, x, nbr64, live):
    """float64: 1e-12 in rtol and atol; float32: 1e-5 of the largest |x| in
    each row's closed neighbourhood."""
    if x.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        return
    row_max = x.abs().amax(1)
    nbhd_max = torch.maximum(row_max, torch.where(live > 0, row_max[nbr64], 0.0).amax(1))
    assert bool(torch.all((got - want).abs() <= 1e-5 * nbhd_max[:, None]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rule,ct", SCREENS)
def test_cuda_kernels_match_their_plain_version(cuda_device, graph, rule, ct, dtype):
    nbr, live, _, x = graph
    tl = torch.from_numpy(live).to(cuda_device)
    tx = torch.from_numpy(x).to(cuda_device, dtype)
    g = torch.randn(tx.shape, device=cuda_device, dtype=dtype)
    eta = torch.tensor([0.013], dtype=dtype, device=cuda_device)
    nbr64 = torch.from_numpy(nbr).long().to(cuda_device)
    tau = torch.tensor([ct], dtype=dtype, device=cuda_device)
    adaptive = rule == "clipped_gossip" and ct == 0.0
    bk.reset_launch_counts()
    got = bk.make_fused_robust_aggregator(rule, 1, nbr, ct, device=cuda_device)(tl, tx)
    got_step = bk.make_fused_robust_dsgd_step(rule, 1, nbr, ct, device=cuda_device)(tl, tx, g, eta)
    want = bk.fused_robust_plain(rule, 1, nbr64, tl, tx, tau, adaptive=adaptive)
    want_step = bk.fused_robust_plain(rule, 1, nbr64, tl, tx, tau, adaptive=adaptive, g=g, eta=eta)
    assert bk.LAUNCHES == {name: 1 for name in bk.KERNELS}
    if rule in COUNT_RULES:
        assert _nan_equal(got, want) and _nan_equal(got_step, want_step)
    else:
        _assert_clip_close(got, want, tx, nbr64, tl)
        _assert_clip_close(got_step, want_step, tx, nbr64, tl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_fixed_radius_clipping_at_the_widest_table(cuda_device, dtype):
    # k_max = 1116 on the fully-connected graph: the most slots the clipping
    # kernel's shared memory takes.
    n = 1117
    nbr, _ = neighbor_table(np.ones((n, n)) - np.eye(n))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((n, 8), generator=gen, device=cuda_device, dtype=dtype)
    tl = torch.ones(nbr.shape, device=cuda_device)
    nbr64 = torch.from_numpy(nbr).long().to(cuda_device)
    tau = torch.tensor([0.7], dtype=dtype, device=cuda_device)
    bk.reset_launch_counts()
    got = bk.make_fused_robust_aggregator("clipped_gossip", 1, nbr, 0.7, device=cuda_device)(tl, x)
    assert bk.LAUNCHES["make_fused_robust_aggregator"] == 1
    want = bk.fused_robust_plain("clipped_gossip", 1, nbr64, tl, x, tau, adaptive=False)
    _assert_clip_close(got, want, x, nbr64, tl)


def _count_rule_pair(cuda_device, rule, budget, nbr, live, x, dtype):
    """(kernel, plain) outputs of the aggregator and the step on the card."""
    tl = torch.from_numpy(live).to(cuda_device)
    tx = torch.from_numpy(x).to(cuda_device, dtype)
    g = torch.randn(tx.shape, device=cuda_device, dtype=dtype)
    eta = torch.tensor([0.013], dtype=dtype, device=cuda_device)
    nbr64 = torch.from_numpy(nbr).long().to(cuda_device)
    tau = torch.zeros(1, dtype=dtype, device=cuda_device)
    agg = bk.make_fused_robust_aggregator(rule, budget, nbr, device=cuda_device)(tl, tx)
    step = bk.make_fused_robust_dsgd_step(rule, budget, nbr, device=cuda_device)(tl, tx, g, eta)
    return ((agg, bk.fused_robust_plain(rule, budget, nbr64, tl, tx, tau, adaptive=False)),
            (step, bk.fused_robust_plain(rule, budget, nbr64, tl, tx, tau, adaptive=False,
                                         g=g, eta=eta)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 41, 128, 129])
@pytest.mark.parametrize("k_max", range(1, 16))
def test_cuda_count_rules_bitwise_at_every_width(cuda_device, k_max, d):
    """Every sort width W = k_max + 1 the kernel is built for, every strip
    layout (d below a warp, one strip, two strips), budgets from 1 to k_max
    (kept < 1 keeps x[i]), on values with ties, ±0 and ±inf."""
    nbr, live, x = random_table(53, k_max, seed=100 + k_max, d=d)
    for rule in COUNT_RULES:
        for budget in sorted({1, max(1, k_max // 2), k_max}):
            for dtype in (torch.float32, torch.float64):
                bk.reset_launch_counts()
                for got, want in _count_rule_pair(cuda_device, rule, budget, nbr, live, x, dtype):
                    assert _nan_equal(got, want), (rule, budget, dtype)
                assert bk.LAUNCHES == {name: 1 for name in bk.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("k_max", [2, 8, 15])
def test_cuda_count_rules_bitwise_on_columns_with_nan(cuda_device, k_max):
    """Columns that hold a NaN take the transposition network inside the
    kernel; the others beside them take the merge network."""
    nbr, live, x = random_table(64, k_max, seed=7 * k_max, d=45)
    rng = np.random.default_rng(k_max)
    x[rng.random(x.shape) < 0.03] = np.nan
    assert np.isnan(x).any()
    for rule in COUNT_RULES:
        for dtype in (torch.float32, torch.float64):
            for got, want in _count_rule_pair(cuda_device, rule, 1, nbr, live, x, dtype):
                assert _nan_equal(got, want), (rule, dtype)
                assert bool(torch.isnan(want).any())


def _clip_pair(cuda_device, ct, nbr, live, x, dtype):
    tl = torch.from_numpy(live).to(cuda_device)
    tx = torch.from_numpy(x).to(cuda_device, dtype)
    g = torch.randn(tx.shape, device=cuda_device, dtype=dtype)
    eta = torch.tensor([0.013], dtype=dtype, device=cuda_device)
    nbr64 = torch.from_numpy(nbr).long().to(cuda_device)
    tau = torch.tensor([ct], dtype=dtype, device=cuda_device)
    adaptive = ct == 0.0
    agg = bk.make_fused_robust_aggregator("clipped_gossip", 1, nbr, ct, device=cuda_device)
    step = bk.make_fused_robust_dsgd_step("clipped_gossip", 1, nbr, ct, device=cuda_device)
    want = bk.fused_robust_plain("clipped_gossip", 1, nbr64, tl, tx, tau, adaptive=adaptive)
    want_step = bk.fused_robust_plain("clipped_gossip", 1, nbr64, tl, tx, tau, adaptive=adaptive,
                                      g=g, eta=eta)
    return tx, nbr64, tl, ((agg(tl, tx), want), (step(tl, tx, g, eta), want_step))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k_max,ct", [*((k, 0.0) for k in range(1, 17)),
                                      *((k, 0.7) for k in (1, 15, 31, 32, 33, 64))])
def test_cuda_clipping_at_every_width(cuda_device, k_max, ct, dtype):
    """Adaptive clipping at every k_max it takes (a warp a row), fixed-radius
    clipping on both sides of a warp's 32 slots (a warp a row, then a block
    a row)."""
    nbr, live, x = random_table(70, k_max, seed=k_max, d=41, specials=False)
    tx, nbr64, tl, pairs = _clip_pair(cuda_device, ct, nbr, live, x, dtype)
    for got, want in pairs:
        _assert_clip_close(got, want, tx, nbr64, tl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_adaptive_clipping_ranks_a_nan_norm_as_the_plain_version(cuda_device, dtype):
    """A NaN in a neighbour's row makes that slot's norm NaN: the kernel
    then ranks the warp's norms by the transposition network, as the plain
    version does. Finite entries agree within the tolerance, NaN with NaN."""
    nbr, live, x = random_table(40, 6, seed=3, d=41, specials=False)
    x[[4, 17], [0, 9]] = np.nan
    tx, nbr64, tl, pairs = _clip_pair(cuda_device, 0.0, nbr, live, x, dtype)
    for got, want in pairs:
        nan = torch.isnan(want)
        assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
        _assert_clip_close(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want),
                           torch.where(torch.isnan(tx), 0.0, tx), nbr64, tl)


# --- runs: the CUDA graph loop against the measured chunk loop -----------------

# (name, config fields): each path that launches a kernel every iteration,
# and the stencil ring, which launches none.
GRAPH_RUNS = {
    "dsgd-ring-pallas": dict(mixing_impl="pallas"),
    "dsgd-ring-stencil": dict(mixing_impl="stencil"),
    "dsgd-fc-pallas": dict(topology="fully_connected", mixing_impl="pallas"),
    "admm-ring-pallas": dict(algorithm="admm", mixing_impl="pallas"),
    "robust-trimmed-mean-fused": dict(partition="shuffled", attack="sign_flip", n_byzantine=2,
                                      attack_scale=2.0, aggregation="trimmed_mean", robust_b=1,
                                      robust_impl="fused", mixing_impl="pallas"),
    "gt-ring-pallas": dict(algorithm="gradient_tracking", mixing_impl="pallas"),
    "extra-ring-pallas": dict(algorithm="extra", mixing_impl="pallas"),
    "choco-randk-ring-pallas": dict(algorithm="choco", compression="random_k", compression_k=5,
                                    mixing_impl="pallas"),
    "gt-qsgd-fc-pallas": dict(algorithm="gradient_tracking", compression="qsgd",
                              compression_k=4, topology="fully_connected", mixing_impl="pallas"),
}


@pytest.fixture(scope="module")
def graph_data():
    from distributed_optimization_tpu_torch.config import ExperimentConfig
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    out = {}
    for partition in ("sorted", "shuffled"):
        cfg = ExperimentConfig(problem_type="logistic", n_workers=16, n_samples=1600,
                               n_features=20, n_informative_features=12, partition=partition)
        ds = generate_synthetic_dataset(cfg)
        out[partition] = (cfg, ds, compute_reference_optimum(ds, cfg.reg_param)[1])
    return out


def _launch_counts():
    return {name: n for mod in (rk, fk, bk, sk, ck, dk) for name, n in mod.LAUNCHES.items()}


def _counted_run(cfg, ds, f_opt, **kw):
    from distributed_optimization_tpu_torch.backends import torch_backend

    before = _launch_counts()
    res = torch_backend.run(cfg, ds, f_opt, device="cuda", **kw)
    after = _launch_counts()
    return res, {name: after[name] - before[name] for name in after}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ring_mix", "fc_mix", "make_fused_robust_dsgd_step"])
def test_cuda_launch_counts_rise_where_the_kernel_runs(cuda_device, name):
    """The kernel counts on the card: a capture, which runs nothing, adds
    nothing, and each replay of the graph adds each launch it holds."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((64, 33), generator=gen, device=cuda_device)
    if name == "make_fused_robust_dsgd_step":
        nbr, _ = neighbor_table(np.roll(np.eye(64), 1, 1) + np.roll(np.eye(64), -1, 1))
        step = bk.make_fused_robust_dsgd_step("trimmed_mean", 1, nbr, device=cuda_device)
        live = torch.ones(nbr.shape, device=cuda_device)
        g, eta = torch.randn_like(x), torch.tensor([0.1], device=cuda_device)
        call, mod = (lambda: step(live, x, g, eta)), bk
    else:
        mod = rk if name == "ring_mix" else fk
        call = lambda: getattr(mod, name)(x)  # noqa: E731
    call()  # built and loaded
    mod.reset_launch_counts()
    call()
    assert mod.LAUNCHES[name] == 1
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        for _ in range(3):
            out = call()
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    assert mod.LAUNCHES[name] == 1
    for _ in range(5):
        graph.replay()
    assert mod.LAUNCHES[name] == 1 + 3 * 5
    assert torch.equal(out, call())
    assert sum(mod.LAUNCHES.values()) == mod.LAUNCHES[name] == 2 + 3 * 5
    graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("T, eval_every", [(300, 1), (1001, 7)])
@pytest.mark.parametrize("name", sorted(GRAPH_RUNS))
def test_cuda_graph_run_is_bitwise_its_measured_run(cuda_device, graph_data, name, T,
                                                    eval_every):
    """Gap and consensus histories and final models bitwise equal, and the
    same launches counted. T=300 at eval_every=1 takes 299 replays of a
    one-iteration graph; T=1,001 at eval_every=7, 142 replays of a
    seven-iteration graph."""
    kw = GRAPH_RUNS[name]
    base, ds, f_opt = graph_data[kw.get("partition", "sorted")]
    cfg = base.replace(n_iterations=T, eval_every=eval_every, **kw)
    graph, graph_launches = _counted_run(cfg, ds, f_opt)
    eager, eager_launches = _counted_run(cfg, ds, f_opt, measure_timestamps=True)
    np.testing.assert_array_equal(graph.history.objective, eager.history.objective)
    np.testing.assert_array_equal(graph.history.consensus_error, eager.history.consensus_error)
    np.testing.assert_array_equal(graph.final_models, eager.final_models)
    assert graph_launches == eager_launches
    # The kernels each path launches every iteration, and how often (the
    # Byzantine rows of the robust run keep the benign ring_mix; GT mixes
    # twice); ADMM once more at init. Every run draws a gather batch
    # (L = 100 > 64) once an iteration.
    per_iteration = {"dsgd-ring-pallas": {"fused_ring_dsgd_step": 1},
                     "dsgd-fc-pallas": {"fc_mix": 1}, "admm-ring-pallas": {"ring_neighbor_sum": 1},
                     "robust-trimmed-mean-fused": {"make_fused_robust_dsgd_step": 1, "ring_mix": 1},
                     "gt-ring-pallas": {"ring_mix": 2}, "extra-ring-pallas": {"ring_mix": 1},
                     "choco-randk-ring-pallas": {"compress_exchange": 1, "ring_mix": 1},
                     "gt-qsgd-fc-pallas": {"compress_exchange": 2, "fc_mix": 2}}
    want = {k: 0 for k in graph_launches}
    for kernel, times in per_iteration.get(name, {}).items():
        want[kernel] = times * T + name.startswith("admm")
    want["sample_worker_batches"] = T
    assert graph_launches == want
    assert np.all(np.isfinite(graph.history.objective))
    assert not graph.history.time_measured and eager.history.time_measured


@pytest.mark.cuda
def test_cuda_graph_run_releases_its_memory(cuda_device, graph_data):
    cfg, ds, f_opt = graph_data["sorted"]
    cfg = cfg.replace(n_iterations=200, mixing_impl="pallas")
    _counted_run(cfg, ds, f_opt)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    for _ in range(3):
        _counted_run(cfg, ds, f_opt)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated


@pytest.mark.cuda
def test_cuda_capture_failure_raises_and_does_not_fall_back(cuda_device, graph_data,
                                                             monkeypatch):
    """A kernel launch inside the capture is refused (an fc plan of more
    threads than a block takes): the run raises, with no eager loop after."""
    cfg, ds, f_opt = graph_data["sorted"]
    cfg = cfg.replace(topology="fully_connected", mixing_impl="pallas", n_iterations=200)
    real = fk.plan_for

    def plan_for(name, x, out=None):
        if torch.cuda.is_current_stream_capturing():
            return dataclasses.replace(real(name, x, out), lanes=64, groups=64)
        return real(name, x, out)

    monkeypatch.setattr(fk, "plan_for", plan_for)
    fk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        _counted_run(cfg, ds, f_opt)
    # The warm-up launched once; the capture stopped at its first launch.
    assert fk.LAUNCHES["fc_mix"] <= 2
    monkeypatch.setattr(fk, "plan_for", real)
    res, launches = _counted_run(cfg, ds, f_opt)  # the card is usable after
    assert launches["fc_mix"] == 200 and np.all(np.isfinite(res.history.objective))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_RUNS))
def test_cuda_capture_reaches_no_synchronize(cuda_device, graph_data, name, monkeypatch):
    real = torch.cuda.synchronize
    reached = []

    def synchronize(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            reached.append(name)
            raise RuntimeError("torch.cuda.synchronize() during capture")
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    kw = GRAPH_RUNS[name]
    base, ds, f_opt = graph_data[kw.get("partition", "sorted")]
    res, _ = _counted_run(base.replace(n_iterations=150, **kw), ds, f_opt)
    assert not reached and np.all(np.isfinite(res.history.objective))


# The sampling kernels' inputs (N, L, b): the main path (dense), the parity
# path (gather), the robust cell, a shard shorter than the batch (indices
# tiled), one row, the dense kernel's edges (32, 33, 64 rows; 65 takes the
# selection kernel), one block of 1,024 threads a row each and 8 rows a
# thread from 1,025, and the float64 key of 128 bits (2,049). Clusters take
# shards past 8,192 rows, and recompute their keys past 65,536
# (test_cuda_sampling_past_the_old_shared_memory_limit).
SAMPLING_SHAPES = [(256, 49, 16), (25, 500, 16), (256, 50, 16), (9, 7, 16), (5, 1, 4),
                   (6, 32, 16), (6, 33, 16), (6, 64, 16), (6, 65, 16), (6, 1024, 16),
                   (6, 1025, 16), (6, 1100, 16), (4, 2049, 16), (4, 7000, 16)]
SAMPLING_D = 5


def _sampling_n_valid(cuda_device, n, L, b):
    """Full shards but three: empty, 3 rows (or L) and min(b − 1, L)."""
    nv = torch.full((n,), L, dtype=torch.int64, device=cuda_device)
    nv[1], nv[2], nv[3 % n] = 0, min(3, L), min(b - 1, L)
    return nv


def _rows(cuda_device, n, L, dtype, seed=0):
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    return (torch.randn((n, L, SAMPLING_D), generator=gen, device=cuda_device, dtype=dtype),
            torch.randn((n, L), generator=gen, device=cuda_device, dtype=dtype))


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SAMPLING_SHAPES)
def test_cuda_sampling_kernels_bitwise_equal_the_twin(cuda_device, shape, dtype):
    n, L, b = shape
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    seeds = (0, 42, 2**31 - 1) + ((2**40 + 5,) if dtype == torch.float64 else ())
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    for seed in seeds:
        run_key = prng.key(seed, x64=dtype == torch.float64)
        for slot in (0, 1, 2):
            key = prng.fold_in(run_key, slot)
            for counter in (0, 2**31 - 1, 2**32 - 1):
                t.fill_(counter)
                assert torch.equal(sk.sample_worker_batch_weights(key, t, nv, L, b, dtype),
                                   sampling.sample_worker_batch_weights(key, t, nv, L, b, dtype))
                got = sk.sample_batch_indices(key, t, nv, L, b, dtype)
                want = sampling.sample_batch_indices(key, t, nv, L, b, dtype)
                assert _same(got, want), (seed, slot, counter)
                assert _same(sk.sample_worker_batches(key, t, X, y, nv, b),
                             (*sampling.gather_batches(X, y, want[0]), want[1])), (seed, slot)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [40_000, 65_536, 65_537, 100_000])
def test_cuda_sampling_past_the_old_shared_memory_limit(cuda_device, L, dtype):
    """Shards past the 227 KB of scores the first design kept in shared
    memory (29,056 rows in float64, 58,112 in float32), up to the most a
    cluster holds in registers (65,536 rows) and past it, where each thread
    recomputes its rows' keys at every pass: indices and rows against the
    twin; the dense weights against the twin's gather draw scattered (the
    dense twin holds L² pairs)."""
    n, b = 3, 40
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    t = torch.full((1,), 2**31 - 1, dtype=torch.int64, device=cuda_device)
    key = prng.fold_in(prng.key(42, x64=dtype == torch.float64), 1)
    idx, w = sampling.sample_batch_indices(key, t, nv, L, b, dtype)
    assert _same(sk.sample_batch_indices(key, t, nv, L, b, dtype), (idx, w))
    assert _same(sk.sample_worker_batches(key, t, X, y, nv, b),
                 (*sampling.gather_batches(X, y, idx), w))
    dense = torch.zeros((n, L), dtype=dtype, device=cuda_device).scatter_add_(1, idx, w)
    assert torch.equal(sk.sample_worker_batch_weights(key, t, nv, L, b, dtype), dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,L,b,in_workspace", [
    (torch.float32, 16_384, 16_384, True), (torch.float64, 4_096, 12_288, False),
    (torch.float64, 12_288, 12_288, True)])
def test_cuda_sampling_batches_past_shared_memory(cuda_device, dtype, L, b, in_workspace):
    """Batches whose min(b, L) + 128 survivors do not fit in a block's 227 KB
    (b = L = 16,384 with 64-bit keys, 12,288 with 128-bit ones) select in the
    global-memory workspace that each wrapper allocates, bitwise the twin,
    called alone and replayed from a captured graph; b = 12,288 at L = 4,096
    tiles 4,096 survivors that fit."""
    n = 4
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    t = torch.full((1,), 2**31 - 1, dtype=torch.int64, device=cuda_device)
    key = prng.fold_in(prng.key(42, x64=dtype == torch.float64), 1)
    assert (sk.workspace_for(n, L, b, dtype, cuda_device) is not None) == in_workspace
    idx, w = sampling.sample_batch_indices(key, t, nv, L, b, dtype)
    want = (*sampling.gather_batches(X, y, idx), w)
    assert _same(sk.sample_batch_indices(key, t, nv, L, b, dtype), (idx, w))
    assert _same(sk.sample_worker_batches(key, t, X, y, nv, b), want)
    dense = torch.zeros((n, L), dtype=dtype, device=cuda_device).scatter_add_(1, idx, w)
    assert torch.equal(sk.sample_worker_batch_weights(key, t, nv, L, b, dtype), dense)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = sk.sample_worker_batches(key, t, X, y, nv, b)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    graph.replay()
    assert _same(out, want)
    graph.reset()


# Tie-heavy integer scores for the selection: (N, L, b, highest score); 0 is
# every score at the highest 0 (padding everywhere), 2^23 the full float32 range.
SELECT_CASES = [(4, 32, 16, 1), (4, 33, 16, 0), (4, 64, 16, 2), (4, 65, 16, 1), (4, 500, 16, 3),
                (4, 500, 16, 0), (3, 1024, 16, 1), (3, 1025, 16, 2), (3, 2049, 16, 1),
                (3, 7000, 16, 0), (3, 7000, 40, 7), (2, 20_000, 16, 1), (5, 500, 16, 1 << 23)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_cuda_selection_equals_the_mirror_on_ties(cuda_device, case, dtype):
    """The gather kernel's selection (``sk._select``, given scores in place of
    the draw) bitwise ``select_mirror``, whose radix passes run into the row
    bits on these ties, under the launcher's plan and forced clusters."""
    n, L, b, hi = case
    gen = torch.Generator().manual_seed(L + hi % 1009)
    scores = torch.randint(0, hi + 1, (n, L), generator=gen, dtype=torch.int64)
    want, _ = sk.select_mirror(scores, b, dtype)
    for cluster in (0, 2, 8):  # the launcher's plan, and clusters of 2 and 8 blocks
        if L <= max(cluster, 1) * 8 * 1024:
            got = sk._select(scores.to(cuda_device), b, dtype, cluster=cluster)
            assert torch.equal(got.cpu(), want), cluster


@pytest.mark.cuda
def test_cuda_sampling_kernel_reads_t_from_the_device(cuda_device):
    """A captured launch replays with the counter's current value."""
    nv = _sampling_n_valid(cuda_device, 256, 49, 16)
    key = prng.fold_in(prng.key(203, x64=False), 0)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    sk.sample_worker_batch_weights(key, t, nv, 49, 16, torch.float32)
    sk.reset_launch_counts()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = sk.sample_worker_batch_weights(key, t, nv, 49, 16, torch.float32)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    for counter in (5, 6, 2**31):
        t.fill_(counter)
        graph.replay()
        assert torch.equal(out, sampling.sample_worker_batch_weights(key, counter, nv, 49, 16,
                                                                     torch.float32))
    assert sk.LAUNCHES["sample_worker_batch_weights"] == 3
    graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gathered_batches_replay_with_t_from_the_device(cuda_device, dtype):
    """The gather form's Xb, yb and weights under graph replay, with t
    advanced on the device between replays, bitwise the twin's at each t;
    each replay counts one launch of the gather form."""
    n, L, b = 25, 500, 16
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    sk.sample_worker_batches(key, t, X, y, nv, b)
    sk.reset_launch_counts()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = sk.sample_worker_batches(key, t, X, y, nv, b)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    for step in range(3):
        t.add_(2**31 - 1 if step == 2 else 1)
        graph.replay()
        counter = int(t.item())
        assert _same(out, sampling.sample_worker_batches(key, counter, X, y, nv, b)), counter
    assert sk.LAUNCHES["sample_worker_batches"] == 3
    assert sk.LAUNCHES["sample_worker_batch_weights"] == 0
    graph.reset()


@pytest.mark.cuda
def test_cuda_sampling_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    nv = torch.full((4,), 10, dtype=torch.int64, device=cuda_device)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    key = prng.fold_in(prng.key(1, x64=False), 0)
    with pytest.raises(TypeError, match="t must be"):
        sk.sample_worker_batch_weights(key, 3, nv, 10, 4, torch.float32)
    with pytest.raises(ValueError, match="must be positive"):
        sk.sample_batch_indices(key, t, nv, 100_000, 0, torch.float32)
    with pytest.raises(ValueError, match="int64"):
        sk.sample_worker_batch_weights(key, t, nv.int(), 10, 4, torch.float32)


# The compression kernel's inputs (N, d): the main path, the study's N=25, a
# row narrower than a warp, the widest row of the warp path (128) and the
# narrowest of the block path (129), a block of a thread a column (1,024)
# and of 4 columns a thread (1,025, 4,096), and rows past 4,096, whose keys
# each radix pass recomputes.
COMPRESSION_SHAPES = [(256, 81), (25, 81), (9, 7), (6, 128), (6, 129), (5, 1025), (5, 4096),
                      (4096, 1024), (5, 5_000), (5, 100_003)]
COMPRESSION_OPERATORS = [("top_k", 1), ("top_k", 9), ("top_k", None), ("random_k", 9),
                         ("random_k", 27), ("qsgd", 1), ("qsgd", 4), ("qsgd", 16)]


def compression_inputs(n, d, dtype, device):
    """v and memory with a zero-difference row, ties across the k boundary,
    −0.0 differences, equal magnitudes of both signs and a zero memory row."""
    gen = torch.Generator(device=device).manual_seed(n * 7_919 + d)
    v = torch.randn((n, d), generator=gen, device=device, dtype=dtype)
    memory = 0.5 * torch.randn((n, d), generator=gen, device=device, dtype=dtype)
    v[1] = memory[1]
    v[2, : min(d, 40)] = memory[2, : min(d, 40)] + 0.75
    v[3, ::2], memory[3, ::2] = -0.0, 0.0
    v[4] = memory[4] + torch.where(torch.rand(d, generator=gen, device=device) < 0.5, -1.5, 1.5)
    memory[min(5, n - 1)] = 0.0
    return v, memory


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", COMPRESSION_SHAPES)
@pytest.mark.parametrize("name,k", COMPRESSION_OPERATORS)
def test_cuda_compression_kernel_is_bitwise_its_twin(cuda_device, name, k, shape, dtype):
    """memory⁺ bit for bit, and the mask bits or qsgd levels equal, at seeds
    past 2³¹ (and, in float64, 2³²), t past 2³¹ and 2³², rounds 0 and 1."""
    n, d = shape
    comp = compression.make_compressor(name, d, d if k is None else min(k, d))
    v, memory = compression_inputs(n, d, dtype, cuda_device)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    seeds = (203, 2**31 - 1) + ((2**40 + 5,) if dtype == torch.float64 else ())
    for seed in seeds:
        for counter, rnd in ((0, 0), (2**31 - 1, 1), (2**32 + 5, 0)):
            t.fill_(counter)
            draw = compression.Draw(compression.tag_key(seed, x64=dtype == torch.float64), t, rnd)
            got = ck.ef_compress(comp, draw, v, memory)
            out, levels = ck.ef_levels(comp, draw, v, memory)
            want = compression.ef_compress_plain(comp, draw, v, memory)
            assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(out), _bits(got))
            assert torch.equal(levels, ck.levels_plain(comp, draw, v, memory))


def _rows_plain(comp, draw, v, memory, rows):
    """The twin's estimate update on a few rows of a stack too large for the
    twin: their uniforms at counters r·d + c, through the twin's operators."""
    d = v.shape[1]
    r = torch.tensor(rows, dtype=torch.int64)
    diff = (v[r.to(v.device)] - memory[r.to(v.device)]).cpu()
    u = prng.uniform_at(draw.key(), r[:, None] * d + torch.arange(d)[None, :], v.dtype)
    if comp.name == "random_k":
        q = diff * compression.top_scored_mask(u, comp.k)
    else:
        s = float(2 ** comp.k)
        norm, levels = compression.qsgd_levels(diff, u, s)
        q = torch.tensor(comp.delta, dtype=v.dtype) * norm * compression._sign(diff) * (levels / s)
    return memory[r.to(v.device)].cpu() + q


@pytest.mark.cuda
def test_cuda_compression_past_two_to_the_32_elements(cuda_device):
    """N·d just past 2³² float32 elements (17 GB a stack): random_k and qsgd
    launch, and the rows before, across and past the counter 2³² equal the
    twin's draws at those 64-bit counters."""
    n, d = 1_431_657, 3_000  # N·d = 2³² + 3,704; row 1,431,655 crosses 2³²
    assert (n - 2) * d < 2**32 < (n - 1) * d
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    v = torch.randn((n, d), generator=gen, device=cuda_device)
    memory = torch.zeros_like(v)
    rows = (0, n - 2, n - 1)
    for name, k in (("random_k", 27), ("qsgd", 4)):
        comp = compression.make_compressor(name, d, k)
        t = torch.full((1,), 2**31 + 3, dtype=torch.int64, device=cuda_device)
        draw = compression.Draw(compression.tag_key(203, x64=False), t, 0)
        got = ck.ef_compress(comp, draw, v, memory)
        host = compression.Draw(draw.tag_key, t.cpu(), 0)
        want = _rows_plain(comp, host, v, memory, rows)
        assert torch.equal(_bits(got[list(rows)].cpu()), _bits(want)), name
        del got
    del v, memory
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name,k", [("random_k", 4), ("qsgd", 4), ("top_k", 3)])
def test_cuda_compression_graph_replays_with_the_current_t(cuda_device, name, k):
    """One launch captured; each replay draws at the counter's current value
    and counts one launch; top_k's result does not depend on t."""
    v, memory = compression_inputs(64, 33, torch.float32, cuda_device)
    comp = compression.make_compressor(name, 33, k)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    draw = compression.Draw(compression.tag_key(7, x64=False), t, 1)
    ck.ef_compress(comp, draw, v, memory)  # built and loaded
    ck.reset_launch_counts()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = ck.ef_compress(comp, draw, v, memory)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    assert ck.LAUNCHES["compress_exchange"] == 0
    seen = set()
    for step in range(3):
        t.add_(2**31 - 1 if step == 2 else 1)
        graph.replay()
        counter = int(t.item())
        want = compression.ef_compress_plain(
            comp, compression.Draw(draw.tag_key, torch.tensor([counter], device=cuda_device), 1),
            v, memory)
        assert torch.equal(out, want), counter
        seen.add(_bits(out).sum().item())
    assert ck.LAUNCHES["compress_exchange"] == 3
    assert len(seen) == (1 if name == "top_k" else 3)
    graph.reset()


@pytest.mark.cuda
def test_cuda_compression_none_launches_nothing(cuda_device, graph_data):
    """compression='none' on choco: the identity exchange in torch ops, no
    compression launch; the ring kernel mixes the estimates."""
    base, ds, f_opt = graph_data["sorted"]
    cfg = base.replace(algorithm="choco", mixing_impl="pallas", n_iterations=50)
    _, launches = _counted_run(cfg, ds, f_opt)
    assert launches["compress_exchange"] == 0 and launches["ring_mix"] == 50


@pytest.mark.cuda
def test_cuda_compression_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    v = torch.zeros((4, 8), device=cuda_device)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    draw = compression.Draw(compression.tag_key(1, x64=False), t, 0)
    comp = compression.make_compressor("random_k", 8, 2)
    with pytest.raises(TypeError, match="int64 tensor"):
        ck.ef_compress(comp, compression.Draw(draw.tag_key, 3, 0), v, v)
    with pytest.raises(ValueError, match="no compression kernel"):
        ck.ef_compress(dataclasses.replace(comp, name="bogus"), draw, v, v)
    for name, k in (("top_k", 0), ("random_k", 9), ("qsgd", 0), ("qsgd", 17)):
        with pytest.raises(ValueError, match="refuses"):
            ck.ef_compress(dataclasses.replace(comp, name=name, k=k), draw, v, v)
    with pytest.raises(ValueError, match="must match"):
        ck.ef_compress(comp, draw, v, v.double())
    huge = torch.empty((1, 2**31), device=cuda_device)  # d = 2³¹, 8 GiB, never written
    with pytest.raises(ValueError, match="d < 2³¹"):
        ck.ef_compress(compression.make_compressor("top_k", 2**31, 1), draw, huge, huge)
    del huge
    torch.cuda.empty_cache()


def _er_table(n=64, p=0.1, seed=203):
    """The robust phase's Erdős–Rényi graph: rows of 3 to 13 live slots of
    13, the rest padding from the graph itself."""
    from distributed_optimization_tpu_torch.parallel.topology import (
        build_topology,
        neighbor_tables_for,
    )

    nbr, mask = neighbor_tables_for(build_topology("erdos_renyi", n, erdos_renyi_p=p, seed=seed))
    return nbr, mask.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rule,ct", SCREENS)
def test_cuda_robust_kernels_on_a_variable_degree_er_table(cuda_device, rule, ct, dtype):
    nbr, live = _er_table()
    assert int(live.sum(1).min()) == 3 and nbr.shape[1] == 13
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tx = torch.randn((64, 81), generator=gen, device=cuda_device, dtype=dtype)
    tl = torch.from_numpy(live).to(cuda_device)
    g = torch.randn(tx.shape, generator=gen, device=cuda_device, dtype=dtype)
    eta = torch.tensor([0.013], dtype=dtype, device=cuda_device)
    nbr64 = torch.from_numpy(nbr).long().to(cuda_device)
    tau = torch.tensor([ct], dtype=dtype, device=cuda_device)
    adaptive = rule == "clipped_gossip" and ct == 0.0
    got = bk.make_fused_robust_aggregator(rule, 1, nbr, ct, device=cuda_device)(tl, tx)
    got_step = bk.make_fused_robust_dsgd_step(rule, 1, nbr, ct, device=cuda_device)(tl, tx, g, eta)
    want = bk.fused_robust_plain(rule, 1, nbr64, tl, tx, tau, adaptive=adaptive)
    want_step = bk.fused_robust_plain(rule, 1, nbr64, tl, tx, tau, adaptive=adaptive, g=g, eta=eta)
    if rule in COUNT_RULES:
        assert _nan_equal(got, want) and _nan_equal(got_step, want_step)
    else:
        _assert_clip_close(got, want, tx, nbr64, tl)
        _assert_clip_close(got_step, want_step, tx, nbr64, tl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,impl", [("erdos_renyi", "gather"), ("erdos_renyi", "sparse"),
                                       ("directed_erdos_renyi", "sparse"), ("star", "sparse"),
                                       ("chain", "gather")])
def test_cuda_table_mixing_forms_replay_bitwise_in_a_graph(cuda_device, name, impl, dtype):
    """The gather and sparse forms hold no atomics and read nothing back to
    the host: captured in a CUDA graph, every replay is bitwise the eager
    call, which is bitwise the CPU's (the same elementwise products, added
    slot after slot)."""
    from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    topo = build_topology(name, 256, erdos_renyi_p=12 / 256, seed=203)
    op = make_mixing_op(topo, impl, device=cuda_device, dtype=dtype)
    cpu = make_mixing_op(topo, impl, device="cpu", dtype=dtype)
    x = torch.randn((256, 81), device=cuda_device, dtype=dtype)
    eager_w, eager_a = op.apply(x), op.neighbor_sum(x)
    assert torch.equal(eager_w.cpu(), cpu.apply(x.cpu()))
    assert torch.equal(eager_a.cpu(), cpu.neighbor_sum(x.cpu()))
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        op.apply(x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out_w, out_a = op.apply(x), op.neighbor_sum(x)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(cuda_device)
        assert torch.equal(out_w, eager_w) and torch.equal(out_a, eager_a)
    graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_ring_mix_on_the_push_sum_mass_column(cuda_device, dtype):
    """Push-sum mixes its [N, 1] mass through ring_mix: bitwise the plain
    version, and a column of ones stays ones (3 · fl(1/3) = 1)."""
    w = torch.rand((256, 1), device=cuda_device, dtype=dtype)
    assert torch.equal(rk.ring_mix(w), rk.ring_mix_plain(w))
    ones = torch.ones((256, 1), device=cuda_device, dtype=dtype)
    assert torch.equal(rk.ring_mix(ones), ones)


@pytest.mark.cuda
def test_cuda_push_sum_run_on_the_ring_launches_ring_mix_twice_a_step(cuda_device, graph_data):
    base, ds, f_opt = graph_data["sorted"]
    cfg = base.replace(algorithm="push_sum", mixing_impl="pallas", n_iterations=40)
    res, launches = _counted_run(cfg, ds, f_opt, return_state=True)
    assert launches["ring_mix"] == 80 and launches["fused_ring_dsgd_step"] == 0
    assert np.all(res.final_state["w"] == 1.0)
    stencil, _ = _counted_run(cfg.replace(mixing_impl="stencil"), ds, f_opt)
    assert np.array_equal(res.history.objective, stencil.history.objective)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gather_sampler_copies_class_labels_bitwise(cuda_device, dtype):
    """Softmax's labels are class indices stored in the run dtype: the
    gather form returns them integer-valued and bitwise the twin's."""
    n, L, b, k = 25, 500, 16, 512
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, _ = _rows(cuda_device, n, L, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    y = torch.randint(0, k, (n, L), generator=gen, device=cuda_device).to(dtype)
    key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0)
    for t in (0, 12_345):
        got = sk.sample_worker_batches(key, torch.full((1,), t, device=cuda_device), X, y, nv, b)
        assert _same(got, sampling.sample_worker_batches(key, t, X, y, nv, b))
        labels = got[1]
        assert torch.equal(labels, labels.round()) and 0 <= float(labels.min())
        assert float(labels.max()) < k


@pytest.mark.cuda
def test_cuda_matmul_precision_scopes_tf32_to_the_run(cuda_device, graph_data, monkeypatch):
    """'default' turns TF32 on for the run's products (read inside the
    gradient, during the warm-up and the capture) and restores the caller's
    setting after; 'highest' keeps it off; float64 leaves it alone."""
    from distributed_optimization_tpu_torch.backends import torch_backend
    from distributed_optimization_tpu_torch.models import get_problem

    seen = []
    problem = get_problem("softmax", n_classes=4)

    def recording_gradient(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return problem.gradient_weighted(*args)

    monkeypatch.setattr(torch_backend, "get_problem", lambda *a, **kw: dataclasses.replace(
        problem, gradient_weighted=recording_gradient))
    base, ds, _ = graph_data["sorted"]
    ds = dataclasses.replace(ds, y_full=(ds.y_full > 0).astype(np.float64) * 3.0,
                             problem_type="softmax")
    cfg = base.replace(problem_type="softmax", n_classes=4, n_iterations=20, eval_every=10)
    caller = torch.backends.cuda.matmul.allow_tf32
    try:
        for start in (False, True):
            for precision, dtype, inside in (("default", "float32", True),
                                             ("high", "float32", True),
                                             ("highest", "float32", False),
                                             ("default", "float64", start)):
                torch.backends.cuda.matmul.allow_tf32 = start
                seen.clear()
                torch_backend.run(cfg.replace(matmul_precision=precision, dtype=dtype), ds, 0.0,
                                  device="cuda")
                assert seen and all(flag is inside for flag in seen), (precision, dtype, seen)
                assert torch.backends.cuda.matmul.allow_tf32 is start
    finally:
        torch.backends.cuda.matmul.allow_tf32 = caller


@pytest.mark.cuda
def test_cuda_softmax_graph_run_is_bitwise_its_measured_run(cuda_device, graph_data):
    """Softmax (K=6, d_model = 21·6) through the gather sampler and the fused
    ring step: the graph run equals the host-driven chunk loop bit for bit,
    with the same launches; the absent classes' gradient columns tie
    exactly on the card too."""
    from distributed_optimization_tpu_torch.ops import losses

    base, ds, _ = graph_data["sorted"]
    labels = (ds.y_full > 0) * 4.0 + np.arange(ds.y_full.size) % 2  # classes 0, 1, 4, 5
    ds = dataclasses.replace(ds, y_full=labels, problem_type="softmax")
    cfg = base.replace(problem_type="softmax", n_classes=6, mixing_impl="pallas",
                       n_iterations=60, eval_every=10)
    graph, counted = _counted_run(cfg, ds, 0.0)
    measured, again = _counted_run(cfg, ds, 0.0, measure_timestamps=True)
    assert graph.final_models.shape == (16, 21 * 6)
    assert np.array_equal(graph.history.objective, measured.history.objective)
    assert np.array_equal(graph.final_models, measured.final_models)
    assert counted == again and counted["fused_ring_dsgd_step"] == 60
    assert counted["sample_worker_batches"] == 60
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    X = torch.randn((6, 16, 21), generator=gen, device=cuda_device, dtype=torch.float64)
    y = torch.randint(0, 2, (6, 16), generator=gen, device=cuda_device).to(torch.float64)
    g = losses.softmax_gradient_weighted(torch.zeros((6, 21 * 6), dtype=X.dtype, device=X.device),
                                         X, y, torch.full_like(y, 1 / 16), 1e-4).view(6, 21, 6)
    for c in range(3, 6):
        assert torch.equal(g[..., c], g[..., 2])


# --- the fault and noise draws ------------------------------------------------

DRAW_NODES = (16, 64, 256, 1024)
DRAW_GRAPHS = ("ring", "erdos_renyi", "directed_ring", "directed_erdos_renyi")
# The round kernel's graphs beside DRAW_GRAPHS: the grid at the same N and
# the fully-connected graph at N=25.
ROUND_GRAPHS = DRAW_GRAPHS + ("grid",)
# The round's fault modes (make_faulty_mixing's arguments): memoryless
# draws, then the timeline's processes, then one-peer scores.
ROUND_MODES = {
    "drops": dict(drop_prob=0.2),
    "stragglers": dict(drop_prob=0.0, straggler_prob=0.1),
    "both": dict(drop_prob=0.2, straggler_prob=0.1),
    "heavy": dict(drop_prob=0.9, straggler_prob=0.5),
    "bursty": dict(drop_prob=0.3, burst_len=4.0, horizon=60),
    "churn-frozen": dict(drop_prob=0.2, mttf=8.0, mttr=3.0, horizon=60),
    "churn-restart": dict(drop_prob=0.0, mttf=8.0, mttr=3.0, rejoin="neighbor_restart",
                          horizon=60),
    "participation": dict(drop_prob=0.1, participation_rate=0.7, horizon=60),
    "one-peer": dict(drop_prob=0.2, straggler_prob=0.1, one_peer=True),
    "one-peer-bursty": dict(drop_prob=0.3, burst_len=2.0, one_peer=True, horizon=60),
}


def _draw_topology(name, n):
    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    return build_topology(name, n, erdos_renyi_p=min(1.0, 12.0 / n), seed=3)


def _round_pair(topo, mode, dtype, cuda_device):
    """The same faulty mixing on the card and on the CPU."""
    from distributed_optimization_tpu_torch.parallel import faults

    kw = dict(ROUND_MODES[mode], x64=dtype == torch.float64)
    return (faults.make_faulty_mixing(topo, seed=203, device=cuda_device, **kw),
            faults.make_faulty_mixing(topo, seed=203, device="cpu", **kw))


def _assert_round_is_the_twin_s(gpu, cpu, t, dtype, cuda_device):
    """One launch of the round kernel against its plain version: A_t,
    active, W_t, the scores and the degree count, bit for bit."""
    kw = dict(drop_prob=gpu.drop_prob, straggler_prob=gpu.straggler_prob,
              weights=None if gpu.one_peer else dtype, scores=gpu.one_peer)
    total = torch.full((), 3.0, dtype=torch.float64, device=cuda_device)
    got = dk.realize_round(torch.tensor([t], device=cuda_device), gpu._keys, gpu._tables,
                           timeline=gpu._tl, degree_total=total, **kw)
    want_total = torch.full((), 3.0, dtype=torch.float64)
    want = dk.realize_round_plain(torch.tensor([t]), cpu._keys, cpu._tables, timeline=cpu._tl,
                                  degree_total=want_total, **kw)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b), t
    assert float(total) == float(want_total), t


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ROUND_GRAPHS)
@pytest.mark.parametrize("n", DRAW_NODES)
def test_cuda_realize_round_is_bitwise_its_plain_version(cuda_device, graph, n):
    """Every fault mode, W_t in both dtypes, at counters past 2³¹ and 2³²
    on the memoryless path, and at and past the horizon on a timeline
    (clamped to its last row)."""
    topo = _draw_topology(graph, n)
    for mode in ROUND_MODES:
        if topo.directed and mode.startswith("one-peer"):
            continue
        for dtype in (torch.float32, torch.float64):
            gpu, cpu = _round_pair(topo, mode, dtype, cuda_device)
            ts = ((0, 7, 59, 60, 61, 10_000) if gpu.timeline is not None
                  else (0, 12_345, 2**31 - 1, 2**32 + 7))
            for t in ts:
                _assert_round_is_the_twin_s(gpu, cpu, t, dtype, cuda_device)


@pytest.mark.cuda
def test_cuda_realize_round_on_the_fully_connected_graph(cuda_device):
    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    topo = build_topology("fully_connected", 25)
    for mode in ROUND_MODES:
        for dtype in (torch.float32, torch.float64):
            gpu, cpu = _round_pair(topo, mode, dtype, cuda_device)
            for t in (0, 7, 59, 60, 61):
                _assert_round_is_the_twin_s(gpu, cpu, t, dtype, cuda_device)


@pytest.mark.cuda
def test_cuda_faulty_mixing_sums_degrees_in_the_kernel(cuda_device):
    """A realized round adds its degree count to the total in the launch;
    the round's W_t is the kernel's."""
    topo = _draw_topology("erdos_renyi", 64)
    gpu, cpu = _round_pair(topo, "both", torch.float32, cuda_device)
    total = torch.zeros((), dtype=torch.float64, device=cuda_device)
    want = torch.zeros((), dtype=torch.float64)
    for t in range(4):
        rnd = gpu.realize(torch.tensor([t], device=cuda_device), total)
        ref = cpu.realize(torch.tensor([t]), want)
        assert torch.equal(rnd.W.cpu(), ref.W)
    assert float(total) == float(want) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("graph", DRAW_GRAPHS)
@pytest.mark.parametrize("n", DRAW_NODES)
def test_cuda_fault_timeline_is_bitwise_its_plain_version(cuda_device, graph, n):
    from distributed_optimization_tpu_torch.parallel import faults

    topo = _draw_topology(graph, n)
    horizon = 200 if n < 1024 else 40
    for kw in (dict(edge_drop_prob=0.3, burst_len=4.0), dict(edge_drop_prob=0.3),
               dict(mttf=8.0, mttr=3.0, participation_rate=0.7),
               dict(straggler_prob=0.2, edge_drop_prob=0.1, burst_len=2.0)):
        want = faults.build_fault_timeline(topo, horizon, 203, device="cpu", **kw)
        got = faults.build_fault_timeline(topo, horizon, 203, device=cuda_device, **kw)
        for field in ("edge_up", "node_up", "rejoin", "part_up"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b), (kw, field)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", DRAW_NODES)
def test_cuda_large_noise_is_bitwise_its_plain_version(cuda_device, n, dtype):
    key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0xBAD0)
    for d in (1, 41, 81, 1000):
        gen = torch.Generator(device=cuda_device).manual_seed(d)
        x = torch.randn((n, d), generator=gen, device=cuda_device, dtype=dtype)
        byz = (torch.arange(n, device=cuda_device) % 5 == 1).to(torch.uint8)
        for t in (0, 7, 2**31 - 1):
            tt = torch.tensor([t], device=cuda_device)
            got = dk.large_noise(key, tt, byz, x, 10.0)
            want = dk.large_noise_plain(key, tt, byz, x, 10.0)
            assert torch.equal(got, want), (d, t)
            assert torch.equal(got[byz == 0], x[byz == 0])


# Horizons across the timeline kernels' segment (16 rounds) and tile (128
# rounds) edges.
TIMELINE_HORIZONS = (1, 15, 16, 17, 31, 32, 33, 127, 128, 129, 1000)
BURSTY_CHURN = dict(edge_drop_prob=0.2, burst_len=8.0, mttf=60.0, mttr=25.0)
TIMELINE_OFF = dict(edge_drop_prob=0.0, burst_len=1.0, straggler_prob=0.0, mttf=0.0, mttr=0.0,
                    participation_rate=1.0)


def _timeline_args(n, kw, device):
    from distributed_optimization_tpu_torch.parallel import faults

    topo = _draw_topology("ring", n)
    return faults.timeline_args(topo, 203, device=device, x64=False,
                                **dict(TIMELINE_OFF, **kw))[0]


def _assert_timeline_is_the_twin_s(args, horizon, device):
    got = dk.fault_timeline(horizon=horizon, device=device, **args)
    want = dk.fault_timeline_plain(horizon=horizon, device=device, **args)
    for field, a in got.items():
        assert (a is None) == (want[field] is None), field
        if a is not None:
            assert torch.equal(a, want[field]), (horizon, field)


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", TIMELINE_HORIZONS)
@pytest.mark.parametrize("kw", [BURSTY_CHURN, dict(edge_drop_prob=0.3, burst_len=4.0),
                                dict(straggler_prob=0.1, participation_rate=0.7,
                                     edge_drop_prob=0.2)],
                         ids=["bursty-churn", "bursty", "stragglers-participation"])
def test_cuda_fault_timeline_across_tile_edges(cuda_device, kw, horizon):
    """The scan's carry across segments and tiles, bitwise the plain
    version at horizons on both sides of each edge (N=40: two entity groups
    of edges and of nodes, the second part full)."""
    _assert_timeline_is_the_twin_s(_timeline_args(40, kw, cuda_device), horizon, cuda_device)


@pytest.mark.cuda
def test_cuda_fault_timeline_at_main_s_shape(cuda_device):
    """Main's shape under bursty drops and churn: ring N=256, T=30,000."""
    _assert_timeline_is_the_twin_s(_timeline_args(256, BURSTY_CHURN, cuda_device), 30_000,
                                   cuda_device)


@pytest.mark.cuda
def test_cuda_fault_timeline_counts_its_launches(cuda_device):
    """Each call counts its two launches (the draws and the scan), eagerly
    and at each replay of a captured graph; participation alone too."""
    for kw in (BURSTY_CHURN, dict(participation_rate=0.7)):
        args = _timeline_args(16, kw, cuda_device)
        dk.fault_timeline(horizon=50, device=cuda_device, **args)
        dk.reset_launch_counts()
        dk.fault_timeline(horizon=50, device=cuda_device, **args)
        assert dk.LAUNCHES["fault_timeline"] == dk.TIMELINE_LAUNCHES
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = dk.fault_timeline(horizon=50, device=cuda_device, **args)
        dk.reset_launch_counts()
        for _ in range(3):
            graph.replay()
        assert dk.LAUNCHES["fault_timeline"] == 3 * dk.TIMELINE_LAUNCHES
        want = dk.fault_timeline_plain(horizon=50, device=cuda_device, **args)
        for field, a in out.items():
            assert a is None or torch.equal(a, want[field]), field
        graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,every", [((8, 4_194_816), 8), ((4096, 1024), 10)])
def test_cuda_large_noise_at_wide_shapes(cuda_device, dtype, shape, every):
    """The compute-bound tier's width (one Byzantine row) and 4,096 × 1,024
    (every tenth row), on an aligned stack and on a view off 16-byte
    alignment: bitwise the plain version, honest rows equal to x."""
    n, d = shape
    key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0xBAD0)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    base = torch.randn(n * d + 1, generator=gen, device=cuda_device, dtype=dtype)
    byz = (torch.arange(n, device=cuda_device) % every == 3).to(torch.uint8)
    for x in (base[:-1].view(n, d), base[1:].view(n, d)):
        for t in (0, 4000, 2**31 - 1):
            tt = torch.tensor([t], device=cuda_device)
            got = dk.large_noise(key, tt, byz, x, 10.0)
            assert torch.equal(got, dk.large_noise_plain(key, tt, byz, x, 10.0)), t
            assert torch.equal(got[byz == 0], x[byz == 0])


@pytest.mark.cuda
def test_cuda_large_noise_past_two_to_the_32_elements(cuda_device):
    """N·d just past 2³² float32 elements (17 GB a stack): the kernel
    launches, rows before, across and past the counter 2³² equal the row-wise
    plain version's draws at the 64-bit counters, and the honest rows equal
    x."""
    n, d = 1_431_657, 3_000  # N·d = 2³² + 3,704; row 1,431,655 crosses 2³²
    assert (n - 2) * d < 2**32 < (n - 1) * d
    key = prng.fold_in(prng.key(203, x64=False), 0xBAD0)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((n, d), generator=gen, device=cuda_device)
    rows = (7, n - 2, n - 1)
    byz = torch.zeros(n, dtype=torch.uint8, device=cuda_device)
    byz[list(rows)] = 1
    t = torch.tensor([2**31 + 3], device=cuda_device)
    got = dk.large_noise(key, t, byz, x, 10.0)
    want = dk.large_noise_rows_plain(key, t, rows, x[list(rows)], d, 10.0)
    assert torch.equal(got[list(rows)], want)
    honest = byz == 0
    for start in range(0, n, 1 << 18):
        stop = min(n, start + (1 << 18))
        keep = honest[start:stop]
        assert torch.equal(got[start:stop][keep], x[start:stop][keep]), start
    del got, x
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_draw_kernels_replay_with_the_current_t(cuda_device):
    topo = _draw_topology("ring", 64)
    gpu, cpu = _round_pair(topo, "both", torch.float32, cuda_device)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    total = torch.zeros((), dtype=torch.float64, device=cuda_device)
    kw = dict(drop_prob=0.2, straggler_prob=0.1, weights=torch.float32)
    dk.realize_round(t, gpu._keys, gpu._tables, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.realize_round(t, gpu._keys, gpu._tables, degree_total=total, **kw)
    dk.reset_launch_counts()
    want_total = torch.zeros((), dtype=torch.float64)
    for step in range(5):
        t.fill_(step)
        graph.replay()
        torch.cuda.synchronize()
        want = dk.realize_round_plain(torch.tensor([step]), cpu._keys, cpu._tables,
                                      degree_total=want_total, **kw)
        assert torch.equal(out.A.cpu(), want.A) and torch.equal(out.W.cpu(), want.W)
    assert float(total) == float(want_total)
    assert dk.LAUNCHES["realize_round"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("rule", COUNT_RULES)
def test_cuda_fused_robust_kernels_on_per_round_liveness(cuda_device, rule):
    """Both fused kernels on a liveness gathered from a new A_t each round
    equal the gather form bit for bit."""
    from distributed_optimization_tpu_torch.ops.robust_aggregation import (
        make_gather_robust_aggregator,
    )
    from distributed_optimization_tpu_torch.parallel import faults

    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    topo = build_topology("erdos_renyi", 64, erdos_renyi_p=0.1, seed=3)  # k_max 13
    nbr_idx, nbr_mask = neighbor_table(topo.adjacency)
    fm = faults.make_faulty_mixing(topo, 0.3, 203, straggler_prob=0.1, device=cuda_device)
    nbr = torch.as_tensor(nbr_idx, dtype=torch.int64, device=cuda_device)
    mask = torch.as_tensor(nbr_mask, dtype=torch.float32, device=cuda_device)
    agg = bk.make_fused_robust_aggregator(rule, 1, nbr_idx, device=cuda_device)
    step = bk.make_fused_robust_dsgd_step(rule, 1, nbr_idx, device=cuda_device)
    gather = make_gather_robust_aggregator(rule, 1, nbr_idx, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((64, 81), generator=gen, device=cuda_device)
    g = torch.randn((64, 81), generator=gen, device=cuda_device)
    eta = torch.tensor([0.05], device=cuda_device)
    lives = []
    for t in range(6):
        live = fm.realize(torch.tensor([t], device=cuda_device)).live(nbr, mask)
        lives.append(live)
        want = gather(live, x)
        assert torch.equal(agg(live, x), want)
        assert torch.equal(step(live, x, g, eta), want - eta * g)
    assert not all(torch.equal(lives[0], lv) for lv in lives[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    dict(edge_drop_prob=0.2, straggler_prob=0.1),
    dict(gossip_schedule="one_peer", edge_drop_prob=0.2),
    dict(edge_drop_prob=0.3, burst_len=4.0, mttf=10.0, mttr=4.0, rejoin="neighbor_restart"),
    dict(partition="shuffled", attack="large_noise", n_byzantine=2, attack_scale=5.0,
         aggregation="trimmed_mean", robust_b=1, robust_impl="fused", edge_drop_prob=0.1),
], ids=["iid", "one_peer", "bursty-churn", "noise-fused"])
def test_cuda_faulted_graph_run_is_bitwise_its_measured_run(cuda_device, graph_data, fields):
    base, ds, f_opt = graph_data[fields.get("partition", "sorted")]
    cfg = base.replace(**fields, n_iterations=60, eval_every=10)
    graph, glaunch = _counted_run(cfg, ds, f_opt)
    measured, mlaunch = _counted_run(cfg, ds, f_opt, measure_timestamps=True)
    assert np.array_equal(graph.history.objective, measured.history.objective)
    assert np.array_equal(graph.final_models, measured.final_models)
    assert graph.history.total_floats_transmitted == measured.history.total_floats_transmitted
    assert glaunch == mlaunch
    T = cfg.n_iterations
    memoryless = fields.get("burst_len", 0.0) == 0.0
    assert glaunch["realize_round"] == T  # the timeline's rounds go through it too
    assert glaunch["fault_timeline"] == (0 if memoryless else dk.TIMELINE_LAUNCHES)
    if "attack" in fields:
        assert glaunch["large_noise"] == T
        assert glaunch["make_fused_robust_dsgd_step"] == T


# --- the replica axis (run_batch) -------------------------------------------------

# R replicas a launch: one, a few, and the 32 of the sweep benches.
REPLICA_COUNTS = (1, 3, 32)
REPLICA_SEEDS = tuple(203 + 7 * r for r in range(32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", REPLICA_COUNTS)
@pytest.mark.parametrize("shape", [(256, 49, 16), (25, 500, 16), (6, 65, 16), (3, 2049, 16)])
def test_cuda_replica_sampling_equals_single_launches(cuda_device, shape, R, dtype):
    """One launch over R slot keys: replica r's weights, indices and batch
    rows are the single launch's with slot key r, bit for bit, in both
    forms, from one shared set of shards (main's and the parity path's
    shapes, the dense form's cluster-free select past 64 rows, 128-bit
    keys past 2,048 rows in float64)."""
    n, L, b = shape
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    x64 = dtype == torch.float64
    seeds = REPLICA_SEEDS[:R]
    t = torch.full((1,), 2**31 + 5, dtype=torch.int64, device=cuda_device)
    for slot in (0, 2):
        keys = prng.keys(seeds, x64=x64, tags=(slot,), device=cuda_device)
        w = sk.sample_worker_batch_weights(keys, t, nv, L, b, dtype)
        idx = sk.sample_batch_indices(keys, t, nv, L, b, dtype)
        rows = sk.sample_worker_batches(keys, t, X, y, nv, b)
        assert w.shape == (R, n, L) and rows[0].shape == (R, n, b, SAMPLING_D)
        for r, seed in enumerate(seeds):
            key = prng.fold_in(prng.key(seed, x64=x64), slot)
            assert torch.equal(w[r], sk.sample_worker_batch_weights(key, t, nv, L, b, dtype))
            assert _same([v[r] for v in idx], sk.sample_batch_indices(key, t, nv, L, b, dtype))
            assert _same([v[r] for v in rows], sk.sample_worker_batches(key, t, X, y, nv, b))
    # And the plain versions' stack, on the card's inputs.
    keys = prng.keys(seeds, x64=x64, tags=(1,), device=cuda_device)
    assert torch.equal(sk.sample_worker_batch_weights(keys, t, nv, L, b, dtype),
                       sampling.sample_worker_batch_weights(keys, t, nv, L, b, dtype))


@pytest.mark.cuda
def test_cuda_replica_sampling_in_the_workspace(cuda_device):
    """Survivors past shared memory: R replicas' workers take R·N regions of
    the workspace, each replica bitwise its single launch."""
    n, L, b, R = 4, 16_384, 16_384, 3
    dtype = torch.float32
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    t = torch.full((1,), 9, dtype=torch.int64, device=cuda_device)
    assert sk.workspace_for(R * n, L, b, dtype, cuda_device) is not None
    keys = prng.keys(REPLICA_SEEDS[:R], x64=False, tags=(0,), device=cuda_device)
    rows = sk.sample_worker_batches(keys, t, X, y, nv, b)
    for r, seed in enumerate(REPLICA_SEEDS[:R]):
        key = prng.fold_in(prng.key(seed, x64=False), 0)
        assert _same([v[r] for v in rows], sk.sample_worker_batches(key, t, X, y, nv, b))


# Fault modes of the replica round: memoryless, timelines, one-peer, and a
# drop threshold a replica (the swept edge_drop_prob).
REPLICA_ROUND_MODES = {
    "both": dict(drop_prob=0.2, straggler_prob=0.1),
    "bursty-churn": dict(drop_prob=0.3, burst_len=4.0, mttf=10.0, mttr=4.0,
                         rejoin="neighbor_restart", horizon=60),
    "participation": dict(drop_prob=0.1, participation_rate=0.7, horizon=60),
    "one-peer": dict(drop_prob=0.2, straggler_prob=0.1, one_peer=True),
    "swept": dict(drop_prob="swept"),
    "swept-bursty": dict(drop_prob="swept", burst_len=2.0, horizon=60),
}


@pytest.mark.cuda
@pytest.mark.parametrize("R", REPLICA_COUNTS)
@pytest.mark.parametrize("graph, n", [("ring", 256), ("erdos_renyi", 64),
                                      ("directed_erdos_renyi", 64)])
def test_cuda_replica_round_equals_single_launches(cuda_device, graph, n, R):
    """One round launch over R replicas' keys, thresholds and stacked
    timelines: replica r's A_t, W_t (both dtypes), mask, one-peer scores and
    degree count are the single launch's with replica r's seed, bit for bit."""
    from distributed_optimization_tpu_torch.parallel import faults

    topo = _draw_topology(graph, n)
    seeds = list(REPLICA_SEEDS[:R])
    for mode, kw in REPLICA_ROUND_MODES.items():
        if topo.directed and mode == "one-peer":
            continue
        swept = kw["drop_prob"] == "swept"
        drops = [0.05 + 0.6 * r / R for r in range(R)] if swept else [kw["drop_prob"]] * R
        for dtype in (torch.float32, torch.float64):
            rest = dict(kw, x64=dtype == torch.float64)
            del rest["drop_prob"]
            batch = faults.make_faulty_mixing(topo, drops if swept else drops[0], seeds,
                                              device=cuda_device, **rest)
            singles = [faults.make_faulty_mixing(topo, drops[r], s, device=cuda_device, **rest)
                       for r, s in enumerate(seeds)]
            for t in (0, 7, 61, 2**31 + 3):
                tt = torch.tensor([t], device=cuda_device)
                total = torch.zeros(R, dtype=torch.float64, device=cuda_device)
                dk.reset_launch_counts()
                rnd = batch.realize(tt, total)
                assert dk.LAUNCHES["realize_round"] == 1
                for r in range(R):
                    one_total = torch.zeros((), dtype=torch.float64, device=cuda_device)
                    one = singles[r].realize(tt, one_total)
                    assert float(total[r]) == float(one_total), (mode, t, r)
                    assert torch.equal(rnd.active[r], one.active)
                    if one.partner is not None:
                        assert torch.equal(rnd.partner[r], one.partner), (mode, t, r)
                    else:
                        assert torch.equal(rnd.A[r], one.A) and torch.equal(rnd.W[r], one.W)
                        if one.rejoin is not None:
                            assert torch.equal(rnd.rejoin[r], one.rejoin)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", REPLICA_COUNTS)
@pytest.mark.parametrize("n, d", [(64, 11), (256, 81), (25, 810), (3, 5)])
def test_cuda_replica_noise_equals_single_launches(cuda_device, n, d, R, dtype):
    """One noise launch over R tag keys and [R, N] flags (N·d not a multiple
    of the block at 64 × 11, 25 × 810 and 3 × 5): replica r's stack is the
    single launch's with key r and flags r, bit for bit."""
    x64 = dtype == torch.float64
    seeds = REPLICA_SEEDS[:R]
    keys = prng.keys(seeds, x64=x64, tags=(0xBAD0,), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((R, n, d), generator=gen, device=cuda_device, dtype=dtype)
    byz = (torch.rand((R, n), generator=gen, device=cuda_device) < 0.3).to(torch.uint8)
    for t in (0, 7, 2**31 - 1):
        tt = torch.tensor([t], device=cuda_device)
        dk.reset_launch_counts()
        got = dk.large_noise(keys, tt, byz, x, 5.0)
        assert dk.LAUNCHES["large_noise"] == 1
        for r, seed in enumerate(seeds):
            key = prng.fold_in(prng.key(seed, x64=x64), 0xBAD0)
            assert torch.equal(got[r], dk.large_noise(key, tt, byz[r].contiguous(),
                                                      x[r].contiguous(), 5.0)), (t, r)


def _counted_batch(cfg, ds, f_opt, R, **kw):
    from distributed_optimization_tpu_torch.backends import torch_backend

    before = _launch_counts()
    res = torch_backend.run_batch(cfg, ds, f_opt, seeds=list(REPLICA_SEEDS[:R]), **kw)
    after = _launch_counts()
    return res, {name: after[name] - before[name] for name in after}


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("fields", [
    dict(sampling_impl="dense", partition="shuffled", attack="large_noise", n_byzantine=2,
         attack_scale=5.0, aggregation="trimmed_mean", robust_b=1, edge_drop_prob=0.2,
         straggler_prob=0.1),
    dict(edge_drop_prob=0.3, burst_len=4.0, mttf=10.0, mttr=4.0, rejoin="neighbor_restart"),
    dict(gossip_schedule="one_peer", edge_drop_prob=0.2, algorithm="gradient_tracking"),
], ids=["noise-iid-dense", "bursty-churn", "one-peer-gt"])
def test_cuda_batch_graph_run_is_bitwise_its_measured_run(cuda_device, graph_data, fields, R):
    """A batch's graph run equals its measured run bit for bit (histories,
    models, floats), and a step launches the sampler, the round and the
    noise once each, whatever R is; the timeline twice a replica."""
    base, ds, f_opt = graph_data[fields.get("partition", "sorted")]
    cfg = base.replace(**fields, n_iterations=60, eval_every=10)
    graph, glaunch = _counted_batch(cfg, ds, f_opt, R)
    measured, mlaunch = _counted_batch(cfg, ds, f_opt, R, measure_timestamps=True)
    assert np.array_equal(graph.objective, measured.objective)
    assert np.array_equal(graph.consensus_error, measured.consensus_error)
    assert np.array_equal(graph.final_states["x"], measured.final_states["x"])
    assert [r.history.total_floats_transmitted for r in graph.results] == \
        [r.history.total_floats_transmitted for r in measured.results]
    assert glaunch == mlaunch
    T = cfg.n_iterations
    sampler = ("sample_worker_batch_weights" if fields.get("sampling_impl") == "dense"
               else "sample_worker_batches")
    assert glaunch[sampler] == T  # one gradient call a step (D-SGD, GT)
    assert glaunch["realize_round"] == T
    memoryless = fields.get("burst_len", 0.0) == 0.0
    assert glaunch["fault_timeline"] == (0 if memoryless else R * dk.TIMELINE_LAUNCHES)
    assert glaunch["large_noise"] == (T if "attack" in fields else 0)
    assert np.all(np.isfinite(graph.objective))


# The matrix-free fault form: the slot round over a neighbour table and the
# per-edge timeline stream. (name, N, p, sampler): ring N=256, ER N=1,024 and
# the federated phase's cell (ii) shape, ER N=100,000 at p = 16/N.
SLOT_GRAPHS = {"ring-256": ("ring", 256, None, "dense"),
               "er-1024": ("erdos_renyi", 1024, 12 / 1024, "dense"),
               "er-100k": ("erdos_renyi", 100_000, 16 / 100_000, "sparse")}
SLOT_MODES = {
    "iid-edges": dict(drop_prob=0.1),
    "bursty-churn-restart": dict(drop_prob=0.3, burst_len=4.0, mttf=10.0, mttr=4.0,
                                 rejoin="neighbor_restart"),
    "participation-stragglers": dict(drop_prob=0.1, straggler_prob=0.1,
                                     participation_rate=0.5),
}
SLOT_HORIZON = 12


def _slot_topology(key):
    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    name, n, p, sampler = SLOT_GRAPHS[key]
    kw = dict(erdos_renyi_p=p, seed=1, sampler=sampler) if p else {}
    return build_topology(name, n, impl="neighbor", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 4, 8])
@pytest.mark.parametrize("graph", sorted(SLOT_GRAPHS))
def test_cuda_slot_round_is_bitwise_its_plain_version(cuda_device, graph, R):
    """One launch pair of the slot round against its plain version on the
    same card tensors, replica by replica: live, w, w_self, active and the
    degree totals bit for bit, in every mode and both dtypes, at t inside,
    at and past the horizon."""
    from distributed_optimization_tpu_torch.parallel import faults

    topo = _slot_topology(graph)
    seeds = list(REPLICA_SEEDS[:R]) if R > 1 else 203
    for mode, kw in SLOT_MODES.items():
        for dtype in (torch.float32, torch.float64):
            fm = faults.make_faulty_mixing(topo, seed=seeds, horizon=SLOT_HORIZON,
                                           device=cuda_device, x64=dtype == torch.float64, **kw)
            for t in (0, 7, SLOT_HORIZON - 1, SLOT_HORIZON, SLOT_HORIZON + 5):
                tt = torch.tensor([t], device=cuda_device)
                lead = (R,) if R > 1 else ()
                total = torch.full(lead, 3.0, dtype=torch.float64, device=cuda_device)
                got = dk.realize_slot_round(tt, fm._slots, fm._tl, weights=dtype,
                                            degree_total=total, replicas=R if R > 1 else None)
                for r in range(R):
                    tl = fm._tl.replica(r) if R > 1 else fm._tl
                    want_total = torch.full((), 3.0, dtype=torch.float64, device=cuda_device)
                    want = dk.realize_slot_round_plain(tt, fm._slots, tl, weights=dtype,
                                                       degree_total=want_total)
                    for a, b in zip(got, want):
                        assert torch.equal(a[r] if R > 1 else a, b), (mode, dtype, t, r)
                    assert float(total.reshape(-1)[r]) == float(want_total), (mode, t, r)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", sorted(SLOT_GRAPHS))
def test_cuda_per_edge_timeline_is_bitwise_its_plain_version(cuda_device, graph):
    """The timeline's per-edge stream (no edge list: edge e at counter e),
    with the node and participation streams, bitwise the plain version,
    across the kernels' tile edge."""
    from distributed_optimization_tpu_torch.parallel import faults

    topo = _slot_topology(graph)
    for kw in (dict(edge_drop_prob=0.1), dict(edge_drop_prob=0.3, burst_len=4.0, mttf=10.0,
                                               mttr=4.0),
               dict(edge_drop_prob=0.1, straggler_prob=0.1, participation_rate=0.5)):
        args, _ = faults.timeline_args(topo, 203, device=cuda_device, x64=False,
                                       **dict(TIMELINE_OFF, **kw))
        assert args["edges"] is None and args["n_edges"] > 0
        for horizon in (1, 50, 129) if topo.n < 100_000 else (50,):
            _assert_timeline_is_the_twin_s(args, horizon, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    dict(edge_drop_prob=0.3, burst_len=4.0, mttf=10.0, mttr=4.0, rejoin="neighbor_restart"),
    dict(edge_drop_prob=0.1, straggler_prob=0.1, participation_rate=0.5,
         algorithm="gradient_tracking"),
    dict(edge_drop_prob=0.1, partition="shuffled", attack="sign_flip", n_byzantine=2,
         aggregation="trimmed_mean", robust_b=1),
], ids=["bursty-churn-restart", "gt-participation", "sign-flip-gather"])
def test_cuda_matrix_free_graph_run_is_bitwise_its_measured_run(cuda_device, graph_data, fields):
    """A faulted matrix-free run: the graph replay equals the measured chunk
    loop bit for bit (histories, models, floats), with the slot round's two
    launches a step, the timeline's two a run and no dense round."""
    base, ds, f_opt = graph_data[fields.get("partition", "sorted")]
    cfg = base.replace(topology_impl="neighbor", n_iterations=60, eval_every=10, **fields)
    graph, glaunch = _counted_run(cfg, ds, f_opt)
    measured, mlaunch = _counted_run(cfg, ds, f_opt, measure_timestamps=True)
    assert np.array_equal(graph.history.objective, measured.history.objective)
    assert np.array_equal(graph.final_models, measured.final_models)
    assert graph.history.total_floats_transmitted == measured.history.total_floats_transmitted
    assert glaunch == mlaunch
    T = cfg.n_iterations
    assert glaunch["realize_slot_round"] == dk.SLOT_ROUND_LAUNCHES * T
    assert glaunch["fault_timeline"] == dk.TIMELINE_LAUNCHES
    assert glaunch["realize_round"] == 0
    assert np.all(np.isfinite(graph.history.objective))


@pytest.mark.cuda
def test_cuda_dense_round_rows_past_two_to_the_32(cuda_device):
    """The dense round at N = 65,537 on the ring, where i·N + j passes 2³²:
    A_t and W_t (2 × 17.2 GB in float32) from tables built of the
    matrix-free ring's table, rows bitwise the rows-only plain version."""
    from distributed_optimization_tpu_torch.parallel import faults
    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    n = 65_537
    topo = build_topology("ring", n, impl="neighbor")
    tables = faults.round_tables(topo, device=cuda_device)
    keys = faults._tag_keys(203, False, faults.FAULT_TAG, faults.NODE_TAG, faults.MATCH_TAG)
    rows = [0, 1, n // 2, n - 2, n - 1]
    tt = torch.tensor([17], device=cuda_device)
    kw = dict(drop_prob=0.2, straggler_prob=0.1)
    out = dk.realize_round(tt, keys, tables, weights=torch.float32, **kw)
    A, W, active = (out.A[rows].clone(), out.W[rows].clone(), out.active[rows].clone())
    del out
    torch.cuda.empty_cache()
    want = dk.realize_round_rows_plain(tt, keys, tables, rows, **kw)
    assert torch.equal(A, want[0]) and torch.equal(W, want[1]) and torch.equal(active, want[2])


# The async event clock's sampler: (N, L, b) at main's shard, bench_async's
# (N=32, 1,600 samples: L = 50), shards shorter than b, past 1,024 rows and
# the float64 key of 128 bits (L = 2,049).
EVENT_SHAPES = [(256, 49, 16), (32, 50, 16), (9, 7, 16), (6, 1100, 16), (4, 2049, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", EVENT_SHAPES)
def test_cuda_event_sampler_bitwise_equals_the_plain_version(cuda_device, shape, dtype):
    """The block entry at B = 1, one launch an event: the kernel reads the
    cursor, the event's worker and step, folds worker then step (then the
    descent) into the base key and selects and gathers; indices, weights
    and rows bitwise the plain version's at every event, and one count a
    launch."""
    n, L, b = shape
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    gen = np.random.default_rng(1)
    E = 12
    workers = torch.as_tensor(np.r_[np.arange(min(n, 4)), gen.integers(0, n, E - min(n, 4))],
                              dtype=torch.int64, device=cuda_device)
    steps = torch.as_tensor(np.r_[0, 2**31 - 1, 2**32 - 1, gen.integers(0, 5000, E - 3)],
                            dtype=torch.int64, device=cuda_device)
    cursor = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    for seed in (0, 42, 2**31 - 1) + ((2**40 + 5,) if dtype == torch.float64 else ()):
        key = sampling.event_key(seed, x64=dtype == torch.float64)
        for descent in (None, 0, 2):
            for e in range(E):
                cursor.fill_(e)
                want = sampling.event_batch_indices(key, cursor, workers, steps, nv, L, b, dtype,
                                                    descent)
                got = sk.event_batch_indices(key, cursor, workers, steps, nv, L, b, dtype,
                                             descent)
                assert _same(got, want), (seed, descent, e)
                w = int(workers[e])
                sk.reset_launch_counts()
                Xb, yb, wb = sk.sample_event_batch(key, cursor, workers, steps, X, y, nv, b,
                                                   descent)
                assert sk.LAUNCHES["sample_event_block"] == 1
                assert torch.equal(Xb[0], X[w, want[0]]) and torch.equal(yb[0], y[w, want[0]])
                assert torch.equal(wb[0], want[1])


# (B, τ, first event): main's block (256 events), bench_async's (200), a
# short one, and blocks that end at the schedule's last event.
EVENT_BLOCKS = [(256, 1, 0), (200, 2, 40), (5, 3, 3), (12, 1, None), (4, 2, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", EVENT_SHAPES)
def test_cuda_event_block_bitwise_equals_the_plain_version(cuda_device, shape, dtype):
    """One launch for a block of B events at τ draws each (a grid block a
    draw): Xb, yb and the weights bitwise the plain block (B per-event
    draws stacked) and B·τ per-event launches, into the run's padded
    buffer; one count a launch."""
    n, L, b = shape
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, y = _rows(cuda_device, n, L, dtype)
    gen = np.random.default_rng(2)
    E = 260
    workers = torch.as_tensor(gen.integers(0, n, E), dtype=torch.int64, device=cuda_device)
    steps = torch.as_tensor(gen.integers(0, 2**32, E), dtype=torch.int64, device=cuda_device)
    key = sampling.event_key(42, x64=dtype == torch.float64)
    for B, tau, first in EVENT_BLOCKS:
        first = E - B if first is None else first
        cursor = torch.tensor([first], dtype=torch.int64, device=cuda_device)
        descents = None if tau == 1 else tau
        out = sk.event_block_buffer(B, tau, b, X.shape[2], dtype, cuda_device)
        sk.reset_launch_counts()
        got = sk.sample_event_block(key, cursor, workers, steps, X, y, nv, b, B,
                                    descents=descents, out=out)
        assert sk.LAUNCHES["sample_event_block"] == 1 and got is out
        want = sampling.sample_event_block(key, cursor, workers, steps, X, y, nv, b, B,
                                           descents)
        assert _same(got, want), (B, tau, first)
        one = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        for e in (0, B // 2, B - 1):
            for m in range(tau):
                one.fill_(first + e)
                Xb, yb, wb = sk.sample_event_batch(key, one, workers, steps, X, y, nv, b,
                                                   None if tau == 1 else m)
                assert torch.equal(Xb[0], got.Xb[e, m]) and torch.equal(yb[0], got.yb[e, m])
                assert torch.equal(wb[0], got.w[e, m])
        assert out.Xb[0, 0].data_ptr() % sk.EVENT_ALIGN == 0


@pytest.mark.cuda
@pytest.mark.parametrize("graph", sorted(SLOT_GRAPHS))
def test_cuda_slot_liveness_over_a_caller_table(cuda_device, graph):
    """The live pass alone over a caller's table: its slots reversed (a
    prefix still) and a float mask with a hole (not a prefix), at R = 1
    and 4, bitwise the plain version; one count a launch."""
    from distributed_optimization_tpu_torch.parallel import faults

    topo = _slot_topology(graph)
    nbr, mask = topo.nbr_idx.copy(), topo.nbr_mask.copy()
    cnt = mask.sum(1)
    rev = nbr.copy()
    for i in np.nonzero(cnt > 1)[0]:
        rev[i, :cnt[i]] = nbr[i, :cnt[i]][::-1]
    holed = np.where(mask, 0.5 + np.arange(mask.shape[1])[None, :], 0.0).astype(np.float32)
    holed[::3, 0] = 0.0
    for R in (1, 4):
        seeds = list(REPLICA_SEEDS[:R]) if R > 1 else 203
        fm = faults.make_faulty_mixing(topo, seed=seeds, horizon=SLOT_HORIZON,
                                       device=cuda_device, **SLOT_MODES["bursty-churn-restart"])
        for table in (fm.device_table(rev, mask), fm.device_table(nbr, holed)):
            assert isinstance(table, dk.SlotTables)
            for t in (0, 7, SLOT_HORIZON + 5):
                tt = torch.tensor([t], device=cuda_device)
                sk.reset_launch_counts()
                dk.reset_launch_counts()
                got = dk.slot_liveness(tt, table, fm._tl, replicas=R if R > 1 else None)
                assert dk.LAUNCHES["realize_slot_round"] == 1
                for r in range(R):
                    tl = fm._tl.replica(r) if R > 1 else fm._tl
                    want = dk.slot_liveness_plain(tt, table, tl)
                    assert torch.equal(got[r] if R > 1 else got, want), (t, r)


# (name, config fields) of the async event clock's graph runs: sampled
# batches, GT with τ = 2 under churn with neighbor_restart, the full shard,
# and a float64 run under drops and participation.
ASYNC_GRAPH_RUNS = {
    "dsgd-lognormal": dict(latency_model="lognormal", latency_tail=1.25),
    "gt-tau2-churn-restart": dict(algorithm="gradient_tracking", local_steps=2, mttf=8.0,
                                  mttr=3.0, rejoin="neighbor_restart"),
    "dsgd-full-batch": dict(local_batch_size=200),
    "dsgd-float64-faults": dict(dtype="float64", edge_drop_prob=0.2, participation_rate=0.8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ASYNC_GRAPH_RUNS))
def test_cuda_async_graph_run_is_bitwise_its_uncaptured_run(cuda_device, graph_data, name):
    """The event clock's graph run (blocks of events replayed over the
    device cursor, the metrics graph once a window) equals the same events
    run eagerly from the host bit for bit, with the event sampler launched
    once a block of events (none on the full shard) and a faulted run's
    timeline twice; the float64 run also within 1e-12 of the CPU's."""
    from distributed_optimization_tpu_torch.backends import async_scan

    base, ds, f_opt = graph_data["sorted"]
    cfg = base.replace(execution="async", n_iterations=40, eval_every=10,
                       **ASYNC_GRAPH_RUNS[name])
    runs = []
    for capture in (True, False):
        before = _launch_counts()
        res = async_scan.run_async(cfg, ds, f_opt, device="cuda", capture=capture,
                                   return_state=True)
        after = _launch_counts()
        runs.append((res, {k: after[k] - before[k] for k in after}))
    (graph, glaunch), (eager, elaunch) = runs
    np.testing.assert_array_equal(graph.history.objective, eager.history.objective)
    np.testing.assert_array_equal(graph.history.consensus_error, eager.history.consensus_error)
    for key in graph.final_state:
        np.testing.assert_array_equal(graph.final_state[key], eager.final_state[key])
    assert glaunch == elaunch
    events = cfg.n_iterations * cfg.n_workers
    sampled = cfg.local_batch_size < 100
    want = {k: 0 for k in glaunch}
    # One block draw a block of events, whatever τ.
    B = async_scan.event_block(cfg.eval_every * cfg.n_workers)
    want["sample_event_block"] = events // B if sampled else 0
    # A faulted config's chains: the timeline's two launches, once a run.
    want["fault_timeline"] = dk.TIMELINE_LAUNCHES if cfg.faults_active else 0
    assert glaunch == want
    assert np.all(np.isfinite(graph.history.objective)) and graph.history.capture_seconds > 0
    if cfg.dtype == "float64":
        host = async_scan.run_async(cfg, ds, f_opt, device="cpu", return_state=True)
        np.testing.assert_allclose(graph.history.objective, host.history.objective,
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(graph.final_models, host.final_models, rtol=1e-12,
                                   atol=1e-12)
        assert graph.total_floats_transmitted == host.total_floats_transmitted


# --- bfloat16 -----------------------------------------------------------------
#
# The bfloat16 instances of the ring, fc and both sampling kernels: the ring
# kernels bitwise their plain versions at every residue of d and N·d modulo 8
# (the bfloat16 vector width), on a misaligned view and at the compute-bound
# width; the fc kernels bitwise the mirror of their order and within a
# bfloat16 ulp of the twin (both sum in float32 and round once; the neighbour
# sum rounds its total, then the difference); the samplers' indices, weights,
# rows and int32 labels bitwise the twin, the weights the float32 draw's
# cast; a bfloat16 graph run bitwise its measured run with its launches
# counted; every wrapper without a bfloat16 instance raises a TypeError
# naming it, on the card, with no fallback.

BF16_RING_SHAPES = [(3, 1), (5, 8), (7, 6), (9, 7), (11, 5), (13, 3), (37, 12), (256, 41),
                    (256, 81), (256, 1024), (8, 2_097_664)]


def _bf16_ulp(v):
    """A bfloat16 ulp of each |v| (float32)."""
    a = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_RING_SHAPES)
def test_cuda_ring_kernels_bfloat16_bitwise(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    g = (30 * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)
    eta = torch.tensor([0.05 / 7.0], device=cuda_device).to(torch.bfloat16)
    rk.reset_launch_counts()
    for got, want in ((rk.fused_ring_dsgd_step(x, g, eta), rk.fused_ring_dsgd_step_plain(x, g, eta)),
                      (rk.ring_mix(x), rk.ring_mix_plain(x)),
                      (rk.ring_neighbor_sum(x), rk.ring_neighbor_sum_plain(x))):
        assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                            want.view(torch.int16))
    assert rk.LAUNCHES == {name: 1 for name in rk.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 7), (256, 81), (256, 1024)])
def test_cuda_ring_kernels_bfloat16_on_a_misaligned_view(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    n, d = shape
    buf = torch.randn(n * d + 1, generator=gen, device=cuda_device).to(torch.bfloat16)
    x = buf[1:].view(n, d)
    assert x.data_ptr() % 16 != 0
    g = torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    eta = torch.tensor([0.013], device=cuda_device).to(torch.bfloat16)
    assert torch.equal(rk.fused_ring_dsgd_step(x, g, eta), rk.fused_ring_dsgd_step_plain(x, g, eta))
    assert torch.equal(rk.ring_mix(x), rk.ring_mix_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", fk.KERNELS)
@pytest.mark.parametrize("shape", [(3, 1), (9, 7), (25, 81), (256, 41), (256, 81), (1024, 1000),
                                   (4096, 1024)])
def test_cuda_fc_kernels_bfloat16(cuda_device, name, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    x = (4 * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)
    got = getattr(fk, name)(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fk.MIRRORS[name](x, fk.plan_for(name, x)))
    want = getattr(fk, f"{name}_plain")(x)
    total = x.float().sum(0, keepdim=True).expand_as(x)
    tol = _bf16_ulp(got) if name == "fc_mix" else _bf16_ulp(total) + _bf16_ulp(got)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 49, 16), (25, 500, 16), (9, 7, 16), (5, 1, 4),
                                   (4, 1100, 16), (4, 9000, 16)])
def test_cuda_sampling_kernels_bfloat16_bitwise(cuda_device, shape):
    """The float32 run's selection, its weights cast, the rows copied, and
    int32 labels copied bit for bit."""
    n, L, b = shape
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, _ = _rows(cuda_device, n, L, torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    labels = torch.randint(0, 512, (n, L), generator=gen, device=cuda_device,
                           dtype=torch.int32)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    for seed in (0, 2**31 - 1):
        key = prng.fold_in(prng.key(seed, x64=False), 0)
        for counter in (0, 12_345):
            t.fill_(counter)
            w = sk.sample_worker_batch_weights(key, t, nv, L, b, torch.bfloat16)
            assert torch.equal(w, sampling.sample_worker_batch_weights(key, t, nv, L, b,
                                                                       torch.bfloat16))
            assert torch.equal(w, sk.sample_worker_batch_weights(key, t, nv, L, b,
                                                                 torch.float32).to(torch.bfloat16))
            want = sampling.sample_batch_indices(key, t, nv, L, b, torch.bfloat16)
            assert _same(sk.sample_batch_indices(key, t, nv, L, b, torch.bfloat16), want)
            got = sk.sample_worker_batches(key, t, X, labels, nv, b)
            assert got[1].dtype == torch.int32 and got[2].dtype == torch.bfloat16
            assert _same(got, (*sampling.gather_batches(X, labels, want[0]), want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gather_sampler_copies_int32_labels(cuda_device, dtype):
    """Softmax's labels are int32 in every run dtype: the gather form copies
    them beside float32 and float64 rows bit for bit."""
    n, L, b = 25, 500, 16
    nv = _sampling_n_valid(cuda_device, n, L, b)
    X, _ = _rows(cuda_device, n, L, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    labels = torch.randint(0, 512, (n, L), generator=gen, device=cuda_device, dtype=torch.int32)
    key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0)
    t = torch.full((1,), 7, dtype=torch.int64, device=cuda_device)
    got = sk.sample_worker_batches(key, t, X, labels, nv, b)
    assert _same(got, sampling.sample_worker_batches(key, t, X, labels, nv, b))


BF16_GRAPH_RUNS = {
    "dsgd-ring-pallas-dense": dict(mixing_impl="pallas", sampling_impl="dense",
                                   n_samples=800),
    "gt-ring-pallas": dict(algorithm="gradient_tracking", mixing_impl="pallas"),
    "admm-fc-pallas": dict(algorithm="admm", topology="fully_connected", mixing_impl="pallas"),
    "dsgd-ring-drops": dict(edge_drop_prob=0.2, straggler_prob=0.1),
    "dsgd-softmax-ring-pallas": dict(problem_type="softmax", n_classes=7, mixing_impl="pallas"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BF16_GRAPH_RUNS))
def test_cuda_bfloat16_graph_run_is_bitwise_its_measured_run(cuda_device, graph_data, name):
    base, _, _ = graph_data["sorted"]
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    cfg = base.replace(dtype="bfloat16", n_iterations=200, eval_every=10,
                       **BF16_GRAPH_RUNS[name])
    ds = generate_synthetic_dataset(cfg)
    f_opt = compute_reference_optimum(ds, cfg.reg_param)[1]
    graph, graph_launches = _counted_run(cfg, ds, f_opt)
    eager, eager_launches = _counted_run(cfg, ds, f_opt, measure_timestamps=True)
    np.testing.assert_array_equal(graph.history.objective, eager.history.objective)
    np.testing.assert_array_equal(graph.final_models, eager.final_models)
    assert graph_launches == eager_launches
    T = cfg.n_iterations
    want = {k: 0 for k in graph_launches}
    want.update({"dsgd-ring-pallas-dense": {"fused_ring_dsgd_step": T,
                                            "sample_worker_batch_weights": T},
                 "gt-ring-pallas": {"ring_mix": 2 * T, "sample_worker_batches": T},
                 "admm-fc-pallas": {"fc_neighbor_sum": T + 1, "sample_worker_batches": T},
                 "dsgd-ring-drops": {"realize_round": T, "sample_worker_batches": T},
                 "dsgd-softmax-ring-pallas": {"fused_ring_dsgd_step": T,
                                              "sample_worker_batches": T}}[name])
    assert graph_launches == want
    assert np.all(np.isfinite(graph.history.objective))
    assert graph.history.objective[-1] < graph.history.objective[0]


@pytest.mark.cuda
def test_cuda_wrappers_without_a_bfloat16_instance_raise(cuda_device):
    """Noise, slot round and event entry: a TypeError naming bfloat16 on the
    card, never the twin (the robust and compression kernels have bfloat16
    instances, held below)."""
    x = torch.randn((16, 5), device=cuda_device).to(torch.bfloat16)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        dk.large_noise(prng.key(1, x64=False), t, torch.ones(16, dtype=torch.uint8,
                                                             device=cuda_device), x, 1.0)
    from distributed_optimization_tpu_torch.parallel import faults
    from distributed_optimization_tpu_torch.parallel.topology import build_topology

    topo = build_topology("ring", 16, impl="neighbor")
    tables = faults.slot_tables(topo.nbr_idx, topo.nbr_mask, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        dk.realize_slot_round(t, tables, weights=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        sk.sample_event_batch(sampling.event_key(1, x64=False), t,
                              torch.zeros(4, dtype=torch.int64, device=cuda_device),
                              torch.zeros(4, dtype=torch.int64, device=cuda_device),
                              x.reshape(4, 4, 5).contiguous(),
                              torch.zeros((4, 4), dtype=torch.bfloat16, device=cuda_device),
                              torch.full((4,), 4, dtype=torch.int64, device=cuda_device), 2)


# The bfloat16 instances of the robust and compression kernels. The robust
# screen runs in float32 and rounds the aggregate once: the count rules are
# bitwise the twin at every sort width, on the 16-byte path (d % 8 == 0, W
# <= 8) and the element path (other d, wider sorts, a misaligned view);
# clipping's norms sum in another float32 order than the twin's torch.sum,
# so its aggregate is within a bfloat16 ulp (plus float32's clipping
# tolerance) of the twin's, and its D-SGD form is exactly bf16(agg) -
# bf16(eta * g) of its own aggregate. The compression kernel is bitwise the
# twin on the warp and the block paths (float32 uniforms; qsgd's float32
# sum rounded once).


def _bf16(x):
    return torch.as_tensor(x, device="cpu").to(torch.float32).to(torch.bfloat16)


def _robust_bf16(cuda_device, rule, ct, budget, nbr, live, x, offset=0):
    """(kernel, plain) of the aggregator and the step on bfloat16 rows, and
    the step the kernel's own aggregate gives; ``offset`` places x at that
    many elements past a 16-byte boundary."""
    n, d = x.shape
    tl = torch.from_numpy(live).to(cuda_device)
    buf = torch.empty(n * d + offset, dtype=torch.bfloat16, device=cuda_device)
    tx = buf[offset:].view(n, d)
    tx.copy_(_bf16(x).to(cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    g = (30 * torch.randn((n, d), generator=gen, device=cuda_device)).to(torch.bfloat16)
    eta = torch.tensor([0.013], device=cuda_device).to(torch.bfloat16)
    nbr64 = torch.from_numpy(nbr).long().to(cuda_device)
    tau = torch.tensor([ct], dtype=torch.float32, device=cuda_device)
    adaptive = rule == "clipped_gossip" and ct == 0.0
    bk.reset_launch_counts()
    agg = bk.make_fused_robust_aggregator(rule, budget, nbr, ct, device=cuda_device)(tl, tx)
    step = bk.make_fused_robust_dsgd_step(rule, budget, nbr, ct, device=cuda_device)(tl, tx, g,
                                                                                     eta)
    assert bk.LAUNCHES == {name: 1 for name in bk.KERNELS}
    want = bk.fused_robust_plain(rule, budget, nbr64, tl, tx, tau, adaptive=adaptive)
    want_step = bk.fused_robust_plain(rule, budget, nbr64, tl, tx, tau, adaptive=adaptive, g=g,
                                      eta=eta)
    assert agg.dtype == step.dtype == torch.bfloat16
    return tx, tl, nbr64, (agg, want), (step, want_step), agg - eta * g


def _assert_bf16_robust(rule, tx, tl, nbr64, pair, step_pair, own_step):
    (agg, want), (step, want_step) = pair, step_pair
    if rule in COUNT_RULES:
        assert _nan_equal(agg, want) and _nan_equal(step, want_step)
        return
    x = tx.float()
    row_max = x.abs().amax(1)
    nbhd_max = torch.maximum(row_max, torch.where(tl > 0, row_max[nbr64], 0.0).amax(1))
    tol = _bf16_ulp(want) + 1e-5 * nbhd_max[:, None]
    assert bool(torch.all((agg.float() - want.float()).abs() <= tol))
    assert torch.equal(step.view(torch.int16), own_step.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [6, 64])
@pytest.mark.parametrize("rule,ct", SCREENS)
def test_cuda_robust_kernels_bfloat16_match_their_twin(cuda_device, graph, rule, ct, d):
    """k_max 4 and 15 with dead slots and two rows scaled by 1e4: count rules
    bitwise, clipping (adaptive and fixed τ) within a bfloat16 ulp; d = 64
    takes the 16-byte path where the kernel has one."""
    nbr, live, _, x = graph
    if d > x.shape[1]:
        extra = np.random.default_rng(d).standard_normal((x.shape[0], d - x.shape[1]))
        x = np.concatenate([x, extra], 1)
    tx, tl, nbr64, pair, step_pair, own = _robust_bf16(cuda_device, rule, ct, 1, nbr, live, x)
    _assert_bf16_robust(rule, tx, tl, nbr64, pair, step_pair, own)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 41, 128, 129])
@pytest.mark.parametrize("k_max", range(1, 16))
def test_cuda_count_rules_bfloat16_bitwise_at_every_width(cuda_device, k_max, d):
    """Every sort width, budgets 1 to k_max, on values with ties, ±0 and
    ±inf: d = 8 and 128 take 8 columns a thread up to width 8, the others
    one; and on a misaligned view, which takes one."""
    nbr, live, x = random_table(53, k_max, seed=200 + k_max, d=d)
    for rule in COUNT_RULES:
        for budget in sorted({1, max(1, k_max // 2), k_max}):
            for offset in (0, 1):
                tx, tl, nbr64, pair, step_pair, own = _robust_bf16(
                    cuda_device, rule, 0.0, budget, nbr, live, x, offset)
                assert _nan_equal(*pair) and _nan_equal(*step_pair), (rule, budget, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [45, 48])
@pytest.mark.parametrize("k_max", [2, 8, 15])
def test_cuda_count_rules_bfloat16_bitwise_on_columns_with_nan(cuda_device, k_max, d):
    nbr, live, x = random_table(64, k_max, seed=9 * k_max, d=d)
    rng = np.random.default_rng(k_max)
    x[rng.random(x.shape) < 0.03] = np.nan
    for rule in COUNT_RULES:
        _, _, _, pair, step_pair, _ = _robust_bf16(cuda_device, rule, 0.0, 1, nbr, live, x)
        assert _nan_equal(*pair) and _nan_equal(*step_pair) and bool(torch.isnan(pair[1]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [41, 64])
@pytest.mark.parametrize("k_max,ct", [*((k, 0.0) for k in range(1, 17)),
                                      *((k, 0.7) for k in (1, 15, 31, 32, 33, 64))])
def test_cuda_clipping_bfloat16_at_every_width(cuda_device, k_max, ct, d):
    """Adaptive clipping at every k_max it takes, fixed τ on both sides of a
    warp's 32 slots; d = 64 takes 8 columns a lane on the warp path."""
    nbr, live, x = random_table(70, k_max, seed=k_max, d=d, specials=False)
    for offset in (0, 1):
        tx, tl, nbr64, pair, step_pair, own = _robust_bf16(cuda_device, "clipped_gossip", ct, 1,
                                                           nbr, live, x, offset)
        _assert_bf16_robust("clipped_gossip", tx, tl, nbr64, pair, step_pair, own)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COMPRESSION_SHAPES)
@pytest.mark.parametrize("name,k", COMPRESSION_OPERATORS)
def test_cuda_compression_kernel_bfloat16_is_bitwise_its_twin(cuda_device, name, k, shape):
    """memory⁺ bit for bit and the mask bits or qsgd levels equal, on the
    warp and block paths, at seeds past 2³¹, t past 2³¹ and 2³², rounds 0
    and 1; bfloat16 rows tie far more often than float32 rows."""
    n, d = shape
    comp = compression.make_compressor(name, d, d if k is None else min(k, d))
    v, memory = compression_inputs(n, d, torch.float32, cuda_device)
    v, memory = (4 * v).to(torch.bfloat16), memory.to(torch.bfloat16)
    t = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    ck.reset_launch_counts()
    for seed in (203, 2**31 - 1):
        for counter, rnd in ((0, 0), (2**31 - 1, 1), (2**32 + 5, 0)):
            t.fill_(counter)
            draw = compression.Draw(compression.tag_key(seed, x64=False), t, rnd)
            got = ck.ef_compress(comp, draw, v, memory)
            out, levels = ck.ef_levels(comp, draw, v, memory)
            want = compression.ef_compress_plain(comp, draw, v, memory)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
            assert torch.equal(out.view(torch.int16), got.view(torch.int16))
            assert torch.equal(levels, ck.levels_plain(comp, draw, v, memory))
    assert ck.LAUNCHES["compress_exchange"] == 6


@pytest.mark.cuda
def test_cuda_bfloat16_compositions_launch_their_kernels(cuda_device, graph_data):
    """A bfloat16 graph run of the fused robust D-SGD step and of CHOCO
    random_k, each bitwise its measured run, with one launch a step."""
    base, _, _ = graph_data["sorted"]
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    T = 100
    for fields, want in (
            (dict(attack="sign_flip", n_byzantine=1, aggregation="trimmed_mean", robust_b=1,
                  robust_impl="fused", edge_drop_prob=0.1),
             {"make_fused_robust_dsgd_step": T, "realize_round": T, "sample_worker_batches": T}),
            (dict(algorithm="choco", compression="random_k", compression_k=3, choco_gamma=0.3,
                  mixing_impl="pallas"),
             {"compress_exchange": T, "ring_mix": T, "sample_worker_batches": T})):
        cfg = base.replace(dtype="bfloat16", n_iterations=T, eval_every=10, **fields)
        ds = generate_synthetic_dataset(cfg)
        f_opt = compute_reference_optimum(ds, cfg.reg_param)[1]
        graph, graph_launches = _counted_run(cfg, ds, f_opt)
        eager, _ = _counted_run(cfg, ds, f_opt, measure_timestamps=True)
        np.testing.assert_array_equal(graph.history.objective, eager.history.objective)
        np.testing.assert_array_equal(graph.final_models, eager.final_models)
        assert graph_launches == {**{k: 0 for k in graph_launches}, **want}
        assert np.all(np.isfinite(graph.history.objective))
