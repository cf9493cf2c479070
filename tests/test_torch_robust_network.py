"""The count-rule and clipping kernels' own logic, mirrored on the CPU.

The CUDA kernels of ``csrc/robust_kernels.cu`` run only on the card; these
tests hold a torch mirror of what they compute against the plain version
(``fused_robust_plain``), bitwise:

- Batcher's odd-even merge network (``merge_network``, the list the kernel
  generates at compile time) sorts every width W = 2…16 (0-1 principle);
- a NaN-free column sorted by that network, with any choice of where +0 and
  -0 land, and selected as the kernel selects (kept positions from float
  counts, only the kept ones added; median picks as selects plus +0), gives
  the plain version's bits for every budget, on ties, ±0, ±inf and dead
  slots; a column with a NaN needs the transposition network, which the
  kernel runs for it;
- the adaptive radius as the (deg - b)-th stable rank across the slots, with
  the network for a NaN norm, is the plain one-hot pick;
- the warp's reduce-scatter leaves slot s's sum in lane s << (5 - log2 KB).

The kernels themselves are held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from distributed_optimization_tpu_torch.ops import robust_kernels as rk
from test_torch_cuda import COUNT_RULES, random_table

WIDTHS = range(2, 17)


def _min_max(a, b):
    return torch.minimum(a, b), torch.maximum(a, b)


def _select(a, b):
    """float64's exchange: one compare and selects; equal values swap."""
    swap = b < a
    return torch.where(swap, b, a), torch.where(swap, a, b)


def _zeros_low_negative(a, b):
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    return torch.where(lo == 0, -0.0, lo), torch.where(hi == 0, 0.0, hi)


def _zeros_low_positive(a, b):
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    return torch.where(lo == 0, 0.0, lo), torch.where(hi == 0, -0.0, hi)


# Any compare-exchange that orders two non-NaN values, whatever it does with
# the signs of equal zeros.
EXCHANGES = {"min_max": _min_max, "select": _select, "zeros_low_negative": _zeros_low_negative,
             "zeros_low_positive": _zeros_low_positive}


def _slot_sum(lv):
    deg = torch.zeros_like(lv[:, 0])
    for col in lv.unbind(1):
        deg = deg + col
    return deg


def count_rule_mirror(rule, budget, nbr, live, x, exchange, nan_branch=True):
    """What count_rule_kernel computes, in torch ops on the CPU."""
    acc = torch.promote_types(torch.float32, x.dtype)
    xa, lv = x.to(acc), live.to(acc)
    width = nbr.shape[1] + 1
    vals = torch.where(lv[:, :, None] > 0, xa[nbr], torch.inf)
    closed = torch.cat([xa[:, None, :], vals], dim=1)
    cols = list(closed.unbind(1))
    for a, b in rk.merge_network(width):
        cols[a], cols[b] = exchange(cols[a], cols[b])
    s = torch.stack(cols, dim=1)
    if nan_branch:
        has_nan = torch.isnan(closed).any(dim=1, keepdim=True)
        s = torch.where(has_nan, rk.sort_columns(closed), s)
    counts = _slot_sum(lv) + 1.0
    pos = torch.arange(width, dtype=acc)
    if rule == "trimmed_mean":
        upper = counts - budget
        kept = torch.clamp(counts - 2 * budget, min=0.0)
        stop = (pos[None, :] < upper[:, None]).sum(dim=1)  # T(s) < upper for s < stop
        total = torch.zeros_like(xa)
        for p, col in enumerate(s.unbind(1)):
            keep = (p >= budget) & (p < stop)
            total = torch.where(keep[:, None], total + col, total)
        mean = total / torch.clamp(kept, min=1.0)[:, None]
        agg = torch.where((kept >= 1.0)[:, None], mean, xa)
    else:
        lo = torch.clamp(torch.floor((counts - 1.0) / 2.0), min=0.0)
        hi = torch.clamp(torch.floor(counts / 2.0), min=0.0)
        pick_lo, pick_hi = torch.zeros_like(xa), torch.zeros_like(xa)
        for p, col in enumerate(s.unbind(1)):
            pick_lo = torch.where((lo == p)[:, None], col, pick_lo)
            pick_hi = torch.where((hi == p)[:, None], col, pick_hi)
        agg = 0.5 * ((0.0 + pick_lo) + (0.0 + pick_hi))
    return agg.to(x.dtype)


def _plain(rule, budget, nbr, live, x):
    return rk.fused_robust_plain(rule, budget, nbr, live, x, torch.zeros(1, dtype=x.dtype),
                                 adaptive=False)


def _bits_equal(a, b):
    return bool(torch.all((a == b) & (torch.signbit(a) == torch.signbit(b))
                          | (torch.isnan(a) & torch.isnan(b))))


def _instance(width, seed, live_values=(0.0, 1.0)):
    nbr, live, x = random_table(23, width - 1, seed=seed, d=9)
    rng = np.random.default_rng(seed)
    if live_values != (0.0, 1.0):
        live = rng.choice(np.asarray(live_values, dtype=np.float32), size=live.shape)
    return torch.from_numpy(nbr).long(), torch.from_numpy(live), x


@pytest.mark.parametrize("width", WIDTHS)
def test_merge_network_sorts_every_width(width):
    """0-1 principle: a comparator network sorts every input iff it sorts
    every 0/1 input. Batcher's network for 16 has 63 compare-exchanges, the
    transposition network 120."""
    pairs = rk.merge_network(width)
    assert all(0 <= a < b < width for a, b in pairs)
    v = (np.arange(2 ** width)[:, None] >> np.arange(width)) & 1
    for a, b in pairs:
        v[:, a], v[:, b] = np.minimum(v[:, a], v[:, b]), np.maximum(v[:, a], v[:, b])
    assert (np.diff(v, axis=1) >= 0).all()
    assert len(pairs) <= width * (width - 1) // 2
    if width == 16:
        assert len(pairs) == 63


@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_selection_is_the_plain_version_bitwise(width):
    """Every budget check_rule allows (past width // 2 + 1 every row keeps
    its own model), both rules and dtypes, four ways of ordering zeros."""
    nbr, live, x64 = _instance(width, seed=width)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(x64).to(dtype)
        for rule in COUNT_RULES:
            for budget in range(1, width // 2 + 2):
                want = _plain(rule, budget, nbr, live, x)
                for name, exchange in EXCHANGES.items():
                    got = count_rule_mirror(rule, budget, nbr, live, x, exchange)
                    assert _bits_equal(got, want), (rule, budget, dtype, name)


@pytest.mark.parametrize("width", [3, 9, 16])
def test_kernel_selection_with_fractional_liveness(width):
    """Counts, kept positions and picks are floats in the working type, as
    in the plain version, so non-0/1 liveness selects the same positions."""
    nbr, live, x64 = _instance(width, seed=40 + width, live_values=(0.0, 0.5, 1.0, 1.5))
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(x64).to(dtype)
        for rule in COUNT_RULES:
            for budget in (1, 2):
                got = count_rule_mirror(rule, budget, nbr, live, x, _min_max)
                assert _bits_equal(got, _plain(rule, budget, nbr, live, x)), (rule, budget)


def _fmin_fmax(a, b):
    """float32's exchange on a NaN: fminf/fmaxf drop it."""
    return torch.fmin(a, b), torch.fmax(a, b)


@pytest.mark.parametrize("width", [3, 8, 16])
def test_nan_columns_need_the_transposition_network(width):
    """The fast exchanges do not propagate a NaN (fminf/fmaxf drop it, the
    float64 selects leave it in place), so without the kernel's branch to
    the transposition network a column with a NaN would not give the plain
    bits; with it, it does."""
    nbr, live, x64 = _instance(width, seed=70 + width)
    x64[np.random.default_rng(width).random(x64.shape) < 0.08] = np.nan
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(x64).to(dtype)
        for rule in COUNT_RULES:
            want = _plain(rule, 1, nbr, live, x)
            assert bool(torch.isnan(want).any())
            for exchange in (_fmin_fmax, _select):
                assert _bits_equal(count_rule_mirror(rule, 1, nbr, live, x, exchange), want)
                unbranched = count_rule_mirror(rule, 1, nbr, live, x, exchange, nan_branch=False)
                assert not _bits_equal(unbranched, want), (rule, dtype, exchange.__name__)


def adaptive_tau_mirror(lv, norms, budget, k_max):
    """clip_warp_kernel's radius: the norm of stable rank (deg - b - 1) across
    the lanes, or the transposition network where a live norm is NaN."""
    deg = _slot_sum(lv)
    val = torch.where(lv > 0, norms, torch.inf)
    k = torch.clamp(deg - budget - 1.0, 0.0, float(k_max - 1))
    t = torch.arange(k_max)
    before = (val[:, None, :] < val[:, :, None]) | (
        (val[:, None, :] == val[:, :, None]) & (t[None, None, :] < t[None, :, None]))
    rank = before.sum(dim=2).to(val.dtype)
    hit = rank == k[:, None]
    first = torch.argmax(hit.to(torch.int8), dim=1)
    kth = torch.where(hit.any(dim=1), val.gather(1, first[:, None])[:, 0], 0.0)
    tau = torch.where(deg - budget >= 1.0, kth, 0.0)
    # A row with a NaN norm: lane 0 runs the plain network and pick.
    return torch.where(torch.isnan(val).any(dim=1), rk._adaptive_tau(lv, norms, budget, k_max), tau)


@pytest.mark.parametrize("k_max", range(1, 17))
def test_stable_rank_radius_is_the_plain_pick(k_max):
    rng = np.random.default_rng(k_max)
    n = 200
    norms = rng.choice([0.0, 0.5, 1.0, 2.0, 3.5, np.inf], size=(n, k_max))
    drawn = rng.random(norms.shape) < 0.3
    norms[drawn] = rng.random(int(drawn.sum()))
    live = (rng.random((n, k_max)) >= 0.25).astype(np.float64)
    nan_rows = rng.random(n) < 0.1
    norms[nan_rows, rng.integers(0, k_max, size=int(nan_rows.sum()))] = np.nan
    for dtype in (torch.float32, torch.float64):
        tn, tl = torch.from_numpy(norms).to(dtype), torch.from_numpy(live).to(dtype)
        for budget in range(1, k_max + 1):
            got = adaptive_tau_mirror(tl, tn, budget, k_max)
            want = rk._adaptive_tau(tl, tn, budget, k_max)
            assert _bits_equal(got, want), (budget, dtype)


def reduce_scatter_mirror(parts):
    """clip_warp_kernel's reduce_scatter over 32 simulated lanes: parts[lane,
    slot] -> the value each lane ends with."""
    v = parts.copy()
    kb = v.shape[1]
    c = kb
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        partner = lanes ^ o
        if c > 1:
            c //= 2
            upper = (lanes & o) != 0
            keep = np.where(upper[:, None], v[:, c:2 * c], v[:, :c])
            send = np.where(upper[:, None], v[:, :c], v[:, c:2 * c])
            v[:, :c] = keep + send[partner]
        else:
            v[:, 0] = v[:, 0] + v[partner, 0]
    return v[:, 0]


@pytest.mark.parametrize("kb", [2, 4, 8, 16, 32])
def test_reduce_scatter_leaves_each_slot_sum_where_the_kernel_reads_it(kb):
    parts = np.random.default_rng(kb).integers(-50, 50, size=(32, kb)).astype(np.float64)
    out = reduce_scatter_mirror(parts)
    shift = 5 - int(np.log2(kb))
    for s in range(kb):
        assert out[s << shift] == parts[:, s].sum()
