"""The port's mini-batch sampler on the JAX package's random stream.

The port draws through ``ops/prng.py``, the twin of ``jax.random``
(tests/test_torch_prng.py holds it bitwise against jax 0.9.0). Here: the
scores, dense weights and gather indices equal the JAX package's sampler
(``distributed_optimization_tpu/ops/sampling.py``) bit for bit, in float32
and, under ``enable_x64``, in float64, on ragged shards; and the structural
guarantees that sampler gives hold: the dense and gather forms pick the same
subsets, each worker takes exactly min(b, n_i) valid rows at weight
1/min(b, n_i) rounded through float32, draws are pure functions of their
counters, and inclusion is uniform.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from distributed_optimization_tpu.ops import sampling as ref_sampling
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.ops import prng
from distributed_optimization_tpu_torch.ops.sampling import (
    gather_batches,
    masked_scores,
    sample_batch_indices,
    sample_worker_batch_weights,
    threefry2x32,
)


def _slot(seed, slot, x64=True):
    """The port's slot key, fold_in(key(seed), slot)."""
    return prng.fold_in(prng.key(seed, x64=x64), slot)


# Ragged shards: a full one, a short one, one shorter than the batch, an
# empty one.
N_VALID = torch.tensor([12, 9, 3, 0, 12])
L = 12


@pytest.mark.parametrize("key,ctr,want", [
    # Random123's known-answer vectors for threefry2x32_20.
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    x0, x1 = threefry2x32(key[0], key[1], ctr[0], torch.tensor([ctr[1]]))
    assert (int(x0[0]), int(x1[0])) == want


def test_threefry_matches_jax_threefry():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint64)
    c0 = int(rng.integers(0, 2**32))
    c1 = rng.integers(0, 2**32, size=64, dtype=np.uint64)
    x0, x1 = threefry2x32(int(k[0]), int(k[1]), c0, torch.tensor(c1.astype(np.int64)))
    want = jax_prng.threefry_2x32(
        jnp.asarray(k.astype(np.uint32)),
        jnp.concatenate([jnp.full(64, c0, dtype=jnp.uint32), jnp.asarray(c1.astype(np.uint32))]),
    )
    want = np.asarray(want).astype(np.int64)
    np.testing.assert_array_equal(x0.numpy(), want[:64])
    np.testing.assert_array_equal(x1.numpy(), want[64:])


@pytest.mark.parametrize("batch_size", [1, 4, 12, 16])
def test_dense_and_gather_forms_pick_the_same_rows(batch_size):
    for t in range(20):
        for slot in (0, 1):
            w = sample_worker_batch_weights(_slot(7, slot), t, N_VALID, L, batch_size,
                                            torch.float64)
            idx, wg = sample_batch_indices(_slot(7, slot), t, N_VALID, L, batch_size,
                                           torch.float64)
            dense_from_gather = torch.zeros_like(w)
            dense_from_gather.scatter_add_(1, idx, wg)
            torch.testing.assert_close(w, dense_from_gather, rtol=0, atol=0)


@pytest.mark.parametrize("batch_size", [1, 4, 16])
def test_each_worker_takes_min_b_n_rows_at_equal_weight(batch_size):
    w = sample_worker_batch_weights(_slot(3, 0), 5, N_VALID, L, batch_size, torch.float64)
    for i, ni in enumerate(N_VALID.tolist()):
        eff = min(batch_size, ni, L)
        picked = w[i] > 0
        assert int(picked.sum()) == eff
        assert not bool(picked[ni:].any())  # padding rows carry no weight
        if eff:
            assert torch.all(w[i][picked] == float(np.float32(1.0 / eff)))
    # Gather form: the batch is b rows, the surplus over b_eff weighs 0.
    X = torch.arange(5 * L * 2, dtype=torch.float64).reshape(5, L, 2)
    y = torch.arange(5 * L, dtype=torch.float64).reshape(5, L)
    idx, wb = sample_batch_indices(_slot(3, 0), 5, N_VALID, L, batch_size, X.dtype)
    Xb, yb = gather_batches(X, y, idx)
    assert Xb.shape == (5, batch_size, 2) and yb.shape == wb.shape == (5, batch_size)
    for i, ni in enumerate(N_VALID.tolist()):
        eff = min(batch_size, ni, L)
        assert int((wb[i] > 0).sum()) == eff
        rows = (yb[i][wb[i] > 0] - i * L).long()
        assert len(set(rows.tolist())) == eff and bool((rows < max(ni, 1)).all())


def test_draws_are_pure_functions_of_their_counters():
    def scores(seed, slot, t, n_valid=N_VALID):
        return masked_scores(_slot(seed, slot), t, n_valid, L, torch.float64)

    a = scores(203, 0, 17)
    assert torch.equal(a, scores(203, 0, 17))
    assert not torch.equal(a, scores(203, 0, 18))
    assert not torch.equal(a, scores(203, 1, 17))
    assert not torch.equal(a, scores(204, 0, 17))
    # A worker's draws do not depend on how many workers are drawn with it.
    np.testing.assert_array_equal(scores(203, 0, 17, N_VALID[:2]).numpy(), a[:2].numpy())
    assert bool((a[3] == float("-inf")).all()) and bool((a[0] >= 0).all())


def test_inclusion_rate_is_b_over_n():
    n_valid = torch.tensor([40, 25])
    b, T = 8, 2000
    counts = torch.zeros(2, 40, dtype=torch.float64)
    for t in range(T):
        counts += sample_worker_batch_weights(_slot(11, 0), t, n_valid, 40, b,
                                              torch.float64) > 0
    for i, ni in enumerate(n_valid.tolist()):
        p = b / ni
        sigma = np.sqrt(p * (1 - p) / T)
        rate = counts[i, :ni] / T
        assert float((rate - p).abs().max()) <= 4 * sigma
        assert float(counts[i, ni:].sum()) == 0.0


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("t", [0, 5, 2**31 - 1])
@pytest.mark.parametrize("batch_size", [1, 4, 12, 16])
def test_sampler_draws_the_jax_package_batches_bitwise(x64, t, batch_size):
    """Worker keys, masked scores, dense weights and gathered batches equal
    the JAX package's sampler at the same slot key, bit for bit: float32
    scores and weights without x64, float64 scores and float32-rounded
    weights with it, on a full, a short, a tiny and an empty shard."""
    seed, slot = 42, 1
    dtype = torch.float64 if x64 else torch.float32
    n_valid = N_VALID.numpy()
    X = np.random.default_rng(0).standard_normal((5, L, 3))
    y = np.tile(np.arange(L, dtype=np.float64), (5, 1))  # a row's label is its index
    with enable_x64() if x64 else contextlib.nullcontext():
        key = jax.random.fold_in(jax.random.key(seed), slot)
        nv = jnp.asarray(n_valid)
        ref_keys = ref_sampling._worker_keys(key, t, 5)
        ref_scores = jax.vmap(lambda k, n: ref_sampling._masked_scores(k, L, n))(ref_keys, nv)
        ref_w = ref_sampling.sample_worker_batch_weights(key, t, nv, L, batch_size)
        ref_Xb, ref_yb, ref_wb = ref_sampling.sample_worker_batches(
            key, t, jnp.asarray(X, dtype=jnp.float64 if x64 else jnp.float32),
            jnp.asarray(y, dtype=jnp.float64 if x64 else jnp.float32), nv, batch_size)
        ref_keys = np.asarray(jax.random.key_data(ref_keys)).astype(np.int64)
        ref_scores, ref_w, ref_yb, ref_wb = (np.asarray(a) for a in (ref_scores, ref_w, ref_yb,
                                                                     ref_wb))
    skey = _slot(seed, slot, x64=x64)
    np.testing.assert_array_equal(
        prng.fold_in(prng.fold_in(skey, t), torch.arange(5)).numpy(), ref_keys)
    scores = masked_scores(skey, t, N_VALID, L, dtype).numpy()
    assert scores.dtype == ref_scores.dtype
    assert np.array_equal(scores, ref_scores)  # -inf equal to -inf
    w = sample_worker_batch_weights(skey, t, N_VALID, L, batch_size, dtype).numpy()
    assert ref_w.dtype == np.float32 and np.array_equal(w, ref_w.astype(w.dtype))
    idx, wb = sample_batch_indices(skey, t, N_VALID, L, batch_size, dtype)
    np.testing.assert_array_equal(idx.numpy(), ref_yb.astype(np.int64))
    assert np.array_equal(wb.numpy(), ref_wb.astype(wb.numpy().dtype))
