"""The port's counter-based mini-batch sampler.

The port draws from Threefry-2x32 keyed by (seed, slot) with counter (t,
worker·L + row); its bits are not ``jax.random``'s, so these tests hold the
structural guarantees the JAX package's sampler gives
(``ops/sampling.py``): the dense and gather forms pick the same subsets,
each worker takes exactly min(b, n_i) valid rows at weight 1/min(b, n_i),
draws are pure functions of their counters, and inclusion is uniform.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from distributed_optimization_tpu_torch.ops.sampling import (
    row_scores,
    sample_batch_indices,
    sample_worker_batch_weights,
    sample_worker_batches,
    threefry2x32,
)

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
            w = sample_worker_batch_weights(7, slot, t, N_VALID, L, batch_size, torch.float64)
            idx, wg = sample_batch_indices(7, slot, t, N_VALID, L, batch_size, torch.float64)
            dense_from_gather = torch.zeros_like(w)
            dense_from_gather.scatter_add_(1, idx, wg)
            torch.testing.assert_close(w, dense_from_gather, rtol=0, atol=0)


@pytest.mark.parametrize("batch_size", [1, 4, 16])
def test_each_worker_takes_min_b_n_rows_at_equal_weight(batch_size):
    w = sample_worker_batch_weights(3, 0, 5, N_VALID, L, batch_size, torch.float64)
    for i, ni in enumerate(N_VALID.tolist()):
        eff = min(batch_size, ni, L)
        picked = w[i] > 0
        assert int(picked.sum()) == eff
        assert not bool(picked[ni:].any())  # padding rows carry no weight
        if eff:
            assert torch.all(w[i][picked] == 1.0 / eff)
    # Gather form: the batch is b rows, the surplus over b_eff weighs 0.
    X = torch.arange(5 * L * 2, dtype=torch.float64).reshape(5, L, 2)
    y = torch.arange(5 * L, dtype=torch.float64).reshape(5, L)
    Xb, yb, wb = sample_worker_batches(3, 0, 5, X, y, N_VALID, batch_size)
    assert Xb.shape == (5, batch_size, 2) and yb.shape == wb.shape == (5, batch_size)
    for i, ni in enumerate(N_VALID.tolist()):
        eff = min(batch_size, ni, L)
        assert int((wb[i] > 0).sum()) == eff
        rows = (yb[i][wb[i] > 0] - i * L).long()
        assert len(set(rows.tolist())) == eff and bool((rows < max(ni, 1)).all())


def test_draws_are_pure_functions_of_their_counters():
    a = row_scores(203, 0, 17, N_VALID, L)
    assert torch.equal(a, row_scores(203, 0, 17, N_VALID, L))
    assert not torch.equal(a, row_scores(203, 0, 18, N_VALID, L))
    assert not torch.equal(a, row_scores(203, 1, 17, N_VALID, L))
    assert not torch.equal(a, row_scores(204, 0, 17, N_VALID, L))
    # A worker's draws do not depend on how many workers are drawn with it.
    np.testing.assert_array_equal(row_scores(203, 0, 17, N_VALID[:2], L).numpy(), a[:2].numpy())
    assert bool((a[3] == -1).all()) and bool((a[0] >= 0).all())


def test_inclusion_rate_is_b_over_n():
    n_valid = torch.tensor([40, 25])
    b, T = 8, 2000
    counts = torch.zeros(2, 40, dtype=torch.float64)
    for t in range(T):
        counts += sample_worker_batch_weights(11, 0, t, n_valid, 40, b, torch.float64) > 0
    for i, ni in enumerate(n_valid.tolist()):
        p = b / ni
        sigma = np.sqrt(p * (1 - p) / T)
        rate = counts[i, :ni] / T
        assert float((rate - p).abs().max()) <= 4 * sigma
        assert float(counts[i, ni:].sum()) == 0.0
