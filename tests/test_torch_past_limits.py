"""Draws past the two limits the card used to refuse, on the CPU.

- Counters at and past 2³²: the twin of ``jax.random`` (``ops/prng.py``)
  feeds Threefry the 64-bit flat index as its (high, low) words, as JAX's
  ``iota_2x32_shape`` does, so an element past 2³² of a large draw (a
  compressed stack of N·d ≥ 2³² elements) is JAX's. Held against JAX's own
  ``threefry2x32`` primitive fed the same pairs, and against
  ``jax.random.bits`` on a draw whose flat indices reach past 2³² in its
  high word alone (a tiny shape is enough: the primitive sees only the
  words).
- Batches whose survivors do not fit in a block's shared memory (b = L =
  16,384 in float32, b = 12,288 in float64): the sampler's twin, which the
  card's kernel equals bit for bit, runs there and draws a valid batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from distributed_optimization_tpu_torch.ops import prng, sampling

COUNTERS = [0, 2**32 - 1, 2**32, 2**32 + 5, 2**33 + 12_345, 3 * 2**40 + 7, 2**62 + 99]


@pytest.mark.parametrize("seed", [0, 203, 2**31 - 1])
def test_words_past_two_to_the_32_are_jax_s(seed):
    rng = np.random.default_rng(seed)
    key = prng.fold_in(prng.key(seed, x64=False), int(rng.integers(2**32)))
    counters = torch.tensor(COUNTERS + [int(c) for c in rng.integers(2**32, 2**63, 32)])
    x0, x1 = prng._words_at(key, counters)
    hi = jnp.asarray((counters.numpy() >> 32).astype(np.uint32))
    lo = jnp.asarray((counters.numpy() & 0xFFFFFFFF).astype(np.uint32))
    k0 = jnp.full(hi.shape, key[0], dtype=jnp.uint32)
    k1 = jnp.full(hi.shape, key[1], dtype=jnp.uint32)
    want0, want1 = jax_prng.threefry2x32_p.bind(k0, k1, hi, lo)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(want0).astype(np.int64))
    np.testing.assert_array_equal(x1.numpy(), np.asarray(want1).astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_at_past_two_to_the_32_is_the_bits_jax_draws(dtype):
    """uniform_at at a counter c ≥ 2³² is the float of JAX's bits at the
    pair (c >> 32, c mod 2³²), through the twin's float conversion."""
    key = prng.fold_in(prng.key(7, x64=True), 11)
    counters = torch.tensor(COUNTERS)
    got = prng.uniform_at(key, counters, dtype)
    x0, x1 = jax_prng.threefry2x32_p.bind(
        jnp.full((len(COUNTERS),), key[0], dtype=jnp.uint32),
        jnp.full((len(COUNTERS),), key[1], dtype=jnp.uint32),
        jnp.asarray([c >> 32 for c in COUNTERS], dtype=jnp.uint32),
        jnp.asarray([c & 0xFFFFFFFF for c in COUNTERS], dtype=jnp.uint32))
    x0, x1 = np.asarray(x0).astype(np.uint64), np.asarray(x1).astype(np.uint64)
    if dtype == torch.float32:
        m = ((x0 ^ x1) >> np.uint64(9)).astype(np.float64)
        want = m * 2.0**-23
    else:
        m = (((x0 << np.uint64(32)) | x1) >> np.uint64(12)).astype(np.float64)
        want = m * 2.0**-52
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
    # Below 2³² the pair is (0, c): the element of an ordinary draw.
    with jax.enable_x64(dtype == torch.float64):
        small = np.asarray(jax.random.uniform(jax.random.wrap_key_data(
            jnp.asarray(key, dtype=jnp.uint32)), (2, 3),
            dtype=jnp.float64 if dtype == torch.float64 else jnp.float32))
    np.testing.assert_array_equal(prng.uniform_at(key, torch.arange(6).reshape(2, 3),
                                                  dtype).numpy(), small)


@pytest.mark.parametrize("dtype,L,b", [(torch.float32, 16_384, 16_384),
                                       (torch.float64, 4_096, 12_288),
                                       (torch.float64, 12_288, 12_288)])
def test_sampler_twin_runs_past_shared_memory(dtype, L, b):
    n = 3
    n_valid = torch.tensor([L, L - 3, 17], dtype=torch.int64)
    key = prng.fold_in(prng.key(42, x64=dtype == torch.float64), 1)
    t = torch.tensor([2**31 - 1])
    idx, w = sampling.sample_batch_indices(key, t, n_valid, L, b, dtype)
    assert idx.shape == (n, b) and w.shape == (n, b)
    for i in range(n):
        nv = int(n_valid[i])
        eff = min(b, nv, L)
        k = min(b, L)
        head = idx[i, :eff]
        assert len(set(head.tolist())) == eff and int(head.max()) < nv
        np.testing.assert_array_equal(idx[i].numpy(), idx[i, torch.arange(b) % k].numpy())
        assert torch.all(w[i, :eff] == torch.tensor(np.float32(1.0 / eff), dtype=dtype))
        assert torch.all(w[i, eff:] == 0)
    dense = sampling.sample_worker_batch_weights(key, t, n_valid, L, b, dtype)
    np.testing.assert_array_equal(
        dense.numpy(), torch.zeros((n, L), dtype=dtype).scatter_add_(1, idx, w).numpy())
