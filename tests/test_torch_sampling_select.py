"""The gather sampling kernel's selection, mirrored in PyTorch ops, against the
twin's stable sort; and the gather form's batches against the JAX package's.

``ops/sampling_kernels.select_mirror`` repeats the kernel's algorithm
(csrc/sampling_kernels.cu): one key a row (the score above L − 1 − row,
left-aligned in 64 bits, or 128 for float64 past L = 2,048), a radix select
over 8-bit digits from the top until at most k + 128 rows survive, the
survivors ranked among themselves, padding rows after the valid ones, and the
top k = min(b, L) rows tiled up to b. Here it is held bit for bit to the
stable descending sort that the twin (``ops/sampling.py``) and
``lax.top_k`` take, on integer scores with forced ties, all-equal scores,
padding, empty shards, L < b, L = 1 and the float64 packing boundary; on the
card ``tests/test_torch_cuda.py`` holds the kernel's selection to the
mirror. The port's ``sample_worker_batches`` (CPU: the twin's indices and
``gather_batches``) equals the JAX package's ``sample_worker_batches``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from distributed_optimization_tpu.ops import sampling as ref_sampling
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.ops import prng, sampling
from distributed_optimization_tpu_torch.ops import sampling_kernels as sk

DTYPES = [torch.float32, torch.float64]


def stable_top(scores: torch.Tensor, b: int, n_valid=None) -> torch.Tensor:
    """The twin's order: a stable descending sort (padding rows, given by
    ``n_valid``, at -inf), its first min(b, L) rows tiled up to b."""
    n, L = scores.shape
    s = scores.double()
    if n_valid is not None:
        s = torch.where(torch.arange(L)[None, :] < n_valid[:, None], s, float("-inf"))
    k = min(b, L)
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :k]
    return order[:, torch.arange(b) % k]


def tie_scores(seed: int, n: int, L: int, levels: int, dtype) -> torch.Tensor:
    """Integer scores in [0, levels], from a seed: few levels force ties
    (0 everywhere at levels = 0), 2^(SCORE_BITS − 1) spans the full range."""
    hi = min(levels, 1 << (sk.SCORE_BITS[dtype] - 1))
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, hi + 1, size=(n, L), dtype=np.int64))


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 3),
       L=st.one_of(st.integers(1, 70), st.sampled_from([128, 255, 256, 257, 500, 1025])),
       b=st.integers(1, 40), levels=st.sampled_from([0, 1, 2, 7, 255, 1 << 23, 1 << 52]),
       dtype=st.sampled_from(DTYPES))
def test_mirror_is_the_stable_sort_on_tied_scores(seed, n, L, b, levels, dtype):
    scores = tie_scores(seed, n, L, levels, dtype)
    got, passes = sk.select_mirror(scores, b, dtype)
    assert torch.equal(got, stable_top(scores, b))
    assert bool((passes >= 1).all())


@pytest.mark.parametrize("levels", [0, 1, 5, 1 << 52])
@pytest.mark.parametrize("L", [2047, 2048, 2049, 4100])
def test_mirror_across_the_float64_packing_boundary(L, levels):
    """53 score bits and ⌈log2 L⌉ row bits fit in 64 up to L = 2,048; past
    it the key takes 128 bits. Both orders are the stable sort's."""
    scores = tie_scores(L + levels % 97, 2, L, levels, torch.float64)
    limbs, width = sk.selection_keys(scores, torch.float64)
    assert width == (64 if L <= 2048 else 128) and len(limbs) == width // 32
    got, _ = sk.select_mirror(scores, 16, torch.float64)
    assert torch.equal(got, stable_top(scores, 16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [1, 2, 49, 500, 2049])
def test_selection_keys_are_distinct_and_order_rows_as_the_stable_sort(L, dtype):
    """Sorting rows by their packed keys, largest first, is the stable
    descending sort of the scores, ties to the lower row."""
    scores = tie_scores(L, 1, L, 3, dtype)
    limbs, width = sk.selection_keys(scores, dtype)
    key = [limb[0].tolist() for limb in limbs]
    packed = [sum(key[j][l] << (32 * j) for j in range(width // 32)) for l in range(L)]
    assert len(set(packed)) == L and max(packed) < 1 << width
    order = sorted(range(L), key=lambda l: -packed[l])
    assert order == stable_top(scores, L)[0].tolist()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_take_more_radix_passes_and_stay_exact(dtype):
    """Equal scores leave every row in the threshold bin until the passes
    reach the row bits; a full-range draw ends in one pass."""
    for levels, L, more in [(0, 500, True), (1, 1100, True), (1 << 52, 500, False)]:
        scores = tie_scores(7, 3, L, levels, dtype)
        got, passes = sk.select_mirror(scores, 16, dtype)
        assert torch.equal(got, stable_top(scores, 16))
        assert bool((passes > 1).all()) if more else bool((passes == 1).all())


N_VALID = torch.tensor([500, 0, 3, 15, 16, 17, 500, -2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,b", [(500, 16), (49, 16), (7, 16), (1, 4), (500, 1), (2049, 40)])
def test_mirror_on_the_draw_is_the_twin(L, b, dtype):
    """On the draw's integer scores, with padding rows past n_valid (empty,
    short, about b, negative), the mirror gives the twin's indices."""
    key = prng.fold_in(prng.key(42, x64=dtype == torch.float64), 1)
    nv = N_VALID.clamp(max=L)
    scores = sk.draw_scores(key, 12_345, nv, L, dtype)
    assert int(scores.max()) <= 1 << (sk.SCORE_BITS[dtype] - 1)
    want, _ = sampling.sample_batch_indices(key, 12_345, nv, L, b, dtype)
    got, _ = sk.select_mirror(scores, b, dtype, n_valid=nv)
    assert torch.equal(got, want)
    assert torch.equal(got, stable_top(scores, b, n_valid=nv))


@pytest.mark.parametrize("dtype", DTYPES)
def test_draw_scores_are_the_uniform_mantissa_plus_one(dtype):
    key = prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0)
    nv = torch.tensor([49, 0, 3])
    u = sampling.masked_scores(key, 7, nv, 49, dtype)
    scores = sk.draw_scores(key, 7, nv, 49, dtype)
    valid = ~torch.isinf(u)
    assert bool((scores[~valid] == 0).all()) and bool((scores[valid] >= 1).all())
    m = (scores[valid] - 1).to(torch.float64) * 2.0 ** -(sk.SCORE_BITS[dtype] - 1)
    assert torch.equal(m.to(dtype), u[valid])


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("t", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("batch_size", [1, 4, 16, 20])
def test_sample_worker_batches_is_the_jax_package_function(x64, t, batch_size):
    """(Xb, yb, weights) of the port's gather form on the CPU equal the JAX
    package's ``sample_worker_batches`` at the same slot key, bit for bit,
    in float32 and, under enable_x64, float64, on full, short, tiny and
    empty shards of L = 17 rows (b = 20 tiles the shard)."""
    seed, slot, L, d = 11, 2, 17, 5
    dtype = torch.float64 if x64 else torch.float32
    n_valid = np.array([17, 9, 3, 0, 17])
    rng = np.random.default_rng(t + batch_size)
    X = rng.standard_normal((5, L, d))
    y = rng.standard_normal((5, L))
    with enable_x64() if x64 else contextlib.nullcontext():
        jdt = jnp.float64 if x64 else jnp.float32
        key = jax.random.fold_in(jax.random.key(seed), slot)
        want = ref_sampling.sample_worker_batches(key, t, jnp.asarray(X, dtype=jdt),
                                                  jnp.asarray(y, dtype=jdt),
                                                  jnp.asarray(n_valid), batch_size)
        want = [np.asarray(a) for a in want]
    got = sk.sample_worker_batches(prng.fold_in(prng.key(seed, x64=x64), slot), t,
                                   torch.as_tensor(X, dtype=dtype),
                                   torch.as_tensor(y, dtype=dtype),
                                   torch.as_tensor(n_valid), batch_size)
    assert got[0].dtype == got[1].dtype == got[2].dtype == dtype
    for g, w in zip(got[:2], want[:2]):
        assert w.dtype == g.numpy().dtype and np.array_equal(g.numpy(), w)
    assert want[2].dtype == np.float32 and np.array_equal(got[2].numpy(),
                                                          want[2].astype(got[2].numpy().dtype))
