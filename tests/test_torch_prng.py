"""The port's twin of ``jax.random`` (ops/prng.py) against jax 0.9.0, bit for bit.

``key``, ``fold_in``, ``random_bits`` and ``uniform`` over the seeds, slots
and counters the sampler meets (t up to 2³² − 1), in float32 without
``enable_x64`` and float64 with it (the JAX package's float64 runs take its
scope); keys as Python ints and as int64 tensors, batched as ``jax.vmap``
batches them. Also: ``chip_smoke.KNOWN_ANSWERS``, the digests the card's
sampling kernel is held to, recomputed from the JAX package's sampler.
"""

import contextlib
import hashlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.ops import sampling as ref_sampling
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.ops import prng

SEEDS = [0, 42, 203, 2**31 - 1]
SEEDS_X64 = [*SEEDS, 2**32, 2**40 + 5, 2**63 - 1]
DATA = [0, 1, 7, 12_345, 2**31 - 1, 2**31, 2**32 - 1]


def _scope(x64):
    return enable_x64() if x64 else contextlib.nullcontext()


def _words(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("x64", [False, True])
def test_key_is_jax_random_key(x64):
    with _scope(x64):
        for seed in SEEDS_X64 if x64 else SEEDS:
            assert prng.key(seed, x64=x64) == _words(jax.random.key(seed))


def test_key_without_x64_keeps_the_low_word_as_jax_does():
    for seed in (2**31, 2**32 + 5, -5):
        assert prng.key(seed, x64=False) == _words(jax.random.key(seed))


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_jax_fold_in_for_int_and_tensor_data(seed, x64):
    with _scope(x64):
        key = jax.random.key(seed)
        ours = prng.key(seed, x64=x64)
        for data in DATA:
            want = _words(jax.random.fold_in(key, data))
            assert prng.fold_in(ours, data) == want
            got = prng.fold_in(ours, torch.tensor([data]))
            assert got.shape == (1, 2) and tuple(got[0].tolist()) == want
            assert tuple(prng.fold_in(torch.tensor(ours), data).tolist()) == want
        batch = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(300))
        got = prng.fold_in(ours, torch.arange(300))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.key_data(batch)))


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_are_jax_bits(seed, width):
    with _scope(width == 64):
        key = jax.random.fold_in(jax.random.key(seed), 3)
        dtype = jnp.uint64 if width == 64 else jnp.uint32
        want = np.asarray(jax.random.bits(key, (7, 61), dtype))
        ours = prng.fold_in(prng.key(seed, x64=width == 64), 3)
        got = prng.random_bits(ours, (7, 61), width).numpy()
    if width == 64:
        np.testing.assert_array_equal(got, want.view(np.int64))
    else:
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t", [0, 5, 2**31 - 1, 2**32 - 1])
def test_uniform_is_jax_uniform_bitwise(dtype, t):
    """The sampler's chain: fold_in(fold_in(fold_in(key(seed), slot), t),
    worker), then uniform over L rows, for a batch of workers at once."""
    x64 = dtype == torch.float64
    seeds = SEEDS_X64 if x64 else SEEDS
    with _scope(x64):
        for seed in seeds:
            for slot in (0, 2):
                step = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), slot), t)
                keys = jax.vmap(lambda i: jax.random.fold_in(step, i))(jnp.arange(6))
                want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (49,)))(keys))
                ours = prng.fold_in(prng.fold_in(prng.fold_in(prng.key(seed, x64=x64), slot),
                                                 torch.tensor([t])), torch.arange(6))
                got = prng.uniform(ours, (49,), dtype).numpy()
                assert got.dtype == want.dtype
                assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (seed, slot)
                assert got.min() >= 0.0 and got.max() < 1.0


def test_uniform_of_an_int_key_on_a_shape():
    with enable_x64():
        want = np.asarray(jax.random.uniform(jax.random.key(9), (3, 4, 5)))
    got = prng.uniform(prng.key(9, x64=True), (3, 4, 5), torch.float64).numpy()
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="int64"):
        prng.fold_in(torch.zeros(3, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="width"):
        prng.random_bits((0, 1), (3,), 16)
    with pytest.raises(ValueError, match="float32 or float64"):
        prng.uniform((0, 1), (3,), torch.float16)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_known_answers_are_the_jax_package_s():
    """The digests ``chip_smoke.py``'s sampling phase holds the card to: the
    JAX package's scores, dense weights and gather indices at each input,
    with three ragged shards (0, 3 and b − 1 rows)."""

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    smoke = _chip_smoke()
    assert len(smoke.KNOWN_ANSWERS) >= 4
    for (seed, slot, t, dname, n, L, b), want in smoke.KNOWN_ANSWERS.items():
        nv = np.full(n, L)
        nv[1], nv[2], nv[3] = 0, 3, b - 1
        with _scope(dname == "float64"):
            key = jax.random.fold_in(jax.random.key(seed), slot)
            wk = ref_sampling._worker_keys(key, t, n)
            scores = jax.vmap(lambda k, m: ref_sampling._masked_scores(k, L, m))(
                wk, jnp.asarray(nv))
            weights = ref_sampling.sample_worker_batch_weights(key, t, jnp.asarray(nv), L, b)
            indices = jax.vmap(lambda k, m: ref_sampling.sample_batch_indices(k, L, m, b)[0])(
                wk, jnp.asarray(nv))
            got = (digest(np.asarray(scores)), digest(np.asarray(weights)),
                   digest(np.asarray(indices).astype(np.int64)))
        assert np.asarray(scores).dtype == np.dtype(dname)
        assert got == want, (seed, slot, t, dname)
