"""The sampler on shards past 65,536 rows, held to the JAX package on the CPU.

Past 65,536 rows the card's selection recomputes each row's key at every
radix pass instead of holding it in registers; its CPU counterparts are the
twin (``ops/sampling.py``) and the mirror of the kernel's selection
(``ops/sampling_kernels.select_mirror``). At N=1 with L=70,000 rows and
b=16 the masked scores, the gather form's indices, weights and rows, and the
dense weights equal the JAX package's sampler bit for bit, in float32 and,
under ``enable_x64``, float64. The dense forms of both packages hold L²
pairs (4.9·10⁹ here), so the dense weights are held as the rows that the
mirror of the card's selection picks, each at 1/b_eff, against the JAX
package's gather draw scattered (the JAX package pins its two forms to the
same subsets).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.ops import sampling as ref_sampling
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.ops import prng, sampling
from distributed_optimization_tpu_torch.ops import sampling_kernels as sk

L, B, D = 70_000, 16, 3


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("t", [0, 2**31 - 1])
def test_long_shard_draws_the_jax_package_batches_bitwise(x64, t):
    seed, slot = 42, 1
    dtype = torch.float64 if x64 else torch.float32
    n_valid = np.array([L])
    rng = np.random.default_rng(t)
    X = rng.standard_normal((1, L, D))
    y = np.arange(L, dtype=np.float64)[None, :]  # a row's label is its index
    with enable_x64() if x64 else contextlib.nullcontext():
        jdt = jnp.float64 if x64 else jnp.float32
        key = jax.random.fold_in(jax.random.key(seed), slot)
        nv = jnp.asarray(n_valid)
        worker_key = ref_sampling._worker_keys(key, t, 1)[0]
        ref_scores = np.asarray(ref_sampling._masked_scores(worker_key, L, nv[0]))
        ref_Xb, ref_yb, ref_w = (np.asarray(a) for a in ref_sampling.sample_worker_batches(
            key, t, jnp.asarray(X, dtype=jdt), jnp.asarray(y, dtype=jdt), nv, B))
    skey = prng.fold_in(prng.key(seed, x64=x64), slot)
    nv_t = torch.as_tensor(n_valid)
    scores = sampling.masked_scores(skey, t, nv_t, L, dtype).numpy()
    assert scores.dtype == ref_scores.dtype and np.array_equal(scores[0], ref_scores)

    idx, w = sampling.sample_batch_indices(skey, t, nv_t, L, B, dtype)
    np.testing.assert_array_equal(idx.numpy(), ref_yb.astype(np.int64))
    assert ref_w.dtype == np.float32 and np.array_equal(w.numpy(), ref_w.astype(w.numpy().dtype))
    Xb, yb = sampling.gather_batches(torch.as_tensor(X, dtype=dtype),
                                     torch.as_tensor(y, dtype=dtype), idx)
    assert np.array_equal(Xb.numpy(), ref_Xb) and np.array_equal(yb.numpy(), ref_yb)

    picked, _ = sk.select_mirror(sk.draw_scores(skey, t, nv_t, L, dtype), B, dtype, nv_t)
    inv = sampling.batch_weight(torch.tensor([B]), dtype)
    dense = torch.zeros((1, L), dtype=dtype).scatter_(1, picked, inv[:, None].expand(1, B))
    want = np.zeros((1, L), dtype=ref_w.dtype)
    want[0, ref_yb.astype(np.int64)[0]] = ref_w[0]
    np.testing.assert_array_equal(dense.numpy(), want.astype(dense.numpy().dtype))
