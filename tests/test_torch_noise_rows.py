"""The row-wise plain version of the large-noise payload, on the CPU.

``draw_kernels.large_noise_rows_plain`` draws chosen Byzantine rows alone,
at the 64-bit counters i·d + j, so that a card test can hold the kernel at
a stack too large for the plain version (N·d past 2³²). Here it equals
``large_noise_plain``'s rows in both dtypes, and past 2³² it reads
``prng.uniform_at`` at those counters (which tests/test_torch_past_limits.py
holds to JAX's bits) through the normal's erf_inv, and agrees with JAX's
own Threefry words and ``lax.erf_inv`` there to the few ulp by which XLA's
CPU ``log1p`` differs from torch's (tests/test_torch_large_noise.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from distributed_optimization_tpu_torch.ops import draw_kernels as dk
from distributed_optimization_tpu_torch.ops import prng

DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64)}
NORMAL_ULP = {"float32": 3, "float64": 32}
SHAPES = ((1, 1), (64, 11), (7, 81), (25, 810))
COUNTERS_T = (0, 4000, 2**31 - 1)
# N·d just past 2³² (the card test's stack): row N − 2 crosses 2³², row N − 1
# lies past it.
BIG = (1_431_657, 3_000)


def _key(dtype):
    return prng.fold_in(prng.key(203, x64=dtype == torch.float64), 0xBAD0)


@pytest.mark.parametrize("t", COUNTERS_T)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_are_the_plain_version_s(dtype, shape, t):
    tdt = DTYPES[dtype][0]
    n, d = shape
    x = torch.from_numpy(np.random.default_rng(n + d).standard_normal(shape)).to(tdt)
    byz = (torch.arange(n) % 3 == n % 3).to(torch.uint8)
    tt = torch.tensor([t])
    want = dk.large_noise_plain(_key(tdt), tt, byz, x, 10.0)
    rows = torch.nonzero(byz)[:, 0]
    got = dk.large_noise_rows_plain(_key(tdt), tt, rows, x[rows], d, 10.0)
    assert got.dtype == tdt and torch.equal(got, want[rows])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_past_two_to_the_32_read_uniform_at_there(dtype):
    tdt, jdt = DTYPES[dtype]
    n, d = BIG
    assert (n - 2) * d < 2**32 < (n - 1) * d
    rows = torch.tensor([3, n - 2, n - 1])
    key, t = _key(tdt), torch.tensor([2**31 + 3])
    zeros = torch.zeros((3, d), dtype=tdt)
    got = dk.large_noise_rows_plain(key, t, rows, zeros, d, 1.0)
    counters = rows[:, None] * d + torch.arange(d)
    assert int(counters.max()) >= 2**32 > int(counters[1].min())
    u = prng.uniform_at(prng.fold_in(key, t.reshape(())), counters, tdt,
                        prng.normal_lower(tdt), 1.0)
    assert torch.equal(got, torch.tensor(2.0**0.5, dtype=tdt) * prng.erf_inv(u))
    # JAX's words at the pairs (c >> 32, c mod 2³²) and lax.erf_inv.
    round_key = prng.fold_in(key, 2**31 + 3)
    c = counters.reshape(-1).numpy()
    x0, x1 = jax_prng.threefry2x32_p.bind(
        jnp.full(c.shape, round_key[0], dtype=jnp.uint32),
        jnp.full(c.shape, round_key[1], dtype=jnp.uint32),
        jnp.asarray((c >> 32).astype(np.uint32)), jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32)))
    x0, x1 = np.asarray(x0).astype(np.uint64), np.asarray(x1).astype(np.uint64)
    with jax.enable_x64(dtype == "float64"):
        if dtype == "float32":
            bits = ((x0 ^ x1) >> np.uint64(9)).astype(np.uint32) | np.uint32(0x3F800000)
            f = bits.view(np.float32) - np.float32(1.0)
        else:
            bits = (((x0 << np.uint64(32)) | x1) >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
            f = bits.view(np.float64) - 1.0
        lo = np.nextafter(np.array(-1.0, f.dtype), np.array(0.0, f.dtype))
        uj = np.maximum(lo, f * (f.dtype.type(1.0) - lo) + lo)
        want = np.asarray(jnp.asarray(np.sqrt(2.0), dtype=jdt)
                          * jax.lax.erf_inv(jnp.asarray(uj, dtype=jdt)))
    assert np.array_equal(u.reshape(-1).numpy(), uj)
    ulps = np.abs(got.reshape(-1).numpy().astype(np.float64) - want) / np.spacing(np.abs(want))
    assert ulps.max() <= NORMAL_ULP[dtype]
