"""The large-noise attack and the normal draw behind it, held to the JAX package.

``prng.uniform`` with ``minval``/``maxval`` and ``prng.uniform_at`` give
``jax.random.uniform``'s bits; ``prng.erf_inv`` is the polynomial XLA lowers
``lax.erf_inv`` to, and ``prng.normal`` is ``jax.random.normal``: both to a
few ulp, since XLA's CPU ``log1p`` is not torch's (measured: erf_inv within 2
ulp in float32 and 21 in float64, normal within 3 ulp in float32 and 30 in
float64; the bounds below). The draw kernel's plain version is
``prng.normal`` at ``fold_in(key, t)``, the adversary's ``corrupt`` is the
JAX package's, and whole runs under ``attack='large_noise'`` (plain gossip,
the trimmed mean in its fused, gather and dense forms, gradient tracking,
and under edge drops) agree with ``jax_backend.run`` to 1e-12 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.parallel.adversary import make_adversary as ref_adversary
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.ops import draw_kernels, prng
from distributed_optimization_tpu_torch.parallel.adversary import make_adversary

TOL = dict(rtol=1e-12, atol=1e-12)
DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64)}
# Largest differences in ulp of the JAX package's value (see the docstring).
ERF_INV_ULP = {"float32": 2, "float64": 32}
NORMAL_ULP = {"float32": 3, "float64": 32}
SEEDS = (0, 7, 203, 2**31 - 1)


def _ulps(got, want):
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.0), (2.5, 6.5), "normal"])
def test_uniform_bounds_are_jax_s(dtype, bounds):
    """Bitwise where max − min is a power of two, as at every use in the port
    (XLA's CPU compiler contracts u·(max − min) + min into one FMA, which
    rounds once; with an exact product the two agree)."""
    tdt, jdt = DTYPES[dtype]
    lo, hi = (prng.normal_lower(tdt), 1.0) if bounds == "normal" else bounds
    with jax.enable_x64(dtype == "float64"):
        for seed in SEEDS:
            want = np.asarray(jax.random.uniform(jax.random.key(seed), (37, 29), jdt, lo, hi))
            got = prng.uniform(prng.key(seed, x64=dtype == "float64"), (37, 29), tdt, lo, hi)
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_at_reads_the_full_draw(dtype):
    tdt = DTYPES[dtype][0]
    key = prng.fold_in(prng.key(203, x64=False), 0x0FA17)
    full = prng.uniform(key, (40, 40), tdt)
    counters = torch.tensor([[0, 1], [41, 1599], [799, 40]])
    got = prng.uniform_at(key, counters, tdt)
    assert torch.equal(got, full.reshape(-1)[counters])
    keys = prng.fold_in(key, torch.arange(5))
    batched = prng.uniform_at(keys, counters, tdt)
    for t in range(5):
        assert torch.equal(batched[t], prng.uniform(prng.fold_in(key, t), (40, 40),
                                                    tdt).reshape(-1)[counters])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_erf_inv_is_xla_s_polynomial(dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.concatenate([np.linspace(-0.9999999, 0.9999999, 200_001),
                        [-1.0, 1.0, 0.0, -0.0, 1e-30, -1e-30, 0.999999999999, -0.5]])
    x = x.astype(np.float32 if dtype == "float32" else np.float64)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.lax.erf_inv(jnp.asarray(x, dtype=jdt)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.array_equal(got[~finite], want[~finite])  # ±1 → ±inf
    assert _ulps(got[finite], want[finite]).max() <= ERF_INV_ULP[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_is_jax_s(dtype, seed):
    tdt, jdt = DTYPES[dtype]
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.random.normal(jax.random.key(seed), (64, 1000), jdt))
    got = prng.normal(prng.key(seed, x64=dtype == "float64"), (64, 1000), tdt).numpy()
    assert np.all(np.isfinite(got))
    assert _ulps(got, want).max() <= NORMAL_ULP[dtype]
    assert prng.normal_lower(tdt) == np.nextafter(np.array(-1.0, want.dtype),
                                                 np.array(0.0, want.dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_noise_plain_version_draws_at_fold_in_t(dtype):
    tdt = DTYPES[dtype][0]
    key = prng.fold_in(prng.key(203, x64=False), 0xBAD0)
    x = torch.randn(12, 7, dtype=tdt, generator=torch.Generator().manual_seed(0))
    byz = torch.tensor([0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0], dtype=torch.uint8)
    for t in (0, 5, 2**31 - 1, 2**32 + 3):
        tt = torch.tensor([t])
        got = draw_kernels.large_noise(key, tt, byz, x, 10.0)
        z = prng.normal(prng.fold_in(key, t), (12, 7), tdt)
        want = torch.where(byz.bool()[:, None], x + torch.tensor(10.0, dtype=tdt) * z, x)
        assert torch.equal(got, want)
        assert torch.equal(got[byz == 0], x[byz == 0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_corrupt_matches_the_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(3).standard_normal((16, 9)).astype(np.dtype(dtype))
    ours = make_adversary(16, "large_noise", 3, 10.0, 203, device="cpu", dtype=tdt)
    with jax.enable_x64(dtype == "float64"):
        ref = ref_adversary(16, "large_noise", 3, 10.0, 203)
        for t in (0, 1, 999):
            want = np.asarray(ref.corrupt(jnp.asarray(t), jnp.asarray(x)))
            got = ours.corrupt(torch.from_numpy(x), torch.tensor([t])).numpy()
            honest = ~ours.byzantine
            assert np.array_equal(got[honest], want[honest])
            # x + 10·z: the normal's few ulp, scaled by 10, on the payload.
            noise = (want - x)[~honest]
            bound = 10 * NORMAL_ULP[dtype] * np.spacing(np.abs(noise) / 10)
            assert np.all(np.abs(got[~honest] - want[~honest]) <= bound + np.spacing(
                np.abs(want[~honest])))
    with pytest.raises(ValueError, match="pass t"):
        ours.corrupt(torch.from_numpy(x))


SMALL = dict(n_workers=12, n_samples=480, n_features=10, n_informative_features=6,
             n_iterations=60, topology="ring", local_batch_size=16, dtype="float64",
             problem_type="logistic", eval_every=10, partition="shuffled",
             attack="large_noise", n_byzantine=2, attack_scale=10.0)
RUNS = {
    "plain": dict(),
    "trimmed-fused": dict(aggregation="trimmed_mean", robust_b=1, robust_impl="fused"),
    "trimmed-gather": dict(aggregation="trimmed_mean", robust_b=1, robust_impl="gather"),
    "trimmed-dense-fc": dict(aggregation="trimmed_mean", robust_b=2,
                             topology="fully_connected"),
    "median-fused-edges": dict(aggregation="median", robust_b=1, robust_impl="fused",
                               edge_drop_prob=0.2),
    "gt-clip": dict(algorithm="gradient_tracking", aggregation="clipped_gossip", robust_b=1),
    "quadratic-plain-stragglers": dict(problem_type="quadratic", straggler_prob=0.2),
}


@pytest.fixture(scope="module")
def data():
    cache = {}

    def get(fields):
        key = fields["problem_type"]
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices,
                                          ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax_backend(data, name):
    fields = {**SMALL, **RUNS[name]}
    ds, ours_ds, f_opt = data(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted


def test_config_accepts_large_noise_and_the_dense_form():
    cfg = ExperimentConfig(attack="large_noise", n_byzantine=2, attack_scale=3.0)
    assert cfg.attack == "large_noise"
    dense = ExperimentConfig(aggregation="median", robust_b=1, robust_impl="dense")
    assert dense.resolved_robust_impl(2) == "dense"
    assert ExperimentConfig(aggregation="median", robust_b=1).resolved_robust_impl(24) == "dense"
