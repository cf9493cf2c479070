"""Compressed gossip (CHOCO-SGD, top_k / random_k / qsgd, compressed D-SGD
and gradient tracking), held to the JAX package on the CPU.

The port's compressors are the plain twin of
``distributed_optimization_tpu/ops/compression.py`` on the twin of
``jax.random`` (``ops/prng.py``): the same keys, the same uniforms, the same
selections. Tolerances:

- keys, floats transmitted, payloads and contraction factors: exact;
- top_k and random_k: bitwise, sign of zero included, in both dtypes;
- qsgd: the twin sums each row's squares in the card kernel's order and
  XLA in its own, so the norms may differ in the last bits. In float64
  every element agrees to 1e-12 relative. In float32 the rounding decision
  ``u < p_up`` is the same at every element of a row whose norm is the same
  bit for bit; where the norms differ, a decision may differ only where u
  lies within 4 ulp of the level of p_up (the norm's rounding carried into
  it). Where the decisions agree, the elements are within 4 ulp of the
  row's ω‖v‖/s times their level;
- whole runs on the JAX package's own batches (``jax_backend.run``,
  unsharded, its Pallas kernels in interpret mode), float64: gap and
  consensus histories, final models and the estimates ``xhat``/``yhat`` to
  1e-12 (rtol and atol).
"""

import hashlib
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.metrics import iterations_to_threshold
from distributed_optimization_tpu.ops import compression as ref_compression
from distributed_optimization_tpu.parallel import build_topology as ref_topology
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.__main__ import main as cli_main
from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.algorithms.base import StepContext
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.ops import compression, compression_kernels, prng

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=9, n_samples=450, n_features=10, n_informative_features=6,
             n_iterations=60, topology="ring", local_batch_size=16, dtype="float64",
             problem_type="logistic")
SEEDS = (0, 203, 2**31 - 1, 2**40 + 5)
BITS = {np.float32: np.uint32, np.float64: np.uint64}


def _x64(dtype) -> bool:
    return dtype == np.float64


def _jax_key_words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed,dtype", [(seed, dtype) for dtype in (np.float32, np.float64)
                                        for seed in SEEDS if seed < 2**32 or _x64(dtype)])
def test_compression_key_is_the_jax_package_s(seed, dtype):
    """Key words of ``compression_key(seed, t, round)`` at rounds 0 and 1,
    t as an int and as the run's int64 counter tensor; float64 under
    ``enable_x64``, where the key takes the seed's high word (a seed past
    2³² needs it)."""
    for t in (0, 12_345, 2**31 - 1):
        for rnd in (0, 1):
            with jax.enable_x64(_x64(dtype)):
                want = _jax_key_words(ref_compression.compression_key(seed, t, rnd))
            assert compression.compression_key(seed, t, rnd, x64=_x64(dtype)) == want
            counter = torch.tensor([t], dtype=torch.int64)
            got = compression.compression_key(seed, counter, rnd, x64=_x64(dtype))
            assert tuple(int(w) for w in got) == want


def _inputs(n, d, dtype, k, seed=0):
    """v with planted ties at the k-th magnitude, a zero row, −0.0 entries and
    a row of equal magnitudes of both signs (those of rows 1–4 that n has)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d))
    v[1] = 0.0
    kk = min(max(k, 1), d)
    if n > 2:
        v[2, :] = rng.standard_normal(d) * 0.1
        v[2, max(kk - 2, 0): kk + 2] = 0.75  # ties across the k boundary
    if n > 3:
        v[3, ::2] = -0.0
    if n > 4:
        v[4] = np.where(rng.random(d) < 0.5, -1.5, 1.5)
    return v.astype(dtype)


# (name, k) at d = 11: k at 1, inside and at d; qsgd at its limits and 4.
COMPRESSORS = [("top_k", 1), ("top_k", 3), ("top_k", 11), ("random_k", 1), ("random_k", 4),
               ("random_k", 11), ("qsgd", 1), ("qsgd", 4), ("qsgd", 16)]


def _jax_qsgd_pieces(key, v, k):
    """JAX's qsgd on v, op by op as its ``apply_qsgd`` runs them: (norm,
    levels, u, p_up)."""
    s = float(2**k)
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    scale = jnp.where(norm > 0, norm, 1.0)
    level = jnp.abs(v) / scale * s
    low = jnp.floor(level)
    p_up = level - low
    u = jax.random.uniform(key, v.shape)
    return (np.asarray(norm), np.asarray(low + (u < p_up)), np.asarray(u), np.asarray(p_up),
            np.asarray(level))


@pytest.mark.parametrize("seed", [0, 203, 2**31 - 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,k", COMPRESSORS)
def test_compressor_twin_is_the_jax_package_s(name, k, dtype, seed):
    _assert_twin_is_jax(name, k, dtype, seed, 9, 11)


# Rows wider than the 4,096 columns the card's first kernel took: (name, k)
# with k at 1, 9 and d (None) for the selections, qsgd at 1, 4 and 16 bits.
WIDE_SHAPES = [(3, 4_097), (2, 5_000)]
WIDE_COMPRESSORS = [("top_k", 1), ("top_k", 9), ("top_k", None), ("random_k", 1),
                    ("random_k", 9), ("random_k", None), ("qsgd", 1), ("qsgd", 4), ("qsgd", 16)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("name,k", WIDE_COMPRESSORS)
def test_compressor_twin_is_the_jax_package_s_past_4096_columns(name, k, shape, dtype):
    n, d = shape
    _assert_twin_is_jax(name, d if k is None else k, dtype, 203, n, d)


def _assert_twin_is_jax(name, k, dtype, seed, n, d):
    """The twin's ``apply`` against the JAX package's at three draws, with
    the tolerances of the module docstring."""
    v = _inputs(n, d, dtype, k, seed)
    x64 = _x64(dtype)
    ours = compression.make_compressor(name, d, k)
    for t, rnd in ((0, 0), (12_345, 1), (2**31 - 1, 0)):
        with jax.enable_x64(x64):
            key = ref_compression.compression_key(seed, t, rnd)
            ref = ref_compression.make_compressor(name, d, k)
            want = np.asarray(ref.apply(key, jnp.asarray(v)))
            pieces = _jax_qsgd_pieces(key, jnp.asarray(v), k) if name == "qsgd" else None
        got = ours.apply(compression.compression_key(seed, t, rnd, x64=x64),
                         torch.as_tensor(v)).numpy()
        assert got.dtype == want.dtype
        if name != "qsgd":
            np.testing.assert_array_equal(got.view(BITS[dtype]), want.view(BITS[dtype]))
            continue
        if dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            continue
        norm_j, levels_j, u, p_up, level = pieces
        vt = torch.as_tensor(v.copy())
        u_ours = prng.uniform(compression.compression_key(seed, t, rnd), v.shape,
                                          torch.float32).numpy()
        np.testing.assert_array_equal(u_ours, u)
        norm_o, levels_o = (a.numpy() for a in compression.qsgd_levels(
            vt, torch.as_tensor(u.copy()), float(2**k)))
        differ = levels_o != levels_j
        same_norm = (norm_o == norm_j)[:, 0]
        assert not differ[same_norm].any(), "a decision differs in a row of equal norm"
        eps = np.finfo(np.float32).eps
        assert np.all(np.abs(u - p_up)[differ] <= 4 * eps * np.maximum(level[differ], 1.0))
        unit = ours.delta * norm_j / 2.0**k  # ω‖v‖/s of each row
        agree = ~differ
        bound = 4 * eps * unit * levels_j
        assert np.all((np.abs(got - want) <= bound)[agree])


def test_identity_compression_exchange_is_not_short_cut():
    """``none``: memory + (v − memory), literally; it differs from v in the
    last bit for these inputs."""
    v = torch.tensor([[0.1, 1e-17, 3.0]], dtype=torch.float64)
    memory = torch.tensor([[0.7, 1.0, -2.0]], dtype=torch.float64)
    comp = compression.make_compressor("none", 3)
    out = compression_kernels.ef_compress(comp, None, v, memory)
    assert torch.equal(out, memory + (v - memory)) and not torch.equal(out, v)


@pytest.mark.parametrize("name", ["none", "top_k", "random_k", "qsgd", "bogus"])
def test_payloads_factors_and_errors_are_the_jax_package_s(name):
    d = 11
    ks = (0, 1, 16, 17) if name == "qsgd" else (-1, 0, 1, 4, d, d + 1)
    for k in ks:
        try:
            ref = ref_compression.make_compressor(name, d, k)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                compression.make_compressor(name, d, k)
            assert str(got.value) == str(e)
            continue
        ours = compression.make_compressor(name, d, k)
        assert (ours.name, ours.floats_per_edge, ours.delta) == (
            ref.name, ref.floats_per_edge, ref.delta)


@pytest.mark.parametrize("name,k", [("top_k", 3), ("random_k", 4), ("qsgd", 4), ("none", 0)])
def test_error_feedback_exchange_is_the_jax_package_s(name, k):
    """One exchange with a dense W mix, float64, from a nonzero memory,
    against JAX's."""
    n, d = 9, 11
    W = ref_topology("ring", n).mixing_matrix
    rng = np.random.default_rng(5)
    v, memory = rng.standard_normal((n, d)), rng.standard_normal((n, d)) * 0.3
    with jax.enable_x64(True):
        ef = ref_compression.make_error_feedback(name, d, k, 0.25)
        key = ref_compression.compression_key(203, 17, 1)
        want = ef.exchange(key, jnp.asarray(v), jnp.asarray(memory), lambda x: jnp.asarray(W) @ x)
        want = [np.asarray(a) for a in want]
    ours = compression.make_error_feedback(name, d, k, 0.25)
    Wt = torch.as_tensor(W)
    mix = lambda x: Wt @ x  # noqa: E731
    draw = compression.Draw(compression.tag_key(203, x64=True), torch.tensor([17]), 1)
    got = ours.exchange(draw, torch.as_tensor(v), torch.as_tensor(memory), mix)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


# (name, k, dtype) of the wide exchange: k at 1, 9 and d (None) for the
# selections in both dtypes; qsgd in float64 (float32 qsgd is held by the
# apply test above, decision by decision: where a norm differs in its last
# bit a decision may flip, and the mix spreads it over every row).
WIDE_EXCHANGES = [(name, k, dtype) for dtype in (np.float32, np.float64)
                  for name, k in (("top_k", 1), ("top_k", 9), ("top_k", None), ("random_k", 1),
                                  ("random_k", 9), ("random_k", None))] + [("qsgd", 4, np.float64)]


@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("name,k,dtype", WIDE_EXCHANGES)
def test_error_feedback_exchange_is_the_jax_package_s_past_4096_columns(name, k, dtype, shape):
    """One exchange of rows past 4,096 columns with an averaging mix, from a
    nonzero memory, against JAX's: in float64 both outputs to 1e-12; in
    float32 the estimate x̂⁺ bit for bit and v⁺ to 1e-6 (the mix is a matrix
    product in each package)."""
    n, d = shape
    k = d if k is None else k
    W = np.full((n, n), 1.0 / n, dtype=dtype)
    rng = np.random.default_rng(d)
    v = rng.standard_normal((n, d)).astype(dtype)
    memory = (rng.standard_normal((n, d)) * 0.3).astype(dtype)
    x64 = _x64(dtype)
    with jax.enable_x64(x64):
        ef = ref_compression.make_error_feedback(name, d, k, 0.25)
        key = ref_compression.compression_key(203, 17, 1)
        want = ef.exchange(key, jnp.asarray(v), jnp.asarray(memory), lambda x: jnp.asarray(W) @ x)
        want = [np.asarray(a) for a in want]
    ours = compression.make_error_feedback(name, d, k, 0.25)
    Wt = torch.as_tensor(W)
    draw = compression.Draw(compression.tag_key(203, x64=x64), torch.tensor([17]), 1)
    got = [a.numpy() for a in ours.exchange(draw, torch.as_tensor(v), torch.as_tensor(memory),
                                            lambda x: Wt @ x)]
    assert all(g.dtype == w.dtype for g, w in zip(got, want))
    if dtype == np.float64:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        return
    np.testing.assert_array_equal(got[1].view(np.uint32), want[1].view(np.uint32))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def datasets():
    cache = {}

    def get(fields):
        key = tuple(fields[k] for k in ("n_samples", "n_workers", "problem_type"))
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


# name -> the fields each whole-run case sets over SMALL.
RUNS = {
    "choco-topk-stencil": dict(algorithm="choco", compression="top_k", compression_k=3,
                               mixing_impl="stencil"),
    "choco-randk-pallas": dict(algorithm="choco", compression="random_k", compression_k=4,
                               mixing_impl="pallas", sampling_impl="dense"),
    "choco-qsgd-dense": dict(algorithm="choco", compression="qsgd", compression_k=4,
                             mixing_impl="dense"),
    "choco-randk-fc-pallas": dict(algorithm="choco", compression="random_k", compression_k=4,
                                  topology="fully_connected", mixing_impl="pallas"),
    "choco-none": dict(algorithm="choco", choco_gamma=0.5, eval_every=10),
    "dsgd-topk-pallas": dict(algorithm="dsgd", compression="top_k", compression_k=3,
                             mixing_impl="pallas"),
    "dsgd-topk-grid": dict(algorithm="dsgd", compression="top_k", compression_k=2,
                           topology="grid", mixing_impl="dense"),
    "gt-topk-stencil": dict(algorithm="gradient_tracking", compression="top_k",
                            compression_k=3, mixing_impl="stencil"),
    "gt-qsgd-pallas": dict(algorithm="gradient_tracking", compression="qsgd", compression_k=4,
                           mixing_impl="pallas", eval_every=5),
    "gt-qsgd-fc-pallas": dict(algorithm="gradient_tracking", compression="qsgd",
                              compression_k=2, topology="fully_connected",
                              mixing_impl="pallas"),
    "gt-randk-grid-quadratic": dict(algorithm="gradient_tracking", compression="random_k",
                                    compression_k=5, topology="grid", problem_type="quadratic"),
}


def _both(datasets, **kw):
    fields = {**SMALL, **kw}
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, return_state=True)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                             return_state=True)
    return ref, ours


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax_backend_on_its_own_batches(datasets, name):
    ref, ours = _both(datasets, **RUNS[name])
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    assert set(ours.final_state) == set(ref.final_state)
    for leaf in ("xhat", "yhat"):
        if leaf in ref.final_state:
            np.testing.assert_allclose(ours.final_state[leaf], np.asarray(ref.final_state[leaf]),
                                       **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    assert np.all(np.isfinite(ours.history.objective))


def test_identity_gamma1_equals_adapt_then_combine_dsgd():
    """The port of test_choco.py's pin: one CHOCO step with ``none`` and
    γ = 1 from x̂ = 0 is W (x − η g)."""
    n, d = 9, 5
    W = torch.as_tensor(ref_topology("ring", n).mixing_matrix, dtype=torch.float64)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.standard_normal((n, d)))
    g = torch.as_tensor(rng.standard_normal((n, d)))
    cfg = ExperimentConfig(algorithm="choco", choco_gamma=1.0, n_workers=n)
    t = torch.zeros(1, dtype=torch.int64)
    ctx = StepContext(grad=lambda params, slot: g, mix=lambda v: W @ v,
                      neighbor_sum=lambda v: v * 0, eta=torch.tensor([0.05], dtype=torch.float64),
                      config=cfg, t=t,
                      draw=lambda r: compression.Draw(compression.tag_key(0, x64=True), t, r))
    algo = get_algorithm("choco")
    out = algo.step(algo.init(x0, cfg), ctx)["x"]
    torch.testing.assert_close(out, W @ (x0 - 0.05 * g), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,k", [("random_k", 4), ("top_k", 3), ("qsgd", 4)])
def test_constant_step_compressed_dsgd_is_choco_bitwise(datasets, name, k):
    fields = {**SMALL, "compression": name, "compression_k": k}
    _, ds, f_opt = datasets(fields)
    choco = torch_backend.run(ExperimentConfig(**fields, algorithm="choco"), ds, f_opt,
                              device="cpu", return_state=True)
    dsgd = torch_backend.run(ExperimentConfig(**fields, algorithm="dsgd", lr_schedule="constant"),
                             ds, f_opt, device="cpu", return_state=True)
    np.testing.assert_array_equal(dsgd.history.objective, choco.history.objective)
    np.testing.assert_array_equal(dsgd.final_models, choco.final_models)
    np.testing.assert_array_equal(dsgd.final_state["xhat"], choco.final_state["xhat"])


# Config fields the JAX package refuses, and the port with the same message.
REFUSED = [
    dict(compression="zip"),
    dict(algorithm="extra", compression="top_k", compression_k=3),
    dict(algorithm="choco", compression="top_k", compression_k=0),
    dict(algorithm="dsgd", compression="qsgd", compression_k=-2),
    dict(algorithm="dsgd", compression="top_k", compression_k=3, attack="sign_flip",
         n_byzantine=1),
    dict(algorithm="dsgd", compression="top_k", compression_k=3, aggregation="trimmed_mean",
         robust_b=1),
    dict(algorithm="choco", choco_gamma=0.0),
    dict(algorithm="dsgd", compression="random_k", compression_k=2, choco_gamma=1.5),
    dict(algorithm="gradient_tracking", compression="top_k", compression_k=2, local_steps=2),
    dict(algorithm="choco", local_steps=2),
]


@pytest.mark.parametrize("fields", REFUSED, ids=range(len(REFUSED)))
def test_config_refusals_are_the_jax_package_s(fields):
    with pytest.raises(ValueError) as want:
        RefConfig(**fields)
    with pytest.raises(ValueError) as got:
        ExperimentConfig(**fields)
    assert str(got.value) == str(want.value)


def test_choco_with_byzantine_fields_is_refused_by_the_backend(datasets):
    fields = {**SMALL, "algorithm": "choco", "attack": "sign_flip", "n_byzantine": 1}
    _, ds, f_opt = datasets(fields)
    with pytest.raises(ValueError, match="unsupported for 'choco'"):
        torch_backend.run(ExperimentConfig(**fields), ds, f_opt, device="cpu")


def test_cli_runs_the_readme_choco_line_as_the_jax_package_does(capsys):
    """The README's CHOCO line, ``--compression top_k --compression-k 3
    --choco-gamma 0.25``, at its defaults (N=25 ring, quadratic), in float64
    and cut to 300 iterations: its final gap and floats transmitted are
    ``jax_backend.run``'s to 1e-12. (γ = 0.25 is far above top-3's δ = 3/81,
    so the run does not converge, and the last-bit differences of two
    summation orders grow until a top-3 selection parts at a near-tie,
    later than these 300 iterations: ROADMAP Queue 3.)"""
    argv = ["--algorithm", "choco", "--compression", "top_k", "--compression-k", "3",
            "--choco-gamma", "0.25", "--n-iterations", "300", "--dtype", "float64",
            "--device", "cpu", "--json"]
    assert cli_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = RefConfig(algorithm="choco", compression="top_k", compression_k=3, choco_gamma=0.25,
                    n_iterations=300, dtype="float64")
    ds = ref_generate(cfg)
    ref = jax_backend.run(cfg, ds, ref_oracle(ds, cfg.reg_param)[1], use_mesh=False)
    assert summary["compression"] == "top_k"
    assert summary["total_floats_transmitted"] == ref.total_floats_transmitted
    np.testing.assert_allclose(summary["final_gap"], ref.history.objective[-1], **TOL)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def test_chip_smoke_compression_known_answers_are_the_jax_package_s():
    """``COMPRESSION_KNOWN_ANSWERS``: digests of JAX's random_k mask (int32,
    1 where kept) and of qsgd's uniforms at each (seed, t, round, dtype, N,
    d, k)."""
    for (seed, t, rnd, dname, n, d, k), want in _chip_smoke().COMPRESSION_KNOWN_ANSWERS.items():
        with jax.enable_x64(dname == "float64"):
            key = ref_compression.compression_key(seed, t, rnd)
            dtype = jnp.dtype(dname)
            mask = ref_compression.make_compressor("random_k", d, k).apply(
                key, jnp.ones((n, d), dtype)) != 0
            u = jax.random.uniform(key, (n, d), dtype)
            got = (_digest(np.asarray(mask).astype(np.int32)), _digest(np.asarray(u)))
        assert got == want, (seed, t, rnd, dname)


def test_chip_smoke_compression_runs_are_the_jax_package_s():
    """``COMPRESSION_RUNS``: the JAX package's iterations to ε on the main
    path's data (N=256 ring, logistic, float32, eval every iteration, mixing
    'stencil'), each run just past its crossing, and its floats transmitted
    over T; the constant-step D-SGD run is CHOCO's count (the JAX package
    pins the two equal in test_compressed_gossip.py)."""
    smoke = _chip_smoke()
    base = RefConfig(problem_type="logistic", topology="ring", n_workers=256, dtype="float32",
                     eval_every=1, mixing_impl="stencil")
    ds = ref_generate(base)
    f_opt = ref_oracle(ds, base.reg_param)[1]
    for name, (fields, T, want, floats) in smoke.COMPRESSION_RUNS.items():
        assert want < T
        if name == "dsgd_randk27_const":
            assert want == smoke.COMPRESSION_RUNS["choco_randk27"][2]
            continue
        cfg = base.replace(n_iterations=want + 10, **fields)
        h = jax_backend.run(cfg, ds, f_opt, use_mesh=False).history
        assert iterations_to_threshold(h.objective, 0.08, h.eval_iterations) == want, name
        assert h.total_floats_transmitted / (want + 10) * T == floats, name
