"""The softmax family of the port against the JAX package.

The weighted torch forms against ``ops/losses.py`` (float64, a non-square
[d, K], int32 labels in both), the numpy twins,
the scipy oracle, the K-class data bit for bit, ``param_dim`` and the per-K
cache, and runs on the CPU against ``jax_backend.run`` in float64 on the
JAX package's own batches to 1e-12 (rtol and atol): the flat [N, d·K]
models compare element for element because both packages flatten W
d-major. Also the constants of ``chip_smoke.py``'s objectives phase,
recomputed from the JAX package.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.models import get_problem as ref_get_problem
from distributed_optimization_tpu.ops import losses as ref_losses
from distributed_optimization_tpu.ops import losses_np as ref_losses_np
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.data import stack_shards as ref_stack
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.models.softmax import make_softmax_problem
from distributed_optimization_tpu_torch.ops import compression_kernels, losses, losses_np
from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset, stack_shards
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

TOL = dict(rtol=1e-12, atol=1e-12)
K = 5
# tests/test_softmax.py's small config: N=8, 400 × 12, K=5, η₀=0.5.
SMALL = dict(problem_type="softmax", n_classes=K, n_workers=8, n_samples=400, n_features=12,
             n_informative_features=8, learning_rate_eta0=0.5, n_iterations=60,
             local_batch_size=16, dtype="float64")
D_MODEL = 13 * K
RUNS = {
    "dsgd-gather": dict(),
    "dsgd-dense-sampling": dict(sampling_impl="dense", eval_every=10),
    "dsgd-pallas": dict(mixing_impl="pallas"),
    "gradient-tracking": dict(algorithm="gradient_tracking", mixing_impl="pallas"),
    # top_k ranks |v − x̂|, random_k uniform scores; k = 13 would part
    # from the JAX package on a tie (test_choco_top_k_at_k13_parts_...).
    "choco-top-k": dict(algorithm="choco", compression="top_k", compression_k=7),
    "choco-random-k": dict(algorithm="choco", compression="random_k", compression_k=13),
    "centralized": dict(algorithm="centralized"),
    "robust-fused": dict(partition="shuffled", attack="sign_flip", n_byzantine=1,
                         aggregation="trimmed_mean", robust_b=1, robust_impl="fused"),
}


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def datasets():
    cache = {}

    def get(fields):
        key = fields.get("partition", "sorted")
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param, n_classes=K)[1])
        return cache[key]

    return get


def _inputs(seed=5, N=4, L=9, d=7, k=K):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, L, d))
    w = rng.standard_normal((N, d * k)) * 2.0  # large logits exercise the stable log-sum-exp
    y = rng.integers(0, k, size=(N, L))
    weights = rng.uniform(size=(N, L)) * (rng.uniform(size=(N, L)) < 0.7)
    return w, X, y, weights


def test_weighted_forms_match_jax_with_float_labels():
    """Non-square [d=7, K=5]: a transposed flattening would not match. The
    port takes the labels as floats of the run dtype, JAX as int32."""
    w, X, y, weights = _inputs()
    lam = 1e-3
    t = [torch.from_numpy(a) for a in (w, X, y.astype(np.float64), weights)]
    got_obj = losses.softmax_objective_weighted(*t, lam).numpy()
    got_grad = losses.softmax_gradient_weighted(*t, lam)
    assert got_grad.is_contiguous() and got_grad.shape == w.shape
    with enable_x64():
        for i in range(X.shape[0]):
            args = [jnp.asarray(w[i]), jnp.asarray(X[i]), jnp.asarray(y[i], dtype=jnp.int32),
                    jnp.asarray(weights[i])]
            want_obj = float(ref_losses.softmax_objective_weighted(*args, lam))
            want_grad = np.asarray(ref_losses.softmax_gradient_weighted(*args, lam))
            np.testing.assert_allclose(got_obj[i], want_obj, rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(got_grad[i].numpy(), want_grad, rtol=1e-13, atol=1e-13)


def test_full_objective_of_one_model_matches_jax():
    """The eval's full objective broadcasts one [d·K] model to every worker
    (a stride-0 view) and weighs every real row 1/total."""
    w, X, y, _ = _inputs(seed=6)
    n_valid = np.array([9, 4, 0, 7])
    yf = y.astype(np.float64)
    ours = torch_backend.make_full_objective_fn(get_problem("softmax", n_classes=K), 1e-3)(
        torch.from_numpy(w[0]), torch.from_numpy(X), torch.from_numpy(yf),
        torch.from_numpy(n_valid))
    with enable_x64():
        want = jax_backend.make_full_objective_fn(ref_get_problem("softmax", n_classes=K), 1e-3)(
            jnp.asarray(w[0]), jnp.asarray(X), jnp.asarray(y, dtype=jnp.int32),
            jnp.asarray(n_valid))
    np.testing.assert_allclose(float(ours), float(want), rtol=1e-13, atol=1e-13)


def test_numpy_twins_match_the_reference():
    w, X, y, _ = _inputs(seed=7)
    w, X, y = w[0], X[0], y[0].astype(np.float64)
    assert losses_np.softmax_objective(w, X, y, 1e-3) == ref_losses_np.softmax_objective(w, X, y, 1e-3)
    np.testing.assert_array_equal(losses_np.softmax_gradient(w, X, y, 1e-3),
                                  ref_losses_np.softmax_gradient(w, X, y, 1e-3))
    assert losses_np.OBJECTIVES["softmax"](w, X[:0], y[:0], 1e-3) == 0.0
    np.testing.assert_array_equal(losses_np.GRADIENTS["softmax"](w, X[:0], y[:0], 1e-3),
                                  np.zeros_like(w))


@pytest.mark.parametrize("n_classes", (None, K))
def test_oracle_matches_the_reference(datasets, n_classes):
    """K passed in, or inferred as max(y) + 1."""
    ds, ours, _ = datasets(SMALL)
    reg = RefConfig(**SMALL).reg_param
    w_ref, f_ref = ref_oracle(ds, reg, n_classes=n_classes)
    w_opt, f_opt = compute_reference_optimum(ours, reg, n_classes=n_classes)
    assert w_opt.shape == (D_MODEL,)
    assert abs(f_opt - f_ref) <= 1e-12 * abs(f_ref)
    np.testing.assert_allclose(w_opt, w_ref, rtol=1e-9, atol=1e-9)


def test_dataset_is_the_reference_s_bit_for_bit():
    for fields in (SMALL, dict(problem_type="softmax")):
        ref = ref_generate(RefConfig(**fields))
        ours = generate_synthetic_dataset(ExperimentConfig(**fields))
        np.testing.assert_array_equal(ours.y_full, ref.y_full)
        np.testing.assert_array_equal(ours.X_full, ref.X_full)
        for a, b in zip(ours.shard_indices, ref.shard_indices, strict=True):
            np.testing.assert_array_equal(a, b)
    # The labels are class indices stored as int32 in every run dtype, as
    # the JAX package stores them.
    for dtype in (np.float32, np.float64):
        got, want = stack_shards(ours, dtype), ref_stack(ref, dtype)
        assert got.y.dtype == want.y.dtype == np.int32
        np.testing.assert_array_equal(got.y, want.y)


def test_too_many_classes_for_the_informative_features_is_refused_as_in_the_reference():
    fields = dict(problem_type="softmax", n_classes=9, n_informative_features=3,
                  n_features=5, n_samples=100, n_workers=4)
    with pytest.raises(ValueError) as want:
        ref_generate(RefConfig(**fields))
    with pytest.raises(ValueError) as got:
        generate_synthetic_dataset(ExperimentConfig(**fields))
    assert str(got.value) == str(want.value)


def test_param_dim_and_cache():
    assert get_problem("softmax").param_dim(81) == 810
    assert get_problem("softmax", n_classes=512).param_dim(4097) == 2_097_664
    assert get_problem("softmax", n_classes=7) is get_problem("softmax", n_classes=7)
    assert get_problem("softmax", n_classes=10) is get_problem("softmax")
    assert get_problem("logistic", n_classes=7) is get_problem("logistic")
    with pytest.raises(ValueError) as got:
        make_softmax_problem(1)
    with pytest.raises(ValueError) as want:
        ref_get_problem("softmax", n_classes=1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runs_match_jax_backend(datasets, name):
    fields = {**SMALL, **RUNS[name]}
    ds, ours, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    got = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu")
    assert got.final_models.shape == (8, D_MODEL)
    np.testing.assert_array_equal(got.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(got.history.objective, ref.history.objective, **TOL)
    if ref.history.consensus_error is not None:
        np.testing.assert_allclose(got.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(got.final_models, ref.final_models, **TOL)
    assert got.history.total_floats_transmitted == ref.history.total_floats_transmitted
    if name == "dsgd-gather":
        # Two floats an edge and a model each way on the ring: 2·N·d·K·T.
        assert got.history.total_floats_transmitted == 2 * 8 * D_MODEL * 60


def test_classes_absent_from_a_batch_tie_exactly():
    """At W = 0 the gradient columns of the classes a batch lacks are equal
    in exact arithmetic (0.2·Σ_l ω_l x_l); the port's product keeps them
    bitwise equal, so top_k breaks their ties by column index. XLA's CPU
    product, as the JAX package's run calls it (vmapped over the workers),
    rounds the last column of a row (past its vector width of four doubles)
    otherwise, so a JAX run breaks such a tie by those last bits."""
    rng = np.random.default_rng(8)
    N, L, d = 6, 16, 13
    X, y = rng.standard_normal((N, L, d)), rng.integers(0, 2, size=(N, L))
    w, weights = np.zeros((N, d * K)), np.full((N, L), 1 / L)
    g = losses.softmax_gradient_weighted(
        torch.from_numpy(w), torch.from_numpy(X), torch.from_numpy(y.astype(np.float64)),
        torch.from_numpy(weights), 1e-4).reshape(N, d, K).numpy()
    for c in range(3, K):
        assert np.array_equal(g[..., c], g[..., 2])
    assert not np.array_equal(g[..., 0], g[..., 2])
    with enable_x64():
        gradient = jax.vmap(ref_losses.softmax_gradient_weighted, in_axes=(0, 0, 0, 0, None))
        ref = np.asarray(gradient(jnp.asarray(w), jnp.asarray(X), jnp.asarray(y, dtype=jnp.int32),
                                  jnp.asarray(weights), 1e-4)).reshape(N, d, K)
    assert np.array_equal(ref[..., 3], ref[..., 2])
    assert not np.array_equal(ref[..., K - 1], ref[..., 2])
    np.testing.assert_allclose(ref[..., K - 1], ref[..., 2], rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(g, ref, rtol=1e-15, atol=1e-15)


def test_choco_top_k_at_k13_parts_from_jax_by_one_swap_of_tied_columns(datasets):
    """Why ``RUNS['choco-top-k']`` keeps 7 of the 65 columns: at 13, the
    first exchange's k-th place falls in a tie between two classes absent
    from a worker's batch, which the port breaks to the lower class and
    the JAX package, by its product's last bits, to the last one. The two
    estimates then differ by that one swap and agree everywhere else."""
    fields = dict(SMALL, algorithm="choco", compression="top_k", compression_k=13,
                  n_iterations=1, eval_every=1)
    ds, ours, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, return_state=True)
    got = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu",
                            return_state=True)
    a, b = got.final_state["xhat"], np.asarray(ref.final_state["xhat"])
    rows, cols = np.nonzero(~np.isclose(a, b, **TOL))
    assert rows.tolist() == [rows[0]] * 2
    (row,), (low, high) = set(rows.tolist()), cols.tolist()
    assert low // K == high // K and high % K == K - 1
    assert a[row, high] == 0.0 and b[row, low] == 0.0 and a[row, low] != 0.0
    np.testing.assert_allclose(b[row, high], a[row, low], rtol=1e-15, atol=0)


def test_gradient_tracking_state_carries_across(datasets):
    """A JAX gradient-tracking state of [N, d·K] leaves, carried across by
    ``state_from_reference``, equals the port's own state after the same
    iterations."""
    fields = dict(SMALL, algorithm="gradient_tracking", n_iterations=10, eval_every=10)
    ds, ours, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, return_state=True)
    got = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu",
                            return_state=True)
    carried = state_from_reference(ref.final_state, "cpu", torch.float64)
    assert set(carried) == set(got.final_state) >= {"x", "y"}
    for key, value in carried.items():
        assert value.shape == (8, D_MODEL) and value.is_contiguous()
        np.testing.assert_allclose(value.numpy(), got.final_state[key], **TOL)
    with pytest.raises(ValueError, match="d_model"):
        state_from_reference({"x": ref.final_state["x"].reshape(8, 13, K)}, "cpu", torch.float64)


def test_chip_smoke_softmax_constants_are_the_jax_package_s():
    """``chip_smoke.JAX_FINAL_GAPS['softmax']``: the JAX package's float64
    gap after ``OBJECTIVE_ITERATIONS`` of D-SGD on the study's N=25 ring
    with K=10 (the gather sampler at L=500)."""
    smoke = _smoke()
    cfg = RefConfig(dtype="float64", n_iterations=smoke.OBJECTIVE_ITERATIONS,
                    eval_every=smoke.OBJECTIVE_EVAL_EVERY, **smoke.SOFTMAX_STUDY)
    ds = ref_generate(cfg)
    f_opt = ref_oracle(ds, cfg.reg_param, n_classes=cfg.n_classes)[1]
    ours = generate_synthetic_dataset(ExperimentConfig(**smoke.SOFTMAX_STUDY))
    assert compute_reference_optimum(ours, cfg.reg_param, n_classes=cfg.n_classes)[1] == f_opt
    gap = float(jax_backend.run(cfg, ds, f_opt, use_mesh=False).history.objective[-1])
    assert abs(gap - smoke.JAX_FINAL_GAPS["softmax"]) <= 1e-12 * abs(gap)


def test_cli_runs_softmax_on_the_cpu(capsys):
    import json

    from distributed_optimization_tpu_torch.__main__ import main

    args = ["--device", "cpu", "--problem-type", "softmax", "--n-classes", str(K),
            "--n-workers", "8", "--n-samples", "400", "--n-features", "12",
            "--n-informative-features", "8", "--learning-rate-eta0", "0.5",
            "--n-iterations", "40", "--dtype", "float64", "--matmul-precision", "default",
            "--json"]
    assert main(args) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = ExperimentConfig(**dict(SMALL, n_iterations=40, matmul_precision="default"))
    ds = generate_synthetic_dataset(cfg)
    f_opt = compute_reference_optimum(ds, cfg.reg_param, n_classes=K)[1]
    want = torch_backend.run(cfg, ds, f_opt, device="cpu").history
    assert summary["problem_type"] == "softmax"
    assert summary["total_floats_transmitted"] == 2 * 8 * D_MODEL * 40
    np.testing.assert_allclose(summary["final_gap"], want.objective[-1], **TOL)


def _split_gradient(w, X, y, weights, lam):
    """``softmax_gradient_weighted`` with the batch's sum taken in two parts:
    the same function, rounded otherwise."""
    half = torch.arange(X.shape[1]) < X.shape[1] // 2
    return (losses.softmax_gradient_weighted(w, X, y, weights * half, lam)
            + losses.softmax_gradient_weighted(w, X, y, weights * ~half, 0.0))


@pytest.mark.parametrize("stable", (False, True), ids=("study-gamma", "stable-gamma"))
def test_choco_top_k_on_the_study_amplifies_rounding_without_a_swap(monkeypatch, stable):
    """``chip_smoke.py``'s CHOCO top_k run (the study's N=25 ring, K=10, 81
    of 810 columns, float64), twice on the CPU, the second with the
    gradient rounded otherwise. At the study's γ = 0.3 the two select the
    same columns at every exchange and keep the gap and consensus histories
    to 1e-12, yet their estimates part beyond 1e-12 after T/2 and their
    final models by more: the dynamics amplify rounding, as between the
    card and the CPU. At ``CHOCO_STABLE_GAMMA`` every leaf agrees to 1e-12."""
    smoke = _smoke()
    gamma = smoke.CHOCO_STABLE_GAMMA if stable else ExperimentConfig().choco_gamma
    cfg = ExperimentConfig(**smoke.SOFTMAX_STUDY, mixing_impl="pallas", dtype="float64",
                           n_iterations=smoke.OBJECTIVE_ITERATIONS,
                           eval_every=smoke.OBJECTIVE_EVAL_EVERY, algorithm="choco",
                           compression="top_k", compression_k=smoke.SOFTMAX_TOP_K,
                           choco_gamma=gamma)
    ds = generate_synthetic_dataset(cfg)
    problem = get_problem("softmax", n_classes=cfg.n_classes)
    runs, records = [], ([], [])
    for record, gradient in zip(records, (problem.gradient_weighted, _split_gradient)):
        bound = dataclasses.replace(problem, gradient_weighted=gradient)
        monkeypatch.setattr(torch_backend, "get_problem", lambda *_, _p=bound, **__: _p)
        with smoke._recorded_exchanges(compression_kernels, record):
            runs.append(torch_backend.run(cfg, ds, 0.0, device="cpu", return_state=True))
    a, b = runs
    T = cfg.n_iterations
    assert len(records[0]) == len(records[1]) == T
    assert all(ma.equal(mb) for (_, ma, *_), (_, mb, *_) in zip(*records))
    np.testing.assert_allclose(a.history.objective, b.history.objective, **TOL)
    np.testing.assert_allclose(a.history.consensus_error, b.history.consensus_error, **TOL)
    parted = [float(((xa - xb).abs() / (1.0 + xb.abs())).max())
              for (_, _, xa, _), (_, _, xb, _) in zip(*records)]
    assert max(parted[: T // 2]) <= 1e-12
    assert max(parted) <= smoke.TOP_K_DRIFT
    models_agree = np.allclose(a.final_models, b.final_models, **TOL)
    assert models_agree == stable and (max(parted) <= 1e-12) == stable
