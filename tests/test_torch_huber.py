"""The Huber family of the port against the JAX package.

The weighted torch forms against ``ops/losses.py`` (float64, across the δ
transition), the numpy twins against ``ops/losses_np.py``, the scipy oracle
against ``compute_reference_optimum``, the regression data bit for bit,
``get_problem``'s per-δ cache, and runs on the CPU against
``jax_backend.run`` in float64 on the JAX package's own batches (its
``pallas`` runs in interpret mode) to 1e-12 (rtol and atol). Also the
constants ``chip_smoke.py``'s objectives phase holds the card to,
recomputed from the JAX package.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops import losses as ref_losses
from distributed_optimization_tpu.ops import losses_np as ref_losses_np
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import DEFAULT_HUBER_DELTA, ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import losses, losses_np
from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

TOL = dict(rtol=1e-12, atol=1e-12)
# tests/test_huber.py's small config (tests/conftest.py::small_backend_config).
SMALL = dict(problem_type="huber", n_workers=8, n_samples=400, n_features=10,
             n_informative_features=6, n_iterations=60, local_batch_size=16, dtype="float64")
RUNS = {
    "dsgd-stencil": dict(mixing_impl="stencil"),
    "dsgd-pallas": dict(mixing_impl="pallas"),
    "dsgd-dense-sampling": dict(sampling_impl="dense", eval_every=10),
    "dsgd-delta-2.5": dict(huber_delta=2.5),
    "gradient-tracking": dict(algorithm="gradient_tracking"),
    "extra": dict(algorithm="extra", mixing_impl="pallas"),
    "admm": dict(algorithm="admm", mixing_impl="pallas"),
    "exact-full-batch": dict(algorithm="gradient_tracking", local_batch_size=50,
                             lr_schedule="constant", eval_every=10),
}


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def small():
    cfg = RefConfig(**SMALL)
    ds = ref_generate(cfg)
    ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
    return ds, ours


def _residual_inputs(delta, seed=3):
    """Worker stacks whose residuals x_lᵀw − y_l fall on both sides of ±δ."""
    rng = np.random.default_rng(seed)
    N, L, d = 4, 11, 6
    X = rng.standard_normal((N, L, d))
    w = rng.standard_normal((N, d))
    r = delta * rng.uniform(-3.0, 3.0, size=(N, L))
    r[:, 0], r[:, 1] = delta, -delta  # exactly on the kink
    y = np.einsum("nld,nd->nl", X, w) - r
    weights = rng.uniform(size=(N, L)) * (rng.uniform(size=(N, L)) < 0.7)
    return w, X, y, weights


@pytest.mark.parametrize("delta", (DEFAULT_HUBER_DELTA, 2.5, 0.3))
def test_weighted_forms_match_jax_across_the_transition(delta):
    w, X, y, weights = _residual_inputs(delta)
    lam = 1e-3
    t = [torch.from_numpy(a) for a in (w, X, y, weights)]
    got_obj = losses.huber_objective_weighted(*t, lam, delta).numpy()
    got_grad = losses.huber_gradient_weighted(*t, lam, delta)
    assert got_grad.is_contiguous() and got_grad.shape == w.shape
    a = np.abs(np.einsum("nld,nd->nl", X, w) - y)
    assert np.any(a < delta) and np.any(a > delta)
    with enable_x64():
        for i in range(X.shape[0]):
            args = [jnp.asarray(v[i]) for v in (w, X, y, weights)]
            want_obj = float(ref_losses.huber_objective_weighted(*args, lam, delta=delta))
            want_grad = np.asarray(ref_losses.huber_gradient_weighted(*args, lam, delta=delta))
            np.testing.assert_allclose(got_obj[i], want_obj, rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(got_grad[i].numpy(), want_grad, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("delta", (DEFAULT_HUBER_DELTA, 0.3))
def test_numpy_twins_match_the_reference(delta):
    w, X, y, _ = _residual_inputs(delta, seed=4)
    X, y = X[0], y[0]
    w = w[0]
    assert (losses_np.huber_objective(w, X, y, 1e-3, delta)
            == ref_losses_np.huber_objective(w, X, y, 1e-3, delta))
    np.testing.assert_array_equal(losses_np.huber_gradient(w, X, y, 1e-3, delta),
                                  ref_losses_np.huber_gradient(w, X, y, 1e-3, delta))
    assert losses_np.OBJECTIVES["huber"](w, X[:0], y[:0], 1e-3) == 0.0
    np.testing.assert_array_equal(losses_np.GRADIENTS["huber"](w, X[:0], y[:0], 1e-3),
                                  np.zeros_like(w))
    assert losses_np.OBJECTIVES["huber"] is losses_np.huber_objective


@pytest.mark.parametrize("delta", (None, 2.5))
def test_oracle_matches_the_reference(small, delta):
    ds, ours = small
    reg = RefConfig(**SMALL).reg_param
    w_ref, f_ref = ref_oracle(ds, reg, huber_delta=delta)
    w_opt, f_opt = compute_reference_optimum(ours, reg, huber_delta=delta)
    assert abs(f_opt - f_ref) <= 1e-12 * abs(f_ref)
    np.testing.assert_allclose(w_opt, w_ref, rtol=1e-9, atol=1e-9)
    assert w_opt.shape == (11,)


def test_dataset_is_the_reference_s_bit_for_bit():
    for fields in (SMALL, dict(problem_type="huber", n_workers=256)):
        ref = ref_generate(RefConfig(**fields))
        ours = generate_synthetic_dataset(ExperimentConfig(**fields))
        assert ours.problem_type == "huber"
        np.testing.assert_array_equal(ours.y_full, ref.y_full)
        np.testing.assert_array_equal(ours.X_full, ref.X_full)
        for a, b in zip(ours.shard_indices, ref.shard_indices, strict=True):
            np.testing.assert_array_equal(a, b)


def test_get_problem_caches_one_problem_per_delta():
    default = get_problem("huber")
    assert default.name == "huber" and default.param_dim(81) == 81
    assert get_problem("huber", huber_delta=2.5) is get_problem("huber", huber_delta=2.5)
    assert get_problem("huber", huber_delta=2.5) is not default
    assert get_problem("huber", huber_delta=DEFAULT_HUBER_DELTA) is default
    # The other families ignore δ.
    assert get_problem("quadratic", huber_delta=2.5) is get_problem("quadratic")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runs_match_jax_backend(small, name):
    ds, ours = small
    fields = {**SMALL, **RUNS[name]}
    f_opt = ref_oracle(ds, RefConfig(**fields).reg_param,
                       huber_delta=fields.get("huber_delta"))[1]
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    got = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu")
    assert got.final_models.shape == (8, 11)
    np.testing.assert_array_equal(got.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(got.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(got.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(got.final_models, ref.final_models, **TOL)
    assert got.history.total_floats_transmitted == ref.history.total_floats_transmitted


def test_delta_changes_the_trajectory(small):
    ds, ours = small
    runs = [torch_backend.run(ExperimentConfig(**SMALL, huber_delta=delta), ours, 0.0,
                              device="cpu").history.objective for delta in (10.0, 2.5)]
    assert np.all(np.isfinite(runs[0])) and not np.allclose(runs[0], runs[1])


def test_chip_smoke_huber_constants_are_the_jax_package_s():
    """``chip_smoke.JAX_FINAL_GAPS['huber']``: the JAX package's float64
    gap after ``OBJECTIVE_ITERATIONS`` on the main path's shapes (N=256
    ring, the dense sampler), and its f*."""
    smoke = _smoke()
    cfg = RefConfig(dtype="float64", n_iterations=smoke.OBJECTIVE_ITERATIONS,
                    eval_every=smoke.OBJECTIVE_EVAL_EVERY, **smoke.HUBER_MAIN)
    ds = ref_generate(cfg)
    f_opt = ref_oracle(ds, cfg.reg_param)[1]
    ours = generate_synthetic_dataset(ExperimentConfig(**smoke.HUBER_MAIN))
    assert compute_reference_optimum(ours, cfg.reg_param)[1] == f_opt
    gap = float(jax_backend.run(cfg, ds, f_opt, use_mesh=False).history.objective[-1])
    assert abs(gap - smoke.JAX_FINAL_GAPS["huber"]) <= 1e-12 * abs(gap)


def test_dense_sampling_past_the_crossover_warns_as_in_the_reference():
    """Forcing sampling_impl='dense' past DENSE_SAMPLING_WARN_ROWS warns,
    as the JAX package does; at the threshold and under 'auto' it does not."""
    import warnings

    assert torch_backend.DENSE_SAMPLING_WARN_ROWS == jax_backend.DENSE_SAMPLING_WARN_ROWS
    fields = dict(SMALL, n_workers=2, n_iterations=2, eval_every=2, sampling_impl="dense")
    for n_samples, warns in ((2 * 257, True), (2 * 256, False)):
        cfg = ExperimentConfig(**dict(fields, n_samples=n_samples))
        ds = generate_synthetic_dataset(cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch_backend.run(cfg, ds, 0.0, device="cpu")
            torch_backend.run(cfg.replace(sampling_impl="auto"), ds, 0.0, device="cpu")
        dense = [w for w in caught if "--sampling-impl dense" in str(w.message)]
        assert len(dense) == warns, n_samples
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jax_backend.run(RefConfig(**dict(fields, n_samples=n_samples)), ref_generate(
                RefConfig(**dict(fields, n_samples=n_samples))), 0.0, use_mesh=False)
        assert len([w for w in caught if "--sampling-impl dense" in str(w.message)]) == warns


def test_cli_runs_huber_on_the_cpu(capsys):
    import json

    from distributed_optimization_tpu_torch.__main__ import main

    args = ["--device", "cpu", "--problem-type", "huber", "--huber-delta", "2.5", "--n-workers",
            "8", "--n-samples", "400", "--n-features", "10", "--n-informative-features", "6",
            "--n-iterations", "40", "--dtype", "float64", "--json"]
    assert main(args) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = ExperimentConfig(**dict(SMALL, n_iterations=40, huber_delta=2.5))
    ds = generate_synthetic_dataset(cfg)
    f_opt = compute_reference_optimum(ds, cfg.reg_param, huber_delta=2.5)[1]
    want = torch_backend.run(cfg, ds, f_opt, device="cpu").history
    assert summary["problem_type"] == "huber"
    np.testing.assert_allclose(summary["final_gap"], want.objective[-1], **TOL)
