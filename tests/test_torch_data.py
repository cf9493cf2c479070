"""The port's host-side pieces against the JAX package: the numpy data
generator (against scikit-learn's), the scipy optimum oracle, the float64
objectives and the torch losses."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops import losses as ref_losses
from distributed_optimization_tpu.ops import losses_np as ref_losses_np
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.utils.data import (
    generate_synthetic_dataset as ref_generate,
    stack_shards as ref_stack,
)
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch import metrics
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import losses, losses_np
from distributed_optimization_tpu_torch.utils.data import (
    generate_synthetic_dataset,
    make_classification,
    stack_shards,
)
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

PARITY = dict(problem_type="logistic")  # N=25, 12,500 × 80: bench.py's parity config
SMALL = dict(n_workers=8, n_samples=400, n_features=10, n_informative_features=6)


@pytest.fixture(scope="module", params=[
    PARITY, dict(problem_type="quadratic"),
    dict(SMALL, problem_type="logistic"), dict(SMALL, problem_type="quadratic"),
], ids=["logistic-parity", "quadratic", "logistic-small", "quadratic-small"])
def both(request):
    ref_cfg = RefConfig(**request.param)
    return (ref_cfg, ref_generate(ref_cfg),
            ExperimentConfig(**request.param), generate_synthetic_dataset(ExperimentConfig(**request.param)))


def test_generator_matches_sklearn(both):
    _, ref, _, ours = both
    np.testing.assert_array_equal(ours.y_full, ref.y_full)
    assert len(ours.shard_indices) == len(ref.shard_indices)
    for a, b in zip(ours.shard_indices, ref.shard_indices):
        np.testing.assert_array_equal(a, b)
    assert ours.X_full.shape == ref.X_full.shape
    np.testing.assert_allclose(ours.X_full, ref.X_full, rtol=0, atol=1e-12)


def test_stack_shards_matches(both):
    _, ref, _, ours = both
    a, b = stack_shards(ours, np.float64), ref_stack(ref, np.float64)
    np.testing.assert_array_equal(a.n_valid, b.n_valid)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_allclose(a.X, b.X, rtol=0, atol=1e-12)


def test_oracle_matches_sklearn(both):
    ref_cfg, ref, cfg, ours = both
    _, f_ref = ref_oracle(ref, ref_cfg.reg_param)
    w_opt, f_ours = compute_reference_optimum(ours, cfg.reg_param)
    tol = 1e-7 if cfg.problem_type == "logistic" else 1e-10
    assert abs(f_ours - f_ref) <= tol
    assert w_opt.shape == (ours.n_features,)
    # The port's optimum is a minimum of the port's objective.
    obj = losses_np.OBJECTIVES[cfg.problem_type]
    assert f_ours <= obj(np.zeros_like(w_opt), ours.X_full, ours.y_full, cfg.reg_param)


@pytest.mark.parametrize("n_clusters,n_informative", [(2, 1), (4, 3), (2, 40)])
def test_hypercube_branches_match_sklearn(n_clusters, n_informative):
    """The reservoir (ratio >= 0.99), permutation (0.01 < ratio < 0.99) and
    above-30-dimension branches of the centroid draw, against scikit-learn."""
    from sklearn.datasets import make_classification as sk_make

    kw = dict(n_samples=60, n_features=n_informative + 2, n_informative=n_informative,
              n_redundant=0, flip_y=0.05, class_sep=0.7)
    n_classes = n_clusters
    X_ref, y_ref = sk_make(**kw, n_classes=n_classes, n_clusters_per_class=1,
                           random_state=11)
    X, y = make_classification(kw["n_samples"], kw["n_features"], kw["n_informative"],
                               kw["n_redundant"], n_classes=n_classes,
                               flip_y=kw["flip_y"], class_sep=kw["class_sep"], seed=11)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(X, X_ref)


@pytest.mark.parametrize("name", ["logistic", "quadratic"])
def test_losses_np_match(name):
    rng = np.random.default_rng(4)
    X, w = rng.standard_normal((30, 6)), rng.standard_normal(6)
    y = np.sign(rng.standard_normal(30)) if name == "logistic" else rng.standard_normal(30)
    assert losses_np.OBJECTIVES[name](w, X, y, 1e-3) == ref_losses_np.OBJECTIVES[name](w, X, y, 1e-3)
    np.testing.assert_array_equal(losses_np.GRADIENTS[name](w, X, y, 1e-3),
                                  ref_losses_np.GRADIENTS[name](w, X, y, 1e-3))
    assert losses_np.OBJECTIVES[name](w, X[:0], y[:0], 1e-3) == 0.0


@pytest.mark.parametrize("name", ["logistic", "quadratic"])
def test_weighted_losses_match_jax_in_float64(name):
    rng = np.random.default_rng(5)
    N, L, d = 4, 9, 7
    X = rng.standard_normal((N, L, d))
    y = np.sign(rng.standard_normal((N, L))) if name == "logistic" else rng.standard_normal((N, L))
    w = rng.standard_normal((N, d)) * 3.0  # large margins exercise the stable softplus
    weights = rng.uniform(size=(N, L)) * (rng.uniform(size=(N, L)) < 0.6)
    lam = 1e-3
    problem = get_problem(name)
    t = [torch.from_numpy(a) for a in (w, X, y, weights)]
    got_obj = problem.objective_weighted(*t, lam).numpy()
    got_grad = problem.gradient_weighted(*t, lam).numpy()
    ref_obj = getattr(ref_losses, f"{name}_objective_weighted")
    ref_grad = getattr(ref_losses, f"{name}_gradient_weighted")
    with enable_x64():
        for i in range(N):
            args = [jnp.asarray(a[i]) for a in (w, X, y, weights)]
            np.testing.assert_allclose(got_obj[i], float(ref_obj(*args, lam)), rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(got_grad[i], np.asarray(ref_grad(*args, lam)),
                                       rtol=1e-13, atol=1e-13)


def test_softplus_is_stable_at_large_margins():
    z = torch.tensor([-800.0, -30.0, 0.0, 30.0, 800.0], dtype=torch.float64)
    got = losses._softplus_neg(z)
    assert torch.all(torch.isfinite(got))
    assert float(got[0]) == 800.0 and float(got[-1]) == 0.0


def test_problem_registry():
    assert get_problem("logistic").name == "logistic"
    with pytest.raises(ValueError, match="does not have it yet"):
        get_problem("poisson")


def test_metrics_match_the_reference():
    from distributed_optimization_tpu import metrics as ref_metrics

    gaps = np.array([0.5, 0.2, 0.08, 0.07])
    its = np.array([10, 20, 30, 40])
    assert metrics.iterations_to_threshold(gaps, 0.08, its) == 30
    assert metrics.iterations_to_threshold(gaps, 0.08) == ref_metrics.iterations_to_threshold(gaps, 0.08)
    assert metrics.iterations_to_threshold(gaps, 0.01) == -1
    models = np.random.default_rng(0).standard_normal((5, 3))
    assert metrics.consensus_error(models) == ref_metrics.consensus_error(models)
    assert metrics.centralized_floats_per_iteration(25, 81) == 2 * 25 * 81


def test_config_refuses_what_the_port_lacks():
    with pytest.raises(ValueError, match="does not have it yet"):
        ExperimentConfig(problem_type="poisson")
    with pytest.raises(ValueError, match="does not have it yet"):
        ExperimentConfig(mixing_impl="shard_map")
    # The matrix-free representation and the sparse sampler are ported.
    assert ExperimentConfig(topology_impl="neighbor").resolved_topology_impl() == "neighbor"
    assert ExperimentConfig(topology="erdos_renyi",
                            topology_sampler="sparse").resolved_topology_sampler() == "sparse"
    # bfloat16 runs the synchronous single run; its compositions with the
    # layers whose kernels lack a bfloat16 instance are refused.
    assert ExperimentConfig(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="bfloat16.*does not have it yet"):
        ExperimentConfig(dtype="bfloat16", execution="async")
    with pytest.raises(ValueError, match="must divide"):
        ExperimentConfig(n_iterations=10, eval_every=3)


@pytest.mark.parametrize("fields", [
    dict(huber_delta=0.0), dict(huber_delta=-1.0), dict(n_classes=1),
    dict(matmul_precision="fastest"),
], ids=["delta-zero", "delta-negative", "one-class", "precision"])
def test_objective_fields_are_refused_with_the_reference_s_messages(fields):
    with pytest.raises(ValueError) as want:
        RefConfig(**fields)
    with pytest.raises(ValueError) as got:
        ExperimentConfig(**fields)
    assert str(got.value) == str(want.value)


def test_cli_takes_the_objective_flags():
    from distributed_optimization_tpu_torch.__main__ import build_parser, config_from_args

    defaults = config_from_args(build_parser().parse_args([]))
    assert (defaults.n_classes, defaults.huber_delta, defaults.matmul_precision) == (
        RefConfig().n_classes, RefConfig().huber_delta, RefConfig().matmul_precision)
    cfg = config_from_args(build_parser().parse_args([
        "--problem-type", "softmax", "--n-classes", "7", "--huber-delta", "2.5",
        "--matmul-precision", "default"]))
    assert (cfg.problem_type, cfg.n_classes, cfg.huber_delta, cfg.matmul_precision) == (
        "softmax", 7, 2.5, "default")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--matmul-precision", "fastest"])


def test_config_defaults_and_resolution_match_the_reference():
    ours, ref = ExperimentConfig(), RefConfig()
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(ref, field.name), field.name
    for problem in ("logistic", "quadratic", "huber", "softmax"):
        assert ours.replace(problem_type=problem).reg_param == ref.replace(problem_type=problem).reg_param
    for L in (49, 64, 65, 500):
        assert ours.resolved_sampling_impl("cuda", L) == ref.resolved_sampling_impl("tpu", L)
        assert ours.resolved_sampling_impl("cpu", L) == ref.resolved_sampling_impl("cpu", L)
    assert ours.resolved_lr_schedule() == ref.resolved_lr_schedule()
    assert ours.replace(data_seed=7).resolved_data_seed() == 7
