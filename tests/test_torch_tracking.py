"""Gradient tracking, EXTRA and local steps, held to ``jax_backend.run`` on
the JAX package's own batches.

No ``batch_schedule`` here: the port draws its batches through the twin of
``jax.random`` (ops/prng.py), so for the same config and seed both packages
run the same trajectory. Each case runs in float64 in both packages (the
JAX package unsharded, under its float64 runs' ``enable_x64``, its Pallas
kernels in interpret mode) and agrees to 1e-12 (rtol and atol): gap and
consensus histories, final models and floats transmitted. The float32 case
draws bitwise-equal batches and its gaps agree to 1e-5 relative (float32
rounding in two summation orders).
"""

import dataclasses
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
from distributed_optimization_tpu.ops import sampling as ref_sampling
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.__main__ import main as cli_main
from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.ops import prng, sampling
from distributed_optimization_tpu_torch.parallel.topology import build_topology
from distributed_optimization_tpu_torch.utils.data import stack_shards

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=9, n_samples=450, n_features=10, n_informative_features=6,
             n_iterations=60, topology="ring", local_batch_size=16, dtype="float64",
             problem_type="logistic")
BYZANTINE = dict(n_workers=12, n_samples=480, partition="shuffled", attack="sign_flip",
                 n_byzantine=2, attack_scale=2.0)

# name -> the fields each case sets over SMALL.
CASES = {
    "dsgd-dense": dict(sampling_impl="dense"),
    "dsgd-gather": dict(sampling_impl="gather", eval_every=10),
    "gt-ring-stencil": dict(algorithm="gradient_tracking", mixing_impl="stencil"),
    "gt-ring-pallas": dict(algorithm="gradient_tracking", mixing_impl="pallas",
                           sampling_impl="dense"),
    "gt-fc-stencil": dict(algorithm="gradient_tracking", topology="fully_connected",
                          mixing_impl="stencil"),
    "gt-fc-pallas": dict(algorithm="gradient_tracking", topology="fully_connected",
                         mixing_impl="pallas", eval_every=5),
    "gt-grid-stencil": dict(algorithm="gradient_tracking", topology="grid",
                            mixing_impl="stencil"),
    "gt-quadratic": dict(algorithm="gradient_tracking", problem_type="quadratic"),
    "extra-ring-stencil": dict(algorithm="extra", mixing_impl="stencil"),
    "extra-ring-pallas": dict(algorithm="extra", mixing_impl="pallas", eval_every=10),
    "extra-fc-pallas": dict(algorithm="extra", topology="fully_connected",
                            mixing_impl="pallas", sampling_impl="dense"),
    "dsgd-tau3": dict(local_steps=3, mixing_impl="pallas"),
    "gt-tau3": dict(algorithm="gradient_tracking", local_steps=3, sampling_impl="dense"),
    "gt-signflip-trimmed-mean-fused": dict(BYZANTINE, algorithm="gradient_tracking",
                                           aggregation="trimmed_mean", robust_b=1,
                                           robust_impl="fused", mixing_impl="pallas"),
    # The first repair: batch weights are float32(1/b_eff) cast to float64,
    # so a b_eff that is not a power of two rounds as in the JAX package
    # (the second, shards shorter than b, is test_repair_short_shards_...).
    "repair-batch-12": dict(local_batch_size=12),
}
# Shards of 0, 3, 5 and 13 rows beside full ones (L = 100 > b = 16): their
# b_eff is the shard's length, which float32 does not hold exactly.
RAGGED = (3, 0, 13, 5, 60, 70, 100, 99, 100)


@pytest.fixture(scope="module")
def datasets():
    """(dataset, port dataset, f_opt) by (n_samples, n_workers, partition, problem)."""
    cache = {}

    def get(fields):
        key = tuple(fields[k] for k in ("n_samples", "n_workers", "partition", "problem_type"))
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


def _both(datasets, **kw):
    fields = {**SMALL, "partition": "sorted", **kw}
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    return ref, ours


def _assert_same_run(ref, ours, tol=TOL):
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **tol)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **tol)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **tol)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **tol)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax_backend_on_its_own_batches(datasets, name):
    ref, ours = _both(datasets, **CASES[name])
    _assert_same_run(ref, ours)
    assert np.all(np.isfinite(ours.history.objective))


@pytest.mark.parametrize("algorithm,sampling_impl", [("dsgd", "dense"),
                                                     ("gradient_tracking", "gather")])
def test_repair_short_shards_match_jax_backend(datasets, algorithm, sampling_impl):
    """The second repair: shards shorter than the batch, beside full ones,
    so that sampling runs (L > b) with b_eff = n_i on the short ones."""
    fields = dict(SMALL, partition="sorted", algorithm=algorithm, sampling_impl=sampling_impl)
    ds, _, f_opt = datasets(fields)
    rows = np.concatenate(ds.shard_indices)
    shards = np.split(rows, np.cumsum(RAGGED)[:-1])
    ds = dataclasses.replace(ds, shard_indices=shards)
    ours_ds = dataset_from_reference(ds.X_full, ds.y_full, shards, ds.problem_type)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    _assert_same_run(ref, ours)


def test_repair_cases_draw_batches_whose_weights_need_float32_rounding():
    """The repair cases really meet a b_eff that float32 does not hold."""
    for b_eff in (12, *(n for n in RAGGED if 0 < n < 16)):
        assert np.float64(np.float32(1 / b_eff)) != 1 / b_eff


def test_gradient_tracking_counts_two_gossip_rounds(datasets):
    ref, ours = _both(datasets, algorithm="gradient_tracking", n_iterations=10)
    topo = build_topology("ring", SMALL["n_workers"])
    d = SMALL["n_features"] + 1
    assert ours.total_floats_transmitted == 2 * topo.floats_per_iteration * d * 10
    assert ref.total_floats_transmitted == ours.total_floats_transmitted


def test_float32_run_draws_the_same_batches_and_agrees_to_1e5(datasets):
    """Every iteration's batch weights equal the JAX sampler's bit for bit
    (float32 scores, no x64), and the two runs' gaps agree to 1e-5
    relative."""
    fields = dict(SMALL, partition="sorted", dtype="float32", algorithm="gradient_tracking",
                  sampling_impl="dense", n_iterations=80)
    ds, ours_ds, f_opt = datasets(fields)
    n_valid = stack_shards(ours_ds, np.float32).n_valid
    L = max(len(s) for s in ds.shard_indices)
    seed = ExperimentConfig().seed
    slot_key = prng.fold_in(prng.key(seed, x64=False), 0)
    ref_key = jax.random.fold_in(jax.random.key(seed), 0)
    for t in range(fields["n_iterations"]):
        want = np.asarray(ref_sampling.sample_worker_batch_weights(
            ref_key, t, jnp.asarray(n_valid), L, 16))
        got = sampling.sample_worker_batch_weights(slot_key, t, torch.as_tensor(n_valid), L, 16,
                                                   torch.float32).numpy()
        assert np.array_equal(got, want), t
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    rel = np.abs(ours.history.objective - ref.history.objective) / np.abs(ref.history.objective)
    assert float(rel.max()) <= 1e-5


def test_gradient_tracking_screens_both_gossip_rounds(datasets, monkeypatch):
    """Under Byzantine screening GT mixes twice an iteration through the
    robust aggregator, and the fused robust D-SGD step is not bound."""
    calls = []
    real = torch_backend.make_fused_robust_aggregator

    def counting(*args, **kw):
        agg = real(*args, **kw)
        return lambda live, x: calls.append(1) or agg(live, x)

    monkeypatch.setattr(torch_backend, "make_fused_robust_aggregator", counting)
    monkeypatch.setattr(torch_backend, "make_fused_robust_dsgd_step",
                        lambda *a, **k: pytest.fail("the fused D-SGD step was bound for GT"))
    fields = dict(SMALL, **CASES["gt-signflip-trimmed-mean-fused"], n_iterations=7)
    _, ours_ds, f_opt = datasets(dict(fields))
    torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    assert len(calls) == 2 * 7


@pytest.mark.parametrize("algorithm", ["dsgd", "gradient_tracking"])
def test_local_steps_auto_robust_form_stays_on_gather_as_in_the_reference(algorithm):
    cfg = ExperimentConfig(**dict(SMALL, **BYZANTINE, algorithm=algorithm,
                                  aggregation="trimmed_mean", robust_b=1))
    topo = build_topology("ring", cfg.n_workers)
    assert torch_backend.resolve_robust_impl(cfg, topo) == "fused"
    assert torch_backend.resolve_robust_impl(cfg.replace(local_steps=2), topo) == "gather"


@pytest.mark.parametrize("algorithm", ["extra", "admm", "centralized"])
def test_local_steps_are_refused_as_in_the_reference(algorithm):
    with pytest.raises(ValueError, match="unsupported for") as ref_err:
        RefConfig(algorithm=algorithm, local_steps=3)
    with pytest.raises(ValueError, match="unsupported for") as our_err:
        ExperimentConfig(algorithm=algorithm, local_steps=3)
    assert str(our_err.value) == str(ref_err.value)
    for ok in ("dsgd", "gradient_tracking"):
        assert ExperimentConfig(algorithm=ok, local_steps=3).local_steps == 3


def test_extra_with_byzantine_injection_is_refused(datasets):
    fields = dict(SMALL, **BYZANTINE, algorithm="extra", n_iterations=4)
    _, ours_ds, f_opt = datasets(dict(fields, problem_type="logistic"))
    with pytest.raises(ValueError, match="use 'dsgd' or 'gradient_tracking'"):
        torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")


def test_gradient_tracking_pallas_on_the_grid_raises_as_in_the_reference(datasets):
    fields = dict(SMALL, partition="sorted", algorithm="gradient_tracking", topology="grid",
                  mixing_impl="pallas", n_iterations=4)
    ds, ours_ds, f_opt = datasets(fields)
    with pytest.raises(ValueError):
        jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    with pytest.raises(ValueError, match="pallas"):
        torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")


def test_extra_first_step_is_the_plain_gossip_step():
    """At t = 0 EXTRA takes W x − η g, after it the corrected recursion:
    ``torch.where`` on the counter chooses, as ``jnp.where`` does."""
    algo = get_algorithm("extra")
    cfg = ExperimentConfig(algorithm="extra")
    x0 = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    state = algo.init(x0, cfg)
    W = lambda v: 0.5 * v + 0.5 * torch.roll(v, 1, 0)  # noqa: E731
    g = lambda v, s: 0.1 * v + 1.0  # noqa: E731
    eta = torch.tensor([0.3], dtype=torch.float64)
    from distributed_optimization_tpu_torch.algorithms.base import StepContext

    ctx = lambda t: StepContext(grad=g, mix=W, neighbor_sum=W, eta=eta, config=cfg,  # noqa: E731
                                t=torch.tensor([t]))
    s1 = algo.step(state, ctx(0))
    torch.testing.assert_close(s1["x"], W(x0) - eta * g(x0, 0), rtol=0, atol=0)
    s2 = algo.step(s1, ctx(1))
    x1 = s1["x"]
    want = x1 + W(x1) - 0.5 * (x0 + W(x0)) - eta * (g(x1, 0) - g(x0, 0))
    torch.testing.assert_close(s2["x"], want, rtol=0, atol=0)


def test_cli_runs_gradient_tracking_with_local_steps(capsys):
    """``--algorithm gradient_tracking --local-steps 2`` reaches the run:
    the summary is the run's, and not the τ = 1 run's."""
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    fields = dict(SMALL, algorithm="gradient_tracking", local_steps=2, n_iterations=20)
    cfg = ExperimentConfig(**fields)
    ds = generate_synthetic_dataset(cfg)
    f_opt = compute_reference_optimum(ds, cfg.reg_param)[1]
    want = torch_backend.run(cfg, ds, f_opt, device="cpu").history.objective[-1]
    one_step = torch_backend.run(cfg.replace(local_steps=1), ds, f_opt,
                                 device="cpu").history.objective[-1]
    argv = ["--device", "cpu", "--json", "--algorithm", "gradient_tracking", "--local-steps", "2",
            "--n-workers", "9", "--n-samples", "450", "--n-features", "10",
            "--n-informative-features", "6", "--n-iterations", "20", "--dtype", "float64",
            "--problem-type", "logistic"]
    assert cli_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["algorithm"] == "gradient_tracking"
    assert summary["final_gap"] == want != one_step


def test_chip_smoke_tracking_counts_are_the_jax_package_s():
    """``chip_smoke.TRACKING_RUNS``: the JAX package's iterations to ε at the
    tracking phase's configs (main-path data, float32, mixing 'stencil'),
    each run just past its crossing (the step sizes do not depend on T)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    base = RefConfig(problem_type="logistic", topology="ring", n_workers=256, dtype="float32",
                     eval_every=1, mixing_impl="stencil")
    ds = ref_generate(base)
    f_opt = ref_oracle(ds, base.reg_param)[1]
    for name, (fields, T, want) in smoke.TRACKING_RUNS.items():
        assert want < T
        cfg = base.replace(n_iterations=want + 10, **fields)
        h = jax_backend.run(cfg, ds, f_opt, use_mesh=False).history
        assert iterations_to_threshold(h.objective, 0.08, h.eval_iterations) == want, name
