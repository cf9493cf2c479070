"""The port's slice as a whole against ``jax_backend.run``.

Both packages run the same configuration in float64 on one injected batch
schedule (tests/conftest.py::batch_schedule), the JAX package unsharded.
Gap history, consensus history, final models and floats transmitted agree
to 1e-12 (rtol and atol), the repo's float64 parity convention.
"""

import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import batch_schedule
from distributed_optimization_tpu.algorithms import get_algorithm as ref_algorithm
from distributed_optimization_tpu.algorithms.base import StepContext as RefStepContext
from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops import losses as ref_losses
from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_mixing_op
from distributed_optimization_tpu.parallel import build_topology as ref_topology
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.__main__ import main as cli_main
from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.algorithms.base import StepContext
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import ring_kernels
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel.topology import build_topology

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=8, n_samples=400, n_features=10, n_informative_features=6,
             n_iterations=60, topology="ring", local_batch_size=16, dtype="float64")


@pytest.fixture(scope="module")
def problems():
    """(dataset, f_opt) per problem type, from the JAX package."""
    out = {}
    for problem in ("logistic", "quadratic"):
        cfg = RefConfig(**SMALL, problem_type=problem)
        ds = ref_generate(cfg)
        out[problem] = (ds, ref_oracle(ds, cfg.reg_param)[1])
    return out


def _both(problems, **kw):
    fields = dict(SMALL, **kw)
    ds, f_opt = problems[fields["problem_type"]]
    sched = batch_schedule(ds, fields["n_iterations"], fields["local_batch_size"])
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, batch_schedule=sched)
    ours_ds = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                             batch_schedule=sched)
    return ref, ours


def _assert_same_run(ref, ours):
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    if ref.history.consensus_error is None:
        assert ours.history.consensus_error is None
    else:
        np.testing.assert_allclose(ours.history.consensus_error,
                                   ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted


@pytest.mark.parametrize("eval_every", [1, 10])
@pytest.mark.parametrize("mixing_impl", ["stencil", "pallas"])
@pytest.mark.parametrize("problem_type", ["logistic", "quadratic"])
def test_dsgd_run_matches_jax_backend(problems, problem_type, mixing_impl, eval_every):
    ref, ours = _both(problems, problem_type=problem_type, mixing_impl=mixing_impl,
                      eval_every=eval_every)
    _assert_same_run(ref, ours)
    assert ours.history.spectral_gap == pytest.approx(ref.history.spectral_gap, abs=1e-12)


def test_centralized_run_matches_jax_backend(problems):
    ref, ours = _both(problems, problem_type="logistic", algorithm="centralized")
    _assert_same_run(ref, ours)


def test_full_batch_fast_path_matches_jax_backend(problems):
    """b >= L and no schedule: the whole shard at 1/n_i, no sampling."""
    ds, f_opt = problems["quadratic"]
    fields = dict(SMALL, problem_type="quadratic", local_batch_size=64, n_iterations=20)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ds, f_opt, device="cpu")
    _assert_same_run(ref, ours)


@pytest.mark.parametrize("sampling_impl", ["dense", "gather"])
def test_sampled_run_converges_and_the_forms_agree(problems, sampling_impl):
    """Without a schedule the port draws its own batches; the dense and
    gather forms pick the same rows, so their runs agree."""
    ds, f_opt = problems["logistic"]
    cfg = ExperimentConfig(**dict(SMALL, problem_type="logistic", n_iterations=200,
                                  local_batch_size=8, sampling_impl=sampling_impl))
    res = torch_backend.run(cfg, ds, f_opt, device="cpu")
    other = torch_backend.run(cfg.replace(sampling_impl="gather" if sampling_impl == "dense"
                                          else "dense"), ds, f_opt, device="cpu")
    np.testing.assert_allclose(res.history.objective, other.history.objective, **TOL)
    assert np.all(np.isfinite(res.history.objective))
    assert res.history.objective[-1] < 0.6 * res.history.objective[0]


def test_fused_path_is_bound_exactly_for_the_pallas_ring(problems, monkeypatch):
    calls = []
    real = ring_kernels.fused_ring_dsgd_step
    monkeypatch.setattr(ring_kernels, "fused_ring_dsgd_step",
                        lambda *a: calls.append(1) or real(*a))
    ds, f_opt = problems["logistic"]
    for impl, expected in (("pallas", 5), ("stencil", 0)):
        calls.clear()
        cfg = ExperimentConfig(**dict(SMALL, problem_type="logistic", n_iterations=5,
                                      mixing_impl=impl))
        torch_backend.run(cfg, ds, f_opt, device="cpu")
        assert len(calls) == expected


def test_state_from_reference_steps_like_the_reference(problems):
    """One D-SGD step from a random JAX-shaped state, in both packages, with
    the fused ring step and the same full-shard gradient weights."""
    ds, _ = problems["logistic"]
    from distributed_optimization_tpu.utils.data import stack_shards

    stacked = stack_shards(ds, np.float64)
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((8, stacked.X.shape[2]))
    wts = rng.uniform(size=stacked.y.shape) / 10
    eta, lam = 0.03, 1e-4
    ref_cfg = RefConfig(**SMALL, problem_type="logistic", mixing_impl="pallas")
    with enable_x64():
        X, y, w = (jnp.asarray(a) for a in (stacked.X, stacked.y, wts))
        grad = lambda p, slot: jax.vmap(  # noqa: E731
            ref_losses.logistic_gradient_weighted, in_axes=(0, 0, 0, 0, None)
        )(p, X, y, w, lam)
        op = ref_mixing_op(ref_topology("ring", 8), impl="pallas", dtype=jnp.float64)
        ctx = RefStepContext(grad=grad, mix=op.apply, neighbor_sum=op.neighbor_sum,
                             eta=jnp.asarray(eta), t=jnp.asarray(0), degrees=None,
                             config=ref_cfg, fused_mix_step=pk.fused_ring_dsgd_step)
        want = np.asarray(ref_algorithm("dsgd").step({"x": jnp.asarray(x0)}, ctx)["x"])

    state = state_from_reference({"x": x0}, "cpu", torch.float64)
    assert state["x"].dtype == torch.float64 and state["x"].is_contiguous()
    problem = get_problem("logistic")
    Xt, yt, wt = (torch.from_numpy(a) for a in (stacked.X, stacked.y, wts))
    op = make_mixing_op(build_topology("ring", 8), "pallas", device="cpu")
    ctx = StepContext(grad=lambda p, slot: problem.gradient_weighted(p, Xt, yt, wt, lam),
                      mix=op.apply, neighbor_sum=op.neighbor_sum,
                      eta=torch.tensor([eta], dtype=torch.float64),
                      config=ExperimentConfig(**SMALL, problem_type="logistic",
                                              mixing_impl="pallas"),
                      fused_mix_step=ring_kernels.fused_ring_dsgd_step)
    got = get_algorithm("dsgd").step(state, ctx)["x"].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_state_from_reference_round_trips_a_reference_final_state(problems):
    ds, f_opt = problems["quadratic"]
    fields = dict(SMALL, problem_type="quadratic", n_iterations=10)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False,
                          batch_schedule=batch_schedule(ds, 10, 16), return_state=True)
    state = state_from_reference(ref.final_state, "cpu", torch.float32)
    assert set(state) == {"x"} and state["x"].dtype == torch.float32
    np.testing.assert_allclose(state["x"].numpy(), ref.final_models, rtol=1e-6)
    with pytest.raises(ValueError, match="'x'"):
        state_from_reference({"y": ref.final_models}, "cpu", torch.float64)


def test_run_rejects_a_malformed_batch_schedule(problems):
    ds, f_opt = problems["quadratic"]
    cfg = ExperimentConfig(**dict(SMALL, problem_type="quadratic", n_iterations=4))
    sched = batch_schedule(ds, 4, 16)
    with pytest.raises(ValueError, match=r"\[T=4, N=8, b\]"):
        torch_backend.run(cfg, ds, f_opt, device="cpu", batch_schedule=sched[:3])
    sched[1, 2, 0] = 10_000
    with pytest.raises(ValueError, match="must lie in"):
        torch_backend.run(cfg, ds, f_opt, device="cpu", batch_schedule=sched)


def test_default_device_never_falls_back_to_the_cpu(problems, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, f_opt = problems["logistic"]
    cfg = ExperimentConfig(**SMALL, problem_type="logistic")
    with pytest.raises(RuntimeError, match="is_available"):
        torch_backend.run(cfg, ds, f_opt)
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(["--n-iterations", "10"])


def test_cli_runs_one_experiment_on_the_cpu(capsys):
    rc = cli_main(["--device", "cpu", "--problem-type", "logistic", "--n-workers", "8",
                   "--n-samples", "400", "--n-features", "10",
                   "--n-informative-features", "6", "--n-iterations", "100",
                   "--mixing-impl", "pallas", "--json"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["mixing_impl"] == "pallas"
    assert np.isfinite(summary["final_gap"]) and summary["total_floats_transmitted"] == 8 * 2 * 11 * 100
    for key in ("iterations_to_threshold", "final_consensus", "iters_per_second"):
        assert key in summary


@pytest.mark.parametrize("flags, expected", [
    (["--lr-schedule", "constant"], {"lr_schedule": "constant"}),
    (["--classification-sep", "1.2"], {"classification_sep": 1.2}),
    (["--algorithm", "admm", "--admm-rho", "2.0"], {"algorithm": "admm", "admm_rho": 2.0}),
    (["--execution", "async", "--latency-model", "lognormal", "--latency-mean", "2.0",
      "--latency-tail", "1.25"],
     {"execution": "async", "latency_model": "lognormal", "latency_mean": 2.0,
      "latency_tail": 1.25}),
], ids=["lr-schedule", "classification-sep", "admm", "async"])
def test_cli_flags_reach_the_run_as_in_the_reference(flags, expected, capsys):
    """Each flag the JAX CLI has and the port's config reads, through the
    port's ``main``, against ``jax_backend.run`` with the same fields. Full
    batch (b >= L) draws no batches, so both packages take the same steps;
    both runs measure the gap from the port's f*."""
    from distributed_optimization_tpu_torch.__main__ import build_parser, config_from_args
    from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
    from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

    argv = ["--device", "cpu", "--problem-type", "logistic", "--n-workers", "8",
            "--n-samples", "400", "--n-features", "10", "--n-informative-features", "6",
            "--n-iterations", "50", "--local-batch-size", "64", "--dtype", "float64",
            *flags]
    cfg = config_from_args(build_parser().parse_args(argv))
    assert {k: getattr(cfg, k) for k in expected} == expected
    assert cli_main([*argv, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    ref_cfg = RefConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                           if f.name in {g.name for g in dataclasses.fields(RefConfig)}})
    ds = ref_generate(ref_cfg)
    _, f_opt = compute_reference_optimum(generate_synthetic_dataset(cfg), cfg.reg_param)
    ref = jax_backend.run(ref_cfg, ds, f_opt, use_mesh=False)
    np.testing.assert_allclose(summary["final_gap"], ref.history.objective[-1], **TOL)
    np.testing.assert_allclose(summary["final_consensus"], ref.history.consensus_error[-1], **TOL)
    assert summary["total_floats_transmitted"] == ref.total_floats_transmitted
    assert summary["algorithm"] == cfg.algorithm


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "distributed_optimization_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    package = REPO / "distributed_optimization_tpu_torch"
    assert {package / "parallel" / "events.py", package / "backends" / "async_scan.py"} <= set(files)
    for path in files:
        for module in _imports(path):
            root = module.split(".")[0]
            # Nor ml_dtypes or scikit-learn: the card's machine has neither.
            assert root not in ("jax", "jaxlib", "distributed_optimization_tpu", "ml_dtypes",
                                "sklearn"), (
                f"{path.relative_to(REPO)} imports {module}"
            )
