"""The periodic grid (torus) in the port against the JAX package.

The topology (adjacency, MH weights, degrees, grid shape, spectral gap,
floats per iteration) equals the JAX package's; the stencil and dense
mixing forms agree with its ``make_mixing_op`` to 1e-12 in float64; D-SGD
and ADMM runs on one injected batch schedule (tests/conftest.py::
batch_schedule), the JAX package unsharded, agree with ``jax_backend.run``
to 1e-12 (rtol and atol), the repo's float64 parity convention; and what
the JAX package refuses on the grid, the port refuses with its message.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import batch_schedule
from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.metrics import (
    decentralized_floats_per_iteration as ref_floats_per_iteration,
)
from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_mixing_op
from distributed_optimization_tpu.parallel import build_topology as ref_topology
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.parallel.topology import (
    torus_spectral_gap_closed_form as ref_torus_gap,
)
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.__main__ import main as cli_main
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.metrics import decentralized_floats_per_iteration
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel.topology import build_topology

TOL = dict(rtol=1e-12, atol=1e-12)
SIDES = (2, 3, 4, 5, 6)  # n = 4 is the 2 x 2 torus, whose neighbours collapse
SMALL = dict(n_workers=9, n_samples=450, n_features=10, n_informative_features=6,
             n_iterations=40, topology="grid", local_batch_size=16, dtype="float64")


@pytest.mark.parametrize("n", [s * s for s in SIDES])
def test_grid_topology_equals_the_reference(n):
    ref, ours = ref_topology("grid", n), build_topology("grid", n)
    np.testing.assert_array_equal(ours.adjacency, ref.adjacency)
    np.testing.assert_array_equal(ours.mixing_matrix, ref.mixing_matrix)
    np.testing.assert_array_equal(ours.degrees, ref.degrees)
    assert ours.grid_shape == ref.grid_shape
    assert ours.spectral_gap == pytest.approx(ref.spectral_gap, abs=1e-12)
    side = ours.grid_shape[0]
    if side >= 3:
        assert ours.spectral_gap == ref_torus_gap(side)
        assert np.all(ours.mixing_matrix[ours.adjacency > 0] == 1.0 / 5.0)
    assert ours.floats_per_iteration == ref.floats_per_iteration
    assert (decentralized_floats_per_iteration(ours, 81)
            == ref_floats_per_iteration(ref, 81))


def test_grid_spectral_gap_is_the_study_value():
    """The reference study's §III-A value for the 5 x 5 torus, and its 25
    workers × 4 neighbours × 81 floats a round."""
    topo = build_topology("grid", 25)
    assert topo.spectral_gap == pytest.approx(0.2764, abs=5e-5)
    assert decentralized_floats_per_iteration(topo, 81) * 10_000 == 8.1e7


@pytest.mark.parametrize("fn", ["apply", "neighbor_sum"])
@pytest.mark.parametrize("n, impl", [(4, "dense"), (9, "stencil"), (9, "dense"),
                                     (16, "stencil"), (25, "stencil"), (25, "dense"),
                                     (36, "stencil")])
def test_grid_mixing_matches_the_reference(n, impl, fn):
    x = np.random.default_rng(n).standard_normal((n, 7))
    with enable_x64():
        want = np.asarray(getattr(ref_mixing_op(ref_topology("grid", n), impl,
                                                dtype=jnp.float64), fn)(jnp.asarray(x)))
    op = make_mixing_op(build_topology("grid", n), impl, device="cpu", dtype=torch.float64)
    assert op.impl == impl
    got = getattr(op, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [9, 16, 25])
def test_grid_stencil_and_dense_agree_to_float32_rounding(n):
    topo = build_topology("grid", n)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 81)).astype(np.float32))
    stencil = make_mixing_op(topo, "auto", device="cpu")
    dense = make_mixing_op(topo, "dense", device="cpu", dtype=torch.float32)
    assert stencil.impl == "stencil"
    # Five terms summed in two orders, each rounded to float32.
    tol = 8 * float(np.finfo(np.float32).eps) * float(x.abs().max())
    for fn in ("apply", "neighbor_sum"):
        diff = (getattr(stencil, fn)(x) - getattr(dense, fn)(x)).abs().max()
        assert float(diff) <= tol


def test_auto_mixing_on_the_collapsed_torus_is_dense():
    assert make_mixing_op(build_topology("grid", 4), "auto", device="cpu").impl == "dense"


@pytest.fixture(scope="module")
def problems():
    """(dataset, f_opt) per (problem type, N), from the JAX package."""
    out = {}
    for problem in ("logistic", "quadratic"):
        for n in (4, 9):
            cfg = RefConfig(**dict(SMALL, n_workers=n, n_samples=50 * n), problem_type=problem)
            ds = ref_generate(cfg)
            out[problem, n] = (ds, ref_oracle(ds, cfg.reg_param)[1])
    return out


def _both(problems, **kw):
    fields = dict(SMALL, **kw)
    fields["n_samples"] = 50 * fields["n_workers"]
    ds, f_opt = problems[fields["problem_type"], fields["n_workers"]]
    sched = batch_schedule(ds, fields["n_iterations"], fields["local_batch_size"])
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, batch_schedule=sched)
    ours_ds = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                             batch_schedule=sched)
    return ref, ours


@pytest.mark.parametrize("problem_type", ["logistic", "quadratic"])
@pytest.mark.parametrize("algorithm, mixing_impl, n_workers", [
    ("dsgd", "stencil", 9), ("dsgd", "dense", 9), ("dsgd", "auto", 4),
    ("admm", "stencil", 9), ("admm", "dense", 9), ("admm", "auto", 4),
])
def test_grid_run_matches_jax_backend(problems, algorithm, mixing_impl, n_workers,
                                      problem_type):
    ref, ours = _both(problems, algorithm=algorithm, mixing_impl=mixing_impl,
                      n_workers=n_workers, problem_type=problem_type, eval_every=5)
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    assert ours.history.spectral_gap == pytest.approx(ref.history.spectral_gap, abs=1e-12)


def test_robust_grid_run_matches_jax_backend():
    """The fused trimmed-mean screen over the torus's k_max = 4 table under
    sign-flip, against the JAX package's fused kernel in interpret mode."""
    byz = dict(partition="shuffled", attack="sign_flip", n_byzantine=1, attack_scale=2.0,
               aggregation="trimmed_mean", robust_b=1, robust_impl="fused")
    fields = dict(SMALL, problem_type="logistic", **byz)
    cfg = RefConfig(**fields)
    ds = ref_generate(cfg)
    f_opt = ref_oracle(ds, cfg.reg_param)[1]
    sched = batch_schedule(ds, fields["n_iterations"], fields["local_batch_size"])
    ref = jax_backend.run(cfg, ds, f_opt, use_mesh=False, batch_schedule=sched)
    ours = torch_backend.run(ExperimentConfig(**fields), ds, f_opt, device="cpu",
                             batch_schedule=sched)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["config_non_square", "topology_non_square", "pallas",
                                  "stencil_on_2x2", "robust_budget"])
def test_grid_refusals_carry_the_reference_message(case):
    if case == "config_non_square":
        ref = lambda: RefConfig(**dict(SMALL, n_workers=10))  # noqa: E731
        ours = lambda: ExperimentConfig(**dict(SMALL, n_workers=10))  # noqa: E731
    elif case == "topology_non_square":
        ref, ours = (lambda: ref_topology("grid", 12)), (lambda: build_topology("grid", 12))
    elif case in ("pallas", "stencil_on_2x2"):
        n, impl = (25, "pallas") if case == "pallas" else (4, "stencil")
        ref = lambda: ref_mixing_op(ref_topology("grid", n), impl)  # noqa: E731
        ours = lambda: make_mixing_op(build_topology("grid", n), impl, device="cpu")  # noqa: E731
    else:
        fields = dict(SMALL, problem_type="logistic", n_iterations=4, attack="sign_flip",
                      n_byzantine=1, aggregation="trimmed_mean", robust_b=3)
        cfg = RefConfig(**fields)
        ds = ref_generate(cfg)
        ref = lambda: jax_backend.run(cfg, ds, 0.0, use_mesh=False)  # noqa: E731
        ours = lambda: torch_backend.run(ExperimentConfig(**fields), ds, 0.0,  # noqa: E731
                                         device="cpu")
    want = _message(ref)
    assert _message(ours) == want


def test_a_grid_run_with_pallas_raises_the_reference_message(problems):
    ds, f_opt = problems["logistic", 9]
    fields = dict(SMALL, problem_type="logistic", mixing_impl="pallas", n_iterations=4)
    want = _message(lambda: jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False))
    assert _message(lambda: torch_backend.run(ExperimentConfig(**fields), ds, f_opt,
                                              device="cpu")) == want


def test_cli_runs_on_the_grid(capsys):
    rc = cli_main(["--topology", "grid", "--device", "cpu", "--problem-type", "logistic",
                   "--n-workers", "9", "--n-samples", "450", "--n-features", "10",
                   "--n-informative-features", "6", "--n-iterations", "100", "--json"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["topology"] == "grid" and np.isfinite(summary["final_gap"])
    assert summary["total_floats_transmitted"] == 9 * 4 * 11 * 100
