"""Decentralized ADMM in the port against the JAX package.

Both packages run the same configuration in float64 on one injected batch
schedule (tests/conftest.py::batch_schedule), the JAX package unsharded
and its Pallas neighbour-sum kernels in interpret mode. Gap history,
consensus history, final models and floats transmitted agree to 1e-12
(rtol and atol), the repo's float64 parity convention; so do one step and
the initial neighbour sum taken alone, and a step from a JAX state carried
across mid-run.
"""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import batch_schedule
from distributed_optimization_tpu.algorithms import get_algorithm as ref_algorithm
from distributed_optimization_tpu.algorithms.base import StepContext as RefStepContext
from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.metrics import iterations_to_threshold
from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_mixing_op
from distributed_optimization_tpu.parallel import build_topology as ref_topology
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.algorithms.base import StepContext
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ALGORITHMS, LR_SCHEDULES, ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel.topology import build_topology

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=8, n_samples=400, n_features=10, n_informative_features=6,
             n_iterations=40, local_batch_size=16, dtype="float64", algorithm="admm")


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


@pytest.mark.parametrize("eval_every", [1, 10])
@pytest.mark.parametrize("problem_type", ["logistic", "quadratic"])
@pytest.mark.parametrize("mixing_impl", ["stencil", "pallas", "dense"])
@pytest.mark.parametrize("topology", ["ring", "fully_connected"])
def test_admm_run_matches_jax_backend(problems, topology, mixing_impl, problem_type, eval_every):
    ref, ours = _both(problems, topology=topology, mixing_impl=mixing_impl,
                      problem_type=problem_type, eval_every=eval_every)
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    # The run moves: ADMM's constant step takes the gap well down in T.
    assert ours.history.objective[-1] < 0.5 * ours.history.objective[0]


def _weighted_grad_inputs(problem, seed):
    """One fixed weighted-gradient oracle for both packages: each worker's
    shard with random per-row weights (numpy-built)."""
    ds, _ = problem
    from distributed_optimization_tpu.utils.data import stack_shards

    stacked = stack_shards(ds, np.float64)
    rng = np.random.default_rng(seed)
    wts = rng.uniform(size=stacked.y.shape) / 10
    return stacked, wts


def _ref_step_context(stacked, wts, cfg, topo_name, n):
    import jax

    from distributed_optimization_tpu.ops import losses as ref_losses

    X, y, w = (jnp.asarray(a) for a in (stacked.X, stacked.y, wts))
    grad = lambda p, slot: jax.vmap(  # noqa: E731
        ref_losses.logistic_gradient_weighted, in_axes=(0, 0, 0, 0, None)
    )(p, X, y, w, cfg.reg_param)
    topo = ref_topology(topo_name, n)
    op = ref_mixing_op(topo, impl="pallas", dtype=jnp.float64)
    degrees = jnp.asarray(topo.degrees, dtype=jnp.float64)[:, None]
    return op, RefStepContext(grad=grad, mix=op.apply, neighbor_sum=op.neighbor_sum,
                              eta=jnp.asarray(0.05), t=jnp.asarray(0), degrees=degrees,
                              config=cfg)


def _our_step_context(stacked, wts, cfg, topo_name, n):
    from distributed_optimization_tpu_torch.models import get_problem

    problem = get_problem("logistic")
    Xt, yt, wt = (torch.from_numpy(a) for a in (stacked.X, stacked.y, wts))
    topo = build_topology(topo_name, n)
    op = make_mixing_op(topo, "pallas", device="cpu")
    degrees = torch.as_tensor(topo.degrees, dtype=torch.float64)[:, None]
    return op, StepContext(grad=lambda p, slot: problem.gradient_weighted(p, Xt, yt, wt,
                                                                          cfg.reg_param),
                           mix=op.apply, neighbor_sum=op.neighbor_sum,
                           eta=torch.tensor([0.05], dtype=torch.float64), degrees=degrees,
                           config=cfg)


@pytest.mark.parametrize("topology", ["ring", "fully_connected"])
def test_admm_init_and_step_match_the_reference(problems, topology):
    """``_init``'s neighbour sum of a nonzero x0, then one step from a
    random state with nonzero duals, in both packages."""
    stacked, wts = _weighted_grad_inputs(problems["logistic"], seed=4)
    d = stacked.X.shape[2]
    rng = np.random.default_rng(5)
    x0, alpha = rng.standard_normal((8, d)), rng.standard_normal((8, d)) / 10
    ref_cfg = RefConfig(**dict(SMALL, problem_type="logistic", topology=topology,
                               admm_c=0.7, admm_rho=3.0))
    cfg = ExperimentConfig(**dict(SMALL, problem_type="logistic", topology=topology,
                                  admm_c=0.7, admm_rho=3.0))
    with enable_x64():
        op, ctx = _ref_step_context(stacked, wts, ref_cfg, topology, 8)
        ref_state = ref_algorithm("admm").init(jnp.asarray(x0), ref_cfg,
                                               neighbor_sum=op.neighbor_sum)
        ref_state["alpha"] = jnp.asarray(alpha)
        ref_next = {k: np.asarray(v) for k, v in ref_algorithm("admm").step(ref_state, ctx).items()}
        ref_init = {k: np.asarray(v) for k, v in ref_state.items()}

    op, ctx = _our_step_context(stacked, wts, cfg, topology, 8)
    state = get_algorithm("admm").init(torch.from_numpy(x0), cfg, neighbor_sum=op.neighbor_sum)
    assert set(state) == {"x", "alpha", "nbr_x"}
    np.testing.assert_allclose(state["nbr_x"].numpy(), ref_init["nbr_x"], **TOL)
    np.testing.assert_allclose(state["nbr_x"].numpy(),
                               build_topology(topology, 8).adjacency @ x0, **TOL)
    state["alpha"] = torch.from_numpy(alpha)
    got = get_algorithm("admm").step(state, ctx)
    for key in ("x", "alpha", "nbr_x"):
        np.testing.assert_allclose(got[key].numpy(), ref_next[key], **TOL)
    # Without a neighbour sum the carried aggregate starts at zero.
    assert torch.count_nonzero(get_algorithm("admm").init(torch.from_numpy(x0), cfg)["nbr_x"]) == 0


def test_admm_state_from_a_jax_run_steps_like_the_reference(problems):
    """A JAX ADMM state taken after 10 iterations, carried across by
    ``state_from_reference`` and stepped once by both packages."""
    ds, f_opt = problems["logistic"]
    fields = dict(SMALL, problem_type="logistic", topology="ring", mixing_impl="pallas",
                  n_iterations=10)
    ref_cfg = RefConfig(**fields)
    ref = jax_backend.run(ref_cfg, ds, f_opt, use_mesh=False,
                          batch_schedule=batch_schedule(ds, 10, 16), return_state=True)
    assert set(ref.final_state) >= {"x", "alpha", "nbr_x"}
    carried = {k: ref.final_state[k] for k in ("x", "alpha", "nbr_x")}
    assert np.any(carried["alpha"] != 0)

    stacked, wts = _weighted_grad_inputs(problems["logistic"], seed=6)
    with enable_x64():
        _, ctx = _ref_step_context(stacked, wts, ref_cfg, "ring", 8)
        want = ref_algorithm("admm").step({k: jnp.asarray(v) for k, v in carried.items()}, ctx)
        want = {k: np.asarray(v) for k, v in want.items()}

    state = state_from_reference(carried, "cpu", torch.float64)
    _, ctx = _our_step_context(stacked, wts, ExperimentConfig(**fields), "ring", 8)
    got = get_algorithm("admm").step(state, ctx)
    for key in ("x", "alpha", "nbr_x"):
        np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)


@pytest.mark.parametrize("lr_schedule", LR_SCHEDULES)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_resolved_lr_schedule_matches_the_reference(algorithm, lr_schedule):
    ours = ExperimentConfig(algorithm=algorithm, lr_schedule=lr_schedule)
    ref = RefConfig(algorithm=algorithm, lr_schedule=lr_schedule)
    assert ours.resolved_lr_schedule() == ref.resolved_lr_schedule()


def test_admm_defaults_match_the_reference():
    ours, ref = ExperimentConfig(), RefConfig()
    assert (ours.admm_c, ours.admm_rho) == (ref.admm_c, ref.admm_rho) == (0.5, 5.0)
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    assert {"admm_c", "admm_rho"} <= fields


def test_admm_with_local_steps_is_refused_as_in_the_reference():
    with pytest.raises(ValueError, match="unsupported for 'admm'") as ref_err:
        RefConfig(algorithm="admm", local_steps=2)
    with pytest.raises(ValueError, match="unsupported for 'admm'") as our_err:
        ExperimentConfig(algorithm="admm", local_steps=2)
    assert str(our_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="local_steps must be >= 1"):
        ExperimentConfig(algorithm="admm", local_steps=0)


def test_admm_with_byzantine_injection_is_refused(problems):
    ds, f_opt = problems["logistic"]
    fields = dict(SMALL, problem_type="logistic", topology="ring", n_iterations=4,
                  attack="sign_flip", n_byzantine=1)
    with pytest.raises(ValueError, match="unsupported for 'admm'"):
        jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    with pytest.raises(ValueError, match="unsupported for 'admm'"):
        torch_backend.run(ExperimentConfig(**fields), ds, f_opt, device="cpu")
    robust = dict(fields, attack="none", n_byzantine=0, aggregation="trimmed_mean", robust_b=1)
    with pytest.raises(ValueError, match="unsupported for 'admm'"):
        torch_backend.run(ExperimentConfig(**robust), ds, f_opt, device="cpu")


def test_admm_launches_the_neighbour_sum_t_plus_one_times(problems, monkeypatch):
    """On the pallas ring the neighbour sum runs once at init and once an
    iteration; the fused D-SGD step and W x never run."""
    from distributed_optimization_tpu_torch.ops import ring_kernels

    calls = {"ring_neighbor_sum": 0, "ring_mix": 0, "fused_ring_dsgd_step": 0}
    for name in calls:
        real = getattr(ring_kernels, name)
        monkeypatch.setattr(ring_kernels, name,
                            lambda *a, _n=name, _r=real: calls.__setitem__(_n, calls[_n] + 1)
                            or _r(*a))
    ds, f_opt = problems["logistic"]
    cfg = ExperimentConfig(**dict(SMALL, problem_type="logistic", topology="ring",
                                  mixing_impl="pallas", n_iterations=7))
    torch_backend.run(cfg, ds, f_opt, device="cpu")
    assert calls == {"ring_neighbor_sum": 8, "ring_mix": 0, "fused_ring_dsgd_step": 0}


def test_chip_smoke_admm_reference_is_the_jax_package_s():
    """``chip_smoke.py`` prints ``ADMM_REFERENCE`` beside the card's admm
    phase: the JAX package's float32 figures at that phase's two
    configurations (main-path data, eval every iteration, T=2,000), where
    its pallas and stencil histories are bitwise equal."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for topology, n in (("ring", 256), ("fully_connected", 25)):
        cfg = RefConfig(problem_type="logistic", algorithm="admm", topology=topology,
                        n_workers=n, n_iterations=smoke.ADMM_ITERATIONS, dtype="float32",
                        eval_every=1)
        ds = ref_generate(cfg)
        _, f_opt = ref_oracle(ds, cfg.reg_param)
        pallas, stencil = (jax_backend.run(cfg.replace(mixing_impl=impl), ds, f_opt,
                                           use_mesh=False).history
                           for impl in ("pallas", "stencil"))
        np.testing.assert_array_equal(pallas.objective, stencil.objective)
        want = smoke.ADMM_REFERENCE[topology]
        assert iterations_to_threshold(pallas.objective, 0.08,
                                       pallas.eval_iterations) == want["iters_to_eps"]
        assert pallas.objective[-1] == pytest.approx(want["final_gap"], rel=1e-3)
        assert pallas.consensus_error[-1] == pytest.approx(want["consensus"], rel=1e-3)
