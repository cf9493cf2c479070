"""Byzantine-robust D-SGD in the port against ``jax_backend.run``.

Both packages run the same float64 configuration on one injected batch
schedule (tests/conftest.py::batch_schedule), the JAX package unsharded
and with ``robust_impl='fused'`` (its Pallas kernel in interpret mode).
Honest gap history, honest consensus history and final models agree to
1e-12 (rtol and atol). The Byzantine set and the shuffled shards are
bitwise the JAX package's.
"""

import inspect
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import batch_schedule
from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.parallel.adversary import (
    byzantine_mask as ref_byzantine_mask,
    make_adversary as ref_make_adversary,
)
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.algorithms.base import StepContext
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import ring_kernels, robust_kernels
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.ops.robust_aggregation import make_gather_robust_aggregator
from distributed_optimization_tpu_torch.parallel.adversary import byzantine_mask, make_adversary
from distributed_optimization_tpu_torch.parallel.topology import build_topology, neighbor_table
from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset, stack_shards

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=12, n_samples=360, n_features=7, n_informative_features=5,
             n_iterations=80, local_batch_size=8, topology="ring", eval_every=20,
             dtype="float64", partition="shuffled")
RULES = ("trimmed_mean", "median", "clipped_gossip")


@pytest.fixture(scope="module")
def problems():
    """(dataset, f_opt, schedule) per problem type, from the JAX package."""
    out = {}
    for problem in ("logistic", "quadratic"):
        cfg = RefConfig(**SMALL, problem_type=problem)
        ds = ref_generate(cfg)
        out[problem] = (ds, ref_oracle(ds, cfg.reg_param)[1], batch_schedule(ds, 80, 8))
    return out


def _attacked(**kw):
    return dict(SMALL, n_byzantine=2, attack_scale=2.0, **kw)


def _run_both(problems, ref_impl, impls, **fields):
    ds, f_opt, sched = problems[fields["problem_type"]]
    robust = fields.get("robust_b", 0) > 0
    ref = jax_backend.run(RefConfig(**fields, **({"robust_impl": ref_impl} if robust else {})),
                          ds, f_opt, use_mesh=False, batch_schedule=sched)
    ours_ds = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
    for impl in impls:
        extra = {"robust_impl": impl} if robust else {}
        ours = torch_backend.run(ExperimentConfig(**fields, **extra), ours_ds, f_opt,
                                 device="cpu", batch_schedule=sched)
        yield ref, ours


def _assert_same_run(ref, ours):
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted


def test_byzantine_mask_is_the_references():
    for n, f, seed in [(12, 2, 203), (64, 6, 203), (256, 12, 203), (256, 16, 7), (9, 0, 1)]:
        np.testing.assert_array_equal(byzantine_mask(n, f, seed), ref_byzantine_mask(n, f, seed))
    with pytest.raises(ValueError, match="n_byzantine"):
        byzantine_mask(4, 4, 0)


@pytest.mark.parametrize("problem_type", ["logistic", "quadratic"])
def test_shuffled_shards_are_the_references(problem_type):
    kw = dict(SMALL, problem_type=problem_type)
    ref = ref_generate(RefConfig(**kw))
    ours = generate_synthetic_dataset(ExperimentConfig(**kw))
    assert len(ours.shard_indices) == len(ref.shard_indices)
    for a, b in zip(ours.shard_indices, ref.shard_indices):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.y_full, ref.y_full)


@pytest.mark.parametrize("attack,scale", [("sign_flip", 5.0), ("alie", 1.5)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_corrupt_matches_the_reference(attack, scale, dtype):
    x = np.random.default_rng(2).standard_normal((16, 9)).astype(dtype)
    with enable_x64():
        ref = ref_make_adversary(16, attack, 5, scale, 203)
        want = np.asarray(ref.corrupt(jnp.asarray(0), jnp.asarray(x)))
    ours = make_adversary(16, attack, 5, scale, 203, device="cpu",
                          dtype=torch.from_numpy(x).dtype)
    got = ours.corrupt(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(ours.byzantine, ref.byzantine)
    tol = TOL if dtype == np.float64 else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(got[ours.honest], x[ours.honest])


@pytest.mark.parametrize("attack", ["sign_flip", "alie"])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("problem_type", ["logistic", "quadratic"])
def test_robust_dsgd_run_matches_jax_backend(problems, problem_type, rule, attack):
    """Each rule under each attack, in the port's gather and fused forms,
    against the JAX package's fused run (its gather and fused runs agree
    to 1e-12 in its own tests)."""
    fields = _attacked(problem_type=problem_type, attack=attack, aggregation=rule, robust_b=1)
    for ref, ours in _run_both(problems, "fused", ("gather", "fused"), **fields):
        _assert_same_run(ref, ours)


@pytest.mark.parametrize("mixing_impl", ["stencil", "pallas"])
def test_plain_gossip_under_attack_and_the_undefended_rule_match(problems, mixing_impl):
    """Sign-flip against plain gossip (Byzantine rows on the benign mix of
    the true stack), and a robust rule with no attacker, against the JAX
    package."""
    for fields in (_attacked(problem_type="logistic", attack="sign_flip",
                             mixing_impl=mixing_impl),
                   dict(SMALL, problem_type="quadratic", aggregation="median", robust_b=1,
                        mixing_impl=mixing_impl)):
        for ref, ours in _run_both(problems, "gather", ("gather",), **fields):
            _assert_same_run(ref, ours)


def test_auto_resolves_as_the_reference():
    """'auto' promotes to fused exactly where the JAX package's
    fused_eligible would on an unsharded, fault-free run."""
    for name, n, rule, ct in [("ring", 12, "trimmed_mean", 0.0), ("ring", 12, "median", 0.0),
                              ("ring", 12, "clipped_gossip", 0.0),
                              ("ring", 12, "clipped_gossip", 0.5)]:
        kw = dict(n_workers=n, topology=name, aggregation=rule, robust_b=1, clip_tau=ct)
        topo = build_topology(name, n)
        k_max = int(topo.degrees.max())
        want = RefConfig(**kw).resolved_robust_impl(
            k_max, fused_eligible=pk.fused_robust_supported(rule, k_max, ct))
        assert torch_backend.resolve_robust_impl(ExperimentConfig(**kw), topo) == want == "fused"
        for impl in ("gather", "fused"):
            cfg = ExperimentConfig(**kw, robust_impl=impl)
            assert torch_backend.resolve_robust_impl(cfg, topo) == impl


def test_fused_robust_step_is_bound_once_per_iteration(problems, monkeypatch):
    """robust_impl='fused' launches the fused step T times and the
    aggregator never; 'gather' launches neither; the fused ring kernel is
    never bound under Byzantine injection, even with mixing_impl='pallas'."""
    calls = {"step": 0, "agg": 0, "ring": 0}
    real_step = robust_kernels.make_fused_robust_dsgd_step
    real_agg = robust_kernels.make_fused_robust_aggregator
    real_ring = ring_kernels.fused_ring_dsgd_step

    def counting(factory, key):
        def make(*a, **k):
            fn = factory(*a, **k)
            return lambda *args: calls.__setitem__(key, calls[key] + 1) or fn(*args)
        return make

    monkeypatch.setattr(torch_backend, "make_fused_robust_dsgd_step", counting(real_step, "step"))
    monkeypatch.setattr(torch_backend, "make_fused_robust_aggregator", counting(real_agg, "agg"))
    monkeypatch.setattr(ring_kernels, "fused_ring_dsgd_step",
                        lambda *a: calls.__setitem__("ring", calls["ring"] + 1) or real_ring(*a))
    ds, f_opt, _ = problems["logistic"]
    base = _attacked(problem_type="logistic", attack="sign_flip", aggregation="trimmed_mean",
                     robust_b=1, mixing_impl="pallas", n_iterations=20)
    for impl, want in (("fused", {"step": 20, "agg": 0, "ring": 0}),
                       ("gather", {"step": 0, "agg": 0, "ring": 0})):
        calls.update(step=0, agg=0, ring=0)
        torch_backend.run(ExperimentConfig(**base, robust_impl=impl), ds, f_opt, device="cpu")
        assert calls == want, impl
    calls.update(step=0, agg=0, ring=0)
    attack_only = {k: v for k, v in base.items() if k not in ("aggregation", "robust_b")}
    torch_backend.run(ExperimentConfig(**attack_only), ds, f_opt, device="cpu")
    assert calls == {"step": 0, "agg": 0, "ring": 0}
    torch_backend.run(ExperimentConfig(**dict(SMALL, problem_type="logistic", n_iterations=20,
                                              mixing_impl="pallas")), ds, f_opt, device="cpu")
    assert calls["ring"] == 20


def test_state_from_reference_steps_like_the_reference(problems):
    """A JAX state taken after 40 iterations, carried across, stepped once in
    the port: equal to the JAX package's iteration 41 on the same batches."""
    ds, f_opt, sched = problems["logistic"]
    fields = _attacked(problem_type="logistic", attack="alie", aggregation="clipped_gossip",
                       robust_b=1, eval_every=1)
    mid = jax_backend.run(RefConfig(**dict(fields, n_iterations=40), robust_impl="fused"), ds,
                          f_opt, use_mesh=False, batch_schedule=sched[:40], return_state=True)
    nxt = jax_backend.run(RefConfig(**dict(fields, n_iterations=41), robust_impl="fused"), ds,
                          f_opt, use_mesh=False, batch_schedule=sched[:41])

    cfg = ExperimentConfig(**fields, robust_impl="fused")
    state = state_from_reference(mid.final_state, "cpu", torch.float64)
    topo = build_topology("ring", 12)
    op = make_mixing_op(topo, "stencil", device="cpu")
    algo = get_algorithm("dsgd")
    byz = torch_backend.bind_byzantine(cfg, algo, topo, op, device=torch.device("cpu"),
                                       dtype=torch.float64)
    host = stack_shards(ds, np.float64)
    X, y = torch.from_numpy(host.X), torch.from_numpy(host.y)
    idx = torch.from_numpy(sched[40]).long()
    problem = get_problem("logistic")

    def grad(params, slot):
        wts = torch.full(idx.shape, 1.0 / idx.shape[1], dtype=torch.float64)
        return problem.gradient_weighted(params, torch.take_along_dim(X, idx[:, :, None], 1),
                                         torch.take_along_dim(y, idx, 1), wts, cfg.reg_param)

    eta = torch_backend.make_eta_schedule(cfg, 41, "cpu", torch.float64)[40:41]
    mix, neighbor_sum, fused_step = byz.at(None, None)
    ctx = StepContext(grad=grad, mix=mix, neighbor_sum=neighbor_sum, eta=eta,
                      config=cfg, fused_mix_step=fused_step)
    got = algo.step(state, ctx)["x"].numpy()
    np.testing.assert_allclose(got, nxt.final_models, **TOL)


def test_what_the_port_does_not_have_yet_raises(problems):
    # large_noise and the dense screen are ported: they build, and 'auto' on
    # the fully-connected graph runs the dense form. The matrix-free fault
    # form is ported too: a faulted config at N = 4,096 resolves to it.
    assert ExperimentConfig(attack="large_noise", n_byzantine=2).attack == "large_noise"
    ExperimentConfig(aggregation="median", robust_b=1, robust_impl="dense")
    assert ExperimentConfig(n_workers=4096, edge_drop_prob=0.1).resolved_topology_impl() \
        == "neighbor"
    ds, f_opt, _ = problems["logistic"]
    fc = ExperimentConfig(**dict(SMALL, problem_type="logistic", topology="fully_connected",
                                 aggregation="median", robust_b=1))
    assert np.all(np.isfinite(torch_backend.run(fc, ds, f_opt, device="cpu").history.objective))
    with pytest.raises(ValueError, match="centralized pattern has no peer edges"):
        torch_backend.run(ExperimentConfig(**_attacked(problem_type="logistic",
                                                       attack="sign_flip",
                                                       algorithm="centralized")),
                          ds, f_opt, device="cpu")
    with pytest.raises(ValueError, match="must be set together"):
        ExperimentConfig(attack="sign_flip")
    with pytest.raises(ValueError, match="robust_impl"):
        ExperimentConfig(robust_impl="fused")
    with pytest.raises(ValueError, match="min degree"):
        torch_backend.run(ExperimentConfig(**dict(SMALL, problem_type="logistic",
                                                  aggregation="median", robust_b=2)),
                          ds, f_opt, device="cpu")


def test_cli_runs_a_robust_experiment_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_optimization_tpu_torch", "--device", "cpu",
         "--problem-type", "logistic", "--n-workers", "12", "--n-samples", "480",
         "--n-features", "10", "--n-informative-features", "6", "--n-iterations", "60",
         "--partition", "shuffled", "--attack", "sign_flip", "--n-byzantine", "2",
         "--attack-scale", "5", "--aggregation", "trimmed_mean", "--robust-b", "1",
         "--robust-impl", "fused", "--mixing-impl", "pallas", "--json"],
        capture_output=True, text=True, check=True, timeout=300,
    )
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["attack"] == "sign_flip" and summary["aggregation"] == "trimmed_mean"
    assert summary["gap_over"] == "honest workers"
    assert np.isfinite(summary["final_gap"]) and np.isfinite(summary["final_consensus"])


_RING_NBR = neighbor_table(build_topology("ring", 12).adjacency)[0]
# Each public factory that places tensors, with arguments that build on the
# ring of 12.
FACTORIES = {
    "make_fused_robust_aggregator":
        lambda **kw: robust_kernels.make_fused_robust_aggregator("median", 1, _RING_NBR, **kw),
    "make_fused_robust_dsgd_step":
        lambda **kw: robust_kernels.make_fused_robust_dsgd_step("median", 1, _RING_NBR, **kw),
    "make_gather_robust_aggregator":
        lambda **kw: make_gather_robust_aggregator("median", 1, _RING_NBR, **kw),
    "make_mixing_op": lambda **kw: make_mixing_op(build_topology("ring", 12), "dense", **kw),
    "make_adversary": lambda **kw: make_adversary(12, "sign_flip", 2, 5.0, 203, **kw),
}
_FACTORY_FUNCTIONS = {
    "make_fused_robust_aggregator": robust_kernels.make_fused_robust_aggregator,
    "make_fused_robust_dsgd_step": robust_kernels.make_fused_robust_dsgd_step,
    "make_gather_robust_aggregator": make_gather_robust_aggregator,
    "make_mixing_op": make_mixing_op, "make_adversary": make_adversary,
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factories_run_on_cuda_unless_asked_and_raise_without_a_card(name, monkeypatch):
    """The port's entry points run on cuda by default: without a card a
    factory called without ``device`` raises instead of building its tables
    on the CPU and running the plain version; ``device='cpu'`` builds."""
    default = inspect.signature(_FACTORY_FUNCTIONS[name]).parameters["device"].default
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' was asked for"):
        FACTORIES[name]()
    assert FACTORIES[name](device="cpu") is not None
