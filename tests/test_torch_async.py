"""The asynchronous event clock (``execution='async'``) against the JAX
package, on the CPU.

``torch_backend.run`` with ``execution='async'`` (``backends/async_scan.py``)
against ``jax_backend.run`` in float64: every eval's gap and consensus, the
final models and state to 1e-12 (rtol and atol), the eval iterations and
the floats transmitted exactly, the batches the event draw of both
packages gives (or the full shard, or an injected per-event schedule).
Configurations: D-SGD under each latency model, gradient tracking, τ = 3
local steps for both, the full batch, round-robin matchings, logistic on
Erdős–Rényi, Huber, softmax and bursty drops (``FAULT_RUNS``, the other
fault processes, run from tests/test_torch_events.py with this file's
helpers). Also: one
float32 run within 1e-5; the port's own identities (an all-up fault
timeline and a state0/start_event split bitwise the plain run, constant
latency equal to the sync one-peer run on shared batches); the numpy
oracle's per-event run; and the JAX package's refusals and messages.
"""

import pathlib

import numpy as np
import pytest
import torch

from conftest import batch_schedule
from distributed_optimization_tpu.backends import jax_backend, numpy_backend
from distributed_optimization_tpu.backends.async_scan import run_async as ref_run_async
from distributed_optimization_tpu.backends.async_scan import timeline_for as ref_timeline_for
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import async_scan, torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.parallel.faults import FaultTimeline, _edge_list
from distributed_optimization_tpu_torch.parallel.topology import build_topology

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-12, atol=1e-12)
BASE = dict(execution="async", n_workers=8, n_iterations=30, eval_every=10, n_samples=400,
            n_features=12, n_informative_features=8, local_batch_size=8, dtype="float64",
            problem_type="quadratic", algorithm="dsgd", topology="ring",
            latency_model="lognormal", latency_tail=0.5, seed=3)
_GT = dict(algorithm="gradient_tracking")
_CHURN = dict(mttf=12.0, mttr=4.0, seed=9)
RUNS = {
    "constant": dict(latency_model="constant", latency_tail=0.0),
    "exponential": dict(latency_model="exponential", latency_tail=0.0),
    "lognormal": dict(latency_tail=1.25),
    "pareto": dict(latency_model="pareto", latency_tail=1.3),
    "gt": _GT,
    "dsgd_tau3": dict(local_steps=3),
    "gt_tau3": dict(_GT, local_steps=3),
    "full_batch": dict(local_batch_size=100),
    "round_robin": dict(gossip_schedule="round_robin"),
    "logistic_er": dict(problem_type="logistic", topology="erdos_renyi", erdos_renyi_p=0.4),
    "huber": dict(problem_type="huber"),
    "softmax_k3": dict(problem_type="softmax", n_classes=3),
    "bursty": dict(edge_drop_prob=0.3, burst_len=4.0),
}
# The fault processes on the event clock (tests/test_torch_events.py runs
# these against the JAX package, beside the event fault realization).
FAULT_RUNS = {
    "drops_stragglers": dict(edge_drop_prob=0.2, straggler_prob=0.1),
    "churn_frozen": _CHURN,
    "churn_restart": dict(_CHURN, rejoin="neighbor_restart"),
    "participation": dict(participation_rate=0.75),
    "gt_composed": dict(_GT, mttf=12.0, mttr=4.0, participation_rate=0.9,
                        edge_drop_prob=0.1, seed=9),
}


@pytest.fixture(scope="module")
def data():
    """(JAX dataset, the port's, f_opt) per problem family, class count,
    N and sample count."""
    cache = {}

    def get(fields):
        key = (fields["problem_type"], fields.get("n_classes", 10), fields["n_workers"],
               fields["n_samples"])
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            cache[key] = (ds, dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices,
                                                     ds.problem_type),
                          ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


def _assert_same_run(ref, ours, state=True):
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    assert ours.history.time_measured is False
    if state:
        assert set(ours.final_state) == set(ref.final_state)
        for k in ref.final_state:
            np.testing.assert_allclose(ours.final_state[k], ref.final_state[k], **TOL)


def _both(data, fields, **kw):
    ds, ours_ds, f_opt = data(fields)
    ref = ref_run_async(RefConfig(**fields), ds, f_opt, return_state=True, **kw)
    ours = async_scan.run_async(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                                return_state=True, **kw)
    return ref, ours


def check_run(data, name, overrides):
    """One configuration against the JAX package (``BASE`` with
    ``overrides``), and what its name promises."""
    fields = dict(BASE, **overrides)
    ref, ours = _both(data, fields)
    _assert_same_run(ref, ours)
    cfg = ExperimentConfig(**fields)
    if name == "churn_restart":
        # The warm restart really runs: rejoin events with their rows.
        topo, tl = async_scan.timeline_for(cfg, "cpu")
        _, real, restart = async_scan.event_faults_for(cfg, topo, tl, device="cpu")
        assert restart is not None and restart.rows.shape[0] > 1
    if name == "gt_composed":
        state = ours.final_state
        residual = np.max(np.abs(state["y"].mean(0) - state["g_prev"].mean(0)))
        assert residual <= 1e-9
    if name == "full_batch":
        assert cfg.local_batch_size >= max(len(s) for s in data(fields)[0].shard_indices)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_the_jax_package(data, name):
    check_run(data, name, RUNS[name])


def test_torch_backend_run_dispatches_the_event_clock(data):
    fields = dict(BASE, **RUNS["gt"])
    _, ours_ds, f_opt = data(fields)
    cfg = ExperimentConfig(**fields)
    direct = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu")
    ours = torch_backend.run(cfg, ours_ds, f_opt, device="cpu")
    assert np.array_equal(ours.history.objective, direct.history.objective)
    assert np.array_equal(ours.final_models, direct.final_models)
    assert ours.final_state is None and ours.history.iters_per_second > 0


def _event_schedule(cfg, ds, tau=1, seed=0):
    """Fixed per-event batch indices into the firing worker's shard, [E, b]
    (or [E, τ, b])."""
    _, tl = ref_timeline_for(cfg)
    sizes = [len(s) for s in ds.shard_indices]
    rng = np.random.default_rng(seed)
    shape = (cfg.local_batch_size,) if tau == 1 else (tau, cfg.local_batch_size)
    return np.stack([rng.integers(0, sizes[int(w)], size=shape) for w in tl.worker])


@pytest.mark.parametrize("case", [dict(), dict(_GT, local_steps=3),
                                  dict(local_steps=3, mttf=12.0, mttr=4.0, seed=9)])
def test_injected_schedules_match_the_jax_package_and_the_numpy_oracle(data, case):
    fields = dict(BASE, **case)
    ds, _, _ = data(fields)
    sched = _event_schedule(RefConfig(**fields), ds, tau=fields.get("local_steps", 1))
    ref, ours = _both(data, fields, batch_schedule=sched)
    _assert_same_run(ref, ours)
    oracle = numpy_backend.run(RefConfig(**fields), ds, data(fields)[2], batch_schedule=sched)
    np.testing.assert_allclose(ours.history.objective, oracle.history.objective, **TOL)
    np.testing.assert_allclose(ours.final_models, oracle.final_models, **TOL)
    assert ours.total_floats_transmitted == oracle.history.total_floats_transmitted


def test_float32_run_is_close_to_the_jax_package_s(data):
    fields = dict(BASE, dtype="float32", problem_type="logistic", local_steps=2)
    ds, ours_ds, f_opt = data(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.final_models, ref.final_models, rtol=1e-5, atol=1e-5)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted


def _all_up(cfg):
    topo = build_topology(cfg.topology, cfg.n_workers)
    edges = _edge_list(topo)
    n, t = cfg.n_workers, cfg.n_iterations
    return FaultTimeline(horizon=t, directed=False, edge_index=edges,
                         edge_up=np.ones((t, len(edges)), bool), node_up=np.ones((t, n), bool),
                         rejoin=np.zeros((t, n), bool), part_up=np.ones((t, n), bool))


@pytest.mark.parametrize("algorithm", ["dsgd", "gradient_tracking"])
def test_all_up_fault_timeline_is_the_plain_run_bitwise(data, algorithm):
    fields = dict(BASE, algorithm=algorithm)
    cfg = ExperimentConfig(**fields)
    _, ours_ds, f_opt = data(fields)
    plain = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", return_state=True)
    forced = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", return_state=True,
                                  _fault_timeline=_all_up(cfg))
    assert np.array_equal(plain.history.objective, forced.history.objective)
    for k in plain.final_state:
        assert np.array_equal(plain.final_state[k], forced.final_state[k]), k
    assert plain.total_floats_transmitted == forced.total_floats_transmitted


def test_a_split_run_is_the_one_shot_run_bitwise(data):
    fields = dict(BASE, **FAULT_RUNS["gt_composed"])
    cfg = ExperimentConfig(**fields)
    ds, ours_ds, f_opt = data(fields)
    full = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", return_state=True)
    E, half = cfg.n_iterations * cfg.n_workers, cfg.eval_every * cfg.n_workers
    head = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", return_state=True,
                                n_events=half)
    tail = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", return_state=True,
                                state0=head.final_state, start_event=half)
    assert np.array_equal(np.concatenate([head.history.objective, tail.history.objective]),
                          full.history.objective)
    np.testing.assert_array_equal(tail.history.eval_iterations, full.history.eval_iterations[1:])
    for k in full.final_state:
        assert np.array_equal(tail.final_state[k], full.final_state[k]), k
    assert (head.total_floats_transmitted + tail.total_floats_transmitted
            == full.total_floats_transmitted)
    assert E == half * 3
    # The JAX package's own carry continues the port's run: the same tail.
    ref_head = ref_run_async(RefConfig(**fields), ds, f_opt, return_state=True, n_events=half)
    state0 = state_from_reference(ref_head.final_state, "cpu", torch.float64)
    cont = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", return_state=True,
                                state0=state0, start_event=half)
    np.testing.assert_allclose(cont.history.objective, tail.history.objective, **TOL)
    np.testing.assert_allclose(cont.final_models, tail.final_models, **TOL)


def test_constant_latency_is_the_sync_one_peer_run(data):
    """The degenerate gate: at constant latency the event schedule is the
    synchronous one-peer round on the same matchings, so on shared batches
    the port's two runs agree to 1e-12 with the floats equal."""
    fields = dict(BASE, latency_model="constant", latency_tail=0.0, n_workers=16,
                  n_samples=800, n_iterations=40)
    ds, ours_ds, f_opt = data(fields)
    cfg = ExperimentConfig(**fields)
    sync_sched = batch_schedule(ds, cfg.n_iterations, cfg.local_batch_size)
    _, tl = async_scan.timeline_for(cfg, "cpu")
    r_a = async_scan.run_async(cfg, ours_ds, f_opt, device="cpu",
                               batch_schedule=sync_sched[tl.local_step, tl.worker])
    r_s = torch_backend.run(cfg.replace(execution="sync", latency_model="constant",
                                        gossip_schedule="one_peer"),
                            ours_ds, f_opt, device="cpu", batch_schedule=sync_sched)
    np.testing.assert_allclose(r_a.final_models, r_s.final_models, **TOL)
    np.testing.assert_allclose(r_a.history.objective, r_s.history.objective, **TOL)
    assert r_a.total_floats_transmitted == r_s.total_floats_transmitted


def test_config_refusals_are_the_jax_package_s():
    ok = dict(execution="async")
    for bad in (dict(algorithm="extra"), dict(algorithm="push_sum"),
                dict(attack="sign_flip", n_byzantine=1),
                dict(aggregation="trimmed_mean", robust_b=1),
                dict(compression="top_k", compression_k=4, algorithm="dsgd"),
                dict(replicas=2), dict(topology="directed_ring"),
                dict(topology_impl="neighbor", n_workers=8192, topology="ring"),
                dict(latency_tail=1.0), dict(latency_mean=3.0),
                dict(latency_model="exponential", latency_tail=1.0),
                dict(latency_model="lognormal"), dict(latency_model="pareto", latency_tail=1.0),
                dict(latency_mean=0.0), dict(execution="bogus"),
                dict(latency_model="bogus")):
        fields = {**ok, **bad} if "execution" not in bad else dict(bad)
        if bad in (dict(latency_tail=1.0), dict(latency_mean=3.0)):
            fields = dict(bad)  # the latency knobs under execution='sync'
        with pytest.raises(ValueError) as ref:
            RefConfig(**fields)
        with pytest.raises(ValueError) as ours:
            ExperimentConfig(**fields)
        assert str(ours.value) == str(ref.value), fields
    for accepted in (dict(algorithm="gradient_tracking"), dict(edge_drop_prob=0.2),
                     dict(participation_rate=0.5), dict(mttf=10.0, mttr=5.0),
                     dict(mttf=10.0, mttr=5.0, rejoin="neighbor_restart"),
                     dict(local_steps=2), dict(local_steps=3, algorithm="gradient_tracking"),
                     dict(gossip_schedule="one_peer"), dict(gossip_schedule="round_robin"),
                     dict(straggler_prob=0.1)):
        assert ExperimentConfig(**ok, **accepted).execution == "async"
    cfg = ExperimentConfig(execution="async", n_workers=8192, topology="ring",
                           local_batch_size=4, n_samples=16384)
    assert cfg.resolved_topology_impl() == "dense"
    assert RefConfig(execution="async", n_workers=8192, topology="ring", local_batch_size=4,
                     n_samples=16384).resolved_topology_impl() == "dense"


def test_window_and_runner_refusals_are_the_jax_package_s(data):
    ds, ours_ds, f_opt = data(BASE)
    ref_cfg, cfg = RefConfig(**BASE), ExperimentConfig(**BASE)
    n = cfg.n_workers
    cases = (dict(n_events=n * 5), dict(start_event=n * cfg.eval_every),
             dict(batch_schedule=np.zeros((7, 4), int)),
             dict(state0={"x": np.zeros((n, 12))}, start_event=0),
             dict(start_event=n * cfg.n_iterations))
    for kw in cases:
        with pytest.raises(ValueError) as ref:
            ref_run_async(ref_cfg, ds, f_opt, **kw)
        with pytest.raises(ValueError) as ours:
            async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", **kw)
        assert str(ours.value) == str(ref.value), kw
    for kw in (dict(measure_timestamps=True),):
        with pytest.raises(ValueError) as ref:
            jax_backend.run(ref_cfg, ds, f_opt, **kw)
        with pytest.raises(ValueError, match="VIRTUAL clock") as ours:
            torch_backend.run(cfg, ours_ds, f_opt, device="cpu", **kw)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=[1, 2])
    with pytest.raises(ValueError, match="run seeds sequentially") as ours:
        torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=[1, 2], device="cpu")
    assert str(ours.value) == str(ref.value)
    assert torch_backend.batch_unsupported_reason(cfg) == jax_backend.batch_unsupported_reason(
        ref_cfg)
    for name in ("executable_cache", "progress_cb", "monitors", "checkpoint"):
        with pytest.raises(ValueError, match="Queue 1 item 5"):
            async_scan.run_async(cfg, ours_ds, f_opt, device="cpu", **{name: object()})
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is True here")
        async_scan.run_async(cfg, ours_ds, f_opt)


def test_event_blocks_divide_the_eval_window():
    assert async_scan.event_block(2560) == 256
    assert async_scan.event_block(80) == 80
    assert async_scan.event_block(13) == 13
    assert async_scan.event_block(17 * 19) == 19
    assert async_scan.event_block(1000) == 250
