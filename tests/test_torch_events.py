"""The port's event schedules, event fault realization and event draw
against the JAX package's, on the CPU.

``parallel/events.py``'s schedules (worker, partner, local step, virtual
times, staleness and durations) bit for bit ``build_event_timeline``'s
under every latency model, on the ring, grid and Erdős–Rényi graphs, for
the sampled one-peer matchings and the round-robin phases; the
duration draws and their refusals; the summaries; the event-axis fault
realization and the ``neighbor_restart`` rows built from the JAX package's
own ``FaultTimeline`` arrays; the plain event batch draw
(``ops/sampling.py``) bit for bit the JAX package's ``sample_batch_indices``
at the per-event keys, in float32 and float64, with shards shorter than b.
And the event faults end to end: ``run_async`` under drops with
stragglers, churn under both rejoin policies, participation and GT under
composed faults (whose tracker keeps mean y = mean g_prev) against the JAX
package's, as tests/test_torch_async.py holds the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops.sampling import sample_batch_indices as ref_sample
from distributed_optimization_tpu.parallel import build_topology as ref_topology
from distributed_optimization_tpu.parallel import events as ref_events
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu.parallel.faults import timeline_for_config as ref_fault_timeline
from distributed_optimization_tpu_torch.ops import sampling, sampling_kernels
from distributed_optimization_tpu_torch.parallel import events
from distributed_optimization_tpu_torch.parallel.faults import FaultTimeline, timeline_for_config
from distributed_optimization_tpu_torch.parallel.topology import build_topology
from test_torch_async import FAULT_RUNS, check_run, data  # noqa: F401

FIELDS = ("worker", "partner", "local_step", "t_virtual", "staleness", "durations")
LATENCY = {"constant": 0.0, "exponential": 0.0, "lognormal": 1.25, "pareto": 1.3}
GRAPHS = {"ring": (8, {}), "grid": (16, {}), "erdos_renyi": (12, dict(erdos_renyi_p=0.4, seed=5))}
T = 30


def _pair(name):
    n, kw = GRAPHS[name]
    return build_topology(name, n, **kw), ref_topology(name, n, **kw)


def _both(name, horizon=T, seed=7, **kw):
    topo, ref_topo = _pair(name)
    ours = events.build_event_timeline(topo, horizon, seed, device="cpu", **kw)
    ref = ref_events.build_event_timeline(ref_topo, horizon, seed, **kw)
    return ours, ref


def _assert_same_timeline(ours, ref):
    for field in FIELDS:
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (ours.n_workers, ours.n_rounds, ours.n_events) == (ref.n_workers, ref.n_rounds,
                                                            ref.n_events)
    np.testing.assert_array_equal(ours.matched(), ref.matched())
    np.testing.assert_array_equal(ours.worker_clocks(), ref.worker_clocks())


SCHEDULES = [("ring", model) for model in sorted(LATENCY)] + [
    ("grid", "lognormal"), ("erdos_renyi", "lognormal"), ("erdos_renyi", "exponential")]


@pytest.mark.parametrize("graph, model", SCHEDULES)
def test_schedule_is_the_jax_package_s_bit_for_bit(graph, model):
    ours, ref = _both(graph, latency_model=model, latency_mean=1.5,
                      latency_tail=LATENCY[model])
    _assert_same_timeline(ours, ref)


@pytest.mark.parametrize("schedule", ["round_robin", "synchronous"])
@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_matching_schedules_are_the_jax_package_s(graph, schedule):
    ours, ref = _both(graph, latency_model="lognormal", latency_tail=1.25,
                      gossip_schedule=schedule)
    _assert_same_timeline(ours, ref)


def test_one_peer_matchings_draw_the_sync_schedule_s_pairs():
    """The sampled matchings are the synchronous one-peer schedule's: the
    constant-latency schedule pairs each round's initiators with
    ``_round_matchings``, and those are the JAX package's draws."""
    topo, ref_topo = _pair("erdos_renyi")
    ours = events._round_matchings(topo, T, 11, device="cpu")
    ref = ref_events._round_matchings(ref_topo, T, 11)
    np.testing.assert_array_equal(ours, ref)
    # Every row is an involution over the graph's edges.
    for row in ours:
        assert np.array_equal(row[row], np.arange(len(row)))
        moved = row != np.arange(len(row))
        assert np.all(topo.adjacency[np.arange(len(row))[moved], row[moved]] == 1)


def test_schedule_is_prefix_stable_in_the_horizon():
    kw = dict(latency_model="lognormal", latency_mean=2.0, latency_tail=1.0)
    topo, _ = _pair("ring")
    short = events.build_event_timeline(topo, T, 7, device="cpu", **kw)
    long, ref_long = _both("ring", horizon=2 * T, **kw)
    _assert_same_timeline(long, ref_long)
    np.testing.assert_array_equal(long.durations[:T], short.durations)
    np.testing.assert_array_equal(events._round_matchings(topo, 2 * T, 7, device="cpu")[:T],
                                  events._round_matchings(topo, T, 7, device="cpu"))
    other = events.build_event_timeline(topo, T, 8, device="cpu", **kw)
    assert not np.array_equal(other.t_virtual, short.t_virtual)


def test_summaries_are_the_jax_package_s():
    ours, ref = _both("ring", latency_model="pareto", latency_tail=1.3)
    np.testing.assert_array_equal(events.sync_round_times(ours), ref_events.sync_round_times(ref))
    for kw in ({}, dict(max_bucket=3), dict(events=(8, 80))):
        assert events.staleness_histogram(ours, **kw) == ref_events.staleness_histogram(ref, **kw)
    for kw in ({}, dict(rounds=(3, 17))):
        assert events.clock_skew(ours, **kw) == ref_events.clock_skew(ref, **kw)


@pytest.mark.parametrize("model", sorted(LATENCY))
def test_durations_and_their_refusals(model):
    kw = dict(latency_model=model, latency_mean=0.7, latency_tail=LATENCY[model])
    np.testing.assert_array_equal(events.sample_durations(20, 5, 3, **kw),
                                  ref_events.sample_durations(20, 5, 3, **kw))
    for bad in (dict(horizon=0), dict(latency_mean=0.0),
                dict(latency_tail=0.0 if model == "lognormal" else 1.0)):
        args = dict(horizon=20, **kw)
        args.update(bad)
        if "latency_tail" in bad and model not in ("lognormal", "pareto"):
            continue
        horizon = args.pop("horizon")
        with pytest.raises(ValueError) as ours:
            events.sample_durations(horizon, 5, 3, **args)
        with pytest.raises(ValueError) as ref:
            ref_events.sample_durations(horizon, 5, 3, **args)
        assert str(ours.value) == str(ref.value)


def test_directed_and_unknown_schedules_are_refused():
    with pytest.raises(ValueError, match="one-way links"):
        events.build_event_timeline(build_topology("directed_ring", 6), 5, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown event matching schedule"):
        events.build_event_timeline(build_topology("ring", 6), 5, 0, device="cpu",
                                    gossip_schedule="bogus")
    with pytest.raises(ValueError, match="Unknown latency model"):
        events.sample_durations(5, 6, 0, latency_model="bogus", latency_mean=1.0,
                                latency_tail=0.0)


FAULT_CASES = {
    "drops_stragglers": dict(edge_drop_prob=0.2, straggler_prob=0.1),
    "churn_restart": dict(mttf=6.0, mttr=3.0, rejoin="neighbor_restart",
                          participation_rate=0.7),
    "bursty_churn": dict(edge_drop_prob=0.3, burst_len=4.0, mttf=8.0, mttr=3.0,
                         rejoin="neighbor_restart"),
}


def _port_fault_timeline(ref_ft):
    """The JAX package's FaultTimeline arrays in the port's dataclass."""
    return FaultTimeline(horizon=ref_ft.horizon, directed=ref_ft.directed,
                         **{k: (None if getattr(ref_ft, k) is None
                                else np.asarray(getattr(ref_ft, k)))
                            for k in ("edge_index", "edge_up", "node_up", "rejoin", "part_up")})


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_event_faults_and_restart_rows_are_the_jax_package_s(case):
    kw = dict(execution="async", n_workers=12, topology="erdos_renyi", erdos_renyi_p=0.4,
              n_iterations=T, latency_model="lognormal", latency_tail=1.25, seed=9,
              **FAULT_CASES[case])
    cfg = RefConfig(**kw)
    topo, ref_topo = (build_topology("erdos_renyi", 12, erdos_renyi_p=0.4, seed=9),
                      ref_topology("erdos_renyi", 12, erdos_renyi_p=0.4, seed=9))
    ours_tl = events.build_event_timeline(topo, T, 9, latency_model="lognormal",
                                          latency_tail=1.25, device="cpu")
    ref_tl = ref_events.build_event_timeline(ref_topo, T, 9, latency_model="lognormal",
                                             latency_tail=1.25)
    ref_ft = ref_fault_timeline(cfg, ref_topo, T)
    ft = _port_fault_timeline(ref_ft)
    real = events.realize_event_faults(ours_tl, ft)
    want = ref_events.realize_event_faults(ref_tl, ref_ft)
    for field in ("fire", "partner", "rejoin", "matched_fired"):
        a, b = getattr(real, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("n_inflight_lost", "n_thinned", "n_degraded", "availability"):
        assert getattr(real, field) == getattr(want, field), field
    rows = events.rejoin_restart_rows(ours_tl, ft, real, topo)
    ref_rows = ref_events.rejoin_restart_rows(ref_tl, ref_ft, want, ref_topo)
    np.testing.assert_array_equal(rows, ref_rows)
    table = events.rejoin_restart_table(ours_tl, ft, real, topo)
    np.testing.assert_array_equal(table.dense(), ref_rows)
    assert table.rows.shape[0] == int(real.rejoin.sum()) + 1
    # The port's own chains (drawn here on the CPU) are the JAX package's.
    own = timeline_for_config(RefConfig(**kw), topo, T, device="cpu")
    for field in ("edge_up", "node_up", "rejoin", "part_up"):
        a, b = getattr(own, field), getattr(ref_ft, field)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), field


def test_all_up_realization_and_edge_ids_are_the_jax_package_s():
    ours, ref = _both("erdos_renyi", latency_model="exponential")
    a, b = events.all_up_realization(ours), ref_events.all_up_realization(ref)
    for field in ("fire", "partner", "rejoin", "matched_fired"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    edges = np.array([[0, 3], [1, 2], [2, 5]])
    np.testing.assert_array_equal(events._edge_id_table(6, edges),
                                  ref_events._edge_id_table(6, edges))
    with pytest.raises(ValueError, match="does not cover"):
        events.realize_event_faults(ours, FaultTimeline(horizon=T - 1, directed=False))


def _ref_draw(worker, step, descent, n_valid, L, b, x64):
    def go():
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(jax.random.key(203), 0xA57E), worker), step)
        if descent is not None:
            key = jax.random.fold_in(key, descent)
        idx, w = ref_sample(key, L, jnp.int32(n_valid), b)
        return np.asarray(idx), np.asarray(w)

    if x64:
        with enable_x64(True):
            return go()
    return go()


@pytest.mark.parametrize("descent", [None, 0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_event_draw_is_the_jax_package_s(dtype, descent):
    """Event e's batch: key fold_in(fold_in(fold_in(key(seed), 0xA57E),
    worker), step) (descent m folded in after), the worker's scores, stable
    top-min(b, L), weights float32(1/b_eff); shards shorter than b tile."""
    x64 = dtype == torch.float64
    n_valid = torch.tensor([20, 3, 0, 7, 16], dtype=torch.int64)
    L, b = 20, 8
    workers = torch.tensor([0, 1, 2, 3, 4, 1, 0], dtype=torch.int64)
    steps = torch.tensor([0, 5, 3, 2**31 - 1, 9, 0, 41], dtype=torch.int64)
    X = torch.randn(5, L, 3, dtype=dtype, generator=torch.Generator().manual_seed(0))
    y = torch.randn(5, L, dtype=dtype, generator=torch.Generator().manual_seed(1))
    key = sampling.event_key(203, x64=x64)
    for e in range(len(workers)):
        cursor = torch.tensor([e])
        idx, w = sampling.event_batch_indices(key, cursor, workers, steps, n_valid, L, b, dtype,
                                              descent)
        worker = int(workers[e])
        want_idx, want_w = _ref_draw(worker, int(steps[e]), descent, int(n_valid[worker]), L,
                                     b, x64)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(w.numpy(), want_w.astype(w.numpy().dtype))
        # The wrappers take the plain version on CPU tensors.
        idx2, w2 = sampling_kernels.event_batch_indices(key, cursor, workers, steps, n_valid, L,
                                                        b, dtype, descent)
        assert torch.equal(idx2, idx) and torch.equal(w2, w)
        Xb, yb, wb = sampling_kernels.sample_event_batch(key, cursor, workers, steps, X, y,
                                                         n_valid, b, descent)
        assert torch.equal(Xb[0], X[worker, idx]) and torch.equal(yb[0], y[worker, idx])
        assert torch.equal(wb[0], w)



@pytest.mark.parametrize("name", sorted(FAULT_RUNS))
def test_faulted_run_matches_the_jax_package(data, name):  # noqa: F811
    check_run(data, name, FAULT_RUNS[name])
