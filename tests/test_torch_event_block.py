"""The event clock's block draw and the slot round's two passes, on the CPU.

The event sampler draws a block of B events' batches at once
(``sampling_kernels.sample_event_block``, before the block's first event):
its plain version is B per-event draws (``ops/sampling.py``'s
``sample_event_batch``) stacked, bit for bit, in float32 and float64, at τ
= 1 and τ = 2, at blocks that start on and between window boundaries and
at the block that ends at the schedule's last event. A run on the block
draw equals, bit for bit, the same run with those per-event draws injected
as its batch schedule: D-SGD and gradient tracking, τ = 2, under faults
with a fire mask and under ``neighbor_restart``, over windows of two
blocks, and a run split at a window boundary.

The slot round (``draw_kernels.realize_slot_round``) is two passes on the
card: the live pass writes each row's live-slot count and a bit a live
slot, the weight pass reads the bits (no float array) and adds a row's
live slots' weights in ascending order in one thread. ``_two_passes``
repeats that in numpy; it and the plain version equal the plain version
as it stood before the passes were restructured (``_slot_round_before``),
bit for bit, in both dtypes and on the replica axis.
"""

import numpy as np
import pytest
import torch

from distributed_optimization_tpu_torch.backends import async_scan
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.ops import draw_kernels as dk
from distributed_optimization_tpu_torch.ops import sampling, sampling_kernels
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.topology import build_topology
from distributed_optimization_tpu_torch.utils.data import (
    generate_synthetic_dataset,
    stack_shards,
)
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

# N = 8 workers of 50 rows, b = 8: every weight 1/8, so an injected
# schedule's uniform weights are the draw's. eval_every = 50 gives windows
# of 400 events, two blocks of 200.
BASE = dict(execution="async", n_workers=8, n_iterations=100, eval_every=50, n_samples=400,
            n_features=6, n_informative_features=4, local_batch_size=8,
            problem_type="quadratic", algorithm="dsgd", topology="ring",
            latency_model="lognormal", latency_tail=1.25, seed=5)
RUNS = {
    "dsgd-f32": dict(dtype="float32"),
    "dsgd-tau2-f64": dict(dtype="float64", local_steps=2),
    "gt-participation-f64": dict(dtype="float64", algorithm="gradient_tracking",
                                 participation_rate=0.7),
    "gt-tau2-churn-restart-f32": dict(dtype="float32", algorithm="gradient_tracking",
                                      local_steps=2, mttf=10.0, mttr=4.0,
                                      rejoin="neighbor_restart"),
}


@pytest.fixture(scope="module")
def dataset():
    cfg = ExperimentConfig(**BASE)
    ds = generate_synthetic_dataset(cfg)
    return ds, compute_reference_optimum(ds, cfg.reg_param)[1]


def _schedule(cfg, ds):
    """(X, y, n_valid, workers, steps, base key) of a config's run, on the CPU."""
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    host = stack_shards(ds, dtype=np.dtype(cfg.dtype))
    _, tl = async_scan.timeline_for(cfg, "cpu")
    return (torch.as_tensor(host.X), torch.as_tensor(host.y),
            torch.as_tensor(host.n_valid, dtype=torch.int64),
            torch.as_tensor(tl.worker, dtype=torch.int64),
            torch.as_tensor(tl.local_step, dtype=torch.int64),
            sampling.event_key(cfg.seed, x64=dtype == torch.float64))


@pytest.mark.parametrize("tau", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_block_is_the_per_event_draws(dataset, dtype, tau):
    ds, _ = dataset
    cfg = ExperimentConfig(**dict(BASE, dtype=dtype))
    X, y, nv, workers, steps, key = _schedule(cfg, ds)
    E, b = len(workers), cfg.local_batch_size
    B = async_scan.event_block(cfg.eval_every * cfg.n_workers)
    # The run's first block, one across the first window's end, a short one
    # between boundaries, and the schedule's last block.
    for first, events in ((0, B), (B + B // 2, B), (7, 5), (E - B, B)):
        cursor = torch.tensor([first])
        out = sampling_kernels.sample_event_block(key, cursor, workers, steps, X, y, nv, b,
                                                  events, descents=None if tau == 1 else tau)
        plain = sampling.sample_event_block(key, cursor, workers, steps, X, y, nv, b, events,
                                            None if tau == 1 else tau)
        assert all(torch.equal(got, p) for got, p in zip(out, plain))
        for e in (0, events // 2, events - 1):
            for m in range(tau):
                one = sampling.sample_event_batch(key, torch.tensor([first + e]), workers,
                                                  steps, X, y, nv, b, None if tau == 1 else m)
                for got, want in zip(out, one):
                    assert torch.equal(got[e, m], want[0])
        # Each draw's outputs start EVENT_ALIGN bytes apart (or a multiple).
        for part in out:
            assert part.stride(0) // tau * part.element_size() % sampling_kernels.EVENT_ALIGN == 0


def _per_event_batches(cfg, ds):
    """Each event's batch indices ([E, b], or [E, τ, b]) as the per-event
    draw gives them."""
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    X, _, nv, workers, steps, key = _schedule(cfg, ds)
    tau = cfg.local_steps
    rows = []
    for e in range(len(workers)):
        at = torch.tensor([e])
        draws = [sampling.event_batch_indices(key, at, workers, steps, nv, X.shape[1],
                                              cfg.local_batch_size, dtype,
                                              None if tau == 1 else m)[0]
                 for m in range(tau)]
        rows.append(draws[0] if tau == 1 else torch.stack(draws))
    return torch.stack(rows).numpy()


def _same_run(a, b):
    assert np.array_equal(a.history.objective, b.history.objective)
    assert np.array_equal(a.history.consensus_error, b.history.consensus_error)
    assert a.history.total_floats_transmitted == b.history.total_floats_transmitted
    for k in a.final_state:
        assert np.array_equal(a.final_state[k], b.final_state[k]), k


@pytest.mark.parametrize("name", sorted(RUNS))
def test_block_drawn_run_is_the_per_event_draws_run(dataset, name):
    ds, f_opt = dataset
    cfg = ExperimentConfig(**dict(BASE, **RUNS[name]))
    assert async_scan.event_block(cfg.eval_every * cfg.n_workers) * 2 == (cfg.eval_every
                                                                          * cfg.n_workers)
    drawn = async_scan.run_async(cfg, ds, f_opt, device="cpu", return_state=True)
    injected = async_scan.run_async(cfg, ds, f_opt, device="cpu", return_state=True,
                                    batch_schedule=_per_event_batches(cfg, ds))
    _same_run(drawn, injected)
    if name == "dsgd-f32":
        # Split at the first window's end: the second slice's blocks start
        # at its start_event.
        half = cfg.eval_every * cfg.n_workers
        first = async_scan.run_async(cfg, ds, f_opt, device="cpu", return_state=True,
                                     n_events=half)
        second = async_scan.run_async(cfg, ds, f_opt, device="cpu", return_state=True,
                                      state0=first.final_state, start_event=half)
        for k in drawn.final_state:
            assert np.array_equal(second.final_state[k], drawn.final_state[k]), k
        assert np.array_equal(np.r_[first.history.objective, second.history.objective],
                              drawn.history.objective)


def _slot_round_before(t, tables, timeline, weights, degree_total=None):
    """The slot round's plain version as it stood before the two passes
    were restructured (a copy, the reference of the restructured one)."""
    n = tables.n
    k = tables.nbr.shape[1]
    up = torch.ones(n, dtype=torch.bool)
    edge_at = None
    if timeline is not None and timeline.horizon:
        row = dk.timeline_row(t, timeline.horizon)
        for states in (timeline.node_up, timeline.part_up):
            if states is not None:
                up = up & states.index_select(0, row)[0].bool()
        if timeline.edge_up is not None:
            edge_at = timeline.edge_up.index_select(0, row)[0].bool()
    nbr = tables.nbr.long()
    live = torch.arange(k)[None, :] < tables.cnt[:, None]
    live = live & up[:, None] & up[nbr]
    if edge_at is not None:
        live = live & edge_at[tables.eid.long().clamp(min=0)]
    d = live.sum(dim=1)
    if degree_total is not None:
        degree_total.add_(d.sum().to(torch.float64))
    deg = d.to(weights)
    one = torch.ones((), dtype=weights)
    w = torch.where(live, one / (one + torch.maximum(deg[:, None], deg[nbr])), 0.0)
    total = torch.zeros(n, dtype=weights)
    for col in w.unbind(1):
        total = total + col
    return dk.SlotRound(live.float(), w, one - total, up.float())


def _two_passes(t, tables, timeline, weights):
    """The card's two passes in numpy: each row's live bits and count, then
    each live slot's weight from the bits and w_self over the live slots in
    ascending order, one add at a time."""
    real = np.float64 if weights == torch.float64 else np.float32
    n, k = tables.nbr.shape
    nbr = tables.nbr.numpy()
    up = np.ones(n, dtype=bool)
    edge = None
    if timeline is not None and timeline.horizon:
        row = int(dk.timeline_row(t, timeline.horizon))
        for states in (timeline.node_up, timeline.part_up):
            if states is not None:
                up &= states[row].numpy().astype(bool)
        if timeline.edge_up is not None:
            edge = timeline.edge_up[row].numpy().astype(bool)
    cnt = tables.cnt.numpy()
    bits = np.zeros((n, (k + 31) // 32), dtype=np.uint64)
    deg = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for s in range(cnt[i]):
            j = nbr[i, s]
            if up[i] and up[j] and (edge is None or edge[tables.eid[i, s]]):
                bits[i, s // 32] |= np.uint64(1) << np.uint64(s % 32)
                deg[i] += 1
    w = np.zeros((n, k), dtype=real)
    w_self = np.zeros(n, dtype=real)
    one = real(1)
    for i in range(n):
        total = real(0)
        for s in range(k):
            if int(bits[i, s // 32]) >> (s % 32) & 1:
                w[i, s] = one / (one + real(max(deg[i], deg[nbr[i, s]])))
                total = real(total + w[i, s])
        w_self[i] = one - total
    return deg, w, w_self


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("graph", [("ring", 16, None), ("erdos_renyi", 40, 0.2)],
                         ids=["ring", "er"])
def test_restructured_slot_round_is_the_old_one(graph, dtype):
    name, n, p = graph
    topo = build_topology(name, n, impl="neighbor",
                          **(dict(erdos_renyi_p=p, seed=3) if p else {}))
    fm = faults.make_faulty_mixing(topo, seed=[4, 5], horizon=10, device="cpu",
                                   x64=dtype == torch.float64, drop_prob=0.3, burst_len=3.0,
                                   mttf=6.0, mttr=3.0, participation_rate=0.7)
    for t in (0, 4, 9, 13):
        tt = torch.tensor([t])
        total = torch.zeros(2, dtype=torch.float64)
        got = dk.realize_slot_round(tt, fm._slots, fm._tl, weights=dtype, degree_total=total,
                                    replicas=2)
        for r in range(2):
            tl = fm._tl.replica(r)
            before_total = torch.zeros((), dtype=torch.float64)
            before = _slot_round_before(tt, fm._slots, tl, dtype, before_total)
            for a, b in zip(before, got):
                assert torch.equal(a, b[r]), t
            assert float(before_total) == float(total[r])
            deg, w, w_self = _two_passes(tt, fm._slots, tl, dtype)
            assert int(deg.sum()) == float(before_total)
            assert np.array_equal(w, before.w.numpy()) and np.array_equal(w_self,
                                                                          before.w_self.numpy())
