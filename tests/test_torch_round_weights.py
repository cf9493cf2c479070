"""One round's W_t and degree count from the round kernel's plain version,
held to the JAX package on the CPU.

The round kernel (``ops/draw_kernels.realize_round``) gives A_t, W_t, the
active mask and the round's degree count in one launch; on the CPU its plain
version, which the kernel equals bit for bit on the card, takes its place.
Here, on numpy-seeded inputs:

- the twin's W_t against the JAX package's ``metropolis_hastings_weights``
  and ``column_stochastic_weights`` of its ``realized_adjacency(t)``, in every
  fault mode: bit for bit on the ring and the directed ring (at most two
  weights a row or column, so the order of the diagonal's sum cannot
  matter), elsewhere within one ulp of 1.0 in float32 (the twin adds a row
  in ascending neighbour order, XLA in its own) and within 1e-12 in
  float64; the degree count exactly the JAX package's;
- the port's host ``metropolis_hastings_weights`` / ``column_stochastic_weights``
  against the twin at the same tolerances;
- a timeline read at and past its horizon: the JAX package clamps a
  traced t into the timeline's rows, and so does the twin;
- whole faulted runs against ``jax_backend.run`` in float64 to 1e-12 on
  graphs with more than two neighbours a row, with the floats transmitted
  exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.parallel import build_topology as ref_build
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.ops import draw_kernels
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.topology import build_topology

TOL = dict(rtol=1e-12, atol=1e-12)
# (name, N): every graph of the port that a round realizes.
GRAPHS = [("ring", 10), ("directed_ring", 8), ("grid", 16), ("erdos_renyi", 14),
          ("chain", 9), ("star", 9), ("fully_connected", 12), ("directed_erdos_renyi", 12)]
# make_faulty_mixing's fault modes.
MODES = {
    "edges": dict(drop_prob=0.3),
    "stragglers": dict(drop_prob=0.0, straggler_prob=0.25),
    "both": dict(drop_prob=0.3, straggler_prob=0.2),
    "bursty": dict(drop_prob=0.3, burst_len=3.0, horizon=30),
    "churn": dict(drop_prob=0.2, mttf=6.0, mttr=3.0, horizon=30),
    "participation": dict(drop_prob=0.2, participation_rate=0.7, horizon=30),
}
ROUNDS = (0, 3, 11, 29)


def _reference_weights(ref, directed: bool, t: int, dtype):
    """The JAX package's W_t at t in ``dtype`` (float64 under enable_x64)."""
    rule = (ref_faults.column_stochastic_weights if directed
            else ref_faults.metropolis_hastings_weights)
    with jax.enable_x64(dtype == torch.float64):
        A = ref.realized_adjacency(t)
        acc = jnp.float64 if dtype == torch.float64 else jnp.float32
        return np.asarray(rule(A.astype(acc)))


def _assert_weights_close(got: np.ndarray, want: np.ndarray, exact: bool, dtype) -> None:
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("graph", GRAPHS, ids=[g for g, _ in GRAPHS])
def test_twin_weights_are_the_jax_package_s(graph, mode, dtype):
    name, n = graph
    kw = MODES[mode]
    topo = build_topology(name, n, erdos_renyi_p=0.4, seed=2)
    ref_topo = ref_build(name, n, erdos_renyi_p=0.4, seed=2)
    x64 = dtype == torch.float64
    ours = faults.make_faulty_mixing(topo, seed=11, device="cpu", x64=x64, **kw)
    ref = ref_faults.make_faulty_mixing(ref_topo, seed=11, **kw)
    exact = name in ("ring", "directed_ring")
    for t in ROUNDS:
        total = torch.zeros((), dtype=torch.float64)
        rnd = ours.realize(torch.tensor([t]), total)
        want = _reference_weights(ref, topo.directed, t, dtype)
        got = rnd.W.numpy()
        assert got.dtype == want.dtype
        _assert_weights_close(got, want, exact, dtype)
        np.testing.assert_array_equal(rnd.A.numpy(), np.asarray(ref.realized_adjacency(t)))
        assert float(total) == float(ref.realized_degree_sum(t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("graph", GRAPHS, ids=[g for g, _ in GRAPHS])
def test_host_weight_rules_agree_with_the_twin(graph, dtype):
    """``metropolis_hastings_weights`` / ``column_stochastic_weights``, kept
    for the host and callers outside a round, against the twin's W_t."""
    name, n = graph
    topo = build_topology(name, n, erdos_renyi_p=0.4, seed=2)
    fm = faults.make_faulty_mixing(topo, 0.3, 5, straggler_prob=0.2, device="cpu",
                                   x64=dtype == torch.float64)
    rule = faults.column_stochastic_weights if topo.directed else \
        faults.metropolis_hastings_weights
    for t in ROUNDS:
        rnd = fm.realize(torch.tensor([t]))
        _assert_weights_close(rule(rnd.A.to(dtype)).numpy(), rnd.W.numpy(),
                              name in ("ring", "directed_ring"), dtype)


def test_twin_rows_sum_to_one_and_order_matters_only_off_the_ring():
    """W_t is row-stochastic (MH) or column-stochastic (directed) to an ulp,
    and on the fully-connected graph the twin's ascending-order diagonal
    differs from a pairwise sum's somewhere: the tolerance above is needed."""
    rng = np.random.default_rng(0)
    topo = build_topology("fully_connected", 12)
    fm = faults.make_faulty_mixing(topo, 0.3, int(rng.integers(1 << 30)), device="cpu")
    differs = False
    for t in range(40):
        rnd = fm.realize(torch.tensor([t]))
        W = rnd.W
        np.testing.assert_allclose(W.sum(dim=1).numpy(), 1.0, rtol=0, atol=4 * 2.0**-23)
        off = W - torch.diag(torch.diagonal(W))
        pairwise = 1.0 - off.sum(dim=1)
        differs |= not torch.equal(pairwise, torch.diagonal(W))
    assert differs
    directed = build_topology("directed_erdos_renyi", 12, erdos_renyi_p=0.4, seed=2)
    fm = faults.make_faulty_mixing(directed, 0.3, 7, device="cpu")
    W = fm.realize(torch.tensor([5])).W
    np.testing.assert_allclose(W.sum(dim=0).numpy(), 1.0, rtol=0, atol=4 * 2.0**-23)


def test_the_twin_s_slots_are_the_dense_draws():
    """The twin draws only on base edges, at the dense draw's counters: its
    A_t equals the [N, N] draw masked (the dense formulation), on numpy
    inputs."""
    from distributed_optimization_tpu_torch.ops import prng

    rng = np.random.default_rng(3)
    for name, n in (("erdos_renyi", 20), ("directed_erdos_renyi", 16), ("grid", 25)):
        topo = build_topology(name, n, erdos_renyi_p=0.3, seed=int(rng.integers(100)))
        tables = faults.round_tables(topo, device="cpu")
        keys = tuple((int(a), int(b)) for a, b in rng.integers(0, 2**32, (3, 2)))
        t = torch.tensor([int(rng.integers(2**31))])
        out = draw_kernels.realize_round(t, keys, tables, drop_prob=0.35, straggler_prob=0.15,
                                         weights=torch.float64)
        counters = torch.arange(n * n).reshape(n, n)
        u = prng.uniform_at(prng.fold_in(keys[0], t.reshape(())), counters)
        if not topo.directed:
            u = torch.triu(u, 1)
            u = u + u.T
        base = torch.as_tensor(topo.adjacency != 0, dtype=torch.float32)
        A = torch.where(u >= np.float32(0.35), base, torch.zeros_like(base))
        up = (prng.uniform_at(prng.fold_in(keys[1], t.reshape(())), counters[0])
              >= np.float32(0.15)).float()
        A = A * up[:, None] * up[None, :]
        assert torch.equal(out.A, A)
        assert torch.equal(out.active, up)


@pytest.mark.parametrize("mode", ["bursty", "churn", "participation", "churn-restart"])
def test_a_timeline_read_past_its_horizon_clamps_as_the_jax_package_does(mode):
    """At t = T and past it the round reads the timeline's last row, as the
    JAX package's ``edge_up[t]`` / ``node_up[t]`` / ``rejoin[t]`` do; the
    twin's A_t, active, W_t, degree count and warm restart against the JAX
    package's per-t functions."""
    kw = dict(MODES[mode.split("-")[0]])
    if mode == "churn-restart":
        kw["rejoin"] = "neighbor_restart"
    horizon = kw["horizon"]
    topo = build_topology("erdos_renyi", 14, erdos_renyi_p=0.4, seed=2)
    ours = faults.make_faulty_mixing(topo, seed=11, device="cpu", **kw)
    ref = ref_faults.make_faulty_mixing(ref_build("erdos_renyi", 14, erdos_renyi_p=0.4, seed=2),
                                        seed=11, **kw)
    x = np.random.default_rng(4).standard_normal((14, 3))
    last = ours.realize(torch.tensor([horizon - 1]))
    for t in (horizon, horizon + 1, 10 * horizon):
        rnd = ours.realize(torch.tensor([t]))
        np.testing.assert_array_equal(rnd.A.numpy(), np.asarray(ref.realized_adjacency(t)))
        np.testing.assert_array_equal(rnd.active.numpy(), np.asarray(ref.active(t)))
        assert torch.equal(rnd.A, last.A) and torch.equal(rnd.W, last.W)
        _assert_weights_close(rnd.W.numpy(), _reference_weights(ref, False, t, torch.float32),
                              False, torch.float32)
        assert float(ours.realized_degree_sum(t)) == float(ref.realized_degree_sum(t))
        if mode == "churn-restart":
            with jax.enable_x64(True):
                want = np.asarray(ref.rejoin_restart(t, jnp.asarray(x)))
            np.testing.assert_allclose(ours.rejoin_restart(t, torch.from_numpy(x)).numpy(),
                                       want, **TOL)


# --- whole runs --------------------------------------------------------------------

SMALL = dict(n_workers=12, n_samples=480, n_features=10, n_informative_features=6,
             n_iterations=50, topology="erdos_renyi", erdos_renyi_p=0.4,
             local_batch_size=16, dtype="float64", problem_type="logistic", eval_every=10)
RUNS = {
    "er-edges": dict(edge_drop_prob=0.2),
    "er-stragglers": dict(straggler_prob=0.2),
    "grid-both": dict(topology="grid", n_workers=16, edge_drop_prob=0.2, straggler_prob=0.1),
    "er-bursty": dict(edge_drop_prob=0.3, burst_len=4.0),
    "er-churn-frozen": dict(mttf=8.0, mttr=3.0),
    "er-churn-restart": dict(mttf=8.0, mttr=3.0, rejoin="neighbor_restart"),
    "fc-participation": dict(topology="fully_connected", participation_rate=0.7,
                             edge_drop_prob=0.1),
    "gt-er-both": dict(algorithm="gradient_tracking", edge_drop_prob=0.2, straggler_prob=0.1),
    "ps-directed-er-edges": dict(algorithm="push_sum", topology="directed_erdos_renyi",
                                 edge_drop_prob=0.2),
}


@pytest.fixture(scope="module")
def datasets():
    cache = {}

    def get(fields):
        key = (fields["n_samples"], fields["n_workers"])
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices,
                                          ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


@pytest.mark.parametrize("name", sorted(RUNS))
def test_faulted_run_is_the_jax_package_s(datasets, name):
    fields = {**SMALL, **RUNS[name]}
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
