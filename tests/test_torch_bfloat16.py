"""bfloat16 in the port against the JAX package's bfloat16 runs on the CPU.

The JAX package's bfloat16 run on the CPU rounds every operation to
bfloat16, with three exceptions the port mirrors: products and reductions
accumulate in float32 and round once; a Python scalar is rounded to
bfloat16 before it is applied (its weak type); and XLA fuses the last
elementwise operation before a reduction into it, so that operation is
summed unrounded (``ops/rounding.py``). Under those rules the pieces are
bitwise the JAX package's: the stacked shards (softmax labels int32 and
exact at K = 512), the ring and fully-connected stencils and the Pallas
kernels' twins, both samplers, the step sizes, the four gradients and the
full objective.

Whole runs (``tests/torch_bfloat16_agreement.py`` measures 30
configurations of N = 8, T = 300 over the six algorithms, four losses,
the mixing forms, samplers and fault processes):

- against ``jax_backend.run(..., measure_timestamps=True)``, the JAX
  package's chunk loop, whose eval is a program of its own: the gap
  histories and final models are bitwise in 28 of 30. In the other two a
  product sums in another order in torch than in XLA and the trajectories
  part: the fault layer's float32 W_t x on the chain under stragglers
  (models 8.9e-4 apart, relative, at T = 300, the gap by an ulp) and ADMM's
  full-batch gradient (the models part in the last eval window, 1.7e-3;
  the gaps equal); this module's runs are all bitwise and held so;
- against the default run (the flat scan), the final models are as
  against the chunk loop, but XLA also fuses the step's last operation (e.g.
  W x − η g) into the eval's mean x̄ inside the scan, so its gap reads the
  unrounded step output where the port, and the JAX package's own chunk
  loop, read the stored, rounded state: the gaps part by up to 7 bfloat16
  ulps of f(x̄) (the most measured, gradient tracking with Huber on the
  pallas ring; 0 to 4 in the others).
  ``test_gap_parts_only_where_xla_fuses_the_eval`` shows that fusion at
  one step.

The JAX runs are the module's six chunk-loop runs, at ``tests/test_dtypes.py``'s BASE size (N = 8, T = 300), shared through
a module-scope fixture; the data come from the port's generator (bit for
bit the JAX package's), f* from the port's oracle, given to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.models import get_problem as ref_get_problem
from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_make_mixing_op
from distributed_optimization_tpu.parallel import build_topology as ref_build_topology
from distributed_optimization_tpu.utils.data import HostDataset as RefHostDataset
from distributed_optimization_tpu.utils.data import stack_shards as ref_stack
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import fc_kernels, prng, ring_kernels, sampling
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.ops.rounding import scalar
from distributed_optimization_tpu_torch.parallel.faults import make_faulty_mixing
from distributed_optimization_tpu_torch.parallel.topology import build_topology
from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset, stack_shards
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

BF16 = torch.bfloat16
BASE = dict(n_workers=8, n_samples=320, n_features=8, n_informative_features=4,
            n_iterations=300, local_batch_size=8, problem_type="quadratic",
            algorithm="dsgd", topology="ring", eval_every=30, dtype="bfloat16")
SOFTMAX = dict(problem_type="softmax", n_classes=5, n_samples=400, n_features=12,
               n_informative_features=8)
# The six algorithms, the four losses, the ring's pallas kernels (the fc
# kernels' twins are held in the stencil test), the gather and dense
# samplers, the full batch and edge drops: six JAX runs. EXTRA's bfloat16
# run grows in both packages alike (bit for bit) at η₀ >= 0.002 on this
# data, so it runs at 0.0005, where it decreases. Full batches (b >= L =
# 40) draw nothing, which keeps the module's time down.
FULL = dict(local_batch_size=40)
RUNS = {
    "dsgd-quadratic-edge-drop-full-batch": dict(edge_drop_prob=0.2, **FULL),
    "gradient-tracking-huber-pallas": dict(algorithm="gradient_tracking", problem_type="huber",
                                           mixing_impl="pallas"),
    "extra-logistic-full-batch": dict(algorithm="extra", problem_type="logistic",
                                      learning_rate_eta0=0.0005, **FULL),
    "admm-quadratic": dict(algorithm="admm"),
    "centralized-logistic-dense-sampling": dict(algorithm="centralized",
                                                problem_type="logistic", sampling_impl="dense"),
    "push-sum-softmax-directed-ring-full-batch": dict(algorithm="push_sum",
                                                      topology="directed_ring", **SOFTMAX,
                                                      **FULL),
}


def _bits(a) -> np.ndarray:
    """The raw 16 bits of a bfloat16 JAX array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _t(a: np.ndarray) -> torch.Tensor:
    """A float array as a bfloat16 tensor (torch's cast)."""
    return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(BF16)


def _j(a: np.ndarray):
    return jnp.asarray(np.asarray(a, dtype=np.float64)).astype(jnp.bfloat16)


def _datasets(fields):
    """The port's dataset of ``fields`` (bit for bit the JAX package's, as
    tests/test_torch_data.py holds) and the JAX package's HostDataset of
    the same arrays."""
    cfg = ExperimentConfig(**fields)
    ours = generate_synthetic_dataset(cfg)
    ref = RefHostDataset(X_full=ours.X_full, y_full=ours.y_full,
                         shard_indices=ours.shard_indices, problem_type=ours.problem_type)
    return ref, ours


@pytest.fixture(scope="module")
def data():
    cache = {}

    def get(fields):
        key = fields["problem_type"]
        if key not in cache:
            ref, ours = _datasets(fields)
            # f* from the port's oracle; Huber's (an L-BFGS solve of seconds)
            # is left at 0, the gap then f(x̄).
            f_opt = 0.0 if key == "huber" else float(
                compute_reference_optimum(ours, ExperimentConfig(**fields).reg_param)[1])
            cache[key] = (ref, f_opt, ours)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def runs(data):
    cache = {}

    def get(name):
        if name not in cache:
            fields = {**BASE, **RUNS[name]}
            ds, f_opt, ours = data(fields)
            ref = jax_backend.run(RefConfig(**fields), ds, f_opt, return_state=True,
                                  measure_timestamps=True, measure_compile=False)
            port = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu")
            cache[name] = (ref, port, f_opt)
        return cache[name]

    return get


# --- the pieces, bit for bit ------------------------------------------------------


@pytest.mark.parametrize("family", ["quadratic", "softmax-512"])
def test_stack_shards_is_the_jax_package_s_bitwise(family):
    """X and y cast by torch from float64 equal the JAX package's ml_dtypes
    stack bit for bit; softmax's 512 class labels stay int32 and exact."""
    rng = np.random.default_rng(7)
    n, rows, d = 8, 640, 11
    X = rng.standard_normal((rows, d)) * 3.0
    if family == "softmax-512":
        y, problem = (np.arange(rows) % 512).astype(np.float64), "softmax"
    else:
        y, problem = rng.standard_normal(rows) * 50.0, "quadratic"
    shards = np.array_split(rng.permutation(rows), n)
    ref = ref_stack(RefHostDataset(X_full=X, y_full=y, shard_indices=shards,
                                   problem_type=problem), np.dtype("bfloat16"))
    ours = stack_shards(dataset_from_reference(X, y, shards, problem), "bfloat16")
    assert ours.X.dtype == BF16 and np.array_equal(_bits(ours.X), _bits(ref.X))
    np.testing.assert_array_equal(ours.n_valid, ref.n_valid)
    if problem == "softmax":
        assert ours.y.dtype == np.int32 and ref.y.dtype == np.int32
        np.testing.assert_array_equal(ours.y, ref.y)
        assert set(np.unique(ours.y).tolist()) == set(range(512))
    else:
        assert ours.y.dtype == BF16 and np.array_equal(_bits(ours.y), _bits(ref.y))
    # Softmax labels are int32 in every run dtype.
    for dtype in ("float32", "float64"):
        stacked = stack_shards(dataset_from_reference(X, y, shards, problem), dtype)
        assert stacked.X.dtype == np.dtype(dtype)
        assert stacked.y.dtype == (np.int32 if problem == "softmax" else np.dtype(dtype))


@pytest.mark.parametrize("n", [256, 25])
def test_stencils_and_twins_are_the_jax_package_s_bitwise(n):
    """At [n, 81]: the ring stencil and the Pallas ring kernels (interpret
    mode) of the JAX package against the port's stencil and kernel twins,
    mix, neighbour sum and fused step; the fc stencil and Pallas kernels
    against the port's fc twins and stencil."""
    rng = np.random.default_rng(n)
    x_np, g_np = rng.standard_normal((n, 81)) * 4.0, rng.standard_normal((n, 81)) * 40.0
    x, g, eta = _t(x_np), _t(g_np), _t(np.array([0.05 / np.sqrt(7.0)]))
    xj, gj, etaj = _j(x_np), _j(g_np), _j(np.array(0.05 / np.sqrt(7.0)))
    ring = ref_make_mixing_op(ref_build_topology("ring", n), "stencil", dtype=jnp.bfloat16)
    ours = make_mixing_op(build_topology("ring", n), "stencil", device="cpu", dtype=BF16)
    pallas = make_mixing_op(build_topology("ring", n), "pallas", device="cpu", dtype=BF16)
    for want, gots in (
        (ring.apply(xj), (ours.apply(x), pallas.apply(x), ring_kernels.ring_mix_plain(x))),
        (pk.ring_mix(xj, interpret=True), (ring_kernels.ring_mix(x),)),
        (ring.neighbor_sum(xj), (ours.neighbor_sum(x), pallas.neighbor_sum(x))),
        (pk.ring_neighbor_sum(xj, interpret=True), (ring_kernels.ring_neighbor_sum(x),)),
        (pk.fused_ring_dsgd_step(xj, gj, etaj, interpret=True),
         (ring_kernels.fused_ring_dsgd_step(x, g, eta),
          ring_kernels.fused_ring_dsgd_step_plain(x, g, 0.05 / np.sqrt(7.0)))),
    ):
        for got in gots:
            assert got.dtype == BF16 and np.array_equal(_bits(got), _bits(want))
    fc = ref_make_mixing_op(ref_build_topology("fully_connected", n), "stencil",
                            dtype=jnp.bfloat16)
    fc_ours = make_mixing_op(build_topology("fully_connected", n), "stencil", device="cpu",
                             dtype=BF16)
    for want, gots in (
        (fc.apply(xj), (fc_ours.apply(x), fc_kernels.fc_mix(x))),
        (pk.fc_mix(xj, interpret=True), (fc_kernels.fc_mix_plain(x),)),
        (fc.neighbor_sum(xj), (fc_ours.neighbor_sum(x), fc_kernels.fc_neighbor_sum(x))),
        (pk.fc_neighbor_sum(xj, interpret=True), (fc_kernels.fc_neighbor_sum_plain(x),)),
    ):
        for got in gots:
            assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [256, 25])
def test_fc_kernel_order_against_the_twin(n):
    """The fc kernels' summation order (``fc_kernels.MIRRORS``, which the
    card's kernels equal bit for bit) against the twins in bfloat16: both
    sum in float32 and round once, so they part only where two float32
    orders round to two bfloat16 values: at most one ulp, at [n, 81] in
    none (mean) and 1 (neighbour sum, n = 256) of the elements measured."""
    x = _t(np.random.default_rng(n + 1).standard_normal((n, 81)) * 4.0)
    for name, plain in (("fc_mix", fc_kernels.fc_mix_plain),
                        ("fc_neighbor_sum", fc_kernels.fc_neighbor_sum_plain)):
        p = fc_kernels.plan_for(name, x)
        got, want = fc_kernels.MIRRORS[name](x, p).float(), plain(x).float()
        ulp = torch.maximum(want.abs(), torch.tensor(2.0 ** -126)).log2().floor().exp2() / 128
        assert bool(((got - want).abs() <= ulp).all())
        assert int((got != want).sum()) <= (1 if name == "fc_neighbor_sum" else 0)


def test_samplers_draw_the_float32_run_s_batches():
    """A bfloat16 run keys and scores as a float32 run: both forms' indices
    are the float32 run's and their weights its weights cast to bfloat16,
    on ragged shards, at t = 0, 17 and 29,999 (the JAX package's bfloat16
    run casts its float32 sampler's weights; tests/test_torch_sampling.py
    holds the float32 sampler bitwise the JAX package's)."""
    n_valid, L, b = torch.tensor([12, 9, 3, 0, 12]), 12, 4
    skey = prng.fold_in(prng.key(203, x64=False), 0)
    for t in (0, 17, 29_999):
        w = sampling.sample_worker_batch_weights(skey, t, n_valid, L, b, BF16)
        w32 = sampling.sample_worker_batch_weights(skey, t, n_valid, L, b, torch.float32)
        idx, wb = sampling.sample_batch_indices(skey, t, n_valid, L, b, BF16)
        idx32, wb32 = sampling.sample_batch_indices(skey, t, n_valid, L, b, torch.float32)
        assert w.dtype == wb.dtype == BF16 and torch.equal(idx, idx32)
        assert torch.equal(w, w32.to(BF16)) and torch.equal(wb, wb32.to(BF16))
    assert sampling.masked_scores(skey, 0, n_valid, L, BF16).dtype == torch.float32


def test_step_sizes_are_the_float32_schedule_cast():
    """η_t for t < 30,000: the JAX package's float32 eta0 / sqrt(t + 1.0),
    cast to bfloat16 (bfloat16 arithmetic would round t + 1 past 256)."""
    cfg = ExperimentConfig(**{**BASE, "n_iterations": 30_000})
    ref = jax_backend._make_eta_fn(RefConfig(**{**BASE, "n_iterations": 30_000}))(
        jnp.arange(30_000)).astype(jnp.bfloat16)
    ours = torch_backend.make_eta_schedule(cfg, 30_000, "cpu", BF16)
    assert ours.dtype == BF16 and np.array_equal(_bits(ours), _bits(ref))


@pytest.mark.parametrize("family", ["logistic", "quadratic", "huber", "softmax"])
def test_gradients_are_the_jax_package_s(family):
    """The four weighted gradients at N = 8 shards: bitwise (0 elements differ; the products' float32 order could part an
    element, as at main's [256, 49, 81], where X w parts 1 of 12,544)."""
    fields = {**BASE, "problem_type": family, **(SOFTMAX if family == "softmax" else {})}
    rc = RefConfig(**fields)
    ds, host = _datasets(fields)
    ref = ref_stack(ds, np.dtype("bfloat16"))
    ours = stack_shards(host, "bfloat16")
    X, y = ours.X, torch.as_tensor(ours.y)
    n, L = X.shape[:2]
    rng = np.random.default_rng(3)
    d_model = get_problem(family, n_classes=5).param_dim(X.shape[2])
    w_np = rng.standard_normal((n, d_model)) * 0.3
    wts_np = (rng.random((n, L)) < 0.3) / 8.0
    ref_problem = ref_get_problem(family, n_classes=5)
    grad = jax.jit(jax.vmap(ref_problem.gradient_weighted, in_axes=(0, 0, 0, 0, None)))
    want = grad(_j(w_np), jnp.asarray(ref.X), jnp.asarray(ref.y), _j(wts_np), rc.reg_param)
    got = get_problem(family, n_classes=5).gradient_weighted(_t(w_np), X, y, _t(wts_np),
                                                             rc.reg_param)
    assert got.dtype == BF16 and int((_bits(got) != _bits(want)).sum()) == 0
    # The full objective: the gap histories of the runs below.


def test_scalars_round_as_weak_types():
    """A Python scalar applied to a bfloat16 tensor is rounded first, as
    JAX's weak type: x · (1/3) and x · 1e-3 bitwise JAX's."""
    x_np = np.random.default_rng(1).standard_normal(100_000) * 5.0
    x, xj = _t(x_np), _j(x_np)
    for c in (1.0 / 3.0, 1e-3):
        assert np.array_equal(_bits(x * scalar(c, BF16)), _bits(xj * c))
    assert scalar(1.0 / 3.0, torch.float32) == 1.0 / 3.0


# --- runs -----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_are_the_jax_package_s_bitwise(runs, name):
    """Gap histories and final models bitwise the JAX package's chunk
    loop; each run's objective finite and decreasing (tests/test_dtypes.py)."""
    ref, port, _ = runs(name)
    assert np.array_equal(port.final_models, np.asarray(ref.final_models, dtype=np.float64))
    gj, gp = np.asarray(ref.history.objective), port.history.objective
    assert np.array_equal(gp, gj)
    assert np.all(np.isfinite(gp)) and gp[-1] < gp[0]


def test_gap_parts_only_where_xla_fuses_the_eval():
    """The cause of the flat scan's gap differences, at one step of D-SGD on
    the ring: jitted with its eval, as in the scan, XLA fuses the step's
    W x − η g into the mean x̄, unrounded, so f(x̄) parts from the eval of
    the stored (rounded) state, which the port computes bit for bit."""
    ds, host = _datasets(BASE)
    stacked = ref_stack(ds, np.dtype("bfloat16"))
    data = (jnp.asarray(stacked.X), jnp.asarray(stacked.y), jnp.asarray(stacked.n_valid))
    objective = jax_backend.make_full_objective_fn(ref_get_problem("quadratic"), 1e-4)
    ring = ref_make_mixing_op(ref_build_topology("ring", 8), "stencil", dtype=jnp.bfloat16)

    @jax.jit
    def fused(x, g, eta):
        x_new = ring.apply(x) - eta * g
        return x_new, objective(jnp.mean(x_new, axis=0), *data)

    ours = torch_backend.make_full_objective_fn(get_problem("quadratic"), 1e-4)
    host_stack = stack_shards(host, "bfloat16")
    X, y, nv = host_stack.X, torch.as_tensor(host_stack.y), torch.as_tensor(host_stack.n_valid)
    rounded = jax.jit(objective)
    rng = np.random.default_rng(5)
    parted = 0
    for _ in range(100):  # 2 of these 100 part (5 of 300)
        x_np, g_np = rng.standard_normal((8, 9)) * 3.0, rng.standard_normal((8, 9)) * 30.0
        x_new, f_fused = fused(_j(x_np), _j(g_np), _j(np.array(0.01)))
        f_rounded = rounded(jnp.mean(x_new, axis=0), *data)
        step = ring_kernels.fused_ring_dsgd_step(_t(x_np), _t(g_np), _t(np.array([0.01])))
        assert np.array_equal(_bits(step), _bits(x_new))
        assert np.array_equal(_bits(ours(step.mean(0), X, y, nv)), _bits(f_rounded))
        parted += float(f_fused) != float(f_rounded)
    assert parted > 0


def test_fault_layer_counts_in_float32():
    """tests/test_faults.py's contract: the degree count of the fully
    connected graph of 40 is exactly 40·39 (bfloat16 would round it), W_t
    and the active mask are float32, mix and neighbour sum keep bfloat16."""
    topo = build_topology("fully_connected", 40)
    fm = make_faulty_mixing(topo, 0.0, seed=2, device="cpu")
    assert float(fm.realized_degree_sum(0)) == 40 * 39
    x16 = torch.ones((40, 3), dtype=BF16)
    assert fm.mix(0, x16).dtype == BF16 and fm.neighbor_sum(0, x16).dtype == BF16
    rnd = fm.realize(torch.tensor([0]))
    assert rnd.active.dtype == torch.float32 and rnd.W.dtype == torch.float32
    one_peer = make_faulty_mixing(topo, 0.0, seed=2, one_peer=True, device="cpu")
    assert one_peer.mix(1, x16).dtype == BF16


def test_interop_carries_bfloat16_bit_for_bit(runs):
    """An ml_dtypes bfloat16 array (what a JAX bfloat16 array becomes in
    numpy) and the JAX run's float64 state come across bit for bit."""
    ref, port, _ = runs("dsgd-quadratic-edge-drop-full-batch")
    xj = jnp.asarray(ref.final_state["x"]).astype(jnp.bfloat16)
    carried = state_from_reference({"x": np.asarray(xj)}, "cpu", BF16)["x"]
    assert carried.dtype == BF16 and np.array_equal(_bits(carried), _bits(xj))
    from64 = state_from_reference(ref.final_state, "cpu", BF16)["x"]
    assert np.array_equal(_bits(from64), _bits(xj))
    assert np.array_equal(from64.double().numpy(), port.final_models)


@pytest.mark.parametrize("fields", [dict(execution="async"), dict(replicas=2)],
                         ids=["async", "replicas"])
def test_bfloat16_compositions_without_a_kernel_are_refused(fields):
    with pytest.raises(ValueError, match="bfloat16.*does not have it yet"):
        ExperimentConfig(**{**BASE, **fields})
    assert ExperimentConfig(**{**BASE, "dtype": "float32", **fields}).dtype == "float32"


@pytest.mark.parametrize("fields", [
    dict(algorithm="choco", compression="top_k", compression_k=2),
    dict(compression="top_k", compression_k=2), dict(attack="sign_flip", n_byzantine=1),
    dict(aggregation="trimmed_mean", robust_b=1), dict(topology_impl="neighbor"),
    dict(n_workers=4096, n_samples=8192),
], ids=["choco", "compression", "attack", "aggregation", "neighbor", "auto-neighbor"])
def test_bfloat16_compositions_with_their_kernels_run(fields):
    """The compositions bfloat16 once refused (tests/test_torch_bfloat16_layers.py
    holds them against the JAX package) are accepted and run a few CPU
    iterations: finite gaps, bfloat16 models."""
    cfg = ExperimentConfig(**{**BASE, **fields, "n_iterations": 4, "eval_every": 2})
    res = torch_backend.run(cfg, generate_synthetic_dataset(cfg), 0.0, device="cpu")
    assert len(res.history.objective) == 2 and np.all(np.isfinite(res.history.objective))
    models = torch.from_numpy(res.final_models)
    assert torch.equal(models.to(BF16).double(), models)


def test_run_batch_refuses_bfloat16(data):
    _, f_opt, ours = data(BASE)
    with pytest.raises(ValueError, match="bfloat16"):
        torch_backend.run_batch(ExperimentConfig(**BASE), ours, f_opt, seeds=[1, 2],
                                device="cpu")


def test_cli_runs_bfloat16(capsys):
    from distributed_optimization_tpu_torch.__main__ import main

    assert main(["--device", "cpu", "--dtype", "bfloat16", "--n-workers", "8",
                 "--n-samples", "320", "--n-features", "8", "--n-informative-features", "4",
                 "--n-iterations", "60", "--eval-every", "30"]) == 0
    assert "iters_per_second" in capsys.readouterr().out
