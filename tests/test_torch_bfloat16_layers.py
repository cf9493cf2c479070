"""bfloat16 through the Byzantine, compressed and matrix-free layers, against
the JAX package's bfloat16 runs on the CPU.

The runs (``tests/test_torch_bfloat16.py``'s BASE size, N = 8, T = 300) are
held bitwise against ``jax_backend.run(..., measure_timestamps=True)``, the
JAX package's chunk loop, in the gap history and the final models: the
fused robust D-SGD step (sign-flip, trimmed mean; the Pallas kernel in
interpret mode), fused GT (ALIE, median; the aggregator form), fused
adaptive clipping under large noise, the gather trimmed mean under 20%
drops, CHOCO with top_k, D-SGD with qsgd at 4 bits, GT with random_k (both
exchange rounds), the neighbour-table Erdős–Rényi graph under drops and
participation 0.5, and a gather screen over a neighbour table.

They hold under the test suite's XLA setting (``tests/conftest.py``: eight
host devices). With one host device XLA's CPU products (X w, the fault
layer's W_t x) sum in another order, and the JAX package's own bfloat16
runs change: CHOCO top_k then parts at t = 170, where one worker's X w
holds an element within a float32 ulp of a bfloat16 tie, and the gather
screen under drops at its last step, in the Byzantine row's W_t x.

Three rules these runs depend on are held on their own: random_k and qsgd
draw float32 uniforms in a bfloat16 run, the exchange's γ is rounded to
bfloat16 before it is applied, and the bfloat16 mix over a neighbour table
computes the fused multiply-adds into which XLA contracts the JAX
package's jitted float32 slot sum.

The twins are held directly against the JAX functions at [256, 41] and
[25, 81]: ``fused_robust_plain`` against ``make_fused_robust_*`` in
interpret mode (bitwise but for clipping's float32 order, within a
bfloat16 ulp), and ``ef_compress_plain`` and the exchange bitwise against
the JAX compressors and ``ErrorFeedbackGossip.exchange``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.ops import compression as ref_compression
from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.ops.mixing import make_mixing_op as ref_make_mixing_op
from distributed_optimization_tpu.parallel import build_topology as ref_build_topology
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu.utils.data import HostDataset as RefHostDataset
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.ops import compression
from distributed_optimization_tpu_torch.ops import robust_kernels as bk
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.topology import build_topology, neighbor_tables_for
from distributed_optimization_tpu_torch.utils.data import generate_synthetic_dataset
from distributed_optimization_tpu_torch.utils.oracle import compute_reference_optimum

BF16 = torch.bfloat16
BASE = dict(n_workers=8, n_samples=320, n_features=8, n_informative_features=4,
            n_iterations=300, local_batch_size=8, problem_type="quadratic",
            algorithm="dsgd", topology="ring", eval_every=30, dtype="bfloat16")
SIGN_FLIP = dict(attack="sign_flip", n_byzantine=1)
ER_NEIGHBOR = dict(topology="erdos_renyi", erdos_renyi_p=0.5, topology_impl="neighbor")
COMPRESSED = dict(compression_k=3, choco_gamma=0.3)
RUNS = {
    "dsgd-sign-flip-trimmed-mean-fused": dict(**SIGN_FLIP, aggregation="trimmed_mean",
                                              robust_b=1, robust_impl="fused",
                                              mixing_impl="pallas"),
    # GT's tracked gradient takes the screened mix too: under ALIE its gap
    # grows (0.19 to 52 here) in both packages alike, bit for bit.
    "gt-alie-median-fused": dict(algorithm="gradient_tracking", problem_type="logistic",
                                 attack="alie", n_byzantine=1, aggregation="median",
                                 robust_b=1, robust_impl="fused"),
    "dsgd-large-noise-adaptive-clipping-fused": dict(attack="large_noise", n_byzantine=1,
                                                     attack_scale=5.0,
                                                     aggregation="clipped_gossip", robust_b=1,
                                                     robust_impl="fused"),
    "dsgd-trimmed-mean-gather-edge-drop": dict(**SIGN_FLIP, aggregation="trimmed_mean",
                                               robust_b=1, robust_impl="gather",
                                               edge_drop_prob=0.2),
    "choco-top-k": dict(algorithm="choco", compression="top_k", **COMPRESSED),
    "dsgd-qsgd-4-bits": dict(compression="qsgd", compression_k=4, choco_gamma=0.3),
    "gt-random-k": dict(algorithm="gradient_tracking", compression="random_k", **COMPRESSED),
    "neighbor-er-edge-drop-participation": dict(**ER_NEIGHBOR, edge_drop_prob=0.2,
                                                participation_rate=0.5),
    "neighbor-er-gather-screen": dict(**ER_NEIGHBOR, **SIGN_FLIP, aggregation="trimmed_mean",
                                      robust_b=1, robust_impl="gather"),
}
GROWS = ("gt-alie-median-fused",)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.fixture(scope="module")
def data():
    cache = {}

    def get(fields):
        key = fields["problem_type"]
        if key not in cache:
            cfg = ExperimentConfig(**fields)
            ours = generate_synthetic_dataset(cfg)
            ref = RefHostDataset(X_full=ours.X_full, y_full=ours.y_full,
                                 shard_indices=ours.shard_indices,
                                 problem_type=ours.problem_type)
            cache[key] = (ref, float(compute_reference_optimum(ours, cfg.reg_param)[1]), ours)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def runs(data):
    cache = {}

    def get(name):
        if name not in cache:
            fields = {**BASE, **RUNS[name]}
            ds, f_opt, ours = data(fields)
            ref = jax_backend.run(RefConfig(**fields), ds, f_opt, measure_timestamps=True,
                                  measure_compile=False)
            port = torch_backend.run(ExperimentConfig(**fields), ours, f_opt, device="cpu")
            cache[name] = (ref, port)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_are_the_jax_package_s_bitwise(runs, name):
    ref, port = runs(name)
    assert np.array_equal(port.final_models, np.asarray(ref.final_models, dtype=np.float64))
    gj, gp = np.asarray(ref.history.objective), port.history.objective
    assert np.array_equal(gp, gj)
    assert np.all(np.isfinite(gp)) and (gp[-1] < gp[0]) != (name in GROWS)


# --- the twins against the JAX functions ------------------------------------------


def _instance(n, d):
    """A table (the ring at N=256, ER p=0.15 at N=25, k_max 8), about 20% of
    its live slots down, x with two rows scaled by 100, g and η."""
    rng = np.random.default_rng(n)
    topo = (build_topology("ring", n) if n == 256
            else build_topology("erdos_renyi", n, erdos_renyi_p=0.15, seed=3))
    nbr, mask = neighbor_tables_for(topo)
    live = (mask * (rng.random(mask.shape) > 0.2)).astype(np.float32)
    x_np = rng.standard_normal((n, d)) * 3.0
    x_np[[1, 5]] *= 100.0
    g_np = rng.standard_normal((n, d)) * 30.0
    return nbr, live, x_np, g_np


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(BF16)


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float64)).astype(jnp.bfloat16)


# The operators whose whole exchange is held (each compile takes seconds).
EXCHANGED = (("top_k", 3), ("random_k", 9), ("qsgd", 4))


def _bf16_ulp(v) -> np.ndarray:
    a = np.abs(np.asarray(v, dtype=np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("shape", [(256, 41), (25, 81)])
def test_fused_robust_twin_is_the_pallas_kernel_s(shape):
    """Each rule, adaptive and fixed τ, aggregator and D-SGD step, against
    the Pallas kernels in interpret mode (the screen in float32, the
    aggregate rounded once, the step in bfloat16): the count rules bitwise.
    Clipping's float32 norms and slot sum are XLA's (its reduction order and
    fused multiply-adds) in the kernel and torch's in the twin, so an
    aggregate may round to the next bfloat16 value: within a bfloat16 ulp,
    and the step within that ulp of the aggregate plus its own (at [25, 81]
    adaptive clipping parts 1 of 2,025 elements; [256, 41] is bitwise)."""
    n, d = shape
    nbr, live, x_np, g_np = _instance(n, d)
    x, g, eta = _t(x_np), _t(g_np), _t([0.013])
    xj, gj, etaj = _j(x_np), _j(g_np), _j(0.013)
    tl, lj, nbr64 = torch.from_numpy(live), jnp.asarray(live), torch.from_numpy(nbr).long()
    for rule, ct in (("trimmed_mean", 0.0), ("median", 0.0), ("clipped_gossip", 0.0),
                     ("clipped_gossip", 0.7)):
        adaptive = rule == "clipped_gossip" and ct == 0.0
        tau = torch.tensor([ct], dtype=torch.float32)
        want = pk.make_fused_robust_aggregator(rule, 1, nbr, ct, interpret=True)(lj, xj)
        want_step = pk.make_fused_robust_dsgd_step(rule, 1, nbr, ct, interpret=True)(lj, xj, gj,
                                                                                     etaj)
        got = bk.fused_robust_plain(rule, 1, nbr64, tl, x, tau, adaptive=adaptive)
        got_step = bk.fused_robust_plain(rule, 1, nbr64, tl, x, tau, adaptive=adaptive, g=g,
                                         eta=eta)
        assert got.dtype == got_step.dtype == BF16
        if rule != "clipped_gossip" or n == 256:
            assert np.array_equal(_bits(got), _bits(want)), (rule, ct)
            assert np.array_equal(_bits(got_step), _bits(want_step)), (rule, ct)
            continue
        agg, agg_j = got.float().numpy(), np.asarray(want, dtype=np.float32)
        step, step_j = got_step.float().numpy(), np.asarray(want_step, dtype=np.float32)
        assert np.all(np.abs(agg - agg_j) <= _bf16_ulp(agg_j)), (rule, ct)
        assert np.all(np.abs(step - step_j) <= _bf16_ulp(agg_j) + _bf16_ulp(step_j)), (rule, ct)
        assert int((_bits(got) != _bits(want)).sum()) <= 1, (rule, ct)
    # The wrapper takes bfloat16 rows on the CPU (its twin).
    agg = bk.make_fused_robust_aggregator("trimmed_mean", 1, nbr, device="cpu")(tl, x)
    assert np.array_equal(_bits(agg), _bits(bk.fused_robust_plain(
        "trimmed_mean", 1, nbr64, tl, x, torch.zeros(1), adaptive=False)))


@pytest.mark.parametrize("shape", [(256, 41), (25, 81)])
def test_compression_twin_is_the_jax_exchange_s_bitwise(shape):
    """top_k, random_k and qsgd at 1, 4 and 16 bits: ``ef_compress_plain``
    bitwise the JAX compressor's memory + Q(v − memory), and for one of
    each operator the exchange's (v⁺, x̂⁺) bitwise
    ``ErrorFeedbackGossip.exchange`` jitted, over the ring stencil at γ =
    0.3; the uniforms are float32."""
    n, d = shape
    rng = np.random.default_rng(d)
    v_np, m_np = rng.standard_normal((n, d)) * 3.0, rng.standard_normal((n, d))
    v, m, vj, mj = _t(v_np), _t(m_np), _j(v_np), _j(m_np)
    ref_mix = ref_make_mixing_op(ref_build_topology("ring", n), "stencil", dtype=jnp.bfloat16)
    mix = make_mixing_op(build_topology("ring", n), "stencil", device="cpu", dtype=BF16)
    key = ref_compression.compression_key(203, 17, 1)
    draw = compression.Draw(compression.tag_key(203, x64=False), 17, 1)
    assert compression.uniforms(draw.key(), v).dtype == torch.float32
    for name, k in (("top_k", 3), ("top_k", 27), ("random_k", 9), ("qsgd", 1), ("qsgd", 4),
                    ("qsgd", 16)):
        ref_ef = ref_compression.ErrorFeedbackGossip(ref_compression.make_compressor(name, d, k),
                                                     0.3)
        ef = compression.make_error_feedback(name, d, k, 0.3)
        q = jax.jit(ref_ef.compressor.apply)(key, vj - mj)
        got = compression.ef_compress_plain(ef.compressor, draw, v, m)
        assert got.dtype == BF16 and np.array_equal(_bits(got), _bits(mj + q)), (name, k)
        if (name, k) not in EXCHANGED:
            continue
        want_v, want_m = jax.jit(lambda a, b: ref_ef.exchange(key, a, b, ref_mix.apply))(vj, mj)
        got_v, got_m = ef.exchange(draw, v, m, mix.apply)
        assert np.array_equal(_bits(got_m), _bits(want_m)), (name, k)
        assert np.array_equal(_bits(got_v), _bits(want_v)), (name, k)


@pytest.mark.parametrize("topology", ["ring", "erdos_renyi"])
def test_matrix_free_mix_is_the_jitted_jax_mix_s_bitwise(topology):
    """The gather fault form's bfloat16 mix over 300 rounds of 20% drops
    against the JAX package's jitted mix: bitwise, where summing the slots
    without XLA's fused multiply-adds parts some elements."""
    kw = dict(erdos_renyi_p=0.5, seed=0) if topology == "erdos_renyi" else {}
    n, T = 8, 300
    ref = ref_faults.make_faulty_mixing(ref_build_topology(topology, n, impl="neighbor", **kw),
                                        0.2, 7, horizon=T)
    ours = faults.make_faulty_mixing(build_topology(topology, n, impl="neighbor", **kw), 0.2, 7,
                                     horizon=T, device="cpu")
    jmix = jax.jit(ref.mix)
    rng = np.random.default_rng(0)
    uncontracted = 0
    for t in range(T):
        x_np = rng.standard_normal((n, 9)) * 4.0
        want = _bits(jmix(jnp.int32(t), _j(x_np)))
        rnd = ours.realize(torch.tensor(t))
        assert np.array_equal(_bits(rnd.mix(_t(x_np))), want), t
        x = _t(x_np).float()
        plain = rnd._r.w_self[:, None] * x + (rnd._r.w[..., None] * x[rnd._nbr]).sum(1)
        uncontracted += int((_bits(plain.to(BF16)) != want).sum())
    assert uncontracted > 0
