"""The run as a sequence of chunks with a device-held iteration counter.

On a card the chunks after the warm-up run as CUDA graph replays
(tests/test_torch_cuda.py holds those runs bitwise against the measured
chunk loop); on the CPU the same chunk function runs chunk after chunk.
Here: the sampler and the η / schedule reads at a tensor counter give the
bits of the Python-int counter; ``measure_timestamps=True`` is bitwise the
default run; runs at several eval cadences agree with ``jax_backend.run``
on one injected
schedule to 1e-12 in float64 (the JAX package unsharded, its Pallas
kernels in interpret mode); the chunk function's counter and eval slot;
and the launch counts that the kernels keep on the card, read through
``LaunchCounts`` from a stand-in library, and kept by every kernel of
``csrc/``.
"""

import functools
import re
import types

import numpy as np
import pytest
import torch

from conftest import batch_schedule
from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.algorithms.base import Algorithm
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.models import get_problem
from distributed_optimization_tpu_torch.ops import (
    _cuda_build,
    fc_kernels,
    ring_kernels,
    robust_kernels,
)
from distributed_optimization_tpu_torch.ops import prng
from distributed_optimization_tpu_torch.ops.sampling import (
    gather_batches,
    masked_scores,
    sample_batch_indices,
    sample_worker_batch_weights,
    threefry2x32,
)
from distributed_optimization_tpu_torch.utils.data import stack_shards

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=8, n_samples=400, n_features=10, n_informative_features=6,
             topology="ring", local_batch_size=16, dtype="float64", problem_type="logistic")
# Counters either side of 2³¹ and up to 2³² − 1, where t + key wraps.
COUNTERS = [0, 1, 17, 2**31 - 1, 2**31, 2**31 + 12_345, 2**32 - 2, 2**32 - 1]


def test_threefry_takes_a_tensor_counter_word():
    c1 = torch.arange(0, 2**32, 2**32 // 37, dtype=torch.int64)
    for c0 in COUNTERS:
        want = threefry2x32(0x1234, 0xABCDEF01, c0, c1)
        got = threefry2x32(0x1234, 0xABCDEF01, torch.tensor([c0]), c1)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_local", [7, 13])
@pytest.mark.parametrize("t", COUNTERS)
def test_tensor_counter_samples_the_int_counter_batches(t, n_local):
    """Scores, dense weights, gather indices and gathered rows at an odd L,
    with a full, a short, a tiny and an empty shard, in both dtypes."""
    n_valid = torch.tensor([n_local, n_local - 2, 2, 0])
    tt = torch.tensor([t])
    for dtype in (torch.float32, torch.float64):
        key = prng.key(203, x64=dtype == torch.float64)
        slot0, slot1 = prng.fold_in(key, 0), prng.fold_in(key, 1)
        assert torch.equal(masked_scores(slot1, tt, n_valid, n_local, dtype),
                           masked_scores(slot1, t, n_valid, n_local, dtype))
        for b in (1, 4, 16):
            assert torch.equal(
                sample_worker_batch_weights(slot0, tt, n_valid, n_local, b, dtype),
                sample_worker_batch_weights(slot0, t, n_valid, n_local, b, dtype))
            got = sample_batch_indices(slot0, tt, n_valid, n_local, b, dtype)
            want = sample_batch_indices(slot0, t, n_valid, n_local, b, dtype)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        X = torch.randn((4, n_local, 3), dtype=dtype)
        y = torch.randn((4, n_local), dtype=dtype)
        got = sample_batch_indices(slot0, tt, n_valid, n_local, 5, dtype)[0]
        want = sample_batch_indices(slot0, t, n_valid, n_local, 5, dtype)[0]
        assert all(torch.equal(g, w) for g, w in zip(gather_batches(X, y, got),
                                                     gather_batches(X, y, want)))


@pytest.fixture(scope="module")
def problems():
    """(dataset, f_opt) per problem type, from the JAX package."""
    out = {}
    for problem in ("logistic", "quadratic"):
        cfg = RefConfig(**dict(SMALL, problem_type=problem))
        ds = ref_generate(cfg)
        out[problem] = (ds, ref_oracle(ds, cfg.reg_param)[1])
    return out


def test_step_reads_eta_and_the_schedule_at_the_counter(problems):
    """``_Program.step`` at counter t hands the step rule η_t and the
    gradient on schedule[t]: what the slices eta[t:t+1] and schedule[t]
    hold, bit for bit."""
    ds, _ = problems["logistic"]
    T = 12
    cfg = ExperimentConfig(**SMALL, n_iterations=T)
    host = stack_shards(ds, np.float64)
    X, y, n_valid = (torch.from_numpy(a) for a in (host.X, host.y, host.n_valid))
    sched = torch.from_numpy(batch_schedule(ds, T, 16))
    problem = get_problem("logistic")
    seen = []
    probe = Algorithm(name="probe", init=lambda x0, c, **_: {"x": x0},
                      step=lambda state, ctx: seen.append(ctx) or state)
    eta = torch_backend.make_eta_schedule(cfg, T, torch.device("cpu"), torch.float64)
    program = torch_backend._Program(
        algo=probe, config=cfg,
        grad_for=torch_backend._make_grad_factory(problem, cfg.reg_param, cfg, X, y, n_valid,
                                                  sched, "gather"),
        mix_op=None, fused_mix_step=None, eta=eta, degrees=torch.zeros((8, 1)),
        full_objective=None, data=(X, y, n_valid))
    params = torch.randn((8, X.shape[2]), dtype=torch.float64)
    for t in range(T):
        program.step({"x": params}, torch.tensor([t]))
        ctx = seen[-1]
        assert torch.equal(ctx.eta, eta[t:t + 1])
        idx = sched[t]
        weights = torch.full(idx.shape, 1.0 / 16, dtype=torch.float64)
        want = problem.gradient_weighted(
            params, torch.take_along_dim(X, idx[:, :, None], dim=1),
            torch.take_along_dim(y, idx, dim=1), weights, cfg.reg_param)
        assert torch.equal(ctx.grad(params, 0), want)


@pytest.mark.parametrize("kw", [
    dict(mixing_impl="pallas"),
    dict(topology="fully_connected", algorithm="admm", eval_every=5),
    dict(algorithm="centralized", problem_type="quadratic", sampling_impl="dense"),
    dict(partition="shuffled", attack="sign_flip", n_byzantine=1, aggregation="trimmed_mean",
         robust_b=1, robust_impl="fused", mixing_impl="pallas", eval_every=2),
], ids=["dsgd-pallas", "admm-fc", "centralized-dense", "robust-fused"])
def test_measured_chunk_loop_is_bitwise_the_default_run(problems, kw):
    """The port's own sampler (no schedule) through both loops."""
    cfg = ExperimentConfig(**dict(SMALL, n_iterations=40, **kw))
    ds, f_opt = problems[cfg.problem_type]
    default = torch_backend.run(cfg, ds, f_opt, device="cpu")
    measured = torch_backend.run(cfg, ds, f_opt, device="cpu", measure_timestamps=True)
    np.testing.assert_array_equal(measured.history.objective, default.history.objective)
    if default.history.consensus_error is not None:
        np.testing.assert_array_equal(measured.history.consensus_error,
                                      default.history.consensus_error)
    np.testing.assert_array_equal(measured.final_models, default.final_models)
    times = measured.history.time
    assert measured.history.time_measured and not default.history.time_measured
    assert times.shape == default.history.time.shape == (40 // cfg.eval_every,)
    assert np.all(np.diff(times) > 0)
    assert np.isfinite(measured.history.iters_per_second)


@pytest.mark.parametrize("algorithm", ["dsgd", "admm"])
@pytest.mark.parametrize("eval_every, T", [(1, 150), (7, 161), (50, 300)])
def test_chunked_run_matches_jax_backend_at_every_cadence(problems, eval_every, T, algorithm):
    """T is not a multiple of 64, and at eval_every 7 the chunks are not a
    power of two: nothing rests on a round number of chunks."""
    fields = dict(SMALL, n_iterations=T, eval_every=eval_every, algorithm=algorithm,
                  mixing_impl="pallas")
    ds, f_opt = problems["logistic"]
    sched = batch_schedule(ds, T, 16)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, batch_schedule=sched)
    ours = torch_backend.run(ExperimentConfig(**fields), ds, f_opt, device="cpu",
                             batch_schedule=sched)
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)


class CountingProgram:
    """Stands in for a bound program: a step adds t to the state."""

    def step(self, state, t):
        return {"x": state["x"] + t.to(state["x"].dtype)}


@pytest.mark.parametrize("with_metrics", [True, False])
@pytest.mark.parametrize("iterations", [1, 7, 50])
def test_chunk_advances_the_counter_and_the_eval_slot_in_place(iterations, with_metrics):
    """A chunk runs ``iterations`` steps at t, t + 1, ..., leaves t advanced
    by as many, and writes eval slot k and advances it once (no metrics, no
    slot); the same function called again continues where it stopped, as a
    replay of the captured chunk does."""
    t = torch.zeros(1, dtype=torch.int64)
    k = torch.zeros(1, dtype=torch.int64)
    written = []
    def metrics(state, slot):
        written.append((int(slot), float(state["x"])))

    chunk = torch_backend._make_chunk(CountingProgram(), iterations, t, k,
                                      metrics if with_metrics else None)
    state = {"x": torch.zeros(())}
    for c in range(3):
        state = chunk(state)
        end = (c + 1) * iterations
        assert int(t) == end and float(state["x"]) == end * (end - 1) / 2
    assert int(k) == (3 if with_metrics else 0)
    if with_metrics:
        assert [slot for slot, _ in written] == [0, 1, 2]
        assert written[-1][1] == float(state["x"])


KERNEL_MODULES = {"ring": ring_kernels, "fc": fc_kernels, "robust": robust_kernels}


def stand_in_library(slots, err=0):
    """A cached loader of a stand-in for a built kernel library, whose
    device slots are the list ``slots``."""

    def read(out, n):
        for i in range(n):
            out[i] = slots[i]
        return err

    def reset():
        slots[:] = [0] * len(slots)
        return err

    lib = types.SimpleNamespace(launch_counts_read=read, launch_counts_reset=reset)
    return functools.lru_cache(maxsize=1)(lambda: lib)


@pytest.mark.parametrize("module", sorted(KERNEL_MODULES))
def test_launch_counts_read_each_kernels_slot(module):
    """Slot i is KERNELS[i]; nothing is read before the library loads."""
    names = KERNEL_MODULES[module].KERNELS
    slots = [30_000 + 7 * i for i in range(len(names))]
    loader = stand_in_library(slots)
    counts = _cuda_build.LaunchCounts(names, loader)
    assert counts == {name: 0 for name in names} and loader.cache_info().currsize == 0
    loader()
    assert counts == dict(zip(names, slots))
    assert list(counts) == list(names) and len(counts) == len(names)
    assert counts[names[-1]] == slots[-1]
    assert repr(counts) == repr(dict(zip(names, slots)))
    with pytest.raises(KeyError):
        counts["no_such_kernel"]
    counts.reset()
    assert counts == {name: 0 for name in names} and slots == [0] * len(names)


@pytest.mark.parametrize("call", ["read", "reset"])
def test_launch_counts_raise_on_a_cuda_error(call):
    loader = stand_in_library([1, 2], err=700)
    loader()
    counts = _cuda_build.LaunchCounts(("a", "b"), loader)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        counts["a"] if call == "read" else counts.reset()


@pytest.mark.parametrize("module", sorted(KERNEL_MODULES))
def test_kernel_modules_count_on_their_own_library(module):
    """Each wrapper module's LAUNCHES reads its own library's slots; on the
    CPU, where nothing launches, it reads 0 and builds nothing."""
    mod = KERNEL_MODULES[module]
    assert isinstance(mod.LAUNCHES, _cuda_build.LaunchCounts)
    assert tuple(mod.LAUNCHES) == mod.KERNELS
    if not torch.cuda.is_available():
        mod.reset_launch_counts()
        assert mod.LAUNCHES == {name: 0 for name in mod.KERNELS}
        loader = mod.library if module == "fc" else mod._library
        assert loader.cache_info().currsize == 0


@pytest.mark.parametrize("source", ["ring_kernels.cu", "fc_kernels.cu", "robust_kernels.cu"])
def test_every_kernel_counts_its_launches_first(source):
    """Each __global__ kernel of a source (the empty launch-floor kernel
    aside) adds to its launch-count slot as its first statement, with a slot
    below the number of the module's kernels."""
    text = (_cuda_build.CSRC / source).read_text()
    assert '#include "launch_counts.cuh"' in text
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(([^{]*)\{"
                         r"\s*([^;]*;)", text)
    names = [k[0] for k in kernels if k[0] != "empty_kernel"]
    assert names
    for name, _, first in kernels:
        if name != "empty_kernel":
            assert first.startswith("launch_counts::add("), (source, name, first)
    n_kernels = len(KERNEL_MODULES[source.split("_")[0]].KERNELS)
    slots = re.findall(r"launch_counts::add\(([^;]*)\);", text)
    for expr in slots:
        assert all(int(v) < n_kernels for v in re.findall(r"\b\d+\b", expr)), expr
