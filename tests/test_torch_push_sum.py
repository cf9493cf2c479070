"""Push-sum held to ``jax_backend.run`` on the JAX package's own batches.

Both packages run the same config in float64 (the JAX package unsharded,
under ``enable_x64``, its Pallas ring kernel in interpret mode) and agree to
1e-12 (rtol and atol): gap and consensus histories, final models, every
leaf of the final state (``x``, ``num`` and the [N, 1] mass ``w``) and the
floats transmitted, which count d + 1 an edge. On a doubly stochastic W the
mass stays 1; the refusals carry the JAX package's text.
"""

import json

import numpy as np
import pytest
import torch

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.__main__ import main as cli_main
from distributed_optimization_tpu_torch.algorithms import get_algorithm
from distributed_optimization_tpu_torch.algorithms.base import StepContext
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference
from distributed_optimization_tpu_torch.parallel.topology import build_topology

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=12, n_samples=480, n_features=10, n_informative_features=6,
             n_iterations=60, local_batch_size=16, dtype="float64", problem_type="logistic",
             algorithm="push_sum", erdos_renyi_p=0.3)

CASES = {
    "directed-er-dense": dict(topology="directed_erdos_renyi"),
    "directed-er-sparse": dict(topology="directed_erdos_renyi", mixing_impl="sparse",
                               eval_every=10),
    "directed-ring-stencil": dict(topology="directed_ring"),
    "directed-ring-dense": dict(topology="directed_ring", mixing_impl="dense"),
    "directed-ring-sparse": dict(topology="directed_ring", mixing_impl="sparse"),
    "ring-pallas": dict(topology="ring", mixing_impl="pallas", sampling_impl="dense"),
    "er-gather-quadratic": dict(topology="erdos_renyi", mixing_impl="gather",
                                problem_type="quadratic"),
}


@pytest.fixture(scope="module")
def datasets():
    cache = {}

    def get(fields):
        key = (fields["problem_type"], fields["n_workers"])
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


def _both(datasets, **kw):
    fields = {**SMALL, **kw}
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False, return_state=True)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                             return_state=True)
    return ref, ours


@pytest.mark.parametrize("name", sorted(CASES))
def test_push_sum_matches_jax_backend_on_its_own_batches(datasets, name):
    ref, ours = _both(datasets, **CASES[name])
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    assert sorted(ours.final_state) == sorted(ref.final_state) == ["num", "w", "x"]
    for key, value in ref.final_state.items():
        np.testing.assert_allclose(ours.final_state[key], value, **TOL)
    assert ours.final_state["w"].shape == (SMALL["n_workers"], 1)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    assert abs(ours.history.spectral_gap - ref.history.spectral_gap) <= 1e-12


def test_floats_transmitted_count_the_mass_with_each_edge(datasets):
    _, ours = _both(datasets, topology="directed_erdos_renyi")
    topo = build_topology("directed_erdos_renyi", SMALL["n_workers"], erdos_renyi_p=0.3,
                          seed=ExperimentConfig(**SMALL).resolved_topology_seed())
    d = SMALL["n_features"] + 1
    assert ours.total_floats_transmitted == topo.adjacency.sum() * (d + 1) * SMALL["n_iterations"]
    w = ours.final_state["w"]
    assert np.all(w > 0) and np.abs(w - 1.0).max() > 1e-3  # the debiasing is at work
    assert abs(w.sum() - SMALL["n_workers"]) <= 1e-9
    np.testing.assert_allclose(ours.final_state["x"], ours.final_state["num"] / w, rtol=1e-12)


@pytest.mark.parametrize("topology,mixing_impl", [("ring", "stencil"), ("ring", "pallas"),
                                                   ("fully_connected", "stencil")])
def test_mass_stays_exactly_one_on_a_uniform_doubly_stochastic_w(datasets, topology,
                                                                mixing_impl):
    """The ring's weights are 1/3 (3 · fl(1/3) = 1 in both dtypes) and the
    fully connected graph's mean of ones is 1: w never moves, and z is num."""
    for dtype in ("float64", "float32"):
        fields = {**SMALL, "topology": topology, "mixing_impl": mixing_impl, "dtype": dtype}
        ds, ours_ds, f_opt = datasets(fields)
        res = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu",
                                return_state=True)
        assert np.all(res.final_state["w"] == 1.0)
        np.testing.assert_array_equal(res.final_state["x"], res.final_state["num"])


def test_mass_stays_one_on_mh_weights_within_rounding(datasets):
    _, ours = _both(datasets, topology="erdos_renyi")
    np.testing.assert_allclose(ours.final_state["w"], 1.0, atol=1e-12)


def test_push_sum_never_takes_the_fused_ring_step():
    """The fused kernel computes W x − η g; push-sum mixes num − η g."""
    def refuse(*args):
        raise AssertionError("push-sum read ctx.fused_mix_step")

    cfg = ExperimentConfig(**{**SMALL, "topology": "ring"})
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((12, 4)))
    state = get_algorithm("push_sum").init(x, cfg)
    ctx = StepContext(grad=lambda v, slot: 0.1 * v, mix=lambda v: 0.5 * v,
                      neighbor_sum=lambda v: v, eta=torch.tensor([0.1], dtype=x.dtype),
                      config=cfg, fused_mix_step=refuse)
    out = get_algorithm("push_sum").step(state, ctx)
    torch.testing.assert_close(out["num"], 0.5 * (x - 0.1 * (0.1 * x)), rtol=0, atol=0)
    torch.testing.assert_close(out["w"], torch.full((12, 1), 0.5, dtype=x.dtype))


def test_byzantine_injection_is_refused_with_the_jax_text(datasets):
    fields = {**SMALL, "topology": "ring", "attack": "sign_flip", "n_byzantine": 2}
    ds, ours_ds, f_opt = datasets(fields)
    with pytest.raises(ValueError) as want:
        jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    with pytest.raises(ValueError) as got:
        torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    assert str(got.value) == str(want.value)
    assert "push-sum's debiasing" in str(got.value) and "CHOCO" in str(got.value)


def test_state_from_reference_carries_the_mass_column(datasets):
    ref, ours = _both(datasets, topology="directed_ring", n_iterations=10)
    state = state_from_reference(ref.final_state, "cpu", torch.float64)
    assert state["w"].shape == (SMALL["n_workers"], 1)
    for key, value in ours.final_state.items():
        np.testing.assert_allclose(state[key].numpy(), value, **TOL)


def test_cli_runs_push_sum_on_a_directed_graph(capsys):
    argv = ["--device", "cpu", "--algorithm", "push_sum", "--topology",
            "directed_erdos_renyi", "--erdos-renyi-p", "0.3", "--topology-seed", "5",
            "--mixing-impl", "sparse", "--problem-type", "logistic", "--n-workers", "8",
            "--n-samples", "320", "--n-features", "6", "--n-informative-features", "4",
            "--n-iterations", "40", "--json"]
    assert cli_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["algorithm"] == "push_sum" and summary["topology"] == "directed_erdos_renyi"
    assert np.isfinite(summary["final_gap"])
    topo = build_topology("directed_erdos_renyi", 8, erdos_renyi_p=0.3, seed=5)
    assert summary["total_floats_transmitted"] == topo.adjacency.sum() * 8 * 40
