"""Runs on the irregular graphs against ``jax_backend.run``, and the
constants ``chip_smoke.py`` holds the card to, recomputed from the JAX
package.

D-SGD and gradient tracking on Erdős–Rényi, chain and star under each
mixing form, and D-SGD under sign-flip on Erdős–Rényi at N=64, p=0.1 (rows
of 3 to 13 live slots: most of a row's slots are padding from the graph
itself) with each screen in its fused (the kernels' plain twin here) and
gather form, run in float64 on the JAX package's own batches and agree
with the JAX package (its fused screens in interpret mode) to 1e-12 (rtol
and atol).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.metrics import iterations_to_threshold
from distributed_optimization_tpu.ops.pallas_kernels import (
    fused_robust_supported as ref_fused_robust_supported,
)
from distributed_optimization_tpu.parallel import build_topology as ref_topology
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference
from distributed_optimization_tpu_torch.parallel.topology import build_topology

TOL = dict(rtol=1e-12, atol=1e-12)
SMALL = dict(n_workers=12, n_samples=480, n_features=8, n_informative_features=5,
             n_iterations=60, local_batch_size=16, dtype="float64", problem_type="logistic",
             erdos_renyi_p=0.3)
ER64 = dict(SMALL, n_workers=64, n_samples=1280, n_iterations=40, topology="erdos_renyi",
            erdos_renyi_p=0.1, eval_every=10, attack="sign_flip", n_byzantine=6,
            attack_scale=5.0)

GOSSIP = {
    "dsgd-er-dense": dict(topology="erdos_renyi", mixing_impl="dense"),
    "dsgd-er-gather": dict(topology="erdos_renyi", mixing_impl="gather", eval_every=10),
    "dsgd-er-sparse": dict(topology="erdos_renyi", mixing_impl="sparse"),
    "dsgd-er-topology-seed": dict(topology="erdos_renyi", topology_seed=4, sampling_impl="dense"),
    "dsgd-chain-sparse": dict(topology="chain", mixing_impl="sparse"),
    "dsgd-star-auto": dict(topology="star"),
    "gt-er-gather": dict(topology="erdos_renyi", algorithm="gradient_tracking",
                         mixing_impl="gather"),
    "gt-chain-dense": dict(topology="chain", algorithm="gradient_tracking"),
    "extra-star-sparse": dict(topology="star", algorithm="extra", mixing_impl="sparse"),
    "choco-er-topk": dict(topology="erdos_renyi", algorithm="choco", compression="top_k",
                          compression_k=3),
}


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def datasets():
    cache = {}

    def get(fields):
        key = (fields["n_samples"], fields["n_workers"], fields.get("partition", "sorted"))
        if key not in cache:
            cfg = RefConfig(**fields)
            ds = ref_generate(cfg)
            ours = dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices, ds.problem_type)
            cache[key] = (ds, ours, ref_oracle(ds, cfg.reg_param)[1])
        return cache[key]

    return get


def _assert_same_run(ref, ours):
    np.testing.assert_array_equal(ours.history.eval_iterations, ref.history.eval_iterations)
    np.testing.assert_allclose(ours.history.objective, ref.history.objective, **TOL)
    np.testing.assert_allclose(ours.history.consensus_error, ref.history.consensus_error, **TOL)
    np.testing.assert_allclose(ours.final_models, ref.final_models, **TOL)
    np.testing.assert_allclose(ours.final_avg_model, ref.final_avg_model, **TOL)
    assert ours.total_floats_transmitted == ref.total_floats_transmitted
    assert abs(ours.history.spectral_gap - ref.history.spectral_gap) <= 1e-12


@pytest.mark.parametrize("name", sorted(GOSSIP))
def test_irregular_graph_runs_match_jax_backend(datasets, name):
    fields = {**SMALL, **GOSSIP[name]}
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
    ours = torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
    _assert_same_run(ref, ours)


@pytest.mark.parametrize("rule", ("trimmed_mean", "median", "clipped_gossip"))
def test_er_screens_match_jax_backend_in_both_forms(datasets, rule):
    """The JAX run screens in its fused Pallas kernel (interpret mode) over
    the ER table; the port's fused form (the kernels' plain twin on the
    CPU) and its gather form both agree with it."""
    fields = dict(ER64, aggregation=rule, robust_b=1)
    topo = build_topology("erdos_renyi", 64, erdos_renyi_p=0.1, seed=203)
    assert (int(topo.degrees.min()), int(topo.degrees.max())) == (3, 13)
    ds, ours_ds, f_opt = datasets(fields)
    ref = jax_backend.run(RefConfig(**fields, robust_impl="fused"), ds, f_opt, use_mesh=False)
    for impl in ("fused", "gather", "auto"):
        cfg = ExperimentConfig(**fields, robust_impl=impl)
        assert torch_backend.resolve_robust_impl(cfg, topo) == ("fused" if impl == "auto" else impl)
        _assert_same_run(ref, torch_backend.run(cfg, ours_ds, f_opt, device="cpu"))


def test_star_and_chain_keep_the_budget_refusal(datasets):
    for topology in ("star", "chain"):
        fields = {**SMALL, "topology": topology, "aggregation": "trimmed_mean", "robust_b": 1}
        ds, ours_ds, f_opt = datasets(fields)
        with pytest.raises(ValueError) as want:
            jax_backend.run(RefConfig(**fields), ds, f_opt, use_mesh=False)
        with pytest.raises(ValueError) as got:
            torch_backend.run(ExperimentConfig(**fields), ours_ds, f_opt, device="cpu")
        assert str(got.value) == str(want.value)
        assert "min degree (1)" in str(got.value)


def test_chip_smoke_graphs_are_the_jax_package_s():
    smoke = _smoke()
    topo = ref_topology("erdos_renyi", 256, erdos_renyi_p=smoke.ER_P, seed=203)
    assert (int(topo.degrees.max()), int(topo.degrees.min())) == smoke.ER_GRAPH[:2]
    assert abs(topo.spectral_gap - smoke.ER_GRAPH[2]) <= 1e-12
    topo = ref_topology("erdos_renyi", 64, erdos_renyi_p=0.1, seed=203)
    assert (int(topo.degrees.max()), int(topo.degrees.min())) == smoke.ER_ROBUST_GRAPH
    # robust_scale.json's crossover cell: k_max 40, beyond the count-rule
    # kernel's sort width, so the JAX rule and the port's both take gather.
    cross = smoke.ROBUST_CROSSOVER
    topo = ref_topology("erdos_renyi", 64, erdos_renyi_p=cross["erdos_renyi_p"], seed=203)
    k_max = int(topo.degrees.max())
    assert k_max == 40 and not ref_fused_robust_supported("trimmed_mean", k_max, 0.0)
    assert RefConfig(**cross).resolved_robust_impl(k_max, fused_eligible=False) == "gather"
    ours = ExperimentConfig(**cross)
    assert torch_backend.resolve_robust_impl(
        ours, build_topology("erdos_renyi", 64, erdos_renyi_p=cross["erdos_renyi_p"],
                             seed=203)) == "gather"


def test_chip_smoke_study_graph_objectives_are_the_jax_package_s():
    smoke = _smoke()
    base = RefConfig(problem_type="logistic", dtype="float64", eval_every=10,
                     n_iterations=smoke.STUDY_GRAPH_ITERATIONS)
    ds = ref_generate(base)
    f_opt = ref_oracle(ds, base.reg_param)[1]
    for name, want in smoke.STUDY_GRAPHS.items():
        h = jax_backend.run(base.replace(topology=name), ds, f_opt, use_mesh=False).history
        assert abs(float(h.objective[-1]) + f_opt - want) <= 1e-15, name


@pytest.mark.parametrize("name", ("dsgd_er256", "push_sum_der256"))
def test_chip_smoke_irregular_counts_are_the_jax_package_s(name):
    """``chip_smoke.IRREGULAR_RUNS``: the JAX package's iterations to ε on
    the main path's data at N=256 (float32, eval every 10), the D-SGD run
    to its crossing (the step sizes do not depend on T); and
    ``PUSH_SUM_MASS``, its Σ w after T."""
    smoke = _smoke()
    fields, T, want = smoke.IRREGULAR_RUNS[name]
    assert want < T
    base = RefConfig(problem_type="logistic", n_workers=256, dtype="float32",
                     eval_every=smoke.IRREGULAR_EVAL_EVERY)
    ds = ref_generate(base)
    f_opt = ref_oracle(ds, base.reg_param)[1]
    push_sum = fields["algorithm"] == "push_sum"
    # Push-sum runs the whole T for its final mass (chip_smoke.PUSH_SUM_MASS).
    res = jax_backend.run(base.replace(n_iterations=T if push_sum else want, **fields), ds,
                          f_opt, use_mesh=False, return_state=push_sum)
    h = res.history
    assert iterations_to_threshold(h.objective, 0.08, h.eval_iterations) == want
    if push_sum:
        mass = float(res.final_state["w"].astype(np.float64).sum())
        assert abs(mass - smoke.PUSH_SUM_MASS) <= 1e-9 * base.n_workers
