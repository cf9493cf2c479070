"""The replica axis on the CPU: the port's ``run_batch`` against the JAX
package's ``jax_backend.run_batch`` and against the port's own sequential
``run``, in float64.

Replica r of ``run_batch(config, seeds=S, sweep=V)`` is the sequential run
of ``config.replace(seed=S[r], topology_seed=<base>, **{f: V[f][r]})``:
gap and consensus histories and final models agree to 1e-12 (rtol and
atol) with both, floats transmitted to 1e-12 relative, on
``tests/test_batch.py``'s six configurations (benign D-SGD on the ring,
gradient tracking on the quadratic, bursty edges + churn + sign-flip +
gather trimmed mean on Erdős–Rényi, one-peer gossip with drops, an η₀
sweep, a clip_tau + edge_drop_prob sweep). Also: a batch continued from the
JAX package's ``final_states`` (through ``interop``) and from the port's
own, default seeds from ``replicas``, ``summarize_replicates`` against the
JAX package's, and every rejection with the JAX package's message.
"""

import numpy as np
import pytest
import torch

from distributed_optimization_tpu import metrics as ref_metrics
from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle
from distributed_optimization_tpu_torch import metrics
from distributed_optimization_tpu_torch.backends import torch_backend
from distributed_optimization_tpu_torch.config import ExperimentConfig
from distributed_optimization_tpu_torch.interop import dataset_from_reference, state_from_reference

TOL = dict(rtol=1e-12, atol=1e-12)

BASE = dict(n_workers=8, n_samples=400, n_features=10, n_informative_features=6,
            problem_type="logistic", n_iterations=40, topology="ring", algorithm="dsgd",
            local_batch_size=8, eval_every=10, dtype="float64")
_ER = dict(n_workers=12, n_samples=480, topology="erdos_renyi", erdos_renyi_p=0.7,
           partition="shuffled")

# tests/test_batch.py's six: (fields, seeds, sweep).
CASES = {
    "benign-ring": ({}, [203, 404, 777], None),
    "gt-quadratic": (dict(algorithm="gradient_tracking", problem_type="quadratic"),
                     [203, 509], None),
    "bursty-churn-signflip-gather": (dict(
        _ER, edge_drop_prob=0.2, burst_len=3.0, mttf=20.0, mttr=4.0, attack="sign_flip",
        n_byzantine=1, aggregation="trimmed_mean", robust_b=1, robust_impl="gather"),
        [203, 500], None),
    "one-peer-drops": (dict(gossip_schedule="one_peer", edge_drop_prob=0.1), [203, 811], None),
    "eta0-sweep": (dict(algorithm="gradient_tracking", problem_type="quadratic",
                        n_iterations=30), [203] * 3,
                   {"learning_rate_eta0": [0.02, 0.05, 0.1]}),
    "clip-tau-edge-drop-sweep": (dict(
        _ER, edge_drop_prob=0.15, attack="alie", n_byzantine=1, attack_scale=1.5,
        aggregation="clipped_gossip", robust_b=1, clip_tau=0.5), [203, 404],
        {"clip_tau": [0.3, 0.6], "edge_drop_prob": [0.1, 0.25]}),
}


def _configs(**fields):
    kw = {**BASE, **fields}
    return RefConfig(backend="jax", **kw), ExperimentConfig(**kw)


_DATA = {}


def _data(ref_cfg):
    """The JAX package's dataset and f*, and the same dataset for the port."""
    key = (ref_cfg.n_workers, ref_cfg.n_samples, ref_cfg.problem_type, ref_cfg.partition)
    if key not in _DATA:
        ds = ref_generate(ref_cfg)
        f_opt = ref_oracle(ds, ref_cfg.reg_param)[1]
        _DATA[key] = (ds, dataset_from_reference(ds.X_full, ds.y_full, ds.shard_indices,
                                                 ds.problem_type), f_opt)
    return _DATA[key]


def _assert_replica(ours, r, want_objective, want_consensus, want_models, want_floats):
    np.testing.assert_allclose(ours.objective[r], want_objective, **TOL)
    if want_consensus is not None:
        np.testing.assert_allclose(ours.consensus_error[r], want_consensus, **TOL)
    np.testing.assert_allclose(ours.results[r].final_models, want_models, **TOL)
    assert ours.results[r].history.total_floats_transmitted == pytest.approx(want_floats,
                                                                             rel=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_the_jax_batch_and_the_sequential_runs(case):
    fields, seeds, sweep = CASES[case]
    ref_cfg, cfg = _configs(**fields)
    ds, ours_ds, f_opt = _data(ref_cfg)
    ref = jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=seeds, sweep=sweep)
    ours = torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=seeds, sweep=sweep, device="cpu")
    assert ours.objective.shape == ref.objective.shape == (len(seeds), cfg.n_iterations // 10)
    assert ours.seeds == seeds
    for r, seed in enumerate(seeds):
        _assert_replica(ours, r, ref.objective[r],
                        None if ref.consensus_error is None else ref.consensus_error[r],
                        ref.results[r].final_models,
                        ref.results[r].history.total_floats_transmitted)
        np.testing.assert_allclose(ours.results[r].final_avg_model,
                                   ref.results[r].final_avg_model, **TOL)
        overrides = {f: v[r] for f, v in (sweep or {}).items()}
        seq = torch_backend.run(cfg.replace(seed=seed, topology_seed=cfg.resolved_topology_seed(),
                                            **overrides), ours_ds, f_opt, device="cpu")
        _assert_replica(ours, r, seq.history.objective, seq.history.consensus_error,
                        seq.final_models, seq.history.total_floats_transmitted)
        np.testing.assert_array_equal(ours.results[r].history.eval_iterations,
                                      seq.history.eval_iterations)
    assert ours.aggregate_iters_per_second == pytest.approx(
        ours.results[0].history.iters_per_second * len(seeds))


def test_continuation_from_the_jax_batch_and_from_its_own():
    """A batch split at t0 = 10 and resumed from the first part's final
    states is the one-shot batch: from the JAX package's states (through
    interop) to 1e-12, from the port's own bit for bit."""
    fields = dict(algorithm="gradient_tracking", problem_type="quadratic", n_iterations=30,
                  edge_drop_prob=0.2, burst_len=2.0)
    ref_cfg, cfg = _configs(**fields)
    ds, ours_ds, f_opt = _data(ref_cfg)
    seeds = [203, 207]
    ref_one = jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=seeds)
    ref_h1 = jax_backend.run_batch(ref_cfg.replace(n_iterations=10), ds, f_opt, seeds=seeds)
    state0 = state_from_reference(ref_h1.final_states, "cpu", torch.float64,
                                  replicas=len(seeds))
    with pytest.raises(ValueError, match=r"\[3, N, d_model\]"):
        state_from_reference(ref_h1.final_states, "cpu", torch.float64, replicas=3)
    tail = cfg.replace(n_iterations=20)
    from_ref = torch_backend.run_batch(tail, ours_ds, f_opt, seeds=seeds, device="cpu", t0=10,
                                       state0={k: v.numpy() for k, v in state0.items()})
    np.testing.assert_array_equal(from_ref.results[0].history.eval_iterations, [20, 30])
    np.testing.assert_allclose(from_ref.objective, ref_one.objective[:, 1:], **TOL)
    for k in ref_one.final_states:
        np.testing.assert_allclose(from_ref.final_states[k], ref_one.final_states[k], **TOL)
    one = torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=seeds, device="cpu")
    h1 = torch_backend.run_batch(cfg.replace(n_iterations=10), ours_ds, f_opt, seeds=seeds,
                                 device="cpu")
    h2 = torch_backend.run_batch(tail, ours_ds, f_opt, seeds=seeds, device="cpu",
                                 state0=h1.final_states, t0=10)
    for k in one.final_states:
        np.testing.assert_array_equal(one.final_states[k], h2.final_states[k])
    np.testing.assert_array_equal(np.concatenate([h1.objective, h2.objective], axis=1),
                                  one.objective)
    for r in range(len(seeds)):
        assert (h1.results[r].history.total_floats_transmitted
                + h2.results[r].history.total_floats_transmitted
                == one.results[r].history.total_floats_transmitted)


def test_default_seeds_follow_replicas():
    ref_cfg, cfg = _configs(replicas=3, n_iterations=20)
    ds, ours_ds, f_opt = _data(ref_cfg)
    ours = torch_backend.run_batch(cfg, ours_ds, f_opt, device="cpu")
    ref = jax_backend.run_batch(ref_cfg, ds, f_opt)
    assert ours.seeds == ref.seeds == [203, 204, 205]
    np.testing.assert_allclose(ours.objective, ref.objective, **TOL)


def test_summarize_replicates_is_the_jax_package_s():
    rng = np.random.default_rng(5)
    objective = rng.random((4, 6)) * 0.2
    objective[2] += 1.0  # never reaches ε
    consensus = rng.random((4, 6))
    evals = np.arange(10, 70, 10)
    for cons in (consensus, None):
        ours = metrics.summarize_replicates(objective, cons, evals, 0.08, [1, 2, 3, 4], 55.0)
        ref = ref_metrics.summarize_replicates(objective, cons, evals, 0.08, [1, 2, 3, 4], 55.0)
        assert ours.__dict__ == ref.__dict__


def _messages(ref_call, our_call):
    with pytest.raises(ValueError) as ref_err:
        ref_call()
    with pytest.raises(ValueError) as our_err:
        our_call()
    assert str(our_err.value) == str(ref_err.value)
    return str(our_err.value)


REJECTED_SWEEPS = {
    "structural": ({}, [1, 2], {"n_workers": [8, 16]}, "structural"),
    "length": ({}, [1, 2], {"learning_rate_eta0": [0.1]}, "length"),
    "edge-drop-values": ({}, [1, 2], {"edge_drop_prob": [0.0, 0.5]}, "edge_drop_prob"),
    "clip-without-clipping": ({}, [1, 2], {"clip_tau": [0.1, 0.2]}, "clipped_gossip"),
    "clip-values": (dict(attack="sign_flip", n_byzantine=1, aggregation="clipped_gossip",
                         robust_b=1), [1, 2], {"clip_tau": [0.0, 0.2]}, "> 0"),
    "centralized-with-faults": (dict(algorithm="centralized"), [1, 2],
                                {"edge_drop_prob": [0.1, 0.2]}, "peer edges"),
    "no-seeds": ({}, [], None, "at least one"),
    "choco": (dict(algorithm="choco", lr_schedule="constant"), [1, 2], None, "choco"),
    "pallas": (dict(mixing_impl="pallas"), [1, 2], None, "pallas"),
    "fused": (dict(attack="sign_flip", n_byzantine=1, aggregation="trimmed_mean", robust_b=1,
                   robust_impl="fused"), [1, 2], None, "fused"),
    "compression": (dict(compression="top_k", compression_k=3), [1, 2], None, "compressed"),
}


@pytest.mark.parametrize("case", sorted(REJECTED_SWEEPS))
def test_rejections_carry_the_jax_package_s_messages(case):
    fields, seeds, sweep, words = REJECTED_SWEEPS[case]
    ref_cfg, cfg = _configs(**fields)
    ds, ours_ds, f_opt = _data(ref_cfg)
    msg = _messages(lambda: jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=seeds, sweep=sweep),
                    lambda: torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=seeds,
                                                    sweep=sweep, device="cpu"))
    assert words in msg


def test_rejects_a_bad_state0_with_the_jax_package_s_messages():
    ref_cfg, cfg = _configs(n_iterations=10)
    ds, ours_ds, f_opt = _data(ref_cfg)
    ref_h1 = jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=[1, 2])
    ours_h1 = torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=[1, 2], device="cpu")
    msg = _messages(
        lambda: jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=[1, 2, 3],
                                      state0=ref_h1.final_states, t0=10),
        lambda: torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=[1, 2, 3],
                                        state0=ours_h1.final_states, t0=10, device="cpu"))
    assert "replicas" in msg
    gt_ref, gt = _configs(n_iterations=10, algorithm="gradient_tracking")
    _messages(lambda: jax_backend.run_batch(gt_ref, ds, f_opt, seeds=[1, 2],
                                            state0=ref_h1.final_states, t0=10),
              lambda: torch_backend.run_batch(gt, ours_ds, f_opt, seeds=[1, 2],
                                              state0=ours_h1.final_states, t0=10, device="cpu"))
    _messages(lambda: jax_backend.run_batch(ref_cfg, ds, f_opt, seeds=[1, 2], t0=-1),
              lambda: torch_backend.run_batch(cfg, ours_ds, f_opt, seeds=[1, 2], t0=-1,
                                              device="cpu"))


@pytest.mark.parametrize("fields", [
    dict(replicas=0), dict(replicas=2, algorithm="choco", lr_schedule="constant"),
    dict(replicas=2, mixing_impl="pallas"), dict(replicas=2, compression="top_k",
                                                 compression_k=3),
    dict(replicas=2, attack="sign_flip", n_byzantine=1, aggregation="trimmed_mean",
         robust_b=1, robust_impl="fused"),
], ids=["zero", "choco", "pallas", "compression", "fused"])
def test_config_rejects_replicas_with_the_jax_package_s_messages(fields):
    _messages(lambda: RefConfig(backend="jax", **{**BASE, **fields}),
              lambda: ExperimentConfig(**{**BASE, **fields}))


@pytest.mark.parametrize("name", ["executable_cache", "progress_cb", "monitors"])
def test_unported_batch_arguments_raise(name):
    _, cfg = _configs()
    with pytest.raises(ValueError, match="does not have it yet"):
        torch_backend.run_batch(cfg, None, 0.0, seeds=[1, 2], device="cpu",
                                **{name: object()})


def test_run_batch_defaults_to_the_card():
    import inspect

    assert inspect.signature(torch_backend.run_batch).parameters["device"].default == "cuda"
