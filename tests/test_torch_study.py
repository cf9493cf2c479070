"""``chip_smoke.py``'s study gate: the JAX package's iterations to ε at the
eight rows of ``examples/reproduce_report.py``.

The study phase holds each row of the port's run on the card within 1% of
the JAX package's count at the same config (``chip_smoke.STUDY_ROWS``); both
packages draw the same batches. This recomputes those counts with the JAX
package on the CPU (float32, its config defaults: N=25, T=10,000, b=16,
η₀=0.05/√(t+1), sorted partition, ε=0.08, use_mesh=False), and the floats
transmitted the phase requires exactly.
"""

import importlib.util
import pathlib

import pytest

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.metrics import iterations_to_threshold
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle


@pytest.fixture(scope="module")
def smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("problem", ["logistic", "quadratic"])
def test_chip_smoke_study_counts_are_the_jax_package_s(smoke, problem):
    rows = {label: row for (p, label), row in smoke.STUDY_ROWS.items() if p == problem}
    assert len(rows) == 4
    data = None
    for label, (algorithm, topology, _, jax_iters, floats) in rows.items():
        cfg = RefConfig(problem_type=problem, algorithm=algorithm, topology=topology)
        if data is None:
            ds = ref_generate(cfg)
            data = (ds, ref_oracle(ds, cfg.reg_param)[1])
        res = jax_backend.run(cfg, *data, use_mesh=False)
        h = res.history
        assert iterations_to_threshold(h.objective, 0.08, h.eval_iterations) == jax_iters, label
        assert res.total_floats_transmitted == floats, label
