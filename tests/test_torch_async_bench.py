"""``chip_smoke.py``'s async references, recomputed from the JAX package.

``chip_smoke.ASYNC_REFERENCE`` holds the final gap and floats transmitted
of ``jax_backend.run`` on examples/bench_async.py's four latency cells
(quadratic N=32 ring, T=2,000, float32), which the chip's ``async`` phase
holds the card's runs to (the gap within 1%, the floats exactly). They
are recomputed here, on the CPU, and not read from docs/perf/async.json,
which predates the JAX code as it stands. A file of its own: the four
runs of 64,000 events take about half a minute on one core.
"""

import importlib.util
import pathlib

import pytest

from distributed_optimization_tpu.backends import jax_backend
from distributed_optimization_tpu.config import ExperimentConfig as RefConfig
from distributed_optimization_tpu.utils.data import generate_synthetic_dataset as ref_generate
from distributed_optimization_tpu.utils.oracle import compute_reference_optimum as ref_oracle


def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("cell", ["constant", "exponential", "lognormal", "pareto"])
def test_chip_smoke_async_reference_is_the_jax_package_s(cell):
    smoke = _smoke()
    cfg = RefConfig(**smoke.ASYNC_BENCH)
    ds = ref_generate(cfg)
    f_opt = ref_oracle(ds, cfg.reg_param)[1]
    fields, gap, floats = smoke.ASYNC_REFERENCE[cell]
    h = jax_backend.run(cfg.replace(**fields), ds, f_opt).history
    # float32 over 64,000 events: another CPU's vector widths may round
    # differently; the card is held to these within 1%.
    assert float(h.objective[-1]) == pytest.approx(gap, rel=1e-4)
    assert h.total_floats_transmitted == floats
