"""The port's ring and fully-connected kernels and mixing operators against
the JAX package.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the Pallas kernels in interpret mode, as tests/test_pallas.py
runs them. Tolerance: 1 ulp (1e-6 in float32, 1e-15 in float64). The
plain versions round every operation on its own; XLA on the CPU may
contract the fused step's multiply and subtract into one FMA, which rounds
once. The CUDA kernels are held against the plain versions by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.ops.mixing import make_mixing_op as jax_mixing_op
from distributed_optimization_tpu.parallel import build_topology as jax_topology
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.ops import fc_kernels as fk
from distributed_optimization_tpu_torch.ops import ring_kernels as rk
from distributed_optimization_tpu_torch.ops.mixing import make_mixing_op
from distributed_optimization_tpu_torch.parallel.topology import build_topology

RTOL = {np.float32: 1e-6, np.float64: 1e-15}
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _inputs(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(dtype),
            rng.standard_normal((n, d)).astype(dtype))


def _pallas(name, x, g, eta):
    if name == "fused_ring_dsgd_step":
        return np.asarray(pk.fused_ring_dsgd_step(jnp.asarray(x), jnp.asarray(g), eta,
                                                  interpret=True))
    return np.asarray(getattr(pk, name)(jnp.asarray(x), interpret=True))


def _port(name, x, g, eta):
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    if name == "fused_ring_dsgd_step":
        return rk.fused_ring_dsgd_step(tx, tg, torch.tensor([eta], dtype=tx.dtype)).numpy()
    return getattr(rk, name)(tx).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 12, 81])
@pytest.mark.parametrize("n", [3, 8, 37])
@pytest.mark.parametrize("name", rk.KERNELS)
def test_plain_version_matches_pallas_interpret(name, n, d, dtype):
    x, g = _inputs(n, d, dtype)
    eta = float(dtype(0.05) / np.sqrt(dtype(7.0)))
    with enable_x64():
        want = _pallas(name, x, g, eta)
    got = _port(name, x, g, eta)
    assert got.dtype == want.dtype == dtype
    # 1 ulp of the last operation's operands: where the fused step's
    # subtraction cancels, an FMA's single rounding differs by up to the
    # ulp of W x and η g, not of their small difference.
    scale = np.abs(want)
    if name == "fused_ring_dsgd_step":
        mixed = rk.ring_mix_plain(torch.from_numpy(x)).numpy()
        scale = np.abs(mixed) + np.abs(dtype(eta) * g)
    assert np.all(np.abs(got - want) <= RTOL[dtype] * scale)


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    x, g = (torch.from_numpy(a) for a in _inputs(8, 12, np.float64))
    eta = torch.tensor([0.01], dtype=torch.float64)
    rk.reset_launch_counts()
    assert torch.equal(rk.ring_mix(x), rk.ring_mix_plain(x))
    assert torch.equal(rk.ring_neighbor_sum(x), rk.ring_neighbor_sum_plain(x))
    assert torch.equal(rk.fused_ring_dsgd_step(x, g, eta),
                       rk.fused_ring_dsgd_step_plain(x, g, eta))
    assert rk.LAUNCHES == {name: 0 for name in rk.KERNELS}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((8, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="N >= 3"):
        rk.ring_mix(torch.zeros((2, 4)))
    with pytest.raises(TypeError, match="float32 or float64"):
        rk.ring_mix(torch.zeros((8, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        rk.ring_neighbor_sum(torch.zeros((4, 8)).t())
    with pytest.raises(ValueError, match=r"\[N, d\]"):
        rk.ring_mix(torch.zeros(8))
    with pytest.raises(ValueError, match="match x"):
        rk.fused_ring_dsgd_step(x, x.float(), 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_step_equals_mix_then_step(dtype):
    x, g = (torch.from_numpy(a).to(dtype) for a in _inputs(37, 81, np.float64, seed=3))
    eta = torch.tensor([0.07], dtype=dtype)
    assert torch.equal(rk.fused_ring_dsgd_step(x, g, eta), rk.ring_mix(x) - eta * g)


def _flat_neighbours(n, d, width):
    """The CUDA ring stencil's index plan (csrc/ring_kernels.cu): element e
    of the flat [N·d] array reads prev = e − d and next = e + d, moved by
    N·d where they fall outside, with no division. With ``width`` > 1 and
    d % width == 0 a vector of ``width`` elements takes its neighbours as
    vectors (the wrap applied to the vector's first element); otherwise, and
    for the last N·d % width elements, each element wraps on its own."""
    total = n * d
    far = total - d
    e = np.arange(total)
    if width > 1 and d % width == 0:
        base = e - e % width
        lane = e - base
        prev = np.where(base >= d, base - d, base + far) + lane
        nxt = np.where(base >= far, base - far, base + d) + lane
        tail = e >= total - total % width
        prev[tail] = np.where(e[tail] >= d, e[tail] - d, e[tail] + far)
        nxt[tail] = np.where(e[tail] >= far, e[tail] - far, e[tail] + d)
        return prev, nxt
    return np.where(e >= d, e - d, e + far), np.where(e >= far, e - far, e + d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", range(1, 41))
def test_flat_stencil_is_the_plain_version_bitwise(d, dtype):
    # The premise of the kernel's index math: on the flattened array, the
    # ±d shift with its wrap reads exactly roll(x, ±1, 0), and the kernel's
    # order of operations on those reads is the plain version bit for bit,
    # for the vector width of float32 (4), of float64 (2), and the
    # one-element instance of a misaligned view (1).
    rng = np.random.default_rng(d)
    for n in (3, 4, 5, 8, 13, 33, 64):
        x = torch.from_numpy(rng.standard_normal((n, d))).to(dtype)
        g = torch.from_numpy(rng.standard_normal((n, d))).to(dtype)
        eta = torch.tensor([0.013], dtype=dtype)
        rows, cols = np.divmod(np.arange(n * d), d)
        for width in (4 if dtype == torch.float32 else 2, 1):
            prev, nxt = _flat_neighbours(n, d, width)
            np.testing.assert_array_equal(prev, (rows - 1) % n * d + cols)
            np.testing.assert_array_equal(nxt, (rows + 1) % n * d + cols)
            xf = x.flatten()
            mixed = ((xf + xf[prev]) + xf[nxt]) * rk.THIRD
            stepped = mixed - eta * g.flatten()
            assert torch.equal(mixed.view(n, d), rk.ring_mix_plain(x))
            assert torch.equal(stepped.view(n, d), rk.fused_ring_dsgd_step_plain(x, g, eta))


@pytest.mark.parametrize("impl", ["stencil", "dense", "pallas"])
@pytest.mark.parametrize("name", ["ring", "fully_connected"])
def test_mixing_op_matches_dense_W_and_the_jax_op(name, impl):
    x = np.random.default_rng(1).standard_normal((8, 12))
    topo = build_topology(name, 8)
    ref_topo = jax_topology(name, 8)
    np.testing.assert_array_equal(topo.mixing_matrix, ref_topo.mixing_matrix)
    op = make_mixing_op(topo, impl, device="cpu", dtype=torch.float64)
    assert op.impl == impl
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(op.apply(tx).numpy(), topo.mixing_matrix @ x,
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(op.neighbor_sum(tx).numpy(), topo.adjacency @ x,
                               rtol=1e-12, atol=1e-14)
    with enable_x64():
        ref = jax_mixing_op(ref_topo, impl=impl, dtype=jnp.float64)
        if impl == "pallas":
            kernel = pk.ring_mix if name == "ring" else pk.fc_mix
            want = np.asarray(kernel(jnp.asarray(x), interpret=True))
        else:
            want = np.asarray(ref.apply(jnp.asarray(x)))
    np.testing.assert_allclose(op.apply(tx).numpy(), want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,d", [(1, 3), (25, 81), (37, 12)])
@pytest.mark.parametrize("name", fk.KERNELS)
def test_fc_plain_version_matches_pallas_interpret(name, n, d, dtype):
    """The column mean or sum over N is a reduction in another order on
    each side: N·ε·max|x|."""
    x, _ = _inputs(n, d, dtype, seed=4)
    with enable_x64():
        want = np.asarray(getattr(pk, name)(jnp.asarray(x), interpret=True))
    got = getattr(fk, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == dtype and got.shape == (n, d)
    eps = np.finfo(dtype).eps
    np.testing.assert_allclose(got, want, rtol=0, atol=n * eps * np.abs(x).max())


def test_fc_wrappers_run_the_plain_version_and_count_nothing():
    x = torch.from_numpy(_inputs(6, 5, np.float64)[0])
    fk.reset_launch_counts()
    assert torch.equal(fk.fc_mix(x), fk.fc_mix_plain(x))
    assert torch.equal(fk.fc_neighbor_sum(x), fk.fc_neighbor_sum_plain(x))
    assert fk.LAUNCHES == {name: 0 for name in fk.KERNELS}
    with pytest.raises(TypeError, match="float32 or float64"):
        fk.fc_mix(torch.zeros((4, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        fk.fc_neighbor_sum(torch.zeros((4, 8)).t())


def test_auto_mixing_resolves_to_stencil():
    assert make_mixing_op(build_topology("ring", 8), device="cpu").impl == "stencil"
    assert make_mixing_op(build_topology("fully_connected", 5), device="cpu").impl == "stencil"


def test_topology_spectral_gap_and_floats_match_the_reference():
    for name, n in (("ring", 25), ("fully_connected", 6)):
        ours, ref = build_topology(name, n), jax_topology(name, n)
        assert ours.spectral_gap == pytest.approx(ref.spectral_gap, abs=1e-12)
        assert ours.floats_per_iteration == ref.floats_per_iteration
        np.testing.assert_array_equal(ours.degrees, ref.degrees)

