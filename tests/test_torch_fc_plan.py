"""The fully-connected kernels' launch plan and the mirror of their summation
order, on the CPU.

The CUDA kernels (csrc/fc_kernels.cu) reduce each column strip in one
block, its rows split among row groups, under a plan chosen in
``ops/fc_kernels.py``. Here the plan is checked to cover every element
exactly once, and ``column_sum_mirror`` (the kernels' order in PyTorch ops,
which tests/test_torch_cuda.py holds the kernels to bit for bit on the
card) is checked against a scalar loop in that order, bitwise, and against
the plain versions and the Pallas kernels in interpret mode to N·ε·max|x|:
the order is not theirs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_optimization_tpu.ops import pallas_kernels as pk
from distributed_optimization_tpu.parallel._compat import enable_x64
from distributed_optimization_tpu_torch.ops import fc_kernels as fk

TORCH_DTYPE = {4: torch.float32, 8: torch.float64}
NP_DTYPE = {4: np.float32, 8: np.float64}

# The fc path (25, 81), robust_mixing's (256, 41), ragged and odd widths,
# one row, and the card shapes.
PLAN_SHAPES = [(25, 81), (256, 41), (37, 1023), (4096, 1021), (1, 3), (1, 8), (5, 4),
               (4096, 1024)]


def _coverage(n, d, p):
    """How often the plan's threads read each element of an [n, d] array."""
    width = p.lanes * p.vec
    seen = np.zeros((n, p.strips * width), dtype=np.int64)
    first = np.arange(p.lanes) * p.vec  # each lane's first column in its strip
    for strip in range(p.strips):
        live = first[strip * width + first < d]  # a lane past d reads nothing
        cols = (strip * width + live[:, None] + np.arange(p.vec)).ravel()
        for g in range(p.groups):
            rows = np.arange(g, n, p.groups)
            np.add.at(seen, (rows[:, None], cols[None, :]), 1)
    assert not seen[:, d:].any()
    return seen[:, :d]


def _replan(name, n, d, itemsize, lanes=None, groups=None):
    """The wrappers' plan with another strip or row-group count, the rest
    (strips, where the rows stay) made consistent with it."""
    p = fk.plan(name, n, d, itemsize)
    lanes = p.lanes if lanes is None else lanes
    groups = p.groups if groups is None else groups
    registers = name == "fc_neighbor_sum" and -(-n // groups) <= fk.ROWS_PER_THREAD
    return fk.Plan(p.vec, lanes, groups, -(-d // (lanes * p.vec)),
                   "registers" if registers else "none")


@pytest.mark.parametrize("name", fk.KERNELS)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_reads_every_element_once(shape, itemsize, name):
    n, d = shape
    for aligned in (True, False):
        p = fk.plan(name, n, d, itemsize, aligned)
        assert p.lanes * p.groups <= fk.THREADS
        # A thread loads all its rows at once where the block size allows.
        assert -(-n // p.groups) <= fk.ROWS_PER_THREAD or p.lanes * p.groups == fk.THREADS
        assert p.vec == (16 // itemsize if aligned and d % (16 // itemsize) == 0 else 1)
        # One sector of a row a strip (two from WIDE_ROWS rows on), or the
        # whole row where it is narrower.
        strip = fk.WIDE_STRIP_BYTES if n >= fk.WIDE_ROWS else fk.STRIP_BYTES
        assert p.lanes * p.vec * itemsize == strip or p.strips == 1
        np.testing.assert_array_equal(_coverage(n, d, p), 1)


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 16, 37, 61])
def test_every_row_group_count_covers_ragged_rows_once(n, groups):
    # N not a multiple of the row groups: the last groups own a row fewer,
    # or none.
    p = _replan("fc_neighbor_sum", n, 13, 8, groups=groups)
    assert p.groups == groups
    assert (p.tile == "registers") == (-(-n // groups) <= fk.ROWS_PER_THREAD)
    np.testing.assert_array_equal(_coverage(n, 13, p), 1)


def test_plan_at_the_path_shapes():
    # The fc path: one block a one-sector strip of 8 columns, eleven in
    # all, of four row groups (seven rows a thread at most).
    p = fk.plan("fc_mix", 25, 81, 4)
    assert (p.vec, p.lanes, p.groups, p.strips) == (1, 8, 4, 11)
    # robust_mixing's: the same, with 32 groups of 8 rows, kept in registers.
    p = fk.plan("fc_neighbor_sum", 256, 41, 4)
    assert (p.lanes, p.groups, p.strips, p.tile) == (8, 32, 6, "registers")
    # Many rows, and a width the 16-byte accesses take: two sectors, four
    # lanes, a strip, a block of THREADS.
    p = fk.plan("fc_mix", 4096, 1024, 4)
    assert (p.vec, p.lanes, p.strips, p.lanes * p.groups) == (4, 4, 64, fk.THREADS)
    # One row: one row group.
    p = fk.plan("fc_neighbor_sum", 1, 3, 8)
    assert (p.strips, p.groups, p.tile) == (1, 1, "registers")


def test_neighbor_sum_tile_in_registers_or_nowhere():
    # Up to ROWS_PER_THREAD rows a thread stay in its registers ...
    assert fk.plan("fc_neighbor_sum", 512, 81, 4).tile == "registers"
    # ... beyond them the kernel reads x again; fc_mix keeps none.
    assert fk.plan("fc_neighbor_sum", 16384, 1024, 8).tile == "none"
    assert fk.plan("fc_mix", 25, 81, 4).tile == "none"


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="unknown fc kernel"):
        fk.plan("fc_sum", 64, 8, 4)


def _loop_column_sums(x, p):
    """The kernels' order as the source states it, one scalar add at a time:
    thread group g from +0 over rows g, g + groups, ...; then the groups
    in order."""
    n, d = x.shape
    zero = x.dtype.type(0)
    total = np.empty(d, dtype=x.dtype)
    for j in range(d):
        sums = []
        for g in range(p.groups):
            s = zero
            for i in range(g, n, p.groups):
                s = s + x[i, j]
            sums.append(s)
        t = sums[0]
        for s in sums[1:]:
            t = t + s
        total[j] = t
    return total


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(37, 5), (61, 12)])
def test_mirror_is_the_kernels_order_bitwise(shape, groups, itemsize):
    n, d = shape
    x = np.random.default_rng(n + groups).standard_normal(shape).astype(NP_DTYPE[itemsize])
    x[3, 1] = -0.0
    p = _replan("fc_mix", n, d, itemsize, groups=groups)
    total = fk.column_sum_mirror(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(total, _loop_column_sums(x, p))
    mean = total / NP_DTYPE[itemsize](n)
    np.testing.assert_array_equal(fk.fc_mix_mirror(torch.from_numpy(x), p).numpy()[0], mean)


# The two path shapes, and shapes of a block of THREADS whose threads load
# more than one batch of rows, one with ragged row groups.
MIRROR_SHAPES = [(25, 81), (256, 41), (4096, 24), (2048, 1021), (3001, 7)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", MIRROR_SHAPES)
@pytest.mark.parametrize("name", fk.KERNELS)
def test_mirror_matches_plain_and_pallas_interpret(name, shape, itemsize):
    n, d = shape
    dtype = NP_DTYPE[itemsize]
    x = np.random.default_rng(7).standard_normal(shape).astype(dtype)
    p = fk.plan(name, n, d, itemsize)
    assert (-(-n // p.groups) > fk.ROWS_PER_THREAD) == (n >= 1024)
    got = fk.MIRRORS[name](torch.from_numpy(x), p)
    tol = n * np.finfo(dtype).eps * np.abs(x).max()
    plain = getattr(fk, f"{name}_plain")(torch.from_numpy(x))
    assert got.dtype == TORCH_DTYPE[itemsize]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
    with enable_x64():
        want = np.asarray(getattr(pk, name)(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if name == "fc_mix":
        assert bool((got == got[0]).all())
