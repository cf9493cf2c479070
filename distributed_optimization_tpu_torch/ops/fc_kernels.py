"""Fully-connected gossip kernels: hand-written CUDA for Hopper, their plain
twins, the launch plan and a mirror of the kernels' summation order.

Ports of the Pallas TPU kernels in
``distributed_optimization_tpu/ops/pallas_kernels.py``:

- ``fc_mix(x)`` ← ``fc_mix`` (:172): W x on the fully-connected graph, the
  column mean broadcast to every row;
- ``fc_neighbor_sum(x)`` ← ``fc_neighbor_sum`` (:183): A x, the column sum
  minus the row itself.

Each takes a contiguous ``[N, d]`` float32, float64 or bfloat16 tensor. For a CUDA
tensor it launches the kernel of ``csrc/fc_kernels.cu`` on the current
stream, or raises; for a CPU tensor it runs the plain PyTorch version
(``*_plain``).

The kernels reduce each column strip in one block (see the source).
``plan`` chooses, from N, d, the item size and the 16-byte alignment, the
vector width, the strip (lanes) and row groups of a block and where the
neighbour sum keeps its rows; the C functions take it as arguments. The
summation order follows from the plan alone, and ``column_sum_mirror``
repeats it in PyTorch ops: the kernels equal ``fc_mix_mirror`` /
``fc_neighbor_sum_mirror`` bit for bit, and agree with the plain versions
(another order) to N·ε·max|x|. In bfloat16 the column sums are float32,
rounded once to bfloat16 (the mean after its division, the neighbour sum's
total before the subtraction, whose result rounds again), as ``torch.mean``
and the JAX package's ``jnp.mean`` / ``jnp.sum`` round; the plain versions
sum in float32 in PyTorch's order, so kernel and twin agree to the
rounding of the float32 sums (PERF.md states the measured agreement).
Nothing on a run's path calls the mirrors;
the tests and ``chip_smoke.py`` do.

``LAUNCHES`` maps each kernel to its launches on the card, which the kernel
counts where it runs (``_cuda_build.LaunchCounts``): graph replays count;
the plain versions and the mirrors do not.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from distributed_optimization_tpu_torch.ops import _cuda_build

# The kernels' instances (csrc/fc_kernels.cu).
SUFFIX = _cuda_build.SUFFIX_BF16
SOURCE = _cuda_build.CSRC / "fc_kernels.cu"
# In the order of the kernels' launch-count slots (csrc/fc_kernels.cu).
KERNELS = ("fc_mix", "fc_neighbor_sum")

THREADS = 512           # threads a block the plan gives at most (the kernel takes 1024)
ROWS_PER_THREAD = 8     # rows a thread loads at once (the kernel's kUnroll)
STRIP_BYTES = 32        # bytes of a row a strip covers: one sector ...
WIDE_STRIP_BYTES = 64   # ... or two from WIDE_ROWS rows on
WIDE_ROWS = 1024
# Where the neighbour sum keeps a thread's rows between the passes, by the C code.
TILES = ("none", "registers")


# --- plain PyTorch versions ---------------------------------------------------


def fc_mix_plain(x: torch.Tensor) -> torch.Tensor:
    """The worker axis is −2, so a leading replica axis passes through."""
    return torch.mean(x, dim=-2, keepdim=True).expand_as(x)


def fc_neighbor_sum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=-2, keepdim=True).expand_as(x) - x


# --- the plan -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a kernel cuts an [N, d] array: ``strips`` strips of ``lanes·vec``
    columns, one block of ``lanes x groups`` threads each; thread group g
    sums rows g, g + groups, ... ``tile``: where the neighbour sum keeps a
    thread's rows for the second pass (one of ``TILES``; "none" reads x
    again; fc_mix keeps none)."""

    vec: int
    lanes: int
    groups: int
    strips: int
    tile: str

    def describe(self) -> str:
        return (f"strip {self.lanes * self.vec} cols (vec {self.vec}), {self.strips} blocks of "
                f"{self.lanes}x{self.groups} threads"
                f"{'' if self.tile == 'none' else f', tile in {self.tile}'}")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(a: int) -> int:
    return 1 << (max(a, 1) - 1).bit_length()


def plan(name: str, n: int, d: int, itemsize: int, aligned: bool = True) -> Plan:
    """The launch plan of kernel ``name`` for an [n, d] array.

    16-byte accesses where ``aligned`` (x and out) and d allow; strips of
    ``STRIP_BYTES`` a row (fewer lanes where d is narrower), so that even a
    narrow array spreads over many blocks, or ``WIDE_STRIP_BYTES`` from
    ``WIDE_ROWS`` rows on, where a block loops over its rows and the wider
    strip measured faster on an H100 (PERF.md); as many row groups as let a
    thread load all its rows at once (``ROWS_PER_THREAD``), up to
    ``THREADS`` a block. The neighbour sum keeps a thread's rows in its
    registers where they fit that one batch, else reads x again."""
    if name not in KERNELS:
        raise ValueError(f"unknown fc kernel {name!r}")
    width = 16 // itemsize
    vec = width if aligned and d % width == 0 else 1
    strip = WIDE_STRIP_BYTES if n >= WIDE_ROWS else STRIP_BYTES
    lanes = min(max(1, strip // (vec * itemsize)), _pow2_at_least(_ceil(d, vec)))
    groups = max(1, min(THREADS // lanes, _pow2_at_least(_ceil(n, ROWS_PER_THREAD))))
    registers = name == "fc_neighbor_sum" and _ceil(n, groups) <= ROWS_PER_THREAD
    return Plan(vec, lanes, groups, _ceil(d, lanes * vec), "registers" if registers else "none")


def plan_for(name: str, x: torch.Tensor, out: torch.Tensor | None = None) -> Plan:
    """The plan a wrapper launches ``name`` with on x (and out)."""
    aligned = x.data_ptr() % 16 == 0 and (out is None or out.data_ptr() % 16 == 0)
    return _plan_cached(name, x.shape[0], x.shape[1], x.element_size(), aligned)


@functools.lru_cache(maxsize=256)
def _plan_cached(name, n, d, itemsize, aligned) -> Plan:
    return plan(name, n, d, itemsize, aligned)


# --- the kernels' summation order, in PyTorch ----------------------------------


def column_sum_mirror(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """[d] column sums added in the kernels' order under plan ``p``: thread
    group g adds rows g, g + groups, ... from +0, and the block adds its
    groups' sums in group order. Padding adds +0, which leaves a sum
    started from +0 unchanged. bfloat16 sums in float32 (float32 sums)."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    n, d = x.shape
    per_group = _ceil(n, p.groups)
    row = torch.arange(per_group * p.groups, device=x.device).view(per_group, p.groups)
    padded = torch.cat([x, x.new_zeros((1, d))])
    rows = padded[torch.where(row < n, row, n)]  # [per_group, groups, d]
    s = x.new_zeros((p.groups, d))
    for step in range(per_group):
        s = s + rows[step]
    total = s[0]
    for group in range(1, p.groups):
        total = total + s[group]
    return total


def fc_mix_mirror(x: torch.Tensor, p: Plan) -> torch.Tensor:
    total = column_sum_mirror(x, p)
    # A tensor divisor: PyTorch on the card multiplies by the reciprocal of
    # a Python scalar, which rounds differently.
    return (total / torch.full_like(total, x.shape[0])).to(x.dtype).expand_as(x)


def fc_neighbor_sum_mirror(x: torch.Tensor, p: Plan) -> torch.Tensor:
    return column_sum_mirror(x, p).to(x.dtype).expand_as(x) - x


MIRRORS = {"fc_mix": fc_mix_mirror, "fc_neighbor_sum": fc_neighbor_sum_mirror}


# --- build, load and launch ---------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the kernels' C functions."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in KERNELS:
        for suffix in SUFFIX.values():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ptr, ptr, i64, i64, i32, i32, i32, i32, ptr]
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """This checkout's build of the kernels, built at first use."""
    return bind(_cuda_build.load(SOURCE))


LAUNCHES = _cuda_build.LaunchCounts(KERNELS, library)


def reset_launch_counts() -> None:
    LAUNCHES.reset()


def _launch(lib: ctypes.CDLL, name: str, x: torch.Tensor, p: Plan | None = None) -> torch.Tensor:
    """Launch kernel ``name`` of ``lib`` on x under plan ``p`` (the
    wrappers' own by default); returns its output."""
    out = torch.empty_like(x)
    p = plan_for(name, x, out) if p is None else p
    _cuda_build.call(lib, name, x, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                     p.vec, p.lanes, p.groups, TILES.index(p.tile), suffixes=SUFFIX)
    return out


def _run(name: str, x: torch.Tensor, plain) -> torch.Tensor:
    _cuda_build.check_stack(x, "x", SUFFIX)
    if x.device.type == "cpu":
        return plain(x)
    return _launch(library(), name, x)


def fc_mix(x: torch.Tensor) -> torch.Tensor:
    """W x for the fully-connected graph: the column mean on every row."""
    return _run("fc_mix", x, fc_mix_plain)


def fc_neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """A x for the fully-connected graph: column sums minus the row."""
    return _run("fc_neighbor_sum", x, fc_neighbor_sum_plain)
