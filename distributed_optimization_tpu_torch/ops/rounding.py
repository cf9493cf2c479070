"""Python scalars as the JAX package's weak types apply them, in any dtype.

JAX rounds a Python float to an array's dtype before the operation: in
bfloat16, ``x * (1/3)`` multiplies by bf16(1/3). PyTorch applies a Python
scalar to a bfloat16 tensor at float32, its operation type, so ``x *
(1/3)`` would multiply by float32(1/3) and round once after. ``scalar``
gives the value already rounded to bfloat16, as a Python float: a
bfloat16 value is exact in float32, so PyTorch's float32 operation then
computes what the JAX package's bfloat16 operation does (the product,
sum or comparison of two bfloat16 values, rounded once), on the CPU and
on the card alike, and a Python float captures in a CUDA graph as a
launch argument. A 0-dim bfloat16 tensor would do the same where
PyTorch takes one. In float32 and float64 the value comes back as it
is: PyTorch already rounds it to the operation's type there, as the JAX
package does. (0.5, the EXTRA and one-peer weight, is exact in every
dtype and needs no rounding.)

``sum_of`` is the other rule of the JAX package's bfloat16 runs on the CPU
(measured against jax 0.9.0): XLA fuses the last elementwise operation
before a reduction into it, so that operation's float32 result is summed
unrounded, in float32, and only the sum is rounded to bfloat16; the
operations before it round one by one. ``sum_of(op, *args, dim=)``
computes ``torch.sum(op(*args), dim)`` so in bfloat16, and exactly as
written in float32 and float64.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _bfloat16(value: float) -> float:
    return float(torch.tensor(value, dtype=torch.float64).to(torch.bfloat16))


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` where PyTorch would apply it wider
    (bfloat16), else ``value``."""
    if dtype == torch.bfloat16:
        return _bfloat16(float(value))
    return value


def _float(v):
    return v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v


def sum_of(op, *args, dim, keepdim: bool = False) -> torch.Tensor:
    """``torch.sum(op(*args), dim)``; where a tensor argument is bfloat16,
    ``op`` runs on their float32 values, unrounded, and the float32 sum is
    rounded once to bfloat16 (XLA's fused reduction)."""
    if any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 for a in args):
        out = torch.sum(op(*(_float(a) for a in args)), dim=dim, keepdim=keepdim)
        return out.to(torch.bfloat16)
    return torch.sum(op(*args), dim=dim, keepdim=keepdim)
