"""A twin of ``jax.random``'s Threefry stream, bit for bit, in torch ops.

The JAX package draws its random numbers through ``jax.random`` with the
``threefry2x32`` implementation and ``jax_threefry_partitionable`` on, the
defaults of jax 0.9.0. This module gives the same bits for the part of it
that the port's sampler uses:

- ``key(seed, x64=...)`` is ``jax.random.key(seed)``: ``(0, seed mod 2³²)``,
  and under ``enable_x64`` (the JAX package's float64 runs) the seed's two
  64-bit words ``(seed >> 32, seed mod 2³²)``;
- ``fold_in(key, data)`` is ``threefry2x32(key, (0, data mod 2³²))``;
- ``random_bits(key, shape, width)``: element i of the flattened shape is
  ``(x0, x1) = threefry2x32(key, (0, i))``, and its bits are ``x0 ^ x1``
  (32) or ``x0 << 32 | x1`` (64);
- ``uniform(key, shape, dtype)``: the top 23 (float32) or 52 (float64) of
  those bits as the mantissa of a float in [1, 2), minus 1, then jax's
  ``max(0, u·(1 − 0) + 0)``.

A key is two Python ints (a key made on the host) or an int64 tensor whose
last dimension holds the two words, on any device; words lie in [0, 2³²).
Keys broadcast against data, so ``fold_in`` of one key and a tensor of data
gives a tensor of keys, and ``random_bits``/``uniform`` of keys ``[..., 2]``
give ``[..., *shape]``, what ``jax.vmap`` over the keys gives. Everything
with a tensor in it runs on that tensor's device; only ints stay on the host.
"""

from __future__ import annotations

import math
from typing import Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_KS_PARITY = 0x1BD11BDA
# The bits of 1.0, the exponent that puts a mantissa in [1, 2).
_ONE_BITS = {torch.float32: 0x3F800000, torch.float64: 0x3FF0000000000000}
_MANTISSA_BITS = {torch.float32: 23, torch.float64: 52}

Word = Union[int, torch.Tensor]
Key = Union[tuple, torch.Tensor]


def _rotl32(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key0: Word, key1: Word, c0: Word, c1: Word):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11), the generator
    behind ``jax.random``: ``(x0, x1)`` for the counter ``(c0, c1)``. Each
    word is a Python int or an int64 tensor in [0, 2³²), and tensors
    broadcast; the result is ints when every word is an int."""
    key0, key1 = key0 & MASK32, key1 & MASK32
    ks = (key0, key1, key0 ^ key1 ^ _KS_PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for group in range(5):
        for r in _ROTATIONS[4 * (group % 2): 4 * (group % 2) + 4]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK32
    return x0, x1


def _words(key: Key):
    if isinstance(key, torch.Tensor):
        if key.dtype != torch.int64 or key.shape[-1:] != (2,):
            raise ValueError(f"a key tensor is int64 [..., 2], got {key.dtype} {tuple(key.shape)}")
        return key[..., 0], key[..., 1]
    k0, k1 = key
    return k0 & MASK32, k1 & MASK32


def key(seed: int, *, x64: bool) -> tuple[int, int]:
    """``jax.random.key(seed)``; ``x64``: inside the JAX package's
    ``enable_x64`` scope, which its float64 runs take."""
    if x64:
        return (seed >> 32) & MASK32, seed & MASK32
    return 0, seed & MASK32


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``: ints for an int key and int data,
    else an int64 tensor ``[..., 2]`` of the broadcast shape."""
    k0, k1 = _words(key)
    x0, x1 = threefry2x32(k0, k1, 0, data & MASK32)
    if isinstance(x0, torch.Tensor):
        return torch.stack((x0, x1), dim=-1)
    return x0, x1


def _counter_words(key: Key, shape):
    """The two Threefry output words for every element of ``shape`` under
    each key: ``[..., *shape]`` each, on the key's device (the CPU for an
    int key)."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 2**32:
        raise ValueError(f"shape {shape} holds 2³² or more elements")
    k0, k1 = _words(key)
    device = "cpu"
    if isinstance(k0, torch.Tensor):
        device = k0.device
        k0 = k0.reshape(k0.shape + (1,) * len(shape))
        k1 = k1.reshape(k1.shape + (1,) * len(shape))
    counter = torch.arange(size, dtype=torch.int64, device=device).reshape(shape)
    return threefry2x32(k0, k1, 0, counter)


def random_bits(key: Key, shape, width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 or uint64)`` as int64: the 32-bit
    words in [0, 2³²), the 64-bit ones with their top bit as the sign."""
    x0, x1 = _counter_words(key, shape)
    if width == 32:
        return x0 ^ x1
    if width == 64:
        hi = torch.where(x0 >= 2**31, x0 - 2**32, x0)  # the high word as signed
        return hi * 2**32 + x1  # no int64 overflow on the way
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(key: Key, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1)."""
    if dtype not in _ONE_BITS:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    nbits, nmant = torch.finfo(dtype).bits, _MANTISSA_BITS[dtype]
    bits = random_bits(key, shape, nbits)
    # The top nmant bits (a logical shift: the mask drops the sign's spread).
    float_bits = ((bits >> (nbits - nmant)) & ((1 << nmant) - 1)) | _ONE_BITS[dtype]
    as_int = torch.int32 if dtype == torch.float32 else torch.int64
    floats = float_bits.to(as_int).view(dtype) - 1.0
    return torch.clamp_min(floats * (1.0 - 0.0) + 0.0, 0.0)
