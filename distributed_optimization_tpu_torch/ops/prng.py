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
  ``(x0, x1) = threefry2x32(key, (i >> 32, i mod 2³²))``, the flat index's
  two words as jax's ``iota_2x32_shape`` splits it, and its bits are
  ``x0 ^ x1`` (32) or ``x0 << 32 | x1`` (64);
- ``uniform(key, shape, dtype, minval, maxval)``: the top 23 (float32) or
  52 (float64) of those bits as the mantissa of a float in [1, 2), minus 1,
  then jax's ``max(minval, u·(maxval − minval) + minval)`` in ``dtype``;
- ``uniform_at(key, counters, dtype)``: the same floats at an explicit
  tensor of counters (element (i, j) of an (n, n) draw is counter i·n + j),
  so a few entries of a large draw cost no more than themselves;
- ``normal(key, shape, dtype)``: √2 · ``erf_inv(uniform(key, shape, dtype,
  nextafter(−1, 0), 1))``, with ``erf_inv`` the polynomial XLA lowers
  ``lax.erf_inv`` to (Giles' approximation: 9 coefficients in float32, up
  to 23 in float64, in its operation order).

A key is two Python ints (a key made on the host) or an int64 tensor whose
last dimension holds the two words, on any device; words lie in [0, 2³²).
``keys(seeds, ...)`` stacks R of them, one a replica, as ``[R, 2]``.
Keys broadcast against data, so ``fold_in`` of one key and a tensor of data
gives a tensor of keys, and ``random_bits``/``uniform`` of keys ``[..., 2]``
give ``[..., *shape]``, what ``jax.vmap`` over the keys gives. Everything
with a tensor in it runs on that tensor's device; only ints stay on the host.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
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
    tensors = [w for w in (key0, key1, c0, c1) if isinstance(w, torch.Tensor)]
    if tensors and all(w.device.type == "cpu" for w in tensors):
        return _threefry2x32_host(key0, key1, c0, c1)
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


def _threefry2x32_host(key0: Word, key1: Word, c0: Word, c1: Word):
    """The same rounds for CPU tensors, on numpy uint32 arrays, whose
    additions wrap at 2³² unmasked: a few times fewer operations than the
    int64 tensor form, each cheaper on the small draws of a CPU run. Returns
    int64 CPU tensors of the words' broadcast shape."""
    def u32(w):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        return (w.astype(np.int64) & MASK32).astype(np.uint32)

    words = np.broadcast_arrays(*(u32(w) for w in (key0, key1, c0, c1)))
    shape = words[0].shape
    # At least 1-d: a 0-d operation gives a numpy scalar, which warns where
    # it wraps.
    k0, k1, x0, x1 = (np.atleast_1d(w).copy() for w in words)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_KS_PARITY))
    x0 += ks[0]
    x1 += ks[1]
    for group in range(5):
        for r in _ROTATIONS[4 * (group % 2): 4 * (group % 2) + 4]:
            x0 += x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 += ks[(group + 1) % 3]
        x1 += ks[(group + 2) % 3]
        x1 += np.uint32(group + 1)
    return tuple(torch.from_numpy(x.astype(np.int64).reshape(shape)) for x in (x0, x1))


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


def keys(seeds, *, x64: bool, tags=(), device="cpu") -> torch.Tensor:
    """The replica axis's keys: ``[R, 2]`` int64 words on ``device``, row r
    ``key(seeds[r], x64=x64)`` with each of ``tags`` folded in after it, in
    order, as the single run derives its key from its seed."""
    rows = []
    for seed in seeds:
        k = key(int(seed), x64=x64)
        for tag in tags:
            k = fold_in(k, tag)
        rows.append(k)
    return torch.tensor(rows, dtype=torch.int64, device=device).reshape(len(rows), 2)


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``: ints for an int key and int data,
    else an int64 tensor ``[..., 2]`` of the broadcast shape."""
    k0, k1 = _words(key)
    x0, x1 = threefry2x32(k0, k1, 0, data & MASK32)
    if isinstance(x0, torch.Tensor):
        return torch.stack((x0, x1), dim=-1)
    return x0, x1


def _key_device(key: Key):
    return key.device if isinstance(key, torch.Tensor) else torch.device("cpu")


def _words_at(key: Key, counter: torch.Tensor):
    """The two Threefry output words at each counter (int64, ≥ 0; its high
    and low words are the Threefry counter's) under each key:
    ``[..., *counter.shape]`` each."""
    k0, k1 = _words(key)
    if isinstance(k0, torch.Tensor):
        k0 = k0.reshape(k0.shape + (1,) * counter.dim())
        k1 = k1.reshape(k1.shape + (1,) * counter.dim())
    return threefry2x32(k0, k1, counter >> 32, counter & MASK32)


def _counter_words(key: Key, shape):
    """The two Threefry output words for every element of ``shape`` under
    each key: ``[..., *shape]`` each, on the key's device (the CPU for an
    int key)."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 2**63:
        raise ValueError(f"shape {shape} holds 2⁶³ or more elements")
    counter = torch.arange(size, dtype=torch.int64, device=_key_device(key)).reshape(shape)
    return _words_at(key, counter)


def _bits_of(words, width: int) -> torch.Tensor:
    x0, x1 = words
    if width == 32:
        return x0 ^ x1
    if width == 64:
        hi = torch.where(x0 >= 2**31, x0 - 2**32, x0)  # the high word as signed
        return hi * 2**32 + x1  # no int64 overflow on the way
    raise ValueError(f"width must be 32 or 64, got {width}")


def random_bits(key: Key, shape, width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 or uint64)`` as int64: the 32-bit
    words in [0, 2³²), the 64-bit ones with their top bit as the sign."""
    return _bits_of(_counter_words(key, shape), width)


def _floats(bits: torch.Tensor, dtype: torch.dtype, minval, maxval) -> torch.Tensor:
    """jax's uniform floats from their random bits, in ``dtype``."""
    if dtype not in _ONE_BITS:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    nbits, nmant = torch.finfo(dtype).bits, _MANTISSA_BITS[dtype]
    # The top nmant bits (a logical shift: the mask drops the sign's spread).
    float_bits = ((bits >> (nbits - nmant)) & ((1 << nmant) - 1)) | _ONE_BITS[dtype]
    as_int = torch.int32 if dtype == torch.float32 else torch.int64
    floats = float_bits.to(as_int).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=bits.device)
    hi = torch.tensor(maxval, dtype=dtype, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key: Key, shape, dtype: torch.dtype = torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``."""
    if dtype not in _ONE_BITS:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    return _floats(random_bits(key, shape, torch.finfo(dtype).bits), dtype, minval, maxval)


def uniform_at(key: Key, counters: torch.Tensor, dtype: torch.dtype = torch.float32,
               minval=0.0, maxval=1.0) -> torch.Tensor:
    """The elements of ``uniform(key, shape, dtype, minval, maxval)`` at the
    flat indices ``counters`` (a non-negative int64 tensor), without the
    rest: ``[..., *counters.shape]`` for keys ``[..., 2]``."""
    if dtype not in _ONE_BITS:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    bits = _bits_of(_words_at(key, counters), torch.finfo(dtype).bits)
    return _floats(bits, dtype, minval, maxval)


# Giles' erf_inv as XLA lowers lax.erf_inv: Horner's rule on w − 2.5 (w =
# −log1p(−x²) < 5) or √w − 3 in float32; in float64 on w − 3.125 (w <
# 6.25), √w − 3.25 (w < 16) or √w − 5.
_ERF_INV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERF_INV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in XLA's operation order (float32 or float64):
    each Horner step rounds its product and its sum; ±1 gives ±inf."""
    w = -torch.log1p(x * -x)
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    if x.dtype == torch.float32:
        small, large = _ERF_INV_F32
        lt = w < 5.0
        w = torch.where(lt, w - c(2.5), torch.sqrt(w) - c(3.0))
        p = torch.where(lt, c(small[0]), c(large[0]))
        for a, b in zip(small[1:], large[1:]):
            p = torch.where(lt, c(a), c(b)) + p * w
    elif x.dtype == torch.float64:
        c625, c16, cbig = _ERF_INV_F64
        lt625, lt16 = w < 6.25, w < 16.0
        w = torch.where(lt625, w - c(3.125),
                        torch.sqrt(w) - torch.where(lt16, c(3.25), c(5.0)))

        def coef(i):
            v = c(c625[i])
            if i < len(c16):
                v = torch.where(lt625, v, c(c16[i]))
            if i < len(cbig):
                v = torch.where(lt16, v, c(cbig[i]))
            return v

        p = coef(0)
        for i in range(1, len(cbig)):
            p = coef(i) + p * w
        for i in range(len(cbig), len(c16)):
            p = torch.where(lt16, coef(i) + p * w, p)
        for i in range(len(c16), len(c625)):
            p = torch.where(lt625, coef(i) + p * w, p)
    else:
        raise ValueError(f"dtype must be float32 or float64, got {x.dtype}")
    return torch.where(torch.abs(x) == 1.0, x * torch.inf, p * x)


def normal_lower(dtype: torch.dtype) -> float:
    """``jax.random.normal``'s lower bound: the float after −1 toward 0."""
    return -1.0 + float(torch.finfo(dtype).eps) / 2.0


def _standard(u: torch.Tensor) -> torch.Tensor:
    return torch.tensor(math.sqrt(2.0), dtype=u.dtype, device=u.device) * erf_inv(u)


def normal(key: Key, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: √2 · erf_inv of a uniform on
    (nextafter(−1, 0), 1)."""
    return _standard(uniform(key, shape, dtype, normal_lower(dtype), 1.0))


def normal_at(key: Key, counters: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The elements of ``normal(key, shape, dtype)`` at the flat indices
    ``counters`` (a non-negative int64 tensor), without the rest."""
    return _standard(uniform_at(key, counters, dtype, normal_lower(dtype), 1.0))
