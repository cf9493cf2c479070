"""Communication-compression operators for gossip, and the error-feedback
exchange (CHOCO-SGD), as plain PyTorch ops.

The twin of ``distributed_optimization_tpu/ops/compression.py``. Each
operator is a row-wise contraction ``Q(key, v) -> v_compressed`` over an
``[N, d]`` stack, with its per-edge float cost:

- ``top_k``: keep the k largest-|magnitude| coordinates of each row; cost 2k
  (k values and k indices), contraction factor k/d.
- ``random_k``: keep k coordinates of each row chosen by uniform scores;
  cost 2k, factor k/d.
- ``qsgd``: stochastic uniform quantization of each row to s = 2^bits
  levels, scaled by ω = 1/(1 + min(d/s², √d/s)); cost d·(bits+1)/32 + 1,
  factor ω.
- ``none``: the identity; cost d.

The draws are the JAX package's, bit for bit (``ops/prng.py``): exchange
``round`` of iteration t draws with ``compression_key(seed, t, round)``,
``fold_in(fold_in(fold_in(key(seed), 0xC0C0), t), round)`` with the round's
fold only when round ≠ 0, and element (r, c) of a ``[N, d]`` draw is counter
r·d + c of that key, in the run dtype (float64 under the float64 runs'
``enable_x64``, where ``key`` also takes the seed's high word). Where the
JAX code leaves a choice to the compiler, the twin fixes it:

- the top-k selection is a stable sort, descending, ties to the lower
  column, as ``jax.lax.top_k`` keeps them (``torch.topk`` promises no order
  on ties). ``jax.lax.top_k`` also ranks −0.0 below +0.0, which the sort
  does not; the scores, |v| and uniforms, are never −0.0;
- masking is ``v * mask``, so an unselected negative entry is −0.0;
- qsgd's row norm sums the squares in a fixed order, the order of the card's
  kernel (``row_norm``); the JAX package's XLA reduction may sum in another,
  so qsgd agrees with it to the rounding of a sum (1e-12 relative in
  float64), and on the card the kernel equals the twin bit for bit;
- bfloat16 rounds as the JAX package's bfloat16 run on the CPU: the
  uniforms of random_k and qsgd are float32's (``sampling.score_dtype``:
  ``jax.random.uniform`` draws in the default float type), so qsgd's
  ``u < p_up`` compares in float32; qsgd's norm sums the float32 squares
  unrounded and rounds the sum once (``jnp.linalg.norm``'s fused
  reduction), then its square root; every other operation rounds to
  bfloat16, and the exchange's γ is rounded to bfloat16 before it is
  applied (``rounding.scalar``), as ω is;
- ``none`` is the identity, and the exchange computes
  ``memory + (v − memory)`` literally, which differs from v in the last bit.

On a card the exchange's memory update ``memory + Q(v − memory)`` is one
launch of ``ops/compression_kernels.py``; this module is its plain version,
and what the CPU runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import torch

from distributed_optimization_tpu_torch.config import COMPRESSIONS
from distributed_optimization_tpu_torch.ops import prng
from distributed_optimization_tpu_torch.ops.rounding import scalar
from distributed_optimization_tpu_torch.ops.sampling import score_dtype

# The stream tag folded into the run key before t (the JAX package's
# _COMPRESSION_TAG): fold_in(fold_in(key(seed), TAG), t).
COMPRESSION_TAG = 0xC0C0
# qsgd's bits per coordinate, and the lanes of the row norm's summation.
QSGD_BITS = (1, 16)
NORM_LANES = 32


@dataclasses.dataclass(frozen=True)
class Draw:
    """Where one exchange draws its compressor's randomness: the tag key
    ``fold_in(key(seed), 0xC0C0)`` (two host words), the iteration counter
    ``t`` (an int, or the run's int64 counter tensor) and the exchange's
    round. ``key()`` is ``compression_key(seed, t, round)``; the card's
    kernel takes the parts and reads t from device memory."""

    tag_key: Tuple[int, int]
    t: Union[int, torch.Tensor]
    round: int = 0

    def key(self):
        t = self.t.reshape(()) if isinstance(self.t, torch.Tensor) else self.t
        step = prng.fold_in(self.tag_key, t)
        return prng.fold_in(step, self.round) if self.round else step


def tag_key(seed: int, *, x64: bool) -> Tuple[int, int]:
    """``fold_in(key(seed), 0xC0C0)``; ``x64`` as ``prng.key`` takes it."""
    return prng.fold_in(prng.key(seed, x64=x64), COMPRESSION_TAG)


def compression_key(seed: int, t, round: int = 0, *, x64: bool = False):
    """The JAX package's ``compression_key(seed, t, round)``: two ints for an
    int ``t``, an int64 tensor ``[2]`` for a tensor ``t``."""
    return Draw(tag_key(seed, x64=x64), t, round).key()


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A row-wise compression operator with its comms payload. ``k`` is the
    coordinates kept (top_k, random_k) or the bits (qsgd); ``delta`` the
    contraction factor, which for qsgd is its scale ω."""

    name: str
    apply: Callable[[Optional[object], torch.Tensor], torch.Tensor]
    floats_per_edge: float
    delta: float
    k: int = 0


def _sign(v: torch.Tensor) -> torch.Tensor:
    """(v > 0) − (v < 0): ±0 and NaN give +0, as the card's kernel does."""
    return (v > 0).to(v.dtype) - (v < 0).to(v.dtype)


def row_norm(v: torch.Tensor) -> torch.Tensor:
    """‖v_r‖ of each row, ``[N, 1]``, summed in the card kernel's order: lane
    j of 32 adds the squares of columns j, j + 32, j + 64, … in turn, then
    the lanes are summed by a butterfly (lane j adds lane j ^ o for o = 16,
    8, 4, 2, 1), and the square root is taken of the sum. A bfloat16 row
    sums its float32 squares in float32 and rounds the sum once to
    bfloat16 before the root."""
    n, d = v.shape
    wide = v.float() if v.dtype == torch.bfloat16 else v
    chunks = max(1, -(-d // NORM_LANES))
    sq = torch.zeros((n, chunks * NORM_LANES), dtype=wide.dtype, device=v.device)
    sq[:, :d] = wide * wide
    sq = sq.view(n, chunks, NORM_LANES)
    acc = sq[:, 0]
    for c in range(1, chunks):
        acc = acc + sq[:, c]
    lanes = torch.arange(NORM_LANES, device=v.device)
    offset = NORM_LANES // 2
    while offset:
        acc = acc + acc[:, lanes ^ offset]
        offset //= 2
    return torch.sqrt(acc[:, :1].to(v.dtype))


def top_scored_mask(scores: torch.Tensor, k: int, dtype=None) -> torch.Tensor:
    """``[N, d]`` 0/1 in ``dtype`` (the scores' by default): each row's k top
    scores, in stable descending order (ties to the lower column)."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.zeros_like(scores, dtype=dtype).scatter_(1, idx, 1.0)


def uniforms(key, v: torch.Tensor) -> torch.Tensor:
    """The compressor's ``[N, d]`` uniforms for the rows ``v``, in the run's
    score dtype (float32 for a bfloat16 run), on v's device."""
    return prng.uniform(key, v.shape, score_dtype(v.dtype)).to(v.device)


def qsgd_levels(v: torch.Tensor, u: torch.Tensor, s: float):
    """(‖v‖ [N, 1], the levels low + (u < p_up) [N, d]) of qsgd with s levels
    on the uniforms ``u``."""
    norm = row_norm(v)
    scale = torch.where(norm > 0, norm, torch.ones_like(norm))
    level = v.abs() / scale * s
    low = torch.floor(level)
    return norm, low + (u < level - low).to(v.dtype)


def make_compressor(name: str, d: int, k: int = 0) -> Compressor:
    """Build a compressor for d-dimensional rows; ``k`` is the coordinates
    kept (0 < k <= d) or, for qsgd, the bits (1 <= k <= 16). The JAX
    package's payloads, factors and errors."""
    if name == "none":
        return Compressor("none", lambda key, v: v, float(d), 1.0)
    if name not in COMPRESSIONS:
        raise ValueError(f"Unknown compression: {name!r}; known {COMPRESSIONS}")

    if name == "qsgd":
        if not QSGD_BITS[0] <= k <= QSGD_BITS[1]:
            raise ValueError(f"qsgd bits (compression_k) must be in [1, 16], got {k}")
        s = float(2 ** k)
        omega = 1.0 / (1.0 + min(d / (s * s), math.sqrt(d) / s))

        def apply_qsgd(key, v):
            if key is None:
                raise ValueError("qsgd compression needs a PRNG key")
            norm, levels = qsgd_levels(v, uniforms(key, v), s)
            w = torch.tensor(omega, dtype=v.dtype)  # ω in the run dtype, as a scalar
            return w * norm * _sign(v) * (levels / s)

        floats_cost = d * (k + 1) / 32.0 + 1.0
        return Compressor("qsgd", apply_qsgd, floats_cost, omega, k)

    if not 0 < k <= d:
        raise ValueError(f"compression_k must be in (0, {d}], got {k}")

    if name == "top_k":
        return Compressor("top_k", lambda key, v: v * top_scored_mask(v.abs(), k),
                          2.0 * k, k / d, k)

    def apply_randk(key, v):
        if key is None:
            raise ValueError("random_k compression needs a PRNG key")
        return v * top_scored_mask(uniforms(key, v), k, v.dtype)

    return Compressor("random_k", apply_randk, 2.0 * k, k / d, k)


def ef_compress_plain(compressor: Compressor, draw: Optional[Draw], v: torch.Tensor,
                      memory: torch.Tensor) -> torch.Tensor:
    """The estimate update ``memory + Q(v − memory)`` of one exchange."""
    key = None if draw is None or compressor.name in ("none", "top_k") else draw.key()
    return memory + compressor.apply(key, v - memory)


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackGossip:
    """CHOCO-style error-feedback compressed gossip (the JAX package's
    ``ErrorFeedbackGossip``). Each worker carries a public estimate x̂ that
    its neighbours hold a copy of; one exchange transmits only Q(v − x̂):

        x̂⁺ = x̂ + Q(v − x̂)
        v⁺  = v + γ [(W − I) X̂⁺]

    ``exchange`` takes the exchange's ``Draw``; the estimate update goes
    through ``compression_kernels.ef_compress``, one kernel launch on a
    card and this module's plain version on the CPU."""

    compressor: Compressor
    gamma: float

    def init(self, x0: torch.Tensor) -> torch.Tensor:
        """The estimate memory starts at 0."""
        return torch.zeros_like(x0)

    def exchange(self, draw: Draw, v: torch.Tensor, memory: torch.Tensor,
                 mix: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
        """One compressed gossip exchange: ``(v⁺, x̂⁺)``."""
        # Imported here: compression_kernels imports this module.
        from distributed_optimization_tpu_torch.ops import compression_kernels

        memory_new = compression_kernels.ef_compress(self.compressor, draw, v, memory)
        v_new = v + scalar(self.gamma, v.dtype) * (mix(memory_new) - memory_new)
        return v_new, memory_new


def make_error_feedback(name: str, d: int, k: int, gamma: float) -> ErrorFeedbackGossip:
    """Build the shared error-feedback exchange for d-dimensional rows."""
    return ErrorFeedbackGossip(compressor=make_compressor(name, d, k), gamma=float(gamma))
