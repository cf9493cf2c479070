"""Byzantine adversary injection: workers that send wrong models.

The port of ``distributed_optimization_tpu/parallel/adversary.py``:

- **sign_flip**: send −scale·x_i;
- **large_noise**: send x_i + scale·N(0, I), the normal draw of
  ``jax.random.normal`` at ``fold_in(fold_in(key(seed), 0xBAD0), t)``,
  redrawn each iteration and shared by an iteration's gossip rounds; on a
  card one launch of ``ops/draw_kernels.large_noise``, on the CPU its
  plain twin;
- **alie** ("a little is enough"): the colluders all send the honest
  workers' per-coordinate mean − scale·std.

The Byzantine set is drawn on the host from the config seed
(``byzantine_mask``), bit for bit the JAX package's draw. The payload math
runs in promote(float32, dtype) and is cast back to the run dtype.

The replica axis (``torch_backend.run_batch``): given R seeds,
``make_adversary`` draws each replica's set and noise key from its own
seed and corrupts ``[R, N, d]`` stacks, each replica's as the single run
does (alie's honest mean and variance over its own worker axis; the noise
in one launch for all R).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from distributed_optimization_tpu_torch.backends.base import resolve_device
from distributed_optimization_tpu_torch.ops import draw_kernels, prng
from distributed_optimization_tpu_torch.ops.mixing import MixFn

# The stream tags the JAX package folds into the seed: of the Byzantine set,
# and of the large-noise draws.
_BYZ_SET_TAG = 0xB12A
_BYZ_NOISE_TAG = 0xBAD0


def byzantine_mask(n_workers: int, n_byzantine: int, seed: int) -> np.ndarray:
    """The static Byzantine set as a host [N] bool mask, drawn from
    ``default_rng([seed, tag])``."""
    if not 0 <= n_byzantine < n_workers:
        raise ValueError(
            f"n_byzantine must be in [0, n_workers), got {n_byzantine} "
            f"of {n_workers}"
        )
    mask = np.zeros(n_workers, dtype=bool)
    if n_byzantine > 0:
        rng = np.random.default_rng([seed, _BYZ_SET_TAG])
        mask[rng.choice(n_workers, size=n_byzantine, replace=False)] = True
    return mask


@dataclasses.dataclass(frozen=True)
class Adversary:
    """One attack bound to its Byzantine set. ``corrupt(x, t)`` replaces the
    Byzantine rows of the [N, d] stack with iteration t's payload (``t``,
    the run's int64 counter tensor, is read by ``large_noise`` alone);
    honest rows pass through. ``rows`` is the [N, 1] 0/1 Byzantine mask on
    the run device. On the replica axis: ``byzantine`` [R, N], ``rows``
    [R, N, 1], stacks [R, N, d]."""

    byzantine: np.ndarray  # host [N] bool ([R, N] on the replica axis)
    rows: torch.Tensor
    corrupt: Callable[..., torch.Tensor]

    @property
    def honest(self) -> np.ndarray:
        return ~self.byzantine


def make_adversary(
    n_workers: int,
    attack: str,
    n_byzantine: int,
    attack_scale: float,
    seed,
    *,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Optional[Adversary]:
    """The adversary of a config, or None when ``attack='none'``. ``cuda``
    raises when no card is visible. The large-noise key is
    ``key(seed, x64=dtype is float64)``, as a float64 run keys its streams.
    ``seed`` a sequence of R seeds gives the replica axis's adversary."""
    device = resolve_device(device)
    if attack == "none":
        return None
    if attack not in ("sign_flip", "large_noise", "alie"):
        raise ValueError(f"Unknown attack: {attack}")
    x64 = dtype == torch.float64
    if isinstance(seed, (list, tuple)):
        byz = np.stack([byzantine_mask(n_workers, n_byzantine, s) for s in seed])
        noise_key = prng.keys(seed, x64=x64, tags=(_BYZ_NOISE_TAG,), device=device)
    else:
        byz = byzantine_mask(n_workers, n_byzantine, seed)
        noise_key = prng.fold_in(prng.key(seed, x64=x64), _BYZ_NOISE_TAG)
    acc = torch.promote_types(torch.float32, dtype)
    m = torch.as_tensor(byz, dtype=acc, device=device)[..., None]
    h = 1.0 - m
    byz_u8 = torch.as_tensor(byz, dtype=torch.uint8, device=device)

    def corrupt(x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attack == "large_noise":
            if t is None:
                raise ValueError("large_noise draws at the iteration counter: pass t")
            return draw_kernels.large_noise(noise_key, t, byz_u8, x.to(acc).contiguous(),
                                            attack_scale).to(x.dtype)
        xa = x.to(acc)
        if attack == "sign_flip":
            payload = -attack_scale * xa
        else:  # alie, over each replica's worker axis (−2)
            n_honest = torch.sum(h, dim=-2)
            mu = torch.sum(xa * h, dim=-2) / n_honest
            var = torch.sum(h * (xa - mu[..., None, :]) ** 2, dim=-2) / n_honest
            payload = (mu - attack_scale * torch.sqrt(var))[..., None, :].expand_as(xa)
        return torch.where(m > 0, payload, xa).to(x.dtype)

    return Adversary(byzantine=byz, rows=m.to(dtype), corrupt=corrupt)


def make_byzantine_mixing(
    adversary: Optional[Adversary],
    base_mix: MixFn,
    aggregate: Optional[MixFn] = None,
    t: Optional[torch.Tensor] = None,
) -> MixFn:
    """Corruption and (robust) aggregation composed into one ``mix(x)`` for
    iteration ``t``.

    Honest rows take ``aggregate`` (the robust screen) of the corrupted
    stack, or ``base_mix`` of it when no rule is active. Byzantine rows
    keep ``base_mix`` of the true stack: an attacker runs honest dynamics
    and lies only on the wire.
    """
    screen = aggregate if aggregate is not None else base_mix

    def honest_view(x: torch.Tensor) -> torch.Tensor:
        return screen(adversary.corrupt(x, t) if adversary is not None else x)

    if adversary is None:
        return honest_view

    def mix(x: torch.Tensor) -> torch.Tensor:
        return torch.where(adversary.rows > 0, base_mix(x), honest_view(x))

    return mix
