"""The fault timeline kernels' decomposition, held on the CPU.

On the card ``draw_kernels.fault_timeline`` unrolls each two-state chain as
a scan: every round is a map of {down, up} to itself drawn on its own (at
t = 0 both images are u >= init, after it up -> u >= enter and down -> u >=
stay), each tile of rounds is composed into a summary, the carry over the
tiles gives the state entering each tile, and an apply pass walks each
tile's rounds from it. ``draw_kernels._chains_scan`` is that decomposition
in torch ops, with the tile length as a parameter. Here it is held bit for
bit against the round-by-round ``_chains_plain`` on draws made with numpy
(thresholds 0.0 and 1.0 included, where a state sticks, and draws equal to
a threshold), and through ``fault_timeline_plain(tile=...)`` against the
JAX package's ``build_fault_timeline``: bursty edges at B = 1, 4 and 48,
churn, iid stragglers and participation, at horizons across the tile edges.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_optimization_tpu.parallel import build_topology as ref_build
from distributed_optimization_tpu.parallel import faults as ref_faults
from distributed_optimization_tpu_torch.ops import draw_kernels as dk
from distributed_optimization_tpu_torch.parallel import faults
from distributed_optimization_tpu_torch.parallel.topology import build_topology

HORIZONS = (1, 2, 31, 32, 33, 64, 1000)
TILES = (1, 32, 256)
# (init, enter, stay): a bursty chain, one that never leaves up, one that
# never leaves down, both states sticking, and a chain that flips each round.
THRESHOLDS = {
    "bursty": (0.3, 0.05, 0.9),
    "always_up": (0.0, 0.0, 0.0),
    "always_down": (1.0, 1.0, 1.0),
    "both_stick": (0.5, 0.0, 1.0),
    "flips": (0.4, 1.0, 0.0),
}
MODES = {
    "bursty_B1": dict(edge_drop_prob=0.3, burst_len=1.0),
    "bursty_B4": dict(edge_drop_prob=0.3, burst_len=4.0),
    "bursty_B48": dict(edge_drop_prob=0.3, burst_len=48.0),
    "churn": dict(mttf=8.0, mttr=3.0, edge_drop_prob=0.2, burst_len=2.0),
    "stragglers": dict(straggler_prob=0.2),
    "participation": dict(participation_rate=0.6, straggler_prob=0.1),
}
FIELDS = ("edge_up", "node_up", "rejoin", "part_up")


def _draws(horizon: int, m: int, thresholds) -> torch.Tensor:
    """float32 uniforms [T, M] from numpy, with some draws equal to a
    threshold so that the comparisons' ties are exercised."""
    rng = np.random.default_rng(horizon * 31 + m)
    u = rng.random((horizon, m)).astype(np.float32)
    ties = rng.random((horizon, m)) < 0.1
    picks = rng.integers(0, 3, (horizon, m))
    u[ties] = np.asarray(thresholds, dtype=np.float32)[picks[ties]]
    return torch.from_numpy(np.minimum(u, np.float32(1.0) - np.float32(2**-24)))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("horizon", HORIZONS)
@pytest.mark.parametrize("chain", sorted(THRESHOLDS))
def test_scan_is_the_round_by_round_chain(chain, horizon, tile):
    thresholds = THRESHOLDS[chain]
    u = _draws(horizon, 37, thresholds)
    want = dk._chains_plain(u, *thresholds)
    got = dk._chains_scan(u, *thresholds, tile=tile)
    assert got.dtype == torch.bool and got.shape == (horizon, 37)
    assert torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_timeline(mode: str, horizon: int):
    return ref_faults.build_fault_timeline(ref_build("ring", 12), horizon, 203, **MODES[mode])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("horizon", HORIZONS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_scan_timeline_is_the_jax_package_s(mode, horizon, tile):
    """The decomposition over tiles of ``tile`` rounds gives the JAX
    package's timeline, and the plain version's."""
    topo = build_topology("ring", 12)
    kw = dict(dict(edge_drop_prob=0.0, burst_len=1.0, straggler_prob=0.0, mttf=0.0, mttr=0.0,
                   participation_rate=1.0), **MODES[mode])
    args, _ = faults.timeline_args(topo, 203, device="cpu", x64=False, **kw)
    got = dk.fault_timeline_plain(horizon=horizon, device="cpu", tile=tile, **args)
    plain = dk.fault_timeline_plain(horizon=horizon, device="cpu", **args)
    want = _jax_timeline(mode, horizon)
    for field in FIELDS:
        a, b = got[field], getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), field
            assert torch.equal(a, plain[field]), field


@pytest.mark.parametrize("f", range(4))
@pytest.mark.parametrize("g", range(4))
def test_maps_compose_as_functions(f, g):
    """A map's bit x is its image of state x; ``_then(f, g)`` is g after f,
    and the identity is 2 (down -> down, up -> up)."""
    ft, gt = torch.tensor(f, dtype=torch.uint8), torch.tensor(g, dtype=torch.uint8)
    for state in (0, 1):
        st = torch.tensor(state, dtype=torch.uint8)
        assert dk._apply(dk._then(ft, gt), st) == dk._apply(gt, dk._apply(ft, st))
    identity = torch.tensor(dk._IDENTITY, dtype=torch.uint8)
    assert dk._then(ft, identity) == ft and dk._then(identity, ft) == ft
