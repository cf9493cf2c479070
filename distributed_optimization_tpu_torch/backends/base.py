"""Run-result container and device resolution shared by the port's entry
points (the port of ``distributed_optimization_tpu/backends/base.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_optimization_tpu_torch.metrics import RunHistory


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default of every
    entry point) raises when no card is visible: the port never carries on
    on the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev


@dataclasses.dataclass
class BackendRunResult:
    history: RunHistory
    final_models: np.ndarray  # [N, d] per-worker models after T iterations
    final_avg_model: np.ndarray  # [d] network average (the reported model)
    # Every leaf of the final state, on request (run(..., return_state=True)).
    final_state: dict | None = None

    @property
    def total_floats_transmitted(self) -> float:
        return self.history.total_floats_transmitted
