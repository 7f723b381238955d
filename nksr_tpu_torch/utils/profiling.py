"""Phase timing on the host clock, with the device drained at each lap."""

from __future__ import annotations

import time
from typing import Dict

import torch


class PhaseTimer:
    """Records seconds per named phase into ``times``.  On a CUDA device
    each lap first waits for the queued device work, so a phase is
    charged for its own kernels.  With ``accumulate``, a phase that
    recurs (a loop's body) sums its laps."""

    def __init__(self, device: torch.device, times: Dict[str, float],
                 accumulate: bool = False):
        self.device = torch.device(device)
        self.times = times
        self.accumulate = accumulate
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        prev = self.times.get(name, 0.0) if self.accumulate else 0.0
        self.times[name] = prev + t - self._t
        self._t = t
