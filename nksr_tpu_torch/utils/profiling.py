"""Phase timing on the host clock, with the device drained at each lap;
device time of short kernels from one CUDA graph; the least time a
kernel's work could take on an H100."""

from __future__ import annotations

import time
import warnings
from typing import Dict

import torch

# H100 SXM data-sheet peaks: HBM bytes and f32 operations per millisecond
HBM_B_PER_MS = 3.35e12 / 1e3
F32_OP_PER_MS = 67e12 / 1e3


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


_DEMOTIONS_LOGGED = set()


def log_engine_demotion(wanted: str, got: str, why: str) -> None:
    """One notice a process on stderr that an engine handed its work to
    another (the JAX package's ``log_engine_demotion``): the sharded
    solve or mesher to the single-device one."""
    if (wanted, got) in _DEMOTIONS_LOGGED:
        return
    _DEMOTIONS_LOGGED.add((wanted, got))
    import sys
    print(f"[nksr_tpu_torch] engine demotion: {wanted} -> {got} ({why})",
          file=sys.stderr, flush=True)


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` on the current CUDA device,
    the host's dispatch taken out: ``reps`` calls captured in one CUDA
    graph, one replay timed with CUDA events after a warm-up replay.  For
    kernels of a few microseconds, where CUDA events around back-to-back
    calls would read the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        # the plain version of a reshape or a slice is a view: no device
        # work, so its graph is empty
        warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work on an H100: bytes over the HBM rate or f32
    operations over the f32 peak, whichever is larger; and which one
    bounds it ("bytes" or "operations")."""
    tb, to = n_bytes / HBM_B_PER_MS, n_ops / F32_OP_PER_MS
    return (tb, "bytes") if tb >= to else (to, "operations")
