"""Kernel probes: 17 tiny CUDA kernels for Hopper, each beside its plain
PyTorch version.

Counterparts of the Pallas probes of scripts/probe_mosaic.py (11 bodies of
``probe``) and scripts/probe_mosaic_cascade.py (bisect probes 0-5).  On
the TPU each probe asked whether Mosaic compiled one feature of the
lattice kernels; on the card each is a kernel that computes the probe's
function at the probe's shapes (``csrc/probes.cu``), so the kernel build
checks the index arithmetic those features stand for.  Bisect probes 6-8
call the cascade kernels themselves; their counterparts are
``fields/lattice_kernels.py`` at the same specs
(``scripts/probe_kernels.py``).

Each ``Probe`` is called like a function.  Dispatch: CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.  Each probe counts
its kernel launches in ``.launches``.  ``launch_floor`` launches an empty
kernel, the yardstick of what one launch costs.  The kernels are built
at first use (``cuda_build.py``); nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import cuda_build as CB


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("probes")
    for p in PROBES:
        fn = getattr(lib, f"probe_{p.key}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4
    lib.launch_floor.restype = ctypes.c_int
    lib.launch_floor.argtypes = [ctypes.c_void_p]
    return lib


def launch_floor(device: torch.device) -> None:
    """Launch ``csrc/probes.cu``'s empty kernel on ``device``'s current
    stream: the launch floor, timed beside every kernel as that kernel is
    timed.  It computes nothing, so on the CPU there is nothing to do."""
    device = torch.device(device)
    if device.type == "cpu":
        return
    rc = _lib().launch_floor(torch.cuda.current_stream(device).cuda_stream)
    CB.raise_on(rc, "launch_floor launch")


@dataclass(eq=False)
class Probe:
    key: str                 # C entry point probe_<key> in csrc/probes.cu
    name: str                # the TPU script's line label
    replaces: str            # file:line of the TPU probe's kernel
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_shape: Tuple[int, ...]
    fill: str                # the TPU script's input: "arange" or "ones"
    plain: Callable          # plain PyTorch version
    exact: bool = True       # False where f32 sums may differ in order
    ops: int = 0             # f32 operations of one call
    reads: Optional[int] = None   # input elements one call needs; None: all
    launches: int = field(default=0, compare=False)

    def __call__(self, *ins: torch.Tensor) -> torch.Tensor:
        if ins[0].device.type == "cpu":
            return self.plain(*ins)
        for t, shape in zip(ins, self.in_shapes):
            CB.check_cuda(t, shape, torch.float32, f"probe {self.key}",
                          align=4)
        out = torch.empty(self.out_shape, dtype=torch.float32,
                          device=ins[0].device)
        z = ins[1].data_ptr() if len(ins) > 1 else None
        rc = getattr(_lib(), f"probe_{self.key}")(
            ins[0].data_ptr(), z, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
        CB.raise_on(rc, f"probe_{self.key} launch")
        self.launches += 1
        return out

    def n_bytes(self) -> int:
        """Bytes one call must move: each input element it needs read once
        and each output element written once, in f32."""
        reads = (self.reads if self.reads is not None else
                 sum(int(np.prod(s)) for s in self.in_shapes))
        return 4 * (reads + int(np.prod(self.out_shape)))

    def inputs(self, kind: str, rng: np.random.Generator):
        """numpy inputs: the TPU script's own (``kind="script"``) or
        uniform in [-1000, 1000), so that a wrong index and the dynamic
        shifts show (``kind="random"``)."""
        out = []
        for shape in self.in_shapes:
            if kind == "random":
                out.append(rng.uniform(-1000, 1000, shape).astype(np.float32))
            elif self.fill == "ones":
                out.append(np.ones(shape, np.float32))
            else:
                out.append(np.arange(np.prod(shape), dtype=np.float32)
                           .reshape(shape))
        return out


def _t_shift4(a):
    return torch.cat([a[:, 4:], torch.roll(a, -1, 0)[:, :4]], 1)


def _t_dyn_lane_roll(a):
    # np.roll(a, int(a[0, 0]) % 128, 1), the shift taken on the device
    s = a[0, 0].long() % 128
    return a.index_select(1, (torch.arange(128, device=a.device) - s) % 128)


def _t_dyn_row(a):
    # a[int(a[0, 0]) % 64][None], the row taken on the device
    return a.index_select(0, a[0, 0].long().reshape(1) % 64)


def _t_shifted_blocks(a):
    return torch.cat([a[8 * (x >> 1):8 * (x >> 1) + 8] + 1.0
                      for x in range(4)])


def _t_window_dot(a, z):
    return torch.stack([torch.matmul(torch.cat(
        [a[x + i, j:j + 8, :] for i in (0, 1) for j in (0, 1)], -1), z)
        for x in (0, 1)])


def _t_pair(a):
    return torch.repeat_interleave(a, 2, 0)


_PM = "scripts/probe_mosaic.py"
_PC = "scripts/probe_mosaic_cascade.py"

PROBES: Tuple[Probe, ...] = (
    Probe("pack", "reshape (256,32)->(64,128) [pack]", f"{_PM}:43",
          ((256, 32),), (64, 128), "arange", lambda a: a.reshape(64, 128)),
    Probe("unpack", "reshape (64,128)->(256,32) [unpack]", f"{_PM}:49",
          ((64, 128),), (256, 32), "arange", lambda a: a.reshape(256, 32)),
    Probe("flat_to_2d", "reshape (8192,)->(64,128)", f"{_PM}:55",
          ((8192,),), (64, 128), "arange", lambda a: a.reshape(64, 128)),
    Probe("strided_rows", "strided rows a[0::2] (256,128)", f"{_PM}:61",
          ((256, 128),), (128, 128), "arange", lambda a: a[0::2],
          reads=128 * 128),
    Probe("lane_reverse", "static lane permute take(axis=1)", f"{_PM}:67",
          ((64, 128),), (64, 128), "arange", lambda a: torch.flip(a, (1,))),
    Probe("shift4", "lane slice+concat shift-4", f"{_PM}:74",
          ((64, 128),), (64, 128), "arange", _t_shift4),
    Probe("dyn_lane_roll", "pltpu.roll dynamic lanes", f"{_PM}:81",
          ((64, 128),), (64, 128), "arange", _t_dyn_lane_roll),
    Probe("lead_sum", "reshape (256,128)->(8,32,128)+sum", f"{_PM}:87",
          ((256, 128),), (8, 128), "arange",
          lambda a: a.reshape(8, 32, 128).sum(1), exact=False,
          ops=8 * 31 * 128),
    Probe("pair_replicate", "row pair-replicate via bcast+reshape",
          f"{_PM}:93", ((64, 128),), (128, 128), "arange", _t_pair),
    Probe("strided_row_write", "strided row write o[0::2]", f"{_PM}:101",
          ((128, 128),), (256, 128), "arange", _t_pair),
    Probe("dyn_row", "dynamic row read", f"{_PM}:108",
          ((64, 128),), (1, 128), "arange", _t_dyn_row, reads=1 + 128),
    Probe("times2", "warmup trivial kernel", f"{_PC}:45",
          ((8, 128),), (8, 128), "ones", lambda a: a * 2.0, ops=8 * 128),
    Probe("grid_accumulate", "3-D grid + pl.when + out accumulation",
          f"{_PC}:60", ((16, 128),), (16, 128), "ones",
          lambda a: a * 1.0 + a, ops=2 * 16 * 128),
    Probe("element_blocks", "pl.Element block dims + element index map",
          f"{_PC}:73", ((12, 128),), (16, 128), "ones",
          lambda a: torch.cat([a[0:8], a[4:12]]) * 2.0, ops=16 * 128),
    Probe("shifted_blocks", "index map with x >> 1", f"{_PC}:87",
          ((16, 128),), (32, 128), "ones", _t_shifted_blocks,
          ops=32 * 128),
    # reads a[0:3, 0:9, :] of the (3, 17, 32) input, and all of z
    Probe("window_dot", "3-D window slices + concat + dot_general",
          f"{_PC}:106", ((3, 17, 32), (128, 128)), (2, 8, 128), "ones",
          _t_window_dot, exact=False, ops=2 * 2 * 8 * 128 * 128,
          reads=3 * 9 * 32 + 128 * 128),
    Probe("row_replicate", "broadcast_to + reshape row-replicate",
          f"{_PC}:125", ((8, 128),), (16, 128), "ones", _t_pair),
)


def agree(got: np.ndarray, want: np.ndarray, exact: bool):
    """(ok, max abs difference) under the probe's bound: exact, or rtol
    1e-5 and atol 1e-5 of the largest value (f32 sums in another
    order)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if got.shape != want.shape:
        return False, float("inf")
    diff = np.abs(got - want)
    err = float(np.max(diff, initial=0.0))
    if exact:
        return err == 0.0, err
    tol = 1e-5 * np.abs(want) + 1e-5 * float(np.max(np.abs(want)))
    return bool(np.all(diff <= tol)), err
