"""Fixed-order segment sum: a CUDA kernel for Hopper beside its plain
PyTorch version.

``segment_sum`` adds rows of ``values`` (R, C) f32 that share a target:
output row t is the sum of ``values[i]`` over every i with
``index[i] == t``, starting from 0.0 and adding the rows in ascending i.
That is bit for bit what CPU ``index_add_`` and ``np.add.at`` compute,
and what XLA's scatter-add computes on the CPU.  CUDA ``index_add_``
adds repeated indices with f32 atomics in no fixed order, so on the card
two runs on one input differ; this kernel replaces it wherever the port
meets repeated indices.

No TPU kernel is replaced: the kernel stands in for XLA's ordered
scatter-add ``z0.at[...].add`` (nksr_tpu/fields/lattice.py:1231-1234).
It moves data: R*C*4 bytes of rows read once and the output written
once bound it (``csrc/segment_sum.cu`` says how its design answers
that).

The order is data: ``segment_order`` sorts the targets stably (on the
card ``torch.sort(stable=True)``, which is deterministic) into a
``SegmentOrder``.  Where the targets are fixed for a whole solve, build
the order once and pass it to every call.  Entries with a negative
target are dropped.  Two output forms: dense (n_targets rows, the rows
of no segment zero) and compact (one row per distinct target, in the
order of ``SegmentOrder.targets``).

Dispatch: a CPU tensor goes to the plain version (CPU ``index_add_``); a
CUDA tensor launches the kernel or raises.  There is no fallback between
the two.  ``segment_sum.launches`` counts the kernel's launches.  The
kernel is built at first use (``cuda_build.py``); nothing is compiled
when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import cuda_build as CB

SOURCE = CB.CSRC / "segment_sum.cu"


class SegmentOrder(NamedTuple):
    """Fixed summation order of R entries over ``n_targets`` targets."""
    index: torch.Tensor    # (R,) int64 target of each entry, < 0 dropped
    perm: torch.Tensor     # (R,) int32 entries sorted by (target, entry)
    offsets: torch.Tensor  # (S + 1,) int32: segment s is perm[o[s]:o[s+1]]
    targets: torch.Tensor  # (S,) int64 distinct targets, ascending
    n_targets: int


def segment_order(index: torch.Tensor, n_targets: int) -> SegmentOrder:
    """The summation order of entries with targets ``index`` (R,) in
    ``[0, n_targets)``; negative targets are dropped.  Pure PyTorch on
    ``index``'s device (two host syncs: the segment count and the range
    check)."""
    idx = index.reshape(-1).long()
    r = idx.numel()
    if r >= 1 << 31:
        raise ValueError(f"segment_order: {r} entries exceed int32 "
                         "positions")
    key, perm = torch.sort(idx, stable=True)
    if r and int(key[-1]) >= n_targets:
        raise ValueError(f"segment_order: target {int(key[-1])} outside "
                         f"[0, {n_targets})")
    first = torch.ones(r, dtype=torch.bool, device=idx.device)
    first[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(first & (key >= 0))[:, 0]
    offsets = torch.cat([starts, starts.new_full((1,), r)])
    return SegmentOrder(idx, perm.to(torch.int32), offsets.to(torch.int32),
                        key[starts], int(n_targets))


# ------------------------------------------------------------ plain version
def segment_sum_plain(values: torch.Tensor, order: SegmentOrder,
                      compact: bool = False) -> torch.Tensor:
    """CPU ``index_add_`` in index order (on the CPU; on another device
    it is that device's ``index_add_``)."""
    keep = order.index >= 0
    tgt = order.index[keep]
    if compact:
        tgt = torch.searchsorted(order.targets, tgt)
    n = order.targets.numel() if compact else order.n_targets
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, tgt, values[keep])


# ------------------------------------------------------------------ wrappers
@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("segment_sum")
    lib.segment_sum.restype = ctypes.c_int
    p = ctypes.c_void_p
    lib.segment_sum.argtypes = [p, ctypes.c_int64, p, p, ctypes.c_int64, p,
                                p, ctypes.c_int, p]
    return lib


def _segment_sum(values: torch.Tensor, order: SegmentOrder,
                 compact: bool = False) -> torch.Tensor:
    if values.device.type == "cpu":
        return segment_sum_plain(values, order, compact)
    r = order.perm.shape[0]
    if values.dim() not in (1, 2) or values.shape[0] != r:
        raise ValueError(f"segment_sum: values {tuple(values.shape)} for "
                         f"{r} entries")
    v2 = values[:, None] if values.dim() == 1 else values
    c = v2.shape[1]
    CB.check_cuda(v2, (r, c), torch.float32, "segment_sum values", align=4)
    n_seg = order.targets.shape[0]
    CB.check_cuda(order.perm, (r,), torch.int32, "segment_sum perm",
                  align=4)
    CB.check_cuda(order.offsets, (n_seg + 1,), torch.int32,
                  "segment_sum offsets", align=4)
    CB.check_cuda(order.targets, (n_seg,), torch.int64,
                  "segment_sum targets", align=8)
    rows = n_seg if compact else order.n_targets
    out = (torch.empty if compact else torch.zeros)(
        (rows, c), dtype=torch.float32, device=values.device)
    if n_seg:
        vec4 = c % 4 == 0 and v2.data_ptr() % 16 == 0
        rc = _lib().segment_sum(
            v2.data_ptr(), c, order.perm.data_ptr(),
            order.offsets.data_ptr(), n_seg,
            None if compact else order.targets.data_ptr(), out.data_ptr(),
            int(vec4), torch.cuda.current_stream(values.device).cuda_stream)
        CB.raise_on(rc, "segment_sum launch")
        segment_sum.launches += 1
    return out.view(-1) if values.dim() == 1 else out


class _SegmentSum(torch.autograd.Function):
    """The sum, and its transpose as the backward: each entry reads the
    cotangent row of its target (zero where dropped), a gather with no
    repeated writes, so it is the same on every device and call."""

    @staticmethod
    def forward(ctx, values, order, compact):
        ctx.order, ctx.compact = order, compact
        ctx.shape = values.shape
        return _segment_sum(values, order, compact)

    @staticmethod
    def backward(ctx, grad):
        order = ctx.order
        keep = order.index >= 0
        tgt = order.index.clamp(min=0)
        if ctx.compact:
            tgt = torch.searchsorted(order.targets, tgt).clamp(
                max=max(order.targets.numel() - 1, 0))
        g = grad.reshape(grad.shape[0], -1)
        if g.shape[0] == 0:
            rows = g.new_zeros((tgt.numel(), g.shape[1]))
        else:
            rows = g.index_select(0, tgt)
        rows = torch.where(keep[:, None], rows, 0.0)
        return rows.reshape(ctx.shape), None, None


def segment_sum(values: torch.Tensor, order: SegmentOrder,
                compact: bool = False) -> torch.Tensor:
    """Sum the rows of ``values`` (R, C) or (R,) f32 by ``order``, each
    segment in ascending entry order from 0.0: dense (n_targets, C) or,
    with ``compact``, (S, C) rows of ``order.targets``.  Differentiable:
    the backward gathers the cotangent's rows (``_SegmentSum``)."""
    return _SegmentSum.apply(values, order, compact)


segment_sum.launches = 0


def index_sum(values: torch.Tensor, index: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """``zeros((n_rows,) + values.shape[1:]).index_add_(0, index, values)``
    with the entries of a negative index dropped, summed in index order on
    every device: CPU ``index_add_`` on the CPU, ``segment_sum`` over an
    order built for this call on the card."""
    if values.device.type == "cpu":
        keep = index >= 0
        return values.new_zeros((n_rows,) + values.shape[1:]).index_add_(
            0, index[keep], values[keep])
    return segment_sum(values.contiguous(), segment_order(index, n_rows))
