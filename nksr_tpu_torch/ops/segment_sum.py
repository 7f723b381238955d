"""Fixed-order segment sum: CUDA kernels for Hopper beside their plain
PyTorch versions.

``segment_sum`` adds rows of ``values`` (R, C) f32 that share a target:
output row t is the sum of ``values[i]`` over every i with
``index[i] == t``, starting from 0.0 and adding the rows in ascending i.
That is bit for bit what CPU ``index_add_`` and ``np.add.at`` compute,
and what XLA's scatter-add computes on the CPU.  CUDA ``index_add_``
adds repeated indices with f32 atomics in no fixed order, so on the card
two runs on one input differ; this kernel replaces it wherever the port
meets repeated indices.  Its backward (``segment_sum_backward``) is a
row gather, a second kernel.

No TPU kernel is replaced: the kernel stands in for XLA's ordered
scatter-add ``z0.at[...].add`` (nksr_tpu/fields/lattice.py:1231-1234).
It moves data: the kept rows read once and the output written once
bound it (``csrc/segment_sum.cu`` says how its designs answer that).

The order is data: ``segment_order`` sorts the targets stably (on the
card ``torch.sort(stable=True)``, which is deterministic) into a
``SegmentOrder`` with a run of entries for every target, found by
``searchsorted``: no count is read back, so building an order, summing
over it and back-propagating make no host sync.  Where the targets are
fixed (a step's index tables, a solve's supports), ``table_order``
keeps each table's order on the table, and ``segment_orders`` builds
many tables' orders in one sort (the gathers' forward notes its tables
with ``expect_order``, so a step's backward sorts them together).
Entries with a negative target are dropped.  Two output forms: dense (n_targets rows, the rows of no
segment zero) and compact (one row per distinct target, in the order of
``SegmentOrder.targets``, which reads the distinct targets back: no step
or lap takes it).

Dispatch: a CPU tensor goes to the plain version (CPU ``index_add_``); a
CUDA tensor launches the kernel or raises.  There is no fallback between
the two.  ``segment_sum.launches`` and ``segment_sum_backward.launches``
count the kernels' launches.  The kernels are built at first use
(``cuda_build.py``); nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import weakref
from typing import NamedTuple, Optional

import torch

from .. import cuda_build as CB

SOURCE = CB.CSRC / "segment_sum.cu"


class SegmentOrder(NamedTuple):
    """Fixed summation order of R entries over ``n_targets`` targets."""
    index: torch.Tensor    # (R,) int32 target of each entry, < 0 dropped
    perm: torch.Tensor     # int32 entries sorted by (target, entry): (R,),
    #                        or a batch's (``segment_orders``), each entry
    #                        by its position in its own table
    offsets: torch.Tensor  # (n_targets + 1,) int32: target t sums
    #                        perm[o[t]:o[t+1]]; the dropped entries lie
    #                        before o[0]
    n_targets: int

    @property
    def targets(self) -> torch.Tensor:
        """(S,) int64 distinct kept targets, ascending: the compact
        form's rows (reads their count back from the device)."""
        return torch.nonzero(self.offsets[1:] != self.offsets[:-1])[:, 0]


def segment_order(index: torch.Tensor, n_targets: int,
                  check: bool = True) -> SegmentOrder:
    """The summation order of entries with targets ``index`` (R,) in
    ``[0, n_targets)``; negative targets are dropped.  Pure PyTorch on
    ``index``'s device, no host sync unless ``check``, which reads the
    largest target back and raises if it is out of range; unchecked, an
    entry at or past ``n_targets`` is in no run, so the caller checks its
    table where that costs nothing (on the host, before the upload)."""
    idx = index.reshape(-1)
    r = idx.numel()
    if r >= 1 << 31 or n_targets >= 1 << 31:
        raise ValueError(f"segment_order: {r} entries onto {n_targets} "
                         "targets exceed int32 positions")
    if check and r and int(idx.max()) >= n_targets:
        raise ValueError(f"segment_order: target {int(idx.max())} outside "
                         f"[0, {n_targets})")
    # a copy: the order holds no view of the caller's table
    key = idx.to(torch.int32, copy=True)
    skey, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        skey, torch.arange(n_targets + 1, dtype=torch.int32,
                           device=idx.device), out_int32=True)
    return SegmentOrder(key, perm.to(torch.int32), offsets, int(n_targets))


def segment_orders(tables) -> list:
    """``segment_order(index, n, check=False)`` of each (index, n) of
    ``tables``, with one sort for all of them: each table's kept targets
    offset past the earlier tables' (an entry at or past its n dropped,
    as ``segment_order`` leaves it in no run), one stable sort, runs over
    all the targets, each entry's position within its own table.  No
    host sync: the tables' sizes go to the card in one pinned copy."""
    if len(tables) < 2:
        return [segment_order(i, n, False) for i, n in tables]
    idx = [i.reshape(-1) for i, _ in tables]
    ns = [int(n) for _, n in tables]
    sizes = [x.numel() for x in idx]
    total_n, total_r = sum(ns), sum(sizes)
    if total_n >= 1 << 31 or total_r >= 1 << 31:
        raise ValueError(f"segment_orders: {total_r} entries onto {total_n} "
                         "targets exceed int32 positions")
    dev = idx[0].device
    starts = [0] + list(itertools.accumulate(sizes))[:-1]
    bases = [0] + list(itertools.accumulate(ns))[:-1]
    meta = torch.tensor([sizes, ns, bases, starts], dtype=torch.int64)
    meta = meta.to(dev) if dev.type == "cpu" else \
        meta.pin_memory().to(dev, non_blocking=True)
    flat = torch.cat([x.long() for x in idx])
    tab = torch.repeat_interleave(
        torch.arange(len(tables), device=dev), meta[0], output_size=total_r)
    per = meta[1:, tab]                     # (3, R): n, base, start
    key = torch.where((flat >= 0) & (flat < per[0]), flat + per[1], -1)
    skey, perm = torch.sort(key.to(torch.int32), stable=True)
    offsets = torch.searchsorted(
        skey, torch.arange(total_n + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    local = (perm - per[2, perm]).to(torch.int32)
    raw = flat.to(torch.int32)
    return [SegmentOrder(raw[a:a + r], local, offsets[b:b + n + 1], n)
            for a, r, b, n in zip(starts, sizes, bases, ns)]


# tables whose orders a backward will ask for (``expect_order``): a weak
# reference to each one's root tensor, the view's layout and its target
# count, built in one sort at the first ``table_order`` that misses
_expected: list = []


def _slot(table: torch.Tensor, n: int):
    root = table if table._base is None else table._base
    orders = root.__dict__.setdefault("_segment_orders", {})
    return orders, (table.storage_offset(), tuple(table.shape),
                    table.stride(), n)


def expect_order(table: torch.Tensor, n: int) -> None:
    """Note that a backward will ask for ``table_order(table, n)``: the
    orders noted before the first such request that misses are built
    with it, in one sort (``segment_orders``)."""
    orders, key = _slot(table, n)
    hit = orders.get(key)
    if hit is None or hit[0] != table._version:
        if len(_expected) >= 1 << 12:     # no backward came: drop the dead
            _expected[:] = [e for e in _expected if e[0]() is not None]
        root = table if table._base is None else table._base
        _expected.append((weakref.ref(root), key))


def table_order(table: torch.Tensor, n: int) -> SegmentOrder:
    """``segment_order`` of ``table``'s entries onto ``n`` rows, unchecked
    (the caller checked the table on the host), kept on the table it
    reads (the root tensor of its views): a batch's tables and a solve's
    supports are fixed, so each part of one is sorted once and reused
    while the table lives and is not written to.  A miss builds every
    order noted by ``expect_order`` with it, in one sort."""
    orders, key = _slot(table, n)
    hit = orders.get(key)
    if hit is None or hit[0] != table._version:
        todo, seen = [(table, orders, key)], {(id(orders), key)}
        expected = _expected[:]
        del _expected[:len(expected)]
        for ref, k in expected:
            root = ref()
            if root is None:
                continue
            slot = root.__dict__.setdefault("_segment_orders", {})
            done = slot.get(k)
            if (id(slot), k) not in seen and (
                    done is None or done[0] != root._version):
                seen.add((id(slot), k))
                todo.append((root.as_strided(k[1], k[2], k[0]), slot, k))
        built = segment_orders([(t, k[3]) for t, _, k in todo])
        for (t, slot, k), order in zip(todo, built):
            slot[k] = (t._version, order)
        hit = orders[key]
    return hit[1]


# ----------------------------------------------------------- plain versions
def segment_sum_plain(values: torch.Tensor, order: SegmentOrder,
                      compact: bool = False) -> torch.Tensor:
    """CPU ``index_add_`` in index order (on the CPU; on another device
    it is that device's ``index_add_``)."""
    keep = order.index >= 0
    tgt = order.index[keep].long()
    if compact:
        targets = order.targets
        tgt = torch.searchsorted(targets, tgt)
        n = targets.numel()
    else:
        n = order.n_targets
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, tgt, values[keep])


def _grad_rows(order: SegmentOrder, compact: bool) -> torch.Tensor:
    """The cotangent row each entry reads: its target (dense) or its
    target's compact row, -1 where dropped."""
    if not compact:
        return order.index
    rank = torch.searchsorted(order.targets, order.index.long())
    return torch.where(order.index >= 0, rank, -1).to(torch.int32)


def segment_sum_backward_plain(grad: torch.Tensor, order: SegmentOrder,
                               compact: bool = False) -> torch.Tensor:
    """The sum's transpose: entry i reads the cotangent row of its target
    (zero where dropped), (R, *grad.shape[1:])."""
    src = _grad_rows(order, compact)
    g = grad.reshape(grad.shape[0], grad.shape[1:].numel())
    if g.shape[0] == 0:
        rows = g.new_zeros((src.numel(), g.shape[1]))
    else:
        rows = g.index_select(0, src.clamp(min=0))
    rows = torch.where((src >= 0)[:, None], rows, 0.0)
    return rows.reshape((src.numel(),) + grad.shape[1:])


# ------------------------------------------------------------------ wrappers
@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("segment_sum")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.segment_sum.restype = i32
    lib.segment_sum.argtypes = [p, i64, p, p, p, i64, p, i32, i32, p]
    lib.segment_sum_backward.restype = i32
    lib.segment_sum_backward.argtypes = [p, i64, p, i64, p, i32, p]
    return lib


def _stream(device: torch.device) -> int:
    """The raw pointer of ``device``'s current stream (one call, no Stream
    object: the wrapper's host time is most of a small sum's)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _rows_2d(t: torch.Tensor, r: int, name: str) -> torch.Tensor:
    """``t`` as (r, C) f32 rows on the card, or raise."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: expected a CUDA tensor, got {t.device} "
                           "(only CPU tensors take the plain version)")
    if t.dtype != torch.float32 or t.dim() not in (1, 2) \
            or t.shape[0] != r or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({r}, C) or ({r},) "
                         f"f32, got {tuple(t.shape)} {t.dtype}")
    return t[:, None] if t.dim() == 1 else t


def _check_order(order: SegmentOrder, device: torch.device) -> None:
    """Only what a call could get wrong cheaply: the order's device and
    types (its contents were made by ``segment_order``)."""
    if order.offsets.device != device:
        raise RuntimeError(f"segment_sum: expected a CUDA tensor, the order "
                           f"is on {order.offsets.device}")
    if order.perm.dtype != torch.int32 or order.offsets.dtype != torch.int32 \
            or order.index.dtype != torch.int32:
        raise ValueError("segment_sum: the order's index, perm and offsets "
                         "must be int32 (segment_order's)")


THREAD, WARP, TILE = 0, 1, 2
# the warp design up to this many output rows: past it the thread design
# has threads enough to hide its latency and the warp's shuffles cost
# more (PERF.md section 6 has the measured crossover)
WARP_MAX_ROWS = 1 << 14


def design(n_cols: int, n_rows: int, n_out: int,
           compact: bool = False) -> int:
    """The sum's design from its shape alone (``csrc/segment_sum.cu``):
    for rows of at most 32 lanes, a block a tile of rows where the targets
    are at least as many as the entries (dense form: most targets empty),
    a warp a row where the output rows are at most ``WARP_MAX_ROWS``;
    else a thread per (row, column group)."""
    if (n_cols // 4 if n_cols % 4 == 0 else n_cols) > 32:
        return THREAD
    if n_out >= n_rows and not compact:
        return TILE
    return WARP if n_out <= WARP_MAX_ROWS else THREAD


def _segment_sum(values: torch.Tensor, order: SegmentOrder,
                 compact: bool = False,
                 force: Optional[int] = None) -> torch.Tensor:
    """The sum without autograd; ``force`` a design (the timing studies
    and tests; None chooses by ``design``)."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, order, compact)
    r = order.index.shape[0]
    v2 = _rows_2d(values, r, "segment_sum values")
    _check_order(order, values.device)
    c = v2.shape[1]
    rows = order.targets if compact else None
    n_out = order.n_targets if rows is None else rows.shape[0]
    out = torch.empty((n_out, c), dtype=torch.float32, device=values.device)
    if n_out:
        how = design(c, r, n_out, compact) if force is None else force
        rc = _lib().segment_sum(
            v2.data_ptr(), c, order.perm.data_ptr(),
            order.offsets.data_ptr(), None if rows is None
            else rows.data_ptr(), n_out, out.data_ptr(),
            int(c % 4 == 0 and v2.data_ptr() % 16 == 0), how,
            _stream(values.device))
        CB.raise_on(rc, "segment_sum launch")
        segment_sum.launches += 1
    return out.view(-1) if values.dim() == 1 else out


def segment_sum_backward(grad: torch.Tensor, order: SegmentOrder,
                         compact: bool = False) -> torch.Tensor:
    """The transpose of ``segment_sum``: (R, *grad.shape[1:]), entry i the
    cotangent row of its target, zero where dropped; one row gather, the
    same on every device and call."""
    if grad.device.type == "cpu":
        return segment_sum_backward_plain(grad, order, compact)
    _check_order(order, grad.device)
    src = _grad_rows(order, compact)
    g = grad if grad.dim() == 2 else grad.reshape(
        grad.shape[0], grad.shape[1:].numel())
    g = _rows_2d(g.contiguous(), grad.shape[0], "segment_sum_backward grad")
    r, c = src.shape[0], g.shape[1]
    out = torch.empty((r, c), dtype=torch.float32, device=grad.device)
    if r and c:
        rc = _lib().segment_sum_backward(
            g.data_ptr(), c, src.data_ptr(), r, out.data_ptr(),
            int(c % 4 == 0 and g.data_ptr() % 16 == 0),
            _stream(grad.device))
        CB.raise_on(rc, "segment_sum_backward launch")
        segment_sum_backward.launches += 1
    return out if grad.dim() == 2 else out.reshape((r,) + grad.shape[1:])


segment_sum_backward.launches = 0


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
        g = segment_sum_backward(grad.contiguous(), ctx.order, ctx.compact)
        return g.reshape(ctx.shape), None, None


def segment_sum(values: torch.Tensor, order: SegmentOrder,
                compact: bool = False) -> torch.Tensor:
    """Sum the rows of ``values`` (R, C) or (R,) f32 by ``order``, each
    segment in ascending entry order from 0.0: dense (n_targets, C) or,
    with ``compact``, (S, C) rows of ``order.targets``.  Differentiable
    (``_SegmentSum``, whose backward is ``segment_sum_backward``) where
    ``values`` needs a gradient; else, as inside a backward, the kernel's
    call alone."""
    if values.requires_grad and torch.is_grad_enabled():
        return _SegmentSum.apply(values, order, compact)
    return _segment_sum(values, order, compact)


segment_sum.launches = 0


def index_sum(values: torch.Tensor, index: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """``zeros((n_rows,) + values.shape[1:]).index_add_(0, index, values)``
    with the entries of a negative index dropped, summed in index order on
    every device: CPU ``index_add_`` on the CPU, ``segment_sum`` over the
    order of ``index`` (``table_order``: unchecked, the caller's table
    being in range) on the card."""
    if values.device.type == "cpu":
        keep = index >= 0
        return values.new_zeros((n_rows,) + values.shape[1:]).index_add_(
            0, index[keep], values[keep])
    return segment_sum(values.contiguous(), table_order(index.reshape(-1),
                                                        n_rows))
