"""The fused AV0 cascade and its adjoint: CUDA kernels for Hopper, each
beside its plain PyTorch version.

``av0_cascade`` replaces ``av0_cascade_pallas`` and
``av0_adjoint_cascade`` replaces ``av0_adjoint_cascade_pallas``
(nksr_tpu/fields/lattice_pallas.py, kernel bodies ``_kernel_fwd`` and
``_kernel_adj`` plus its halo fold).  ``av0_adjoint_rows`` replaces the
matvec's pair of the ordered scatter-add into the dense buffer
(nksr_tpu/fields/lattice.py ``apply_AT``, ``z0.at[...].add``) and
``av0_adjoint_cascade_pallas``: it reads the solve's slot rows and the
order tables ``adjoint_rows_tables`` builds once per solve, sums each
cell's rows in a fixed order (``ops/segment_sum.py``) and runs the
adjoint's two stages over the occupied cells and bricks only.
``av0_rows`` replaces the matvec's pair of ``av0_cascade_pallas`` and the
sorted row gather (nksr_tpu/fields/lattice.py ``_take_rows_sorted``): it
computes AV0's rows at given depth-0 cells only, straight from the
coefficient lattices.  The CUDA source is ``csrc/av0_cascade.cu``; its
header says what bounds the kernels on the H100 and how their design
answers that.  In short: all of them only move data, so the forward is
one coalesced write of AV0 with L2-served coefficient reads, the row
kernel one coalesced write of the rows, and the adjoint reads its input
once, coalesced, in two stages (8^3 bricks fold the ancestors of depths
>= 1 into partials, then one thread per coefficient sums its 8 corners),
with no atomics and a fixed order of every f32 sum; the slot-row form
runs the same stages over the occupied bricks, through a cell map.  It
reads f32 in bf16 by rounding in registers, so the solve hands it f32
sums with no cast.

Semantics (per depth d, corner (i, j, l), lane group g = 8d + 4i + 2j + l):
``AV0[x, y, z, g*k + kk] = coeff_d[(x>>d)+i, (y>>d)+j, (z>>d)+l, kk]``
with zero past the lattice edge, as the Pallas kernel zero-fills.  The
XLA cascade the JAX package runs by default wraps its flat-stride
windows into the next row instead (nksr_tpu/fields/lattice.py
``_corner_cat``); the two agree on every cell a solve can reach, because
``plan_lattice`` keeps a >= 2-cell inactive margin.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback between the two.  Each
wrapper counts its kernel launches in ``.launches``.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``nksr_tpu_torch/_build/`` (``cuda_build.py``: a plain-C shared library
loaded with ctypes); nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import cuda_build as CB
from ..ops import segment_sum as SEG

SOURCE = CB.CSRC / "av0_cascade.cu"
_MAX_DEPTH = 8
# the adjoint's stage-1 brick is 2^3 depth-0 cells a side (ADJ_LEVELS)
_BRICK_LEVELS = 3
_CORNERS = tuple((i, j, l) for i in (0, 1) for j in (0, 1) for l in (0, 1))


class _Av0Spec(ctypes.Structure):
    _fields_ = [("depth", ctypes.c_int32), ("k", ctypes.c_int32),
                ("dims", (ctypes.c_int32 * 3) * _MAX_DEPTH)]


class _Av0AdjLayout(ctypes.Structure):
    _fields_ = [("grid", (ctypes.c_int32 * 3) * _MAX_DEPTH),
                ("offset", ctypes.c_int64 * _MAX_DEPTH)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("av0_cascade")
    lib.av0_cascade_fwd.restype = ctypes.c_int
    lib.av0_cascade_fwd.argtypes = [
        ctypes.POINTER(_Av0Spec), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.av0_rows.restype = ctypes.c_int
    lib.av0_rows.argtypes = [
        ctypes.POINTER(_Av0Spec), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.av0_cascade_adj.restype = ctypes.c_int
    lib.av0_cascade_adj.argtypes = [
        ctypes.POINTER(_Av0Spec), ctypes.POINTER(_Av0AdjLayout),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    p = ctypes.c_void_p
    lib.av0_cascade_adj_rows.restype = ctypes.c_int
    lib.av0_cascade_adj_rows.argtypes = [
        ctypes.POINTER(_Av0Spec), ctypes.POINTER(_Av0AdjLayout), p, p, p,
        ctypes.c_int, p, p, p, ctypes.c_int, p]
    return lib


def _c_spec(spec) -> _Av0Spec:
    if not 1 <= spec.depth <= _MAX_DEPTH:
        raise ValueError(f"depth {spec.depth} outside 1..{_MAX_DEPTH}")
    if spec.k not in (1, 2, 4, 8):
        raise ValueError(f"kernel_dim {spec.k} not in (1, 2, 4, 8)")
    s = _Av0Spec(depth=spec.depth, k=spec.k)
    for d in range(spec.depth):
        for a in range(3):
            s.dims[d][a] = int(spec.dims[d][a])
    return s


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cascade dtype {dtype} not float32/bfloat16")


def adjoint_partials(spec) -> Tuple[Tuple[Tuple[Tuple[int, int, int], int],
                                          ...], int]:
    """Layout of the adjoint kernel's stage-1 partials.  For each depth
    d >= 1: the grid of its groups of 2^min(d, 3) depth-0 cells a side
    (``ceil(dims_0 / 2^min(d, 3))``: every depth-d ancestor for d <= 3,
    every 8^3 brick above) and the float offset of its rows, 8k f32 a
    group, in one scratch buffer.  Returns (((grid, offset) for d = 1 ..
    depth-1), buffer length in floats)."""
    parts, total = [], 0
    for d in range(1, spec.depth):
        g = min(d, _BRICK_LEVELS)
        grid = tuple((n + (1 << g) - 1) >> g for n in spec.dims[0])
        parts.append((grid, total))
        total += grid[0] * grid[1] * grid[2] * 8 * spec.k
    return tuple(parts), total


class AdjointRowsTables(NamedTuple):
    """Once-per-solve tables of ``av0_adjoint_rows`` for the solve's slot
    cells (``order.index``, point slots then gradient slots)."""
    order: SEG.SegmentOrder   # merge order of the slot rows by depth-0
    #                           cell; order.targets: the distinct cells
    cell_row: torch.Tensor    # (cells_0,) int32 compact row, -1 elsewhere
    bricks: torch.Tensor      # (B,) int32 8^3 bricks holding a slot cell
    brick_occ: torch.Tensor   # (bricks in the grid,) uint8, 1 at ``bricks``


def brick_grid(spec) -> Tuple[int, int, int]:
    """The adjoint's 8^3 bricks a side: ceil(dims_0 / 8)."""
    return tuple((n + (1 << _BRICK_LEVELS) - 1) >> _BRICK_LEVELS
                 for n in spec.dims[0])


def adjoint_rows_tables(spec, slot_cells0: torch.Tensor
                        ) -> AdjointRowsTables:
    """The order tables of ``av0_adjoint_rows`` for slot cells
    ``slot_cells0`` (R,) in ``[0, cells_0)``, -1 for a slot whose row is
    dropped: the stable merge order by cell, the distinct cells and
    segment offsets (``segment_order``), the dense map from cell to
    compact row and the occupied bricks.  Pure PyTorch on the cells'
    device; built once per solve."""
    n0 = spec.n_cells(0)
    order = SEG.segment_order(slot_cells0, n0)
    cells = order.targets
    dev = cells.device
    cell_row = torch.full((n0,), -1, dtype=torch.int32, device=dev)
    cell_row[cells] = torch.arange(cells.numel(), dtype=torch.int32,
                                   device=dev)
    _, y0, z0 = spec.dims[0]
    gx, gy, gz = brick_grid(spec)
    cz, cxy = cells % z0, cells // z0
    cy, cx = cxy % y0, cxy // y0
    sh = _BRICK_LEVELS
    brick = ((cx >> sh) * gy + (cy >> sh)) * gz + (cz >> sh)
    brick_occ = torch.zeros(gx * gy * gz, dtype=torch.uint8, device=dev)
    brick_occ[brick] = 1
    bricks = torch.nonzero(brick_occ)[:, 0].to(torch.int32)
    return AdjointRowsTables(order, cell_row, bricks, brick_occ)


# ------------------------------------------------------------ plain versions
def _ancestor_index(n0: int, d: int, corner: int, device) -> torch.Tensor:
    return (torch.arange(n0, device=device) >> d) + corner


def _padded_extent(n0: int, nd: int, d: int) -> int:
    """Coarse extent that holds every (x >> d) + 1 read for x < n0."""
    return max(nd, ((n0 - 1) >> d) + 1) + 1


def av0_cascade_plain(spec, xs: Sequence[torch.Tensor],
                      dtype) -> torch.Tensor:
    """Plain PyTorch forward: padded indexing per depth and corner."""
    x0, y0, z0 = spec.dims[0]
    k, depth = spec.k, spec.depth
    dev = xs[0].device
    out = torch.empty((x0, y0, z0, depth, 8, k), dtype=dtype, device=dev)
    for d in range(depth):
        xd, yd, zd = spec.dims[d]
        px, py, pz = (_padded_extent(n, m, d) for n, m in
                      zip(spec.dims[0], spec.dims[d]))
        cp = F.pad(xs[d].reshape(xd, yd, zd, k),
                   (0, 0, 0, pz - zd, 0, py - yd, 0, px - xd))
        for c, (i, j, l) in enumerate(_CORNERS):
            sel = cp.index_select(0, _ancestor_index(x0, d, i, dev))
            sel = sel.index_select(1, _ancestor_index(y0, d, j, dev))
            sel = sel.index_select(2, _ancestor_index(z0, d, l, dev))
            out[:, :, :, d, c] = sel.to(dtype)
    return out.reshape(spec.n_cells(0), spec.lanes)


def av0_rows_plain(spec, xs: Sequence[torch.Tensor], cells0: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Plain PyTorch slot rows: per depth and corner, index each row's
    ancestor coefficient row, zero past the lattice edge; no dense
    buffer.  Equal to ``av0_cascade_plain(spec, xs, dtype)[cells0]
    .float()`` for cells in ``[0, cells_0)``; other cells give zero
    rows, as in the kernel."""
    _check_dtype(dtype)
    x0, y0, z0 = spec.dims[0]
    c = cells0.long()
    inside = (c >= 0) & (c < spec.n_cells(0))
    c = torch.where(inside, c, 0)
    cz, cxy = c % z0, c // z0
    cy, cx = cxy % y0, cxy // y0
    out = torch.empty((c.shape[0], spec.depth, 8, spec.k),
                      dtype=torch.float32, device=c.device)
    for d in range(spec.depth):
        xd, yd, zd = spec.dims[d]
        for g, (i, j, l) in enumerate(_CORNERS):
            ax, ay, az = (cx >> d) + i, (cy >> d) + j, (cz >> d) + l
            ok = inside & (ax < xd) & (ay < yd) & (az < zd)
            flat = torch.where(ok, (ax * yd + ay) * zd + az, 0)
            v = torch.where(ok[:, None], xs[d].index_select(0, flat), 0.0)
            out[:, d, g] = v.to(dtype).float()
    return out.reshape(c.shape[0], spec.lanes)


def av0_adjoint_cascade_plain(spec, z0_buf: torch.Tensor,
                              compute_dtype) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch adjoint: the exact transpose of
    ``av0_cascade_plain`` (index_add_ along each axis, then the crop that
    drops contributions from beyond the lattice edge).  ``z0_buf`` is
    read in ``compute_dtype``; sums are f32."""
    x0, y0, z0 = spec.dims[0]
    k, depth = spec.k, spec.depth
    dev = z0_buf.device
    zz = z0_buf.to(compute_dtype).float().reshape(x0, y0, z0, depth, 8, k)
    outs = []
    for d in range(depth):
        xd, yd, zd = spec.dims[d]
        px, py, pz = (_padded_extent(n, m, d) for n, m in
                      zip(spec.dims[0], spec.dims[d]))
        acc = torch.zeros((px, py, pz, k), dtype=torch.float32, device=dev)
        for c, (i, j, l) in enumerate(_CORNERS):
            blk = zz[:, :, :, d, c]
            a = torch.zeros((px, y0, z0, k), device=dev).index_add_(
                0, _ancestor_index(x0, d, i, dev), blk)
            b = torch.zeros((px, py, z0, k), device=dev).index_add_(
                1, _ancestor_index(y0, d, j, dev), a)
            acc += torch.zeros((px, py, pz, k), device=dev).index_add_(
                2, _ancestor_index(z0, d, l, dev), b)
        outs.append(acc[:xd, :yd, :zd].reshape(xd * yd * zd, k))
    return tuple(outs)


def av0_adjoint_rows_plain(spec, tables: AdjointRowsTables,
                           y: torch.Tensor, compute_dtype
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch slot-row adjoint: the dense chain, ``zeros((cells_0,
    lanes)).index_add_(0, cells, y)`` over the kept slots (each cell's
    rows summed in slot order from 0.0 on the CPU), then
    ``av0_adjoint_cascade_plain``."""
    z0 = SEG.segment_sum_plain(y, tables.order)
    return av0_adjoint_cascade_plain(spec, z0, compute_dtype)


# ------------------------------------------------------------------ wrappers
def av0_cascade(spec, xs: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """Fused (cells_0, depth*8k) support buffer in ``dtype`` from the
    per-depth (n_d, k) f32 coefficient lattices ``xs``."""
    _check_dtype(dtype)
    if xs[0].device.type == "cpu":
        return av0_cascade_plain(spec, xs, dtype)
    cs = _c_spec(spec)
    for d in range(spec.depth):
        CB.check_cuda(xs[d], (spec.n_cells(d), spec.k), torch.float32,
                    f"av0_cascade xs[{d}]")
    out = torch.empty((spec.n_cells(0), spec.lanes), dtype=dtype,
                      device=xs[0].device)
    ptrs = (ctypes.c_void_p * spec.depth)(*[x.data_ptr() for x in xs])
    rc = _lib().av0_cascade_fwd(
        ctypes.byref(cs), ptrs, out.data_ptr(),
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(out.device).cuda_stream)
    CB.raise_on(rc, "av0_cascade_fwd launch")
    av0_cascade.launches += 1
    return out


av0_cascade.launches = 0


def av0_rows(spec, xs: Sequence[torch.Tensor], cells0: torch.Tensor,
             dtype) -> torch.Tensor:
    """AV0's rows at the depth-0 cells ``cells0`` (R,) int32, computed
    from the per-depth (n_d, k) f32 coefficient lattices ``xs``: (R,
    depth*8k) f32 holding values rounded to ``dtype``, bit-equal to
    ``av0_cascade(spec, xs, dtype)[cells0].float()``."""
    _check_dtype(dtype)
    if xs[0].device.type == "cpu":
        return av0_rows_plain(spec, xs, cells0, dtype)
    cs = _c_spec(spec)
    for d in range(spec.depth):
        CB.check_cuda(xs[d], (spec.n_cells(d), spec.k), torch.float32,
                      f"av0_rows xs[{d}]")
    rows = cells0.shape[0] if cells0.dim() else -1
    CB.check_cuda(cells0, (rows,), torch.int32, "av0_rows cells0", align=4)
    if rows * spec.depth * 8 >= 1 << 31:
        raise ValueError(f"av0_rows: {rows} rows exceed 32-bit thread "
                         "indices")
    out = torch.empty((rows, spec.lanes), dtype=torch.float32,
                      device=xs[0].device)
    if rows == 0:
        return out
    ptrs = (ctypes.c_void_p * spec.depth)(*[x.data_ptr() for x in xs])
    rc = _lib().av0_rows(
        ctypes.byref(cs), ptrs, cells0.data_ptr(), rows, out.data_ptr(),
        int(dtype == torch.bfloat16),
        torch.cuda.current_stream(out.device).cuda_stream)
    CB.raise_on(rc, "av0_rows launch")
    av0_rows.launches += 1
    return out


av0_rows.launches = 0


def _adj_layout(spec) -> Tuple[_Av0AdjLayout, int]:
    parts, n_part = adjoint_partials(spec)
    lay = _Av0AdjLayout()
    for d, (grid, offset) in enumerate(parts, start=1):
        for a in range(3):
            lay.grid[d][a] = grid[a]
        lay.offset[d] = offset
    return lay, n_part


def av0_adjoint_cascade(spec, z0_buf: torch.Tensor,
                        compute_dtype) -> Tuple[torch.Tensor, ...]:
    """Adjoint of ``av0_cascade``: (cells_0, depth*8k) -> per-depth
    (n_d, k) f32.  ``z0_buf`` (f32 or bf16) is read in ``compute_dtype``:
    an f32 buffer with a bf16 compute dtype is rounded to bf16 as it is
    read, as the Pallas adjoint does; sums are f32."""
    _check_dtype(compute_dtype)
    if z0_buf.device.type == "cpu":
        return av0_adjoint_cascade_plain(spec, z0_buf, compute_dtype)
    cs = _c_spec(spec)
    _check_dtype(z0_buf.dtype)
    CB.check_cuda(z0_buf, (spec.n_cells(0), spec.lanes), z0_buf.dtype,
                  "av0_adjoint_cascade z0")
    lay, n_part = _adj_layout(spec)
    dev = z0_buf.device
    scratch = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    outs = tuple(torch.empty((spec.n_cells(d), spec.k), dtype=torch.float32,
                             device=dev)
                 for d in range(spec.depth))
    ptrs = (ctypes.c_void_p * spec.depth)(*[o.data_ptr() for o in outs])
    in_bf16 = z0_buf.dtype == torch.bfloat16
    rc = _lib().av0_cascade_adj(
        ctypes.byref(cs), ctypes.byref(lay), z0_buf.data_ptr(),
        scratch.data_ptr(), ptrs, int(in_bf16),
        int(compute_dtype == torch.bfloat16 and not in_bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    CB.raise_on(rc, "av0_cascade_adj launch")
    av0_adjoint_cascade.launches += 1
    return outs


av0_adjoint_cascade.launches = 0


def av0_adjoint_rows(spec, tables: AdjointRowsTables, y: torch.Tensor,
                     compute_dtype) -> Tuple[torch.Tensor, ...]:
    """Adjoint of ``av0_cascade`` on the dense buffer that the slot rows
    ``y`` (R, depth*8k) f32 sum into at the slot cells of ``tables``
    (a dropped slot's row is not read), without that buffer: equal to
    ``av0_adjoint_cascade(spec, zeros.index_add_(0, cells, y),
    compute_dtype)`` with the CPU's index-order sums, bit for bit up to
    the sign of a zero.  Each cell's summed row is read in
    ``compute_dtype`` (rounded once, never row by row); sums are f32.
    Returns per-depth (n_d, k) f32."""
    _check_dtype(compute_dtype)
    if y.device.type == "cpu":
        return av0_adjoint_rows_plain(spec, tables, y, compute_dtype)
    cs = _c_spec(spec)
    r = tables.order.perm.shape[0]
    CB.check_cuda(y, (r, spec.lanes), torch.float32, "av0_adjoint_rows y")
    n0 = spec.n_cells(0)
    CB.check_cuda(tables.cell_row, (n0,), torch.int32,
                  "av0_adjoint_rows cell_row", align=4)
    gx, gy, gz = brick_grid(spec)
    CB.check_cuda(tables.brick_occ, (gx * gy * gz,), torch.uint8,
                  "av0_adjoint_rows brick_occ", align=1)
    n_bricks = tables.bricks.shape[0] if tables.bricks.dim() else -1
    CB.check_cuda(tables.bricks, (n_bricks,), torch.int32,
                  "av0_adjoint_rows bricks", align=4)
    rows = SEG.segment_sum(y, tables.order, compact=True)
    lay, n_part = _adj_layout(spec)
    dev = y.device
    scratch = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    outs = tuple(torch.empty((spec.n_cells(d), spec.k), dtype=torch.float32,
                             device=dev)
                 for d in range(spec.depth))
    ptrs = (ctypes.c_void_p * spec.depth)(*[o.data_ptr() for o in outs])
    rc = _lib().av0_cascade_adj_rows(
        ctypes.byref(cs), ctypes.byref(lay), rows.data_ptr(),
        tables.cell_row.data_ptr(), tables.bricks.data_ptr(), n_bricks,
        tables.brick_occ.data_ptr(), scratch.data_ptr(), ptrs,
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    CB.raise_on(rc, "av0_cascade_adj_rows launch")
    av0_adjoint_rows.launches += 1
    return outs


av0_adjoint_rows.launches = 0
