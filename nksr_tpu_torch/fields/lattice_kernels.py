"""The fused AV0 cascade and its adjoint: CUDA kernels for Hopper, each
beside its plain PyTorch version.

``av0_cascade`` replaces ``av0_cascade_pallas`` and
``av0_adjoint_cascade`` replaces ``av0_adjoint_cascade_pallas``
(nksr_tpu/fields/lattice_pallas.py, kernel bodies ``_kernel_fwd`` and
``_kernel_adj`` plus its halo fold).  ``av0_adjoint_rows`` replaces the
matvec's pair of the ordered scatter-add into the dense buffer
(nksr_tpu/fields/lattice.py ``apply_AT``, ``z0.at[...].add``) and
``av0_adjoint_cascade_pallas``: it reads the solve's slot rows in the
brick-major order that ``adjoint_rows_tables`` builds once per solve,
sums each cell's rows in slot order and folds them into the adjoint in
two stages over the occupied bricks and the coefficient tiles they feed.
``av0_rows`` replaces the matvec's pair of ``av0_cascade_pallas`` and the
sorted row gather (nksr_tpu/fields/lattice.py ``_take_rows_sorted``): it
computes AV0's rows at given depth-0 cells only, straight from the
coefficient lattices.  The CUDA source is ``csrc/av0_cascade.cu``; its
header says what bounds the kernels on the H100 and how their design
answers that.  In short: all of them only move data, so the forward
writes AV0 in output order, a z-line of depth-0 cells a CTA and whole
128 B lines a warp, with each coefficient row a thread's four cells read
loaded once; the row kernel is one coalesced write of the rows; and the
adjoint reads its input once, coalesced, in two stages (8^3 bricks fold
the ancestors of depths >= 1 into partials, then each coefficient sums
its 8 corners), with no atomics and a fixed order of every f32 sum.  The slot-row form folds
each cell's slot rows straight into its brick's partials and writes
+0.0 without reading anything where no occupied brick feeds a
coefficient tile.  It reads f32 in bf16 by rounding in registers, so the
solve hands it f32 sums with no cast.

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

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_build as CB

SOURCE = CB.CSRC / "av0_cascade.cu"
_MAX_DEPTH = 8
# the adjoint's stage-1 brick is 2^3 depth-0 cells a side (ADJ_LEVELS)
_BRICK_LEVELS = 3
_CORNERS = tuple((i, j, l) for i in (0, 1) for j in (0, 1) for l in (0, 1))
# the dense forward's grid takes the depth-0 x and y as its z and y
# extents (FWD_MAX_LINES)
_FWD_MAX_LINES = 65535


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
        ctypes.POINTER(_Av0Spec), ctypes.POINTER(_Av0AdjLayout), p, p, p, p,
        p, ctypes.c_int, p, p, p, p, p, p, ctypes.c_int, p]
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
    cells (``index``, point slots then gradient slots).  The kept slots
    are ordered brick-major: by 8^3 brick, then by the cell's depth-1
    group in its brick (4^3, row-major), then by the cell's child place
    in that group (x, y, z bits), then by slot.  One segment a distinct
    cell."""
    index: torch.Tensor       # (R,) int64 slot cells, -1 where dropped
    perm: torch.Tensor        # (R_kept,) int32 kept slots, brick-major
    seg_off: torch.Tensor     # (S + 1,) int32: cell s is perm[o[s]:o[s+1]]
    cells: torch.Tensor       # (S,) int64 the segments' depth-0 cells
    cell_row: torch.Tensor    # (cells_0,) int32 segment of a cell, else -1
    bricks: torch.Tensor      # (B,) int32 8^3 bricks holding a slot cell
    group_seg: torch.Tensor   # (64 bricks in the grid + 1,) int32 first
    #                           segment of each (brick, depth-1 group)
    brick_occ: torch.Tensor   # (bricks in the grid,) uint8, 1 at ``bricks``
    tile_live: torch.Tensor   # (tiles,) uint8 per depth, 8^3 coefficient
    #                           tiles whose corners read an occupied brick


def brick_grid(spec) -> Tuple[int, int, int]:
    """The adjoint's 8^3 bricks a side: ceil(dims_0 / 8)."""
    return tuple((n + (1 << _BRICK_LEVELS) - 1) >> _BRICK_LEVELS
                 for n in spec.dims[0])


def tile_grids(spec) -> Tuple[Tuple[int, int, int], ...]:
    """The 8^3 tiles of each depth's coefficient lattice a side: ceil(dims_d
    / 8).  ``AdjointRowsTables.tile_live`` lists them depth after depth."""
    return tuple(tuple((n + 7) >> 3 for n in spec.dims[d])
                 for d in range(spec.depth))


@functools.lru_cache(maxsize=8)
def _tile_boxes(spec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bricks under each 8^3 tile of each depth's coefficients
    (``tile_live``'s order) as a box over the brick grid: the flat indices
    of its 8 corners in the brick occupancy's prefix sums, padded by a
    leading zero plane on each side, and their signs; on ``device``, built
    once per spec and device.  Along a side, tile t's cells read the
    depth-d ancestors [8t - 1, min(8t + 8, dims_d)), over the depth-0
    cells [(8t - 1) 2^d, min(8t + 8, dims_d) 2^d) within the lattice, so
    the bricks [lo, hi) that hold those cells."""
    g = brick_grid(spec)
    lo = [[] for _ in range(3)]
    hi = [[] for _ in range(3)]
    for d, tg in enumerate(tile_grids(spec)):
        for a in range(3):
            t = np.arange(tg[a])
            first = (8 * t - 1) << d
            end = np.minimum(np.minimum(8 * t + 8, spec.dims[d][a]) << d,
                             spec.dims[0][a])
            b_lo = np.clip(first // 8, 0, g[a])
            b_hi = np.where(end > first, (end + 7) // 8, b_lo)
            shape = [1, 1, 1]
            shape[a] = -1
            for out, v in ((lo[a], b_lo), (hi[a], b_hi)):
                out.append(np.broadcast_to(v.reshape(shape), tg).ravel())
    lo = [np.concatenate(v) for v in lo]
    hi = [np.concatenate(v) for v in hi]
    idx, sign = [], []
    for corner in range(8):
        ix = [(hi if corner >> (2 - a) & 1 else lo)[a] for a in range(3)]
        idx.append(np.ravel_multi_index(ix, [n + 1 for n in g]))
        sign.append((-1) ** (3 - bin(corner).count("1")))
    return (torch.from_numpy(np.stack(idx)).to(device),
            torch.tensor(sign, device=device)[:, None])


def _tile_live(spec, occ: torch.Tensor) -> torch.Tensor:
    """uint8 per 8^3 tile of each depth's coefficients (depth after depth,
    z fastest): 1 where an occupied brick holds a depth-0 cell under an
    ancestor that a corner of the tile's cells reads (a box sum over the
    prefix sums of the brick occupancy ``occ``, (bricks a side) bool)."""
    idx, sign = _tile_boxes(spec, occ.device)
    c = F.pad(occ.int().cumsum(0).cumsum(1).cumsum(2), (1, 0, 1, 0, 1, 0))
    return ((c.reshape(-1)[idx] * sign).sum(0) > 0).to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _order_keys(spec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The brick-major sort key of a depth-0 cell (x, y, z), ((brick * 64
    + depth-1 group in the brick) * 8 + child place in the group), as the
    sum of a part of (x, y) and a part of z: (x0 * y0,) and (z0,) int32
    on ``device`` (built once per spec and device)."""
    x, y, z = (np.arange(n) for n in spec.dims[0])
    _, gy, gz = brick_grid(spec)
    kx = (x >> 3) * (gy * gz * 512) + (x & 7) // 2 * 128 + (x & 1) * 4
    ky = (y >> 3) * (gz * 512) + (y & 7) // 2 * 32 + (y & 1) * 2
    kz = (z >> 3) * 512 + (z & 7) // 2 * 8 + (z & 1)
    kxy = (kx[:, None] + ky[None, :]).reshape(-1)
    return (torch.from_numpy(kxy.astype(np.int32)).to(device),
            torch.from_numpy(kz.astype(np.int32)).to(device))


def adjoint_rows_tables(spec, slot_cells0: torch.Tensor
                        ) -> AdjointRowsTables:
    """The tables of ``av0_adjoint_rows`` for slot cells ``slot_cells0``
    (R,) in ``[0, cells_0)``, -1 for a slot whose row is dropped: the kept
    slots in brick-major order (a stable sort, so each cell keeps its slot
    order), the segment of each distinct cell, the map from cell to
    segment, the occupied bricks, the first segment of each brick's 64
    depth-1 groups, the brick occupancy and the live coefficient tiles.
    Pure PyTorch on the cells' device; built once per solve."""
    idx = slot_cells0.reshape(-1).long()
    n0 = spec.n_cells(0)
    gx, gy, gz = brick_grid(spec)
    if max(idx.numel(), 512 * gx * gy * gz) >= 1 << 31:
        raise ValueError(f"adjoint_rows_tables: {idx.numel()} slots or "
                         f"{gx * gy * gz} bricks exceed int32 keys")
    if idx.numel() and int(idx.max()) >= n0:
        raise ValueError(f"adjoint_rows_tables: cell {int(idx.max())} "
                         f"outside [0, {n0})")
    dev = idx.device
    kept = torch.nonzero(idx >= 0)[:, 0]
    cells = idx[kept]
    z0 = spec.dims[0][2]
    kxy, kz = _order_keys(spec, dev)
    key, order = torch.sort(kxy[cells // z0] + kz[cells % z0], stable=True)
    seg_key, counts = torch.unique_consecutive(key, return_counts=True)
    seg_off = F.pad(counts.cumsum(0), (1, 0))
    seg_cells = cells[order[seg_off[:-1]]]
    cell_row = torch.full((n0,), -1, dtype=torch.int32, device=dev)
    cell_row[seg_cells] = torch.arange(seg_cells.numel(), dtype=torch.int32,
                                       device=dev)
    brick_occ = torch.zeros(gx * gy * gz, dtype=torch.uint8, device=dev)
    brick_occ[seg_key >> 9] = 1
    group_seg = torch.searchsorted(
        seg_key >> 3, torch.arange(64 * gx * gy * gz + 1, dtype=torch.int32,
                                   device=dev), out_int32=True)
    return AdjointRowsTables(
        idx, kept[order].to(torch.int32), seg_off.to(torch.int32), seg_cells,
        cell_row, torch.nonzero(brick_occ)[:, 0].to(torch.int32), group_seg,
        brick_occ, _tile_live(spec, brick_occ.view(gx, gy, gz).bool()))


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
    keep = tables.index >= 0
    z0 = y.new_zeros((spec.n_cells(0), spec.lanes)).index_add_(
        0, tables.index[keep], y[keep])
    return av0_adjoint_cascade_plain(spec, z0, compute_dtype)


# ------------------------------------------------------------------ wrappers
def av0_cascade(spec, xs: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """Fused (cells_0, depth*8k) support buffer in ``dtype`` from the
    per-depth (n_d, k) f32 coefficient lattices ``xs``."""
    _check_dtype(dtype)
    if xs[0].device.type == "cpu":
        return av0_cascade_plain(spec, xs, dtype)
    cs = _c_spec(spec)
    x0, y0, _ = spec.dims[0]
    if max(x0, y0) > _FWD_MAX_LINES:
        raise ValueError(f"av0_cascade: depth-0 dims {spec.dims[0]} exceed "
                         f"the kernel's {_FWD_MAX_LINES} lines along x or y")
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
    r = tables.index.shape[0]
    CB.check_cuda(y, (r, spec.lanes), torch.float32, "av0_adjoint_rows y")
    n_seg = tables.cells.shape[0]
    n_bricks = tables.bricks.shape[0]
    gx, gy, gz = brick_grid(spec)
    n_grid = gx * gy * gz
    n_tiles = sum(a * b * c for a, b, c in tile_grids(spec))
    for name, t, shape, dt in (
            ("perm", tables.perm, (tables.perm.shape[0],), torch.int32),
            ("seg_off", tables.seg_off, (n_seg + 1,), torch.int32),
            ("cell_row", tables.cell_row, (spec.n_cells(0),), torch.int32),
            ("bricks", tables.bricks, (n_bricks,), torch.int32),
            ("group_seg", tables.group_seg, (64 * n_grid + 1,),
             torch.int32),
            ("brick_occ", tables.brick_occ, (n_grid,), torch.uint8),
            ("tile_live", tables.tile_live, (n_tiles,), torch.uint8)):
        CB.check_cuda(t, shape, dt, f"av0_adjoint_rows {name}",
                      align=dt.itemsize)
    lay, n_part = _adj_layout(spec)
    dev = y.device
    scratch = torch.empty((max(n_part, 1),), dtype=torch.float32, device=dev)
    d0 = torch.empty((max(n_seg, 1), 8 * spec.k), dtype=compute_dtype,
                     device=dev)
    outs = tuple(torch.empty((spec.n_cells(d), spec.k), dtype=torch.float32,
                             device=dev)
                 for d in range(spec.depth))
    ptrs = (ctypes.c_void_p * spec.depth)(*[o.data_ptr() for o in outs])
    rc = _lib().av0_cascade_adj_rows(
        ctypes.byref(cs), ctypes.byref(lay), y.data_ptr(),
        tables.perm.data_ptr(), tables.seg_off.data_ptr(),
        tables.cell_row.data_ptr(), tables.bricks.data_ptr(), n_bricks,
        tables.group_seg.data_ptr(), tables.brick_occ.data_ptr(),
        tables.tile_live.data_ptr(), d0.data_ptr(), scratch.data_ptr(), ptrs,
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    CB.raise_on(rc, "av0_cascade_adj_rows launch")
    av0_adjoint_rows.launches += 1
    return outs


av0_adjoint_rows.launches = 0
