"""Sorted row scatter-add: CUDA kernels for Hopper, each beside its plain
PyTorch version.

Counterparts of the Pallas kernels of scripts/microbench_scatter.py, the
JAX package's study of the lattice CG adjoint's row stage (rows of ``w``
f32 lanes added into a dense per-cell table at sorted cell indices, as
``fields/lattice.py``'s ``apply_AT`` does into ``z0``):

- ``scatter_rate_write`` <- ``pallas_rate("write")``: the sorted row
  update into a (bc, w) table, ``zeros.index_add_(0, idx, y)``;
- ``scatter_rate_read`` <- ``pallas_rate("read")``: the row-gather sum
  ``y[idx].sum(0)``;
- ``blocked_sorted_scatter`` <- ``pallas_blocked``: the full scatter, one
  CTA per block of ``bc`` cells, with the host-built slot CSR of
  ``block_starts``.

The TPU study ran both rate kernels on ``grid=(1,)`` on one TPU v5e chip,
whose single TensorCore that grid filled: the whole chip, timed per row.
Their kernels here use the whole card in the same way.
``scatter_rate_write`` is a grid over tiles of cells
(``rate_write_tiles``), each CTA finding its rows in the sorted indices
and summing each cell's rows in row order, so it equals CPU
``index_add_`` bit for bit.  ``scatter_rate_read`` takes fixed slices of
the indices (``rate_read_slices``), a partial row each, folded in a
fixed order by a second launch, so two calls are bit-equal.
Bytes bound both, and at the study's shape one launch costs more than
its bound.  The CUDA source is ``csrc/sorted_scatter.cu``; its header
says what bounds each kernel and how the design answers that.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its calls that launch in
``.launches``.  The kernels are built at first use (``cuda_build.py``);
nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .. import cuda_build as CB

# shared memory a CTA may use (H100: 227 KB)
MAX_TILE_BYTES = 232448
# the tile of blocked_sorted_scatter on the card: 64 KiB, so three CTAs
# share an SM and one's zeroing overlaps another's adds and stores
CARD_TILE_BYTES = 65536


# threads a CTA of the rate kernels and cells a CTA of the write at most
# (RATE_THREADS, RATE_MAX_CELLS in csrc/sorted_scatter.cu)
RATE_THREADS = 256
RATE_MAX_CELLS = 2048
# the write's grid: one (cell, column group) a thread up to this many CTAs,
# then more a thread
WRITE_CTAS = 1024
# scatter_rate_read's slices: at least this many indices a CTA, and at
# most this many CTAs (the partial rows its second launch folds)
READ_MIN_ROWS = 128
READ_MAX_CTAS = 512


def column_groups(w: int, vec4: bool) -> int:
    """Column groups of a row of ``w`` f32 lanes: float4s, or floats."""
    return w // 4 if vec4 else w


def rate_write_tiles(bc: int, nv: int) -> Tuple[int, int]:
    """(cells a CTA, CTAs) of ``scatter_rate_write`` on a (bc, w) table
    whose rows are ``nv`` column groups: as many cells as give each of
    RATE_THREADS threads one (cell, column group), at least one cell, or
    a multiple of that where the grid would pass WRITE_CTAS, up to
    RATE_MAX_CELLS; CTA k owns cells [k * cells, min((k + 1) * cells,
    bc))."""
    base = max(1, RATE_THREADS // nv)
    k = max(1, -(-bc // (base * WRITE_CTAS)))
    cells = min(base * k, max(base, RATE_MAX_CELLS // base * base))
    return cells, -(-bc // cells)


def rate_read_slices(n: int) -> Tuple[int, int]:
    """(indices a CTA, CTAs) of ``scatter_rate_read`` over ``n`` indices:
    CTA s sums indices [s * rows, min((s + 1) * rows, n)); one CTA when
    n = 0."""
    rows = max(READ_MIN_ROWS, -(-n // READ_MAX_CTAS))
    return rows, max(1, -(-n // rows))


def card_block_cells(w: int) -> int:
    """Cells per CTA of ``blocked_sorted_scatter`` on the card: a 64 KiB
    (bc, w) f32 tile (bc 512 at w = 32, 128 at w = 128)."""
    return CARD_TILE_BYTES // (4 * w)


def block_starts(idx: np.ndarray, n_cells: int, bc: int) -> np.ndarray:
    """Slot CSR of sorted cell indices over blocks of ``bc`` cells:
    (nb + 1,) int32, block b's rows are ``starts[b]:starts[b + 1]``."""
    nb = (n_cells + bc - 1) // bc
    counts = np.bincount(np.asarray(idx) // bc, minlength=nb)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return starts.astype(np.int32)


# ------------------------------------------------------------ plain versions
def scatter_rate_write_plain(idx: torch.Tensor, y: torch.Tensor,
                             bc: int) -> torch.Tensor:
    return torch.zeros((bc, y.shape[1]), dtype=torch.float32,
                       device=y.device).index_add_(0, idx.long(), y)


def scatter_rate_read_plain(idx: torch.Tensor, y: torch.Tensor
                            ) -> torch.Tensor:
    return y.index_select(0, idx.long()).sum(0, keepdim=True)


def blocked_sorted_scatter_plain(y: torch.Tensor, idx: torch.Tensor,
                                 starts: torch.Tensor, n_cells: int,
                                 bc: int) -> torch.Tensor:
    nb = (n_cells + bc - 1) // bc
    return torch.zeros((nb * bc, y.shape[1]), dtype=torch.float32,
                       device=y.device).index_add_(0, idx.long(), y)


# ------------------------------------------------------------------ wrappers
@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("sorted_scatter")
    i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.scatter_rate_write.argtypes = [p, p, p, i64, i32, i32, i32,
                                       ctypes.c_int, p]
    lib.scatter_rate_read.argtypes = [p, p, p, p, i64, i64, i32, i64, i64,
                                      ctypes.c_int, p]
    lib.blocked_sorted_scatter.argtypes = [p, p, p, p, i64, i32, i32, p]
    for fn in (lib.scatter_rate_write, lib.scatter_rate_read,
               lib.blocked_sorted_scatter):
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(idx: torch.Tensor, y: torch.Tensor, name: str,
                same_rows: bool) -> None:
    """idx (n,) int32 and y (m, w) f32 on the card; m == n where each row
    of y goes to one index."""
    if idx.dim() != 1 or y.dim() != 2 or (same_rows
                                          and idx.shape[0] != y.shape[0]):
        raise ValueError(f"{name}: expected idx (n,) and y (n, w), got "
                         f"{tuple(idx.shape)} and {tuple(y.shape)}")
    CB.check_cuda(idx, idx.shape, torch.int32, f"{name} idx", align=4)
    CB.check_cuda(y, y.shape, torch.float32, f"{name} y", align=4)


def _vec4(y: torch.Tensor) -> bool:
    """float4 column groups: rows a multiple of 4 lanes, 16 B aligned."""
    return y.shape[1] % 4 == 0 and y.data_ptr() % 16 == 0


def scatter_rate_write(idx: torch.Tensor, y: torch.Tensor,
                       bc: int) -> torch.Tensor:
    """(bc, w) f32 = zeros((bc, w)).index_add_(0, idx, y) for ``idx``
    (n,) int32 sorted in [0, bc) and ``y`` (n, w) f32; on the card bit for
    bit CPU ``index_add_``, rows with an index outside [0, bc) dropped."""
    if y.device.type == "cpu":
        return scatter_rate_write_plain(idx, y, bc)
    _check_rows(idx, y, "scatter_rate_write", same_rows=True)
    w = y.shape[1]
    out = torch.empty((bc, w), dtype=torch.float32, device=y.device)
    if bc == 0 or w == 0:
        return out
    vec4 = _vec4(y)
    cells, _ = rate_write_tiles(bc, column_groups(w, vec4))
    rc = _lib().scatter_rate_write(idx.data_ptr(), y.data_ptr(),
                                   out.data_ptr(), y.shape[0], bc, w, cells,
                                   int(vec4), _stream(y))
    CB.raise_on(rc, "scatter_rate_write launch")
    scatter_rate_write.launches += 1
    return out


scatter_rate_write.launches = 0


def scatter_rate_read(idx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(1, w) f32 = y[idx].sum(0): the one row the TPU kernel writes; on
    the card an index outside [0, len(y)) is dropped, and the sum's order
    is fixed by len(idx) and w."""
    if y.device.type == "cpu":
        return scatter_rate_read_plain(idx, y)
    _check_rows(idx, y, "scatter_rate_read", same_rows=False)
    w = y.shape[1]
    out = torch.empty((1, w), dtype=torch.float32, device=y.device)
    if w == 0:
        return out
    rows, ctas = rate_read_slices(idx.shape[0])
    partials = torch.empty((ctas, w), dtype=torch.float32, device=y.device)
    rc = _lib().scatter_rate_read(idx.data_ptr(), y.data_ptr(),
                                  partials.data_ptr(), out.data_ptr(),
                                  idx.shape[0], y.shape[0], w, rows, ctas,
                                  int(_vec4(y)), _stream(y))
    CB.raise_on(rc, "scatter_rate_read launch")
    scatter_rate_read.launches += 1
    return out


scatter_rate_read.launches = 0


def blocked_sorted_scatter(y: torch.Tensor, idx: torch.Tensor,
                           starts: torch.Tensor, n_cells: int,
                           bc: int) -> torch.Tensor:
    """(nb * bc, w) f32 = zeros.index_add_(0, idx, y), nb = ceil(n_cells /
    bc), for ``idx`` (S,) int32 sorted in [0, n_cells) and ``starts`` =
    ``block_starts(idx, n_cells, bc)``.  The values do not depend on
    ``bc``; on the card it is the CTA's tile (``card_block_cells``)."""
    if y.device.type == "cpu":
        return blocked_sorted_scatter_plain(y, idx, starts, n_cells, bc)
    nb = (n_cells + bc - 1) // bc
    w = y.shape[1]
    _check_rows(idx, y, "blocked_sorted_scatter", same_rows=True)
    CB.check_cuda(starts, (nb + 1,), torch.int32,
                  "blocked_sorted_scatter starts", align=4)
    if w % 4 or not 0 < bc * w * 4 <= MAX_TILE_BYTES:
        raise ValueError(f"blocked_sorted_scatter: w {w} must be a multiple "
                         f"of 4 and the ({bc}, {w}) f32 tile must fit "
                         f"{MAX_TILE_BYTES} B of shared memory")
    out = torch.empty((nb * bc, w), dtype=torch.float32, device=y.device)
    if nb == 0:
        return out
    rc = _lib().blocked_sorted_scatter(y.data_ptr(), idx.data_ptr(),
                                       starts.data_ptr(), out.data_ptr(), nb,
                                       bc, w, _stream(y))
    CB.raise_on(rc, "blocked_sorted_scatter launch")
    blocked_sorted_scatter.launches += 1
    return out


blocked_sorted_scatter.launches = 0
