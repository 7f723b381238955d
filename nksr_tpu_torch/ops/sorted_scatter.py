"""Sorted row scatter-add: CUDA kernels for Hopper, each beside its plain
PyTorch version.

Counterparts of the Pallas kernels of scripts/microbench_scatter.py, the
JAX package's study of the lattice CG adjoint's row stage (rows of ``w``
f32 lanes added into a dense per-cell table at sorted cell indices, as
``fields/lattice.py``'s ``apply_AT`` does into ``z0``):

- ``scatter_rate_write`` <- ``pallas_rate("write")``: one CTA's per-row
  update rate into a (bc, w) table;
- ``scatter_rate_read`` <- ``pallas_rate("read")``: one CTA's row-gather
  sum rate;
- ``blocked_sorted_scatter`` <- ``pallas_blocked``: the full scatter, one
  CTA per block of ``bc`` cells, with the host-built slot CSR of
  ``block_starts``.

The CUDA source is ``csrc/sorted_scatter.cu``; its header says what bounds
each kernel and how the design answers that.  Dispatch: a CPU tensor goes
to the plain version; a CUDA tensor launches the kernel or raises.  Each
wrapper counts its kernel launches in ``.launches``.  The kernels are built
at first use (``cuda_build.py``); nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build as CB

# shared memory a CTA may use (H100: 227 KB)
MAX_TILE_BYTES = 232448
# the tile of blocked_sorted_scatter on the card: 64 KiB, so three CTAs
# share an SM and one's zeroing overlaps another's adds and stores
CARD_TILE_BYTES = 65536


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
    lib.scatter_rate_write.argtypes = [p, p, p, i64, i32, i32, p]
    lib.scatter_rate_read.argtypes = [p, p, p, i64, i64, i32, p]
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


def scatter_rate_write(idx: torch.Tensor, y: torch.Tensor,
                       bc: int) -> torch.Tensor:
    """(bc, w) f32 = zeros((bc, w)).index_add_(0, idx, y) for ``idx``
    (n,) int32 sorted in [0, bc) and ``y`` (n, w) f32; one CTA, rows in
    order."""
    if y.device.type == "cpu":
        return scatter_rate_write_plain(idx, y, bc)
    _check_rows(idx, y, "scatter_rate_write", same_rows=True)
    out = torch.empty((bc, y.shape[1]), dtype=torch.float32,
                      device=y.device)
    rc = _lib().scatter_rate_write(idx.data_ptr(), y.data_ptr(),
                                   out.data_ptr(), y.shape[0], bc,
                                   y.shape[1], _stream(y))
    CB.raise_on(rc, "scatter_rate_write launch")
    scatter_rate_write.launches += 1
    return out


scatter_rate_write.launches = 0


def scatter_rate_read(idx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(1, w) f32 = y[idx].sum(0): the one row the TPU kernel writes; one
    CTA, summed in row order."""
    if y.device.type == "cpu":
        return scatter_rate_read_plain(idx, y)
    _check_rows(idx, y, "scatter_rate_read", same_rows=False)
    out = torch.empty((1, y.shape[1]), dtype=torch.float32, device=y.device)
    rc = _lib().scatter_rate_read(idx.data_ptr(), y.data_ptr(),
                                  out.data_ptr(), idx.shape[0], y.shape[0],
                                  y.shape[1], _stream(y))
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
