"""The fused AV0 cascade and its adjoint: CUDA kernels for Hopper, each
beside its plain PyTorch version.

``av0_cascade`` replaces ``av0_cascade_pallas`` and
``av0_adjoint_cascade`` replaces ``av0_adjoint_cascade_pallas``
(nksr_tpu/fields/lattice_pallas.py, kernel bodies ``_kernel_fwd`` and
``_kernel_adj`` plus its halo fold).  The CUDA source is
``csrc/av0_cascade.cu``; its header says what bounds the kernels on the
H100 and how their design answers that.  In short: both only move data,
so the forward is one coalesced write of AV0 with L2-served coefficient
reads, and the adjoint is a gather with one read of AV0, no atomics and
a deterministic f32 sum.

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
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import cuda_build as CB

SOURCE = CB.CSRC / "av0_cascade.cu"
_MAX_DEPTH = 8
_CORNERS = tuple((i, j, l) for i in (0, 1) for j in (0, 1) for l in (0, 1))


class _Av0Spec(ctypes.Structure):
    _fields_ = [("depth", ctypes.c_int32), ("k", ctypes.c_int32),
                ("dims", (ctypes.c_int32 * 3) * _MAX_DEPTH)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("av0_cascade")
    for fn in (lib.av0_cascade_fwd, lib.av0_cascade_adj):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Av0Spec), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
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


def av0_adjoint_cascade(spec, z0_buf: torch.Tensor,
                        compute_dtype) -> Tuple[torch.Tensor, ...]:
    """Adjoint of ``av0_cascade``: (cells_0, depth*8k) -> per-depth
    (n_d, k) f32.  ``z0_buf`` is read in ``compute_dtype`` (bf16 halves
    the dominant read, as the Pallas adjoint does); sums are f32."""
    _check_dtype(compute_dtype)
    if z0_buf.device.type == "cpu":
        return av0_adjoint_cascade_plain(spec, z0_buf, compute_dtype)
    cs = _c_spec(spec)
    if z0_buf.dtype != compute_dtype:
        z0_buf = z0_buf.to(compute_dtype)
    CB.check_cuda(z0_buf, (spec.n_cells(0), spec.lanes), compute_dtype,
                "av0_adjoint_cascade z0")
    outs = tuple(torch.empty((spec.n_cells(d), spec.k), dtype=torch.float32,
                             device=z0_buf.device)
                 for d in range(spec.depth))
    ptrs = (ctypes.c_void_p * spec.depth)(*[o.data_ptr() for o in outs])
    rc = _lib().av0_cascade_adj(
        ctypes.byref(cs), z0_buf.data_ptr(), ptrs,
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(z0_buf.device).cuda_stream)
    CB.raise_on(rc, "av0_cascade_adj launch")
    av0_adjoint_cascade.launches += 1
    return outs


av0_adjoint_cascade.launches = 0
