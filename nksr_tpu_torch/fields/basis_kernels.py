"""The fused basis evaluation of the lattice routes: two CUDA kernels for
Hopper beside their plain PyTorch versions.

``basis_rows`` writes the lattice solve's basis rows (the point rows of
all points and depths in one launch, the gradient rows of all slots in
one more); ``basis_field`` evaluates the solved field, value and
gradient, for one wave of queries in one launch.  Per (query, corner,
depth) both compute, in registers, the local offset, the corner's
feature row, the interpolator MLP (with its three forward tangents where
the gradient needs them), the C1 window and its gradient: the work that
the Pallas kernel ``window_and_grad_fused`` (nksr_tpu/ops/pallas/
window_basis.py) sits inside.  The CUDA source is ``csrc/basis_eval.cu``;
its header says what bounds the kernels (operations) and how the design
answers that.  The standalone window kernel (``ops/window_basis.py``)
stays on the support-row paths.

``basis_rows_plain`` and ``basis_field_plain`` are the row assembly of
``nksr_tpu.fields.lattice`` and the query waves of
``nksr_tpu.fields.lattice_eval``.  Their divisions by a voxel size go
through a divisor on the tensor's device (``_div``): CUDA turns a division
by a host scalar into a multiplication by its reciprocal, which can move
``floor`` across a cell boundary (``core/grid.world_to_grid``).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback between the two.  The kernels
have no backward: with grad enabled, an input or an MLP parameter that
requires grad raises, on either device.  Each wrapper counts its kernel
launches in ``.launches``.  The kernels are built at first use
(``cuda_build.py``); nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cuda_build as CB
from ..models.network import Interpolators, mlp_with_tangents

SOURCE = CB.CSRC / "basis_eval.cu"
_MAX_DEPTH = 8
_MAX_K = 8
# the kernels' padded hidden widths (template instances)
_HIDDEN = (16, 32)

CORNER_OFFS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                       -1).reshape(8, 3).astype(np.float32)


# ------------------------------------------------------ shared primitives
def corner_rows(tabp: torch.Tensor, cells: torch.Tensor, spec, d: int
                ) -> torch.Tensor:
    """(C,) flat cells -> (C, 8, v) rows of their 8 cell corners: corner c
    of cell m is row ``m + stride_c`` of the padded table, exactly the
    rows ``_corner_cat`` of the JAX package materializes."""
    strides = torch.tensor(spec.corner_strides(d), device=cells.device)
    return tabp[cells[:, None] + strides]


def window_grad(t: torch.Tensor):
    """C1 bump window prod (1-t_a^2)^2 and its gradient, (..., 3)."""
    u = torch.clamp(1.0 - t * t, min=0.0)
    u2 = u * u
    w = u2.prod(-1)
    du = -4.0 * t * u
    g = torch.stack([du[..., a] * u2[..., (a + 1) % 3] * u2[..., (a + 2) % 3]
                     for a in range(3)], -1)
    return w, g


def _div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` correctly rounded on any device: the divisor is a tensor
    on ``t``'s device (``core/grid.world_to_grid``)."""
    return t / t.new_full((), s)


def query_cells0(x: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Depth-0 integer cells ``floor(x / voxel_size)`` (int64) of (n, 3)
    f32 queries, the division correctly rounded."""
    return torch.floor(_div(x, voxel_size)).long()


# --------------------------------------------------------- weight packing
class PackedMLP(NamedTuple):
    """Every depth's interpolator MLP in one contiguous f32 buffer, the
    kernels' layout: per depth ``stride`` floats holding W0^T (n_in, H),
    b0 (H), then per middle layer W^T (H, H) and b (H), then Wo^T (H, k)
    and bo (k), zero-padded to a multiple of 4.  Hidden widths are
    zero-padded to ``hidden`` (16 or 32): a padded unit's
    pre-activation is 0, its SiLU 0, and its outgoing weights 0."""
    buf: torch.Tensor
    dims: Tuple[int, ...]       # (n_in, hidden widths ..., k), unpadded
    hidden: int
    stride: int

    @property
    def n_mid(self) -> int:
        return len(self.dims) - 3


def _layout(dims: Sequence[int], hidden: int) -> Tuple[List[Tuple[int, int,
                                                                  int]], int]:
    """Offsets of each layer's (W^T, b) in a depth's block: [(w_off,
    rows, cols)], with b right after its W^T, and the block's padded
    length."""
    n_in, k = dims[0], dims[-1]
    shapes = [(n_in, hidden)] + [(hidden, hidden)] * (len(dims) - 3) + \
        [(hidden, k)]
    out, off = [], 0
    for rows, cols in shapes:
        out.append((off, rows, cols))
        off += rows * cols + cols
    return out, (off + 3) // 4 * 4


def pack_mlps(interp: Interpolators, depth: int) -> PackedMLP:
    """Pack ``interp``'s depth MLPs on their device (one zero fill and a
    copy a tensor; no host sync)."""
    mlps = [interp.level(d).layers() for d in range(depth)]
    dims = (mlps[0][0].in_features,) + tuple(l.out_features for l in mlps[0])
    for layers in mlps:
        got = (layers[0].in_features,) + tuple(l.out_features
                                               for l in layers)
        if got != dims:
            raise ValueError(f"basis MLPs differ by depth: {got} != {dims}")
    if len(dims) < 3:
        raise ValueError(f"basis MLP {dims} has no hidden layer")
    widest = max(dims[1:-1])
    hidden = next((h for h in _HIDDEN if widest <= h), None)
    if hidden is None:
        raise ValueError(f"basis MLP hidden width {widest} over "
                         f"{_HIDDEN[-1]}")
    if not 1 <= dims[-1] <= _MAX_K:
        raise ValueError(f"kernel_dim {dims[-1]} outside 1..{_MAX_K}")
    lay, stride = _layout(dims, hidden)
    w0 = mlps[0][0].weight
    buf = torch.zeros(depth * stride, dtype=torch.float32, device=w0.device)
    for d, layers in enumerate(mlps):
        base = d * stride
        for (off, rows, cols), layer in zip(lay, layers):
            o = base + off
            wt = buf[o:o + rows * cols].view(rows, cols)
            wt[:layer.in_features, :layer.out_features].copy_(
                layer.weight.detach().T)
            buf[o + rows * cols:o + rows * cols + layer.out_features].copy_(
                layer.bias.detach())
    return PackedMLP(buf, dims, hidden, stride)


def unpack_mlp(packed: PackedMLP, d: int) -> List[Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """Depth ``d``'s (weight, bias) pairs, in ``nn.Linear``'s shapes,
    read back from the packed buffer."""
    lay, _ = _layout(packed.dims, packed.hidden)
    base = d * packed.stride
    out = []
    for (off, rows, cols), (n_in, n_out) in zip(
            lay, zip(packed.dims[:-1], packed.dims[1:])):
        o = base + off
        wt = packed.buf[o:o + rows * cols].view(rows, cols)
        out.append((wt[:n_in, :n_out].T,
                    packed.buf[o + rows * cols:o + rows * cols + n_out]))
    return out


def mlp_flops(packed: PackedMLP, tangents: bool) -> int:
    """f32 operations of one (query, corner, depth) MLP evaluation in the
    kernels (an FMA 2, a SiLU 5: negation, exp, add, reciprocal,
    multiply), with the three forward tangents when ``tangents`` (a
    tangent FMA 2 and a SiLU derivative 4 plus 3 multiplies)."""
    dims = packed.dims
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    units = sum(dims[1:-1])
    ops = 2 * macs + dims[-1] + 5 * units + 1 + 3 * dims[-1]
    if tangents:
        tan_macs = macs - dims[0] * dims[1]
        ops += 3 * 2 * tan_macs + units * (4 + 3)
    return ops


def _refuse_grad(name: str, tensors, interp: Interpolators) -> None:
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors) or any(
            p.requires_grad for p in interp.parameters()):
        raise ValueError(f"{name}: an input or an MLP parameter requires "
                         "grad, and the fused basis kernels have no "
                         "backward (call under torch.no_grad(), or freeze "
                         "the network)")


# ---------------------------------------------------------------- ctypes
class _Geom(ctypes.Structure):
    _fields_ = [("depth", ctypes.c_int32), ("k", ctypes.c_int32),
                ("cb", ctypes.c_int32), ("hidden", ctypes.c_int32),
                ("n_mid", ctypes.c_int32), ("stride", ctypes.c_int32),
                ("voxel_size", ctypes.c_float),
                ("dims", (ctypes.c_int32 * 3) * _MAX_DEPTH),
                ("origins", (ctypes.c_int64 * 3) * _MAX_DEPTH),
                ("corner", (ctypes.c_int64 * 8) * _MAX_DEPTH),
                ("feat", ctypes.c_void_p * _MAX_DEPTH),
                ("act", ctypes.c_void_p * _MAX_DEPTH)]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("basis_eval")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    g = ctypes.POINTER(_Geom)
    lib.basis_rows_points.restype = ctypes.c_int
    lib.basis_rows_points.argtypes = [g, p, p, p, p, p, i64, i64,
                                      ctypes.c_int, p, p]
    lib.basis_rows_grads.restype = ctypes.c_int
    lib.basis_rows_grads.argtypes = [g, p, p, p, p, p, i64, ctypes.c_int,
                                     p, p]
    lib.basis_field.restype = ctypes.c_int
    lib.basis_field.argtypes = [g, p, p, p, p, i64, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, p, p, p, p]
    return lib


def _expect(t: torch.Tensor, shape, dtypes, name: str) -> None:
    """The kernels' contract on ``t``'s shape and type, checked on any
    device before its placement (``cuda_build.check_cuda``)."""
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {tuple(shape)} "
                         f"{' or '.join(str(d) for d in dtypes)}, got "
                         f"{tuple(t.shape)} {t.dtype}")


_F32 = (torch.float32,)
_INT = (torch.int32, torch.int64)


def _table_rows(spec, d: int) -> int:
    return spec.n_cells(d) + spec.corner_strides(d)[-1]


def _expect_tables(spec, feat, act, cb: int, dtype, name: str) -> None:
    if spec.k not in (1, 2, 4, 8):
        raise ValueError(f"{name}: kernel_dim {spec.k} not in (1, 2, 4, 8)")
    if not 1 <= spec.depth <= _MAX_DEPTH:
        raise ValueError(f"{name}: depth {spec.depth} outside "
                         f"1..{_MAX_DEPTH}")
    for d in range(spec.depth):
        _expect(feat[d], (_table_rows(spec, d), cb), (dtype,),
                f"{name} features (depth {d})")
        if act is not None:
            _expect(act[d], (_table_rows(spec, d), 1), _F32,
                    f"{name} activity (depth {d})")


def _geom(spec, packed: PackedMLP, voxel_size: float, feat, act=None,
          origins=None) -> _Geom:
    """The kernels' parameter block; every table on the card."""
    if spec.k != packed.dims[-1] or len(feat) != spec.depth:
        raise ValueError(f"kernel_dim {spec.k} is not the MLP's "
                         f"{packed.dims[-1]}, or {len(feat)} tables for "
                         f"depth {spec.depth}")
    g = _Geom(depth=spec.depth, k=spec.k, cb=packed.dims[0] - 3,
              hidden=packed.hidden, n_mid=packed.n_mid,
              stride=packed.stride, voxel_size=float(voxel_size))
    for d in range(spec.depth):
        strides = spec.corner_strides(d)
        CB.check_cuda(feat[d], feat[d].shape, feat[d].dtype,
                      f"basis features (depth {d})",
                      align=16 if feat[d].dtype == torch.float32 else 8)
        g.feat[d] = feat[d].data_ptr()
        if act is not None:
            CB.check_cuda(act[d], act[d].shape, torch.float32,
                          f"basis activity (depth {d})", align=4)
            g.act[d] = act[d].data_ptr()
        for a in range(3):
            g.dims[d][a] = int(spec.dims[d][a])
            if origins is not None:
                g.origins[d][a] = int(origins[d][a])
        for c in range(8):
            g.corner[d][c] = int(strides[c])
    return g


def _index(t: torch.Tensor, name: str) -> torch.Tensor:
    t = t.to(torch.int64).contiguous()
    CB.check_cuda(t, t.shape, torch.int64, name, align=8)
    return t


# ------------------------------------------------------------ basis rows
def basis_rows_plain(spec, interp: Interpolators, fdp, adp,
                     xyz_sorted: torch.Tensor, pt_cell0: torch.Tensor,
                     pt_dest: torch.Tensor, slot_cells_pt: torch.Tensor,
                     gr_coords: torch.Tensor, gr_depth: torch.Tensor,
                     gr_active: torch.Tensor, slot_cells_gr: torch.Tensor,
                     voxel_size: float, approx_grad: bool,
                     chunk: int = 1 << 16):
    """Per-slot basis blocks of the solve rows.

    Returns ``b_pt`` (s_pt, p_rows, lanes) with its row-occupancy mask
    ``m_pt`` (s_pt, p_rows), and ``b_gr`` (s_gr, 3, lanes): the three
    gradient-component rows of each decoder-voxel slot.  The chunk loops
    stand in for the JAX package's ``lax.map``."""
    k, depth = spec.k, spec.depth
    dev = xyz_sorted.device
    offs = torch.as_tensor(CORNER_OFFS, device=dev)
    lanes = spec.lanes

    # ---------------- point rows ----------------
    n = xyz_sorted.shape[0]
    slot = pt_dest % spec.s_pt
    cells_pp = slot_cells_pt[:, slot]                    # (depth, n)
    rows = torch.empty((n, lanes), device=dev)
    for s in range(0, n, chunk):
        x, c0 = xyz_sorted[s:s + chunk], pt_cell0[s:s + chunk]
        for d in range(depth):
            vs_d = voxel_size * (2.0 ** d)
            z0 = _div(x, vs_d)[:, None, :] \
                - (c0 >> d).float()[:, None, :] - offs
            cells = cells_pp[d, s:s + chunk]
            fc = corner_rows(fdp[d], cells, spec, d)
            raw, _ = mlp_with_tangents(interp.level(d),
                                       torch.cat([z0, fc], -1), 0)
            act = corner_rows(adp[d], cells, spec, d)[..., 0]
            w, _ = window_grad(z0)
            rows[s:s + chunk, d * 8 * k:(d + 1) * 8 * k] = \
                (raw * (w * act)[..., None]).reshape(-1, 8 * k)
    # JAX layout (p_rows, s_pt) flattened is row * s_pt + slot; here the
    # slot is the leading axis so the per-slot contraction is one bmm
    dest = slot * spec.p_rows + pt_dest // spec.s_pt
    b_pt = torch.zeros((spec.s_pt * spec.p_rows, lanes), device=dev)
    b_pt.index_add_(0, dest, rows)
    m_pt = _row_mask(spec, dest)
    b_pt = b_pt.view(spec.s_pt, spec.p_rows, lanes)

    # ---------------- gradient rows ----------------
    s_gr = spec.s_gr
    b_gr = torch.empty((s_gr, 3, lanes), device=dev)
    for s in range(0, s_gr, chunk):
        c, dd = gr_coords[s:s + chunk], gr_depth[s:s + chunk]
        x = c.float() * (torch.exp2(dd.float()) * voxel_size)[:, None]
        am = gr_active[s:s + chunk].float()[:, None, None]
        for d in range(depth):
            vs_d = voxel_size * (2.0 ** d)
            rel = (dd - d)[:, None]
            cell_d = torch.where(rel >= 0, c << rel.clamp(min=0),
                                 c >> (-rel).clamp(min=0)).float()
            z0 = _div(x, vs_d)[:, None, :] - cell_d[:, None, :] - offs
            cells = slot_cells_gr[d, s:s + chunk]
            fc = corner_rows(fdp[d], cells, spec, d)
            act = corner_rows(adp[d], cells, spec, d)[..., 0]
            raw, draws = mlp_with_tangents(
                interp.level(d), torch.cat([z0, fc], -1),
                0 if approx_grad else 3)
            w, dw = window_grad(z0)
            wa = (w * act)[..., None]
            for a in range(3):
                db = raw * (dw[..., a] * act)[..., None]
                if not approx_grad:
                    db = db + draws[a] * wa
                b_gr[s:s + chunk, a, d * 8 * k:(d + 1) * 8 * k] = \
                    _div(db, vs_d).reshape(-1, 8 * k)
        b_gr[s:s + chunk] *= am
    return b_pt, m_pt, b_gr


def _row_mask(spec, dest: torch.Tensor) -> torch.Tensor:
    """(s_pt, p_rows) f32: 1 where a point's row is, from its row index
    ``dest`` (slot * p_rows + row)."""
    m_pt = torch.zeros(spec.s_pt * spec.p_rows, device=dest.device)
    m_pt.index_add_(0, dest, torch.ones(dest.shape[0], device=dest.device))
    return torch.clamp(m_pt, max=1.0).view(spec.s_pt, spec.p_rows)


def basis_rows(spec, interp: Interpolators, fdp, adp,
               xyz_sorted: torch.Tensor, pt_cell0: torch.Tensor,
               pt_dest: torch.Tensor, slot_cells_pt: torch.Tensor,
               gr_coords: torch.Tensor, gr_depth: torch.Tensor,
               gr_active: torch.Tensor, slot_cells_gr: torch.Tensor,
               voxel_size: float, approx_grad: bool):
    """``basis_rows_plain``'s (b_pt, m_pt, b_gr): on CUDA tensors the
    point rows in one launch, written straight to their slot rows
    (``plan_lattice``'s ``pt_dest`` is one-to-one), and the gradient rows
    in one more; the MLPs are packed once a call (a lattice solve makes
    one call).  ``fdp`` / ``adp``: the per-depth padded f32 feature and
    activity tables (``lattice.scatter_tables``)."""
    _refuse_grad("basis_rows", [xyz_sorted, *fdp, *adp], interp)
    if xyz_sorted.device.type == "cpu":
        return basis_rows_plain(spec, interp, fdp, adp, xyz_sorted,
                                pt_cell0, pt_dest, slot_cells_pt, gr_coords,
                                gr_depth, gr_active, slot_cells_gr,
                                voxel_size, approx_grad)
    n, depth, s_pt, s_gr = xyz_sorted.shape[0], spec.depth, spec.s_pt, \
        spec.s_gr
    _expect(xyz_sorted, (n, 3), _F32, "basis_rows xyz")
    _expect_tables(spec, fdp, adp, fdp[0].shape[-1], torch.float32,
                   "basis_rows")
    for t, shape, name in (
            (pt_cell0, (n, 3), "pt_cell0"), (pt_dest, (n,), "pt_dest"),
            (slot_cells_pt, (depth, s_pt), "slot_cells_pt"),
            (gr_coords, (s_gr, 3), "gr_coords"),
            (gr_depth, (s_gr,), "gr_depth"),
            (slot_cells_gr, (depth, s_gr), "slot_cells_gr")):
        _expect(t, shape, _INT, f"basis_rows {name}")
    _expect(gr_active, (s_gr,), (torch.bool,), "basis_rows gr_active")
    packed = pack_mlps(interp, depth)
    if packed.dims[0] != 3 + fdp[0].shape[-1]:
        raise ValueError(f"basis_rows: MLP input {packed.dims[0]} is not 3 "
                         f"+ the feature width {fdp[0].shape[-1]}")
    CB.check_cuda(packed.buf, packed.buf.shape, torch.float32,
                  "basis_rows MLPs")
    CB.check_cuda(xyz_sorted, (n, 3), torch.float32, "basis_rows xyz",
                  align=4)
    geom = _geom(spec, packed, voxel_size, fdp, adp)
    cell0 = _index(pt_cell0, "basis_rows pt_cell0")
    dest = _index(pt_dest, "basis_rows pt_dest")
    slots_pt = _index(slot_cells_pt, "basis_rows slot cells")
    coords = _index(gr_coords, "basis_rows gr_coords")
    gdepth = _index(gr_depth, "basis_rows gr_depth")
    slots_gr = _index(slot_cells_gr, "basis_rows gradient slot cells")
    active = gr_active.contiguous()
    CB.check_cuda(active, (s_gr,), torch.bool, "basis_rows gr_active",
                  align=1)
    dev = xyz_sorted.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    b_pt = torch.zeros((s_pt * spec.p_rows, spec.lanes), dtype=torch.float32,
                       device=dev)
    b_gr = torch.empty((s_gr, 3, spec.lanes), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    if n:
        CB.raise_on(lib.basis_rows_points(
            ctypes.byref(geom), packed.buf.data_ptr(), xyz_sorted.data_ptr(),
            cell0.data_ptr(), dest.data_ptr(), slots_pt.data_ptr(), n, s_pt,
            spec.p_rows, b_pt.data_ptr(), stream), "basis_rows (points) launch")
        basis_rows.launches += 1
    if s_gr:
        CB.raise_on(lib.basis_rows_grads(
            ctypes.byref(geom), packed.buf.data_ptr(), coords.data_ptr(),
            gdepth.data_ptr(), active.data_ptr(), slots_gr.data_ptr(), s_gr,
            0 if approx_grad else 1, b_gr.data_ptr(), stream),
            "basis_rows (gradients) launch")
        basis_rows.launches += 1
    m_pt = _row_mask(spec, (dest % s_pt) * spec.p_rows + dest // s_pt)
    return b_pt.view(s_pt, spec.p_rows, spec.lanes), m_pt, b_gr


basis_rows.launches = 0


# ----------------------------------------------------------- basis field
def basis_field_plain(spec, interp: Interpolators, tab, origins: np.ndarray,
                      x: torch.Tensor, voxel_size: float, grad: bool,
                      approx_grad: bool, compute_dtype):
    """One wave of queries of the lattice evaluator: values (n,), mask
    (n,) [, gradients (n, 3)] at (n, 3) f32 points, from the evaluator's
    tables ``tab`` (``lattice_eval.LatticeEvalTables``)."""
    k, vs = spec.k, voxel_size
    dev = tab.av0.device
    cdt = compute_dtype
    offs = torch.as_tensor(CORNER_OFFS, device=dev)
    origins = torch.as_tensor(np.asarray(origins).astype(np.int64),
                              device=dev)
    dims = [torch.tensor(dd, device=dev) for dd in spec.dims]
    want_tan = grad and not approx_grad
    w8 = 8 * k
    xc = x
    c0 = query_cells0(xc, vs)
    cells = []
    for d in range(spec.depth):
        _, Y, Z = spec.dims[d]
        loc = (c0 >> d) - origins[d]
        ok = ((loc >= 0) & (loc < dims[d])).all(-1)
        flat = (loc[:, 0] * Y + loc[:, 1]) * Z + loc[:, 2]
        cells.append(torch.where(ok, flat, 0))
    avr = tab.av0.index_select(0, cells[0])
    v = torch.zeros(xc.shape[0], device=dev)
    g = torch.zeros((xc.shape[0], 3), device=dev) if grad else None
    for d in range(spec.depth):
        vs_d = vs * (2.0 ** d)
        z0 = _div(xc, vs_d)[:, None, :] \
            - (c0 >> d).float()[:, None, :] - offs
        fc = corner_rows(tab.fdp[d], cells[d], spec, d)
        xin = torch.cat([z0.to(cdt), fc], -1).float()
        raw, draws = mlp_with_tangents(interp.level(d), xin,
                                       3 if want_tan else 0)
        w, dw = window_grad(z0)
        av_d = avr[:, d * w8:(d + 1) * w8].float().view(-1, 8, k)
        v += (raw * w[..., None] * av_d).sum((1, 2))
        if grad:
            for a in range(3):
                db = raw * dw[..., a, None]
                if want_tan:
                    db = db + draws[a] * w[..., None]
                g[:, a] += _div((db * av_d).sum((1, 2)), vs_d)
    mask = tab.mask0[cells[0]]
    return (v, mask, g) if grad else (v, mask)


def basis_field(spec, interp: Interpolators, tab, origins: np.ndarray,
                x: torch.Tensor, voxel_size: float, grad: bool,
                approx_grad: bool, compute_dtype,
                packed: Optional[PackedMLP] = None):
    """``basis_field_plain``'s outputs; on CUDA tensors one launch for the
    whole wave, with the MLPs ``packed`` (``pack_mlps``, made once by the
    caller; packed here when None)."""
    _refuse_grad("basis_field", [x], interp)
    if x.device.type == "cpu":
        return basis_field_plain(spec, interp, tab, origins, x, voxel_size,
                                 grad, approx_grad, compute_dtype)
    n = x.shape[0]
    dev = x.device
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"basis_field tables: {compute_dtype} not "
                         "float32/bfloat16")
    _expect(x, (n, 3), _F32, "basis_field x")
    _expect_tables(spec, tab.fdp, None, tab.fdp[0].shape[-1], compute_dtype,
                   "basis_field")
    _expect(tab.av0, (spec.n_cells(0), spec.lanes), (compute_dtype,),
            "basis_field av0")
    _expect(tab.mask0, (spec.n_cells(0),), (torch.bool,),
            "basis_field mask0")
    if packed is None:
        packed = pack_mlps(interp, spec.depth)
    if packed.dims[0] != 3 + tab.fdp[0].shape[-1]:
        raise ValueError(f"basis_field: MLP input {packed.dims[0]} is not 3 "
                         f"+ the feature width {tab.fdp[0].shape[-1]}")
    CB.check_cuda(packed.buf, packed.buf.shape, torch.float32,
                  "basis_field MLPs")
    CB.check_cuda(x, (n, 3), torch.float32, "basis_field x", align=4)
    geom = _geom(spec, packed, voxel_size, tab.fdp, origins=origins)
    CB.check_cuda(tab.av0, tab.av0.shape, compute_dtype, "basis_field av0",
                  align=4)
    CB.check_cuda(tab.mask0, tab.mask0.shape, torch.bool,
                  "basis_field mask0", align=1)
    val = torch.empty(n, dtype=torch.float32, device=dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    g = torch.empty((n, 3), dtype=torch.float32, device=dev) if grad \
        else None
    if n:
        CB.raise_on(_lib().basis_field(
            ctypes.byref(geom), packed.buf.data_ptr(), tab.av0.data_ptr(),
            tab.mask0.data_ptr(), x.data_ptr(), n,
            int(compute_dtype == torch.bfloat16), int(grad),
            int(grad and not approx_grad), val.data_ptr(), mask.data_ptr(),
            g.data_ptr() if grad else None,
            torch.cuda.current_stream(dev).cuda_stream),
            "basis_field launch")
        basis_field.launches += 1
    return (val, mask, g) if grad else (val, mask)


basis_field.launches = 0
