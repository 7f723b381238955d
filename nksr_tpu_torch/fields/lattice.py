"""Dense-lattice kernel solve (counterpart of nksr_tpu/fields/lattice.py,
primal formulation).

The plan half (``LatticeSpec``, ``LatticePlan``, ``plan_lattice``) is
integer numpy, copied from the JAX package so that both packages build
byte-identical plans from the same host grids.

The device half fits per-depth coefficient lattices ``xs[d]`` of shape
``(n_d, k)`` f32 by preconditioned CG on the normal equations
``(A^T W A + reg I) x = A^T W y``.  Each matvec builds the fused
depth-0 support buffer AV0 ``(cells_0, depth*8k)`` with the forward
cascade kernel, gathers one AV0 row per slot, contracts it with the
slot's basis block, scatter-adds the transposed contraction into a
depth-0 buffer and maps that back with the adjoint cascade kernel
(``fields/lattice_kernels.py``).

The lattice is exact integer geometry: a point's support cell at depth d
is ``floor(x / vs_d)`` and deeper cells are nested prefixes
(``cell_d = cell_0 >> d``), so corner determination never depends on
float rounding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.host_build import unpack64
from ..models.network import Interpolators, mlp_with_tangents
from ..native import coord_minmax, flat_cells
from ..solver.pcg import pcg
from . import lattice_kernels as LK


# --------------------------------------------------------------------- spec
@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static description of the dense solve (hashable: keys jit caches).

    ``dims[d] = (X, Y, Zp)``: dense cell counts per depth (Zp includes the
    +2 corner margin).  ``n_cells[d] = X*Y*Zp``.  Slot layout: ``s_pt``
    point slots of ``p_rows`` rows each, ``s_gr`` gradient slots (3
    component rows each, one slot per decoder voxel of the adaptive
    depths).
    """
    dims: Tuple[Tuple[int, int, int], ...]
    k: int
    depth: int
    adaptive_depth: int
    s_pt: int
    p_rows: int
    s_gr: int
    n_pts_cap: int

    @property
    def lanes(self) -> int:
        return self.depth * 8 * self.k

    def n_cells(self, d: int) -> int:
        x, y, z = self.dims[d]
        return x * y * z

    def corner_strides(self, d: int) -> Tuple[int, ...]:
        """Flat-index deltas of the 8 cell corners (static slice starts)."""
        _, y, z = self.dims[d]
        return tuple((dx * y + dy) * z + dz
                     for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))


class LatticePlan(NamedTuple):
    """Host-built integer tables driving the device solve (numpy)."""
    spec: LatticeSpec
    origins: np.ndarray       # (depth, 3) int32 lattice origin per depth
    phase: np.ndarray         # (depth, 3) int32: o0 - (o_d << d) per axis —
    #                           the sub-cell offset that aligns each coarse
    #                           lattice with the depth-0 frame (fused AV0)
    # points (in slot-sorted order):
    pt_perm: np.ndarray       # (n,) original index of each sorted point
    pt_dest: np.ndarray       # (n,) row destination in (p_rows * s_pt)
    pt_cell0: np.ndarray      # (n, 3) int32 depth-0 cell of each point
    slot_cell_pt: np.ndarray  # (depth, s_pt) flat dense cell per depth (-1 pad -> 0)
    slot_cell0_pt: np.ndarray  # (s_pt,) flat DEPTH-0 cell per slot, sorted
    # grad slots (one per decoder voxel of depths < adaptive_depth,
    # cap-padded, in hierarchy row order):
    gr_coords: np.ndarray     # (s_gr, 3) voxel coord at its own depth
    gr_depth: np.ndarray      # (s_gr,) own depth of each voxel
    gr_active: np.ndarray     # (s_gr,) bool
    slot_cell_gr: np.ndarray  # (depth, s_gr) flat dense cell per depth
    slot_cell0_gr: np.ndarray  # (s_gr,) flat depth-0 cell per grad slot, sorted
    gr_perm: np.ndarray       # (s_gr,) hierarchy-order index of each slot
    #                           (device realigns gradient targets with it)
    # per-depth voxel -> dense cell maps (cap-padded, pad -> 0):
    vox_cell: Tuple[np.ndarray, ...]   # (cap_d,) flat dense cell ids
    vox_active: Tuple[np.ndarray, ...]


def _next_pow2(n: int) -> int:
    return 1 << max(6, int(np.ceil(np.log2(max(n, 1)))))


def plan_lattice(grids, caps: Sequence[int], xyz: np.ndarray,
                 sorted_base0: np.ndarray, order0: np.ndarray,
                 voxel_size: float, depth: int, adaptive_depth: int,
                 k: int = 4, p_rows: int = 4,
                 dec_grids=None, dec_caps=None,
                 force_dims=None, force_s_pt: Optional[int] = None,
                 force_cap: Optional[int] = None) -> Optional[LatticePlan]:
    """Build the lattice plan on the host (pure integer numpy, no joins).

    ``grids``/``caps``: decoder hierarchy (host_build.HostGrid).
    ``sorted_base0``/``order0``: depth-0 point base keys sorted + argsort
    (from host_build.build_splat_grids_ex — reused, no extra sort).
    ``force_dims``/``force_s_pt``/``force_cap``: override the derived
    per-depth dims / point-slot count / point capacity so a BATCH of
    plans (e.g. the chunks of a sharded reconstruction) shares one
    LatticeSpec and can be stacked + vmapped.
    Returns None when the dense bbox is too large (caller falls back to
    the sparse path / chunk mode), or when a forced size is exceeded.
    """
    if dec_grids is None:
        dec_grids, dec_caps = grids, caps
    n = xyz.shape[0]
    # bbox per depth from the DECODER grid coords (voxel corner set).
    # Margin 2 on both sides so local cell 0 can never touch an active
    # voxel: out-of-bbox queries alias to cell 0 and read zero basis —
    # exactly the sparse path's idx==-1 masking.
    def _cminmax(c):
        mm = coord_minmax(c)
        if mm is not None:
            return mm[0].astype(np.int64), mm[1].astype(np.int64)
        return c.min(0).astype(np.int64), c.max(0).astype(np.int64)

    lo_t, hi_t = [], []
    for d in range(depth):
        c = dec_grids[d].coords
        if len(c) == 0:
            lo_t.append(np.zeros(3, np.int64))
            hi_t.append(np.ones(3, np.int64))
        else:
            mn, mx = _cminmax(c)
            lo_t.append(mn - 2)
            hi_t.append(mx + 2)
    # The depth-0 FRAME must contain every fused-gather address (AV0 is
    # indexed at depth-0 resolution): all point depth-0 cells and every
    # grad slot's (c_dd << dd).  With a pruned decoder depth 0 (adaptive
    # hierarchies) those extend beyond the depth-0 voxel bbox.
    cand_lo = [lo_t[0] + 2]
    cand_hi = [hi_t[0] - 2]
    sb_all = sorted_base0
    if n and len(sb_all):
        # sorted keys: componentwise x-bounds are free (ends of the
        # sorted order); y/z still need a pass
        c0_all = unpack64(sb_all)
        mn, mx = _cminmax(c0_all)
        cand_lo.append(mn)
        cand_hi.append(mx)
    for dd in range(adaptive_depth):
        c = dec_grids[dd].coords
        if len(c):
            mn, mx = _cminmax(c)
            cand_lo.append(mn * (1 << dd))
            cand_hi.append(mx * (1 << dd))
    lo_t[0] = np.minimum.reduce(cand_lo) - 2
    hi_t[0] = np.maximum.reduce(cand_hi) + 2
    # ZERO-PHASE nesting: pick o0 so that o_d = o0 >> d simultaneously
    # (a) stays <= every level's lo_t (margin preserved) and (b) is exactly
    # divisible down the chain (o0 multiple of 2^(depth-1)).  Every
    # upsample/downsample step then has step-phase 0 — the fused AV0
    # cascade (_up2/_down2) becomes a static, vmappable program shared by
    # all chunks of a sharded batch.
    algn = 1 << (depth - 1)
    # o0 >> d <= lo_t[d]  <=>  o0 <= (lo_t[d] << d) + 2^d - 1 — the +2^d-1
    # matters: without it a coarse level's -2 margin would be amplified
    # 2^d-fold into the depth-0 extent
    o0_cand = np.minimum.reduce(
        [(lo_t[d] << d) + (1 << d) - 1 for d in range(depth)])
    o0 = o0_cand & ~np.int64(algn - 1)
    origins, dims, phase, total = [], [], [], 0
    for d in range(depth):
        o = o0 >> d
        if d == 0:
            ext = hi_t[0] - o + 1
        else:
            # cover both this level's active extent and the upsample
            # window of the finer level (step phase 0: ceil(ext_f / 2))
            need_up = (np.asarray(dims[d - 1], np.int64) + 1) >> 1
            ext = np.maximum(hi_t[d] - o + 1, need_up)
        # round dims up to multiples of 8: the LatticeSpec keys the jit
        # cache, so bucketed dims let same-size scenes (bench reps, chunk
        # grids) reuse compiles; extra cells are inactive and read zeros
        ext = (ext + 7) // 8 * 8
        if force_dims is not None:
            if (ext > np.asarray(force_dims[d])).any():
                return None
            ext = np.asarray(force_dims[d], np.int64)
        origins.append(o)
        phase.append(origins[0] - o * (1 << d))
        dims.append((int(ext[0]), int(ext[1]), int(ext[2])))
        total += int(ext[0] * ext[1] * ext[2])
    if total * k > 160_000_000:     # dense coefficient budget (~2.5 GB f32)
        return None

    # ---- point slots: group sorted points by depth-0 cell ----------------
    sb, order = sorted_base0, order0
    if n:
        first = np.concatenate([[True], sb[1:] != sb[:-1]])
        cell_rank = np.cumsum(first) - 1                  # cell id per sorted pt
        pos_in_cell = np.arange(n) - np.maximum.accumulate(
            np.where(first, np.arange(n), 0))
    else:
        first = np.zeros(0, bool)
        cell_rank = np.zeros(0, np.int64)
        pos_in_cell = np.zeros(0, np.int64)
    sub_slot = pos_in_cell // p_rows                      # spill slot index
    row_in_slot = pos_in_cell % p_rows
    # slot id = rank over (cell_rank, sub_slot) pairs — both sorted
    pair_first = np.concatenate([[True], (cell_rank[1:] != cell_rank[:-1])
                                 | (sub_slot[1:] != sub_slot[:-1])]) \
        if n else np.zeros(0, bool)
    slot_of_pt = np.cumsum(pair_first) - 1 if n else np.zeros(0, np.int64)
    n_slots = int(slot_of_pt[-1]) + 1 if n else 0
    s_pt = _next_pow2(n_slots) if force_s_pt is None else force_s_pt
    if n_slots > s_pt:
        return None

    cell0_sorted = c0_all if n and len(sb_all) else \
        unpack64(sb).astype(np.int64)                     # (n, 3) int
    slot_cell0 = cell0_sorted[pair_first] if n else np.zeros((0, 3), np.int64)

    def flat_cell(cd: np.ndarray, d: int) -> np.ndarray:
        """Map coordinates ALREADY at depth d into the depth-d lattice
        (one fused native pass: shift/subtract/bounds/index)."""
        return flat_cells(cd, 0, origins[d], dims[d])

    slot_cell_pt = np.zeros((depth, s_pt), np.int32)
    for d in range(depth):
        flat_cells(slot_cell0, -d, origins[d], dims[d],
                   out=slot_cell_pt[d, :n_slots])
    # fused depth-0 slot cells (sorted by construction: slots enumerate
    # the sorted point keys).  Pad slots repeat the last cell so the
    # sortedness hint stays valid; their rows are zero.
    slot_cell0_pt = np.zeros(s_pt, np.int32)
    if n_slots:
        flat_cells(slot_cell0, 0, origins[0], dims[0],
                   out=slot_cell0_pt[:n_slots])
        slot_cell0_pt[n_slots:] = slot_cell0_pt[n_slots - 1]

    pt_dest = (row_in_slot * s_pt + slot_of_pt).astype(np.int32)

    # ---- gradient slots: decoder voxels of the adaptive depths ----------
    gr_parts, grd_parts, gra_parts = [], [], []
    for dd in range(adaptive_depth):
        cap = dec_caps[dd]
        nn = min(len(dec_grids[dd].keys), cap)
        c = np.zeros((cap, 3), np.int64)
        c[:nn] = dec_grids[dd].coords[:nn]
        gr_parts.append(c)
        grd_parts.append(np.full(cap, dd, np.int32))
        a = np.zeros(cap, bool)
        a[:nn] = True
        gra_parts.append(a)
    gr_coords = np.concatenate(gr_parts, 0) if gr_parts else \
        np.zeros((0, 3), np.int64)
    gr_depth = np.concatenate(grd_parts, 0) if grd_parts else \
        np.zeros(0, np.int32)
    gr_active = np.concatenate(gra_parts, 0) if gra_parts else \
        np.zeros(0, bool)
    s_gr = len(gr_coords)

    # grad slots are concatenated per source depth dd, so each dd is a
    # contiguous range — the per-depth shifts run as strided native
    # passes with no masked gathers or temporaries
    gr_offs = np.cumsum([0] + [dec_caps[dd]
                               for dd in range(adaptive_depth)])
    slot_cell_gr = np.zeros((depth, max(s_gr, 1)), np.int32)
    for d in range(depth):
        # support cell of a depth-dd voxel center at depth d:
        # floor(c * 2^dd / 2^d) = c << (dd-d)  |  c >> (d-dd)
        for dd in range(adaptive_depth):
            lo, hi = int(gr_offs[dd]), int(gr_offs[dd + 1])
            flat_cells(gr_coords[lo:hi], dd - d, origins[d], dims[d],
                       out=slot_cell_gr[d, lo:hi])
    slot_cell_gr = slot_cell_gr[:, :s_gr] if s_gr else \
        np.zeros((depth, 0), np.int32)
    # fused depth-0 cell of each grad slot: a depth-dd voxel's support
    # cell at depth d is ((c_dd << dd) >> d) for every d, so indexing the
    # AV0 buffer at (c_dd << dd) reads the right lanes at all depths
    if s_gr:
        slot_cell0_gr = np.zeros(s_gr, np.int32)
        for dd in range(adaptive_depth):
            lo, hi = int(gr_offs[dd]), int(gr_offs[dd + 1])
            flat_cells(gr_coords[lo:hi], dd, origins[0], dims[0],
                       out=slot_cell0_gr[lo:hi])
        slot_cell0_gr[~gr_active] = 0
        # sort grad slots globally by depth-0 cell so BOTH the fused
        # gather and the scatter-add get the sorted-indices hint
        # (measured 23 vs 134 ns/row for the scatter).  ``gr_perm``
        # realigns the hierarchy-ordered gradient targets on device.
        gr_perm = np.argsort(slot_cell0_gr, kind="stable").astype(np.int32)
        slot_cell0_gr = slot_cell0_gr[gr_perm]
        gr_coords = gr_coords[gr_perm]
        gr_depth = gr_depth[gr_perm]
        gr_active = gr_active[gr_perm]
        slot_cell_gr = slot_cell_gr[:, gr_perm]
    else:
        slot_cell0_gr = np.zeros(0, np.int32)
        gr_perm = np.zeros(0, np.int32)

    # ---- per-depth voxel -> dense cell (coefficient init/extract) -------
    vox_cell, vox_active = [], []
    for d in range(depth):
        cap = dec_caps[d]
        nn = min(len(dec_grids[d].keys), cap)
        c = np.zeros((cap, 3), np.int64)
        c[:nn] = dec_grids[d].coords[:nn]
        vox_cell.append(flat_cell(c, d))
        a = np.zeros(cap, bool)
        a[:nn] = True
        vox_active.append(a)

    cap_pts = _next_pow2(max(n, 1)) if force_cap is None else force_cap
    if n > cap_pts:
        return None
    spec = LatticeSpec(
        dims=tuple(dims), k=k, depth=depth, adaptive_depth=adaptive_depth,
        s_pt=s_pt, p_rows=p_rows, s_gr=s_gr, n_pts_cap=cap_pts)
    return LatticePlan(
        spec=spec, origins=np.stack(origins).astype(np.int32),
        phase=np.stack(phase).astype(np.int32),
        pt_perm=order.astype(np.int32), pt_dest=pt_dest,
        pt_cell0=cell0_sorted.astype(np.int32),
        slot_cell_pt=slot_cell_pt, slot_cell0_pt=slot_cell0_pt,
        gr_coords=gr_coords.astype(np.int32), gr_depth=gr_depth,
        gr_active=gr_active, slot_cell_gr=slot_cell_gr,
        slot_cell0_gr=slot_cell0_gr.astype(np.int32),
        gr_perm=gr_perm,
        vox_cell=tuple(vox_cell), vox_active=tuple(vox_active))


# ------------------------------------------------------- device primitives
CORNER_OFFS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                        -1).reshape(8, 3).astype(np.float32)


def corner_table(tab: torch.Tensor, spec: LatticeSpec, d: int
                 ) -> torch.Tensor:
    """(n_cells_d, v) per-cell table, zero-padded at the end so that row
    ``cell + s`` exists for every corner stride s of depth d."""
    return F.pad(tab, (0, 0, 0, spec.corner_strides(d)[-1]))


def corner_rows(tabp: torch.Tensor, cells: torch.Tensor, spec: LatticeSpec,
                d: int) -> torch.Tensor:
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


def scatter_tables(spec, basis_features, vox_cell, vox_active):
    """Per depth: padded (cells, Cb) basis features and (cells, 1) voxel
    activity on the dense lattice."""
    fdp, adp = [], []
    for d in range(spec.depth):
        nc = spec.n_cells(d)
        act = vox_active[d]
        cells = vox_cell[d][act]
        feats = basis_features[d][act].float()
        fd = torch.zeros((nc, feats.shape[-1]), device=feats.device)
        fd.index_add_(0, cells, feats)
        ad = torch.zeros((nc, 1), device=feats.device)
        ad.index_add_(0, cells, torch.ones_like(cells, dtype=torch.float32
                                                )[:, None])
        fdp.append(corner_table(fd, spec, d))
        adp.append(corner_table(ad, spec, d))
    return fdp, adp


def assemble_rows(spec: LatticeSpec, interp: Interpolators, fdp, adp,
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
            z0 = (x / vs_d)[:, None, :] - (c0 >> d).float()[:, None, :] \
                - offs
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
    m_pt = torch.zeros(spec.s_pt * spec.p_rows, device=dev)
    m_pt.index_add_(0, dest, torch.ones(n, device=dev))
    b_pt = b_pt.view(spec.s_pt, spec.p_rows, lanes)
    m_pt = torch.clamp(m_pt, max=1.0).view(spec.s_pt, spec.p_rows)

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
            z0 = (x / vs_d)[:, None, :] - cell_d[:, None, :] - offs
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
                    (db / vs_d).reshape(-1, 8 * k)
        b_gr[s:s + chunk] *= am
    return b_pt, m_pt, b_gr


# ------------------------------------------------------------------- solve
@torch.no_grad()
def lattice_solve(spec: LatticeSpec, interp: Interpolators,
                  basis_features: Sequence[torch.Tensor],
                  xyz_sorted: torch.Tensor, pt_cell0: torch.Tensor,
                  pt_dest: torch.Tensor, slot_cells_pt: torch.Tensor,
                  slot_cells_gr: torch.Tensor, gr_coords: torch.Tensor,
                  gr_depth: torch.Tensor, gr_active: torch.Tensor,
                  gr_targets: torch.Tensor,
                  vox_cell: Sequence[torch.Tensor],
                  vox_active: Sequence[torch.Tensor],
                  voxel_size: float, pos_weight: float,
                  normal_weight: float, reg_weight: float, tol: float,
                  max_iters: int, approx_grad: bool, *,
                  slot_cell0_pt: torch.Tensor, slot_cell0_gr: torch.Tensor,
                  gr_perm: torch.Tensor, compute_dtype=torch.float32):
    """Fit the per-depth coefficients (primal formulation).

    Point arrays hold the real points only, in plan order
    (``plan.pt_perm``); ``gr_targets`` (s_gr, 3) are the gradient targets
    in hierarchy order (``gr_perm`` realigns them with the sorted slots).
    Row blocks and AV0 are held in ``compute_dtype`` values (bf16 on the
    card), every contraction and sum is f32.

    Returns (alphas, dense_xs, (iters, rel_res)): per-voxel flat
    coefficients (cap_d * k,), the dense (n_d, k) solution lattices (zero
    outside the active voxels) for the evaluator, and CG diagnostics.
    """
    depth, k = spec.depth, spec.k
    cdt = compute_dtype
    f32 = torch.float32
    dev = xyz_sorted.device
    gr_targets = gr_targets[gr_perm]

    fdp, adp = scatter_tables(spec, basis_features, vox_cell, vox_active)
    b_pt, m_pt, b_gr = assemble_rows(
        spec, interp, fdp, adp, xyz_sorted, pt_cell0, pt_dest,
        slot_cells_pt, gr_coords, gr_depth, gr_active, slot_cells_gr,
        voxel_size, approx_grad)
    del fdp, adp
    # the blocks keep the compute dtype's values in f32 storage: a bf16
    # product is exact in f32, so the f32 bmm below sums what the JAX
    # package's bf16 einsum with f32 accumulation sums
    b_pt = b_pt.to(cdt).float()
    b_gr = b_gr.to(cdt).float()

    n_pts = torch.tensor(float(max(xyz_sorted.shape[0], 1)), device=dev)
    m_vox = torch.clamp(gr_active.float().sum(), min=1.0)
    w_pt = m_pt * (pos_weight / n_pts)                          # (s_pt, r)
    w_gr = gr_active.float() * (normal_weight / m_vox * voxel_size ** 2)
    n_c0 = spec.n_cells(0)

    def apply_A(xs):
        av0 = LK.av0_cascade(spec, xs, cdt)
        av_pt = av0.index_select(0, slot_cell0_pt).float()
        av_gr = av0.index_select(0, slot_cell0_gr).float()
        t_pt = torch.bmm(b_pt, av_pt[..., None])[..., 0]        # (s_pt, r)
        t_gr = torch.bmm(b_gr, av_gr[..., None])[..., 0]        # (s_gr, 3)
        return t_pt, t_gr

    def apply_AT(t_pt, t_gr):
        y_pt = torch.bmm(b_pt.transpose(1, 2),
                         t_pt.to(cdt).float()[..., None])[..., 0]
        y_gr = torch.bmm(b_gr.transpose(1, 2),
                         t_gr.to(cdt).float()[..., None])[..., 0]
        z0 = torch.zeros((n_c0, spec.lanes), dtype=f32, device=dev)
        z0.index_add_(0, slot_cell0_pt, y_pt)
        z0.index_add_(0, slot_cell0_gr, y_gr)
        return LK.av0_adjoint_cascade(spec, z0, cdt)

    def matvec(xs):
        t_pt, t_gr = apply_A(xs)
        y = apply_AT(w_pt * t_pt, w_gr[:, None] * t_gr)
        return tuple(yi + reg_weight * xi for yi, xi in zip(y, xs))

    # rhs = A_g^T W_g targets (value rows have target 0)
    rhs = apply_AT(torch.zeros_like(w_pt), w_gr[:, None] * gr_targets)

    # Jacobi diagonal: sum over rows of w * basis^2 per (cell, k), mapped
    # back by the adjoint cascade in f32
    dz = torch.zeros((n_c0, spec.lanes), dtype=f32, device=dev)
    dz.index_add_(0, slot_cell0_pt, (b_pt ** 2 * w_pt[..., None]).sum(1))
    dz.index_add_(0, slot_cell0_gr,
                  (b_gr ** 2).sum(1) * w_gr[:, None])
    diag = tuple(a + reg_weight
                 for a in LK.av0_adjoint_cascade(spec, dz, f32))
    del dz

    xs, iters, rel_res = pcg(
        matvec, rhs, precond=lambda r: tuple(ri / di
                                             for ri, di in zip(r, diag)),
        tol=tol, max_iters=max_iters)

    alphas = []
    for d in range(depth):
        rows = xs[d].index_select(0, vox_cell[d])
        rows = torch.where(vox_active[d][:, None], rows, 0.0)
        alphas.append(rows.reshape(-1))
    return tuple(alphas), tuple(xs), (iters, rel_res)
