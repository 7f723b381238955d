"""One scene's lattice solve in x-slabs over the ranks of a device mesh
(counterpart of nksr_tpu/parallel/lattice_shard.py).

  * ``plan_sharded`` (numpy, byte-identical to the JAX package's)
    re-plans the lattice so that every depth's X divides into n slabs:
    slab boundaries then align across depths, since a point's nested
    cells satisfy (x0 >> d) // (X_d / n) == x0 // (X_0 / n).  Its spec
    is therefore not the single-device plan's.  Solve rows and voxels
    belong to the slab of their depth-0 cell.  Beside the JAX package's
    fields the port's plan keeps each slot's local depth-0 cell, which
    its slot-row kernels read.
  * The only coupling between slabs is the +1 x corner read of the
    compact kernel support: one x-plane a depth.  Each matvec appends
    the right neighbour's first plane to every depth's slab lattice
    (``_halo_fwd``), runs the port's ``av0_rows`` and
    ``av0_adjoint_rows`` kernels on the local spec (slab plus one halo
    plane a depth), and folds the adjoint's halo plane back onto the
    right neighbour's first plane (``_halo_adj``); the open chain's last
    rank reads zeros, the lattice's inactive margin.  The planes of all
    depths travel as one tensor: two exchanges a matvec.
  * CG dots are ``all_reduce`` sums (``_pcg_psum``): every rank reads
    the same residual and stops at the same iteration.
  * ``gather_alphas`` ends the solve with every rank holding the whole
    field (one ``all_gather`` of the slabs), the counterpart of the JAX
    package's host gather, so ``evaluate_f`` works on any rank.

The sharded and the single-device solves compute the same normal
equations on different plans with sums in other orders; unconverged
(the tests' iteration counts) their fields differ by the CG trajectory
(ROADMAP queue 3, facts), so they are compared by operator, by mesh and
by the JAX package's own sharded-vs-single distance.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..fields import lattice as LAT
from ..solver.pcg import pcg
from . import spatial as SP


def _next_pow2(n: int, lo: int = 8) -> int:
    import math
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), int(math.log2(lo)))


# ------------------------------------------------------------ host planning
class ShardedPlan(NamedTuple):
    """Per-rank (leading axis n) localizations of a LatticePlan."""
    spec_local: LAT.LatticeSpec      # slab+1-halo-plane dims
    n_shards: int
    slab_x: Tuple[int, ...]          # per-depth slab width (cells)
    # point rows (stacked per rank):
    xyz: np.ndarray                  # (n, cap_loc, 3)
    mask: np.ndarray                 # (n, cap_loc)
    cell0: np.ndarray                # (n, cap_loc, 3) world depth-0 cell
    dest: np.ndarray                 # (n, cap_loc)
    slot_cells_pt: np.ndarray        # (n, depth, s_pt_loc) LOCAL flat ids
    # gradient rows:
    gr_coords: np.ndarray            # (n, s_gr_loc, 3)
    gr_depth: np.ndarray             # (n, s_gr_loc)
    gr_active: np.ndarray            # (n, s_gr_loc)
    slot_cells_gr: np.ndarray        # (n, depth, s_gr_loc)
    gr_src: np.ndarray               # (n, s_gr_loc) global hierarchy row
    # voxels (coefficient/basis ownership):
    vox_cell_loc: Tuple[np.ndarray, ...]   # per depth (n, vcap_loc)
    vox_active_loc: Tuple[np.ndarray, ...]
    vox_src: Tuple[np.ndarray, ...]        # per depth (n, vcap_loc) global row
    # the port's: each slot's LOCAL flat depth-0 cell (the slot-row
    # kernels' index; 0 on pad slots)
    slot_cell0_pt: np.ndarray        # (n, s_pt_loc)
    slot_cell0_gr: np.ndarray        # (n, s_gr_loc)


def plan_sharded(grids, caps, xyz: np.ndarray, sorted_base0, order0,
                 voxel_size: float, depth: int, adaptive_depth: int,
                 n_shards: int, k: int = 4,
                 dec_grids=None, dec_caps=None):
    """Aligned global plan + per-slab localization (the JAX package's,
    line for line).

    Returns (global LatticePlan, ShardedPlan) or None when the lattice
    doesn't fit (caller falls back)."""
    plan = LAT.plan_lattice(grids, caps, xyz, sorted_base0, order0,
                            voxel_size, depth, adaptive_depth, k=k,
                            dec_grids=dec_grids, dec_caps=dec_caps)
    if plan is None:
        return None
    # re-plan with X aligned so every depth's X divides into n slabs
    A = n_shards * (1 << (depth - 1))
    x0_need = max(plan.spec.dims[d][0] << d for d in range(depth))
    x0 = -(-x0_need // A) * A
    force = tuple((x0 >> d,) + plan.spec.dims[d][1:] for d in range(depth))
    plan = LAT.plan_lattice(grids, caps, xyz, sorted_base0, order0,
                            voxel_size, depth, adaptive_depth, k=k,
                            dec_grids=dec_grids, dec_caps=dec_caps,
                            force_dims=force)
    if plan is None:
        return None
    spec = plan.spec
    n = n_shards
    slab_x = tuple(spec.dims[d][0] // n for d in range(depth))
    yz = tuple(spec.dims[d][1] * spec.dims[d][2] for d in range(depth))
    # local cell count: slab + ONE halo x-plane (the +1x corner read; y/z
    # wrap rows of the halo plane are global-margin cells, never
    # referenced)
    n_cells_loc = tuple((slab_x[d] + 1) * yz[d] for d in range(depth))

    def owner_of_flat0(flat0):
        return np.minimum(flat0 // yz[0] // slab_x[0], n - 1)

    def localize(flat, d, dev):
        loc = flat.astype(np.int64) - dev * slab_x[d] * yz[d]
        # pad/foreign entries clamp to 0 (their rows are zero-masked)
        return np.where((loc >= 0) & (loc < n_cells_loc[d]),
                        loc, 0).astype(np.int32)

    # ---- point slots & their rows --------------------------------------
    own_slot = owner_of_flat0(plan.slot_cell0_pt.astype(np.int64))
    # plan pads slot arrays by repeating the last real slot; detect count
    # from pt_dest (real points reference real slots)
    s_pt, p_rows = spec.s_pt, spec.p_rows
    pt_slot = plan.pt_dest.astype(np.int64) % s_pt
    pt_row = plan.pt_dest.astype(np.int64) // s_pt
    own_pt = own_slot[pt_slot]

    slot_lists = [np.nonzero(own_slot == dev)[0] for dev in range(n)]
    # restrict to slots that actually carry points (pad slots repeat the
    # last cell and would double-count)
    used = np.zeros(s_pt, bool)
    used[pt_slot] = True
    slot_lists = [s[used[s]] for s in slot_lists]
    s_pt_loc = _next_pow2(max((len(s) for s in slot_lists), default=1))
    cap_loc = _next_pow2(max((int((own_pt == dev).sum())
                              for dev in range(n)), default=1), lo=64)

    xyz_sorted = xyz[plan.pt_perm]
    xyz_l = np.zeros((n, cap_loc, 3), np.float32)
    mask_l = np.zeros((n, cap_loc), bool)
    cell0_l = np.zeros((n, cap_loc, 3), np.int32)
    dest_l = np.full((n, cap_loc), p_rows * s_pt_loc, np.int32)
    slot_cells_pt_l = np.zeros((n, spec.depth, s_pt_loc), np.int32)
    slot_cell0_pt_l = np.zeros((n, s_pt_loc), np.int32)
    for dev in range(n):
        slots = slot_lists[dev]
        remap = np.full(s_pt, -1, np.int64)
        remap[slots] = np.arange(len(slots))
        sel = np.nonzero(own_pt == dev)[0]
        m = len(sel)
        xyz_l[dev, :m] = xyz_sorted[sel]
        mask_l[dev, :m] = True
        cell0_l[dev, :m] = plan.pt_cell0[sel]
        dest_l[dev, :m] = (pt_row[sel] * s_pt_loc
                           + remap[pt_slot[sel]]).astype(np.int32)
        for d in range(spec.depth):
            slot_cells_pt_l[dev, d, :len(slots)] = localize(
                plan.slot_cell_pt[d][slots], d, dev)
        slot_cell0_pt_l[dev, :len(slots)] = localize(
            plan.slot_cell0_pt[slots], 0, dev)

    # ---- gradient slots -------------------------------------------------
    own_gr = owner_of_flat0(plan.slot_cell0_gr.astype(np.int64))
    own_gr = np.where(plan.gr_active, own_gr, 0)
    gr_lists = [np.nonzero((own_gr == dev) & plan.gr_active)[0]
                for dev in range(n)]
    s_gr_loc = _next_pow2(max((len(g) for g in gr_lists), default=1))
    gr_coords_l = np.zeros((n, s_gr_loc, 3), np.int32)
    gr_depth_l = np.zeros((n, s_gr_loc), np.int32)
    gr_active_l = np.zeros((n, s_gr_loc), bool)
    slot_cells_gr_l = np.zeros((n, spec.depth, s_gr_loc), np.int32)
    slot_cell0_gr_l = np.zeros((n, s_gr_loc), np.int32)
    gr_src_l = np.zeros((n, s_gr_loc), np.int32)
    for dev in range(n):
        g = gr_lists[dev]
        m = len(g)
        gr_coords_l[dev, :m] = plan.gr_coords[g]
        gr_depth_l[dev, :m] = plan.gr_depth[g]
        gr_active_l[dev, :m] = True
        # realign to hierarchy order: gr_perm[g] is the hierarchy row of
        # sorted slot g (lattice_solve applies the same take)
        gr_src_l[dev, :m] = plan.gr_perm[g]
        for d in range(spec.depth):
            slot_cells_gr_l[dev, d, :m] = localize(
                plan.slot_cell_gr[d][g], d, dev)
        slot_cell0_gr_l[dev, :m] = localize(plan.slot_cell0_gr[g], 0, dev)

    # ---- voxels ----------------------------------------------------------
    vox_cell_loc, vox_active_loc, vox_src = [], [], []
    for d in range(spec.depth):
        vc = plan.vox_cell[d].astype(np.int64)
        va = plan.vox_active[d]
        own_v = np.minimum(vc // yz[d] // slab_x[d], n - 1)
        own_v = np.where(va, own_v, 0)
        lists = [np.nonzero((own_v == dev) & va)[0] for dev in range(n)]
        vcap = _next_pow2(max((len(x) for x in lists), default=1), lo=64)
        c_l = np.zeros((n, vcap), np.int32)
        a_l = np.zeros((n, vcap), bool)
        s_l = np.zeros((n, vcap), np.int32)
        for dev in range(n):
            sel = lists[dev]
            m = len(sel)
            c_l[dev, :m] = localize(vc[sel], d, dev)
            a_l[dev, :m] = True
            s_l[dev, :m] = sel
        vox_cell_loc.append(c_l)
        vox_active_loc.append(a_l)
        vox_src.append(s_l)

    # local spec: extended dims + LOCAL slot/row capacities
    spec_local = dataclasses.replace(
        spec,
        dims=tuple((slab_x[d] + 1,) + spec.dims[d][1:]
                   for d in range(depth)),
        s_pt=s_pt_loc, s_gr=s_gr_loc, n_pts_cap=cap_loc)

    return plan, ShardedPlan(
        spec_local=spec_local, n_shards=n, slab_x=slab_x,
        xyz=xyz_l, mask=mask_l, cell0=cell0_l, dest=dest_l,
        slot_cells_pt=slot_cells_pt_l,
        gr_coords=gr_coords_l, gr_depth=gr_depth_l,
        gr_active=gr_active_l, slot_cells_gr=slot_cells_gr_l,
        gr_src=gr_src_l,
        vox_cell_loc=tuple(vox_cell_loc),
        vox_active_loc=tuple(vox_active_loc),
        vox_src=tuple(vox_src),
        slot_cell0_pt=slot_cell0_pt_l, slot_cell0_gr=slot_cell0_gr_l)


# ------------------------------------------------------------ halo planes
def _planes(spec, d: int) -> int:
    """Cells in one x-plane of depth d."""
    return spec.dims[d][1] * spec.dims[d][2]


def append_right(mesh, bufs, plane_rows: Sequence[int], planes: int = 1):
    """Append the right neighbour's first ``planes`` x-planes to each
    slab buffer (rows, v) whose x-plane holds ``plane_rows[i]`` rows:
    one exchange for all buffers; the open chain's last rank appends
    zeros."""
    sizes = [planes * p * b.shape[1] for b, p in zip(bufs, plane_rows)]
    first = torch.cat([b[:planes * p].reshape(-1)
                       for b, p in zip(bufs, plane_rows)])
    halo, _ = SP.exchange(mesh, first, None)
    return tuple(torch.cat([b, h.view(-1, b.shape[1])])
                 for b, h in zip(bufs, torch.split(halo, sizes)))


def _halo_fwd(mesh, spec_local: LAT.LatticeSpec, xs_slab):
    """Append the right neighbour's first x-plane to each depth's slab
    lattice (the +1 x corner read of the local spec)."""
    return append_right(mesh, xs_slab, [_planes(spec_local, d)
                                        for d in range(spec_local.depth)])


def _halo_adj(mesh, spec_local: LAT.LatticeSpec, ys_ext):
    """Adjoint of ``_halo_fwd``: fold each extended lattice's halo plane
    back onto the right neighbour's first plane."""
    depth = spec_local.depth
    p = [_planes(spec_local, d) for d in range(depth)]
    sizes = [p[d] * ys_ext[d].shape[1] for d in range(depth)]
    last = torch.cat([ys_ext[d][-p[d]:].reshape(-1) for d in range(depth)])
    _, back = SP.exchange(mesh, None, last)
    out = []
    for d, b in enumerate(torch.split(back, sizes)):
        slab = ys_ext[d][:-p[d]].clone()
        slab[:p[d]] += b.view(p[d], -1)
        out.append(slab)
    return tuple(out)


def _halo_refresh(mesh, spec_local: LAT.LatticeSpec, bufs):
    """One-time feature/activity halo: overwrite each extended buffer's
    LAST x-plane with the right neighbour's first owned plane (``bufs``:
    per-depth buffers, depth after depth, any number of rounds)."""
    rows = [_planes(spec_local, i % spec_local.depth)
            for i in range(len(bufs))]
    return append_right(mesh, [b[:-p] for b, p in zip(bufs, rows)], rows)


def _psum_dot(mesh):
    """The CG inner product of two tuples, summed over the slabs."""
    def dot(a, b):
        return SP.psum(mesh, sum((x.float() * y.float()).sum()
                                 for x, y in zip(a, b)))
    return dot


def _pcg_psum(matvec, b, precond, tol: float, max_iters: int, mesh):
    """PCG whose dot products are summed over the mesh (the distributed
    twin of ``solver/pcg.pcg``, whose host stopping rule then reads the
    same residual on every rank)."""
    return pcg(matvec, b, precond=precond, tol=tol, max_iters=max_iters,
               dot=_psum_dot(mesh))


# ------------------------------------------------------------------- solve
def local_scatter(spec_local, basis_features, splan: ShardedPlan, r: int,
                  dev):
    """This slab's owned voxels' basis features and activity on the
    local lattice (halo planes zero): per depth (cells_loc, Cb) and
    (cells_loc, 1) f32."""
    fds, ads = [], []
    for d in range(spec_local.depth):
        act = torch.as_tensor(splan.vox_active_loc[d][r], device=dev)
        cells = torch.as_tensor(splan.vox_cell_loc[d][r], device=dev,
                                dtype=torch.int64)[act]
        src = torch.as_tensor(splan.vox_src[d][r], device=dev,
                              dtype=torch.int64)[act]
        feats = basis_features[d][src].float()
        nc = spec_local.n_cells(d)
        fds.append(torch.zeros((nc, feats.shape[-1]), device=dev)
                   .index_add_(0, cells, feats))
        ads.append(torch.zeros((nc, 1), device=dev).index_add_(
            0, cells, torch.ones((cells.shape[0], 1), device=dev)))
    return fds, ads


def sharded_system(mesh, splan: ShardedPlan, interp, basis_features,
                   gr_targets: torch.Tensor, voxel_size: float,
                   pos_weight: float, normal_weight: float,
                   reg_weight: float, approx_grad: bool,
                   compute_dtype=torch.float32):
    """This rank's slab of the primal normal equations: (matvec over slab
    lattices, rhs, Jacobi preconditioner), as ``fields/lattice.
    primal_system`` gives them.
    ``basis_features`` (per depth (cap_d, Cb)) and ``gr_targets``
    (s_gr, 3, hierarchy order) are the GLOBAL arrays every rank holds;
    the plan's source tables pick the slab's rows."""
    spec_l = splan.spec_local
    r = SP.rank(mesh)
    if SP.size(mesh) != splan.n_shards:
        raise ValueError(f"the plan has {splan.n_shards} slabs, the mesh "
                         f"{SP.size(mesh)} ranks")
    dev = basis_features[0].device
    i64 = torch.int64

    def up(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    m = int(splan.mask[r].sum())
    gr_a = up(splan.gr_active[r])
    # the global row counts first: a collective every rank reaches before
    # any neighbour exchange
    n_pts = torch.clamp(SP.psum(mesh, torch.tensor(float(m), device=dev)),
                        min=1.0)
    m_vox = torch.clamp(SP.psum(mesh, gr_a.float().sum()), min=1.0)
    fds, ads = local_scatter(spec_l, basis_features, splan, r, dev)
    # owned voxels live in the slab; the halo plane comes from the right
    tabs = _halo_refresh(mesh, spec_l, fds + ads)
    depth = spec_l.depth
    fdp = [LAT.corner_table(t, spec_l, d) for d, t in enumerate(tabs[:depth])]
    adp = [LAT.corner_table(t, spec_l, d) for d, t in enumerate(tabs[depth:])]
    b_pt, m_pt, b_gr = LAT.assemble_rows(
        spec_l, interp, fdp, adp, up(splan.xyz[r, :m]),
        up(splan.cell0[r, :m], i64), up(splan.dest[r, :m], i64),
        up(splan.slot_cells_pt[r], i64), up(splan.gr_coords[r], i64),
        up(splan.gr_depth[r], i64), gr_a, up(splan.slot_cells_gr[r], i64),
        voxel_size, approx_grad)
    del fdp, adp, tabs
    b_pt = b_pt.to(compute_dtype).float()
    b_gr = b_gr.to(compute_dtype).float()

    w_pt = m_pt * (pos_weight / n_pts)
    w_gr = gr_a.float() * (normal_weight / m_vox * voxel_size ** 2)
    targets = torch.where(gr_a[:, None],
                          gr_targets[up(splan.gr_src[r], i64)], 0.0)
    real = torch.cat([m_pt.amax(1) > 0, gr_a])
    op = LAT.SlotOperator(
        spec_l, b_pt, b_gr, up(splan.slot_cell0_pt[r]),
        up(splan.slot_cell0_gr[r]), real, compute_dtype,
        extend=lambda xs: _halo_fwd(mesh, spec_l, xs),
        fold=lambda ys: _halo_adj(mesh, spec_l, ys))
    return LAT.primal_system(op, w_pt, w_gr, targets, reg_weight)


@torch.no_grad()
def sharded_lattice_solve(mesh, splan: ShardedPlan, interp, basis_features,
                          gr_targets: torch.Tensor, voxel_size: float,
                          pos_weight: float, normal_weight: float,
                          reg_weight: float, tol: float, max_iters: int,
                          approx_grad: bool = False,
                          compute_dtype=torch.float32):
    """Distributed PCG over the slab-sharded lattice (arguments as in
    ``sharded_system``).  Returns this rank's slab lattices, per depth
    (slab_x[d] * Y * Z, k) f32, and (iters, rel_res), the same on every
    rank."""
    matvec, rhs, precond = sharded_system(
        mesh, splan, interp, basis_features, gr_targets, voxel_size,
        pos_weight, normal_weight, reg_weight, approx_grad, compute_dtype)
    xs, iters, rel = _pcg_psum(matvec, rhs, precond, tol, max_iters, mesh)
    return tuple(xs), (iters, rel)


def gather_alphas(mesh, plan, splan: ShardedPlan, xs_slab,
                  vox_cell: Sequence[torch.Tensor],
                  vox_active: Sequence[torch.Tensor]):
    """Every rank's slab lattices gathered into the global ones (slabs
    are contiguous x-ranges of the flat lattice, in rank order), and the
    per-voxel coefficients read from them as the single-device solve
    reads its own.  Returns (alphas, dense_xs): per depth (cap_d * k,)
    and (cells_d, k) f32, the same on every rank."""
    k = plan.spec.k
    sizes = [x.numel() for x in xs_slab]
    g = SP.all_gather_cat(mesh, torch.cat([x.reshape(-1) for x in xs_slab]))
    dense, alphas = [], []
    for d, part in enumerate(torch.split(g, sizes, dim=1)):
        xd = part.reshape(-1, k)
        dense.append(xd)
        rows = torch.where(vox_active[d][:, None],
                           xd.index_select(0, vox_cell[d]), 0.0)
        alphas.append(rows.reshape(-1))
    return tuple(alphas), tuple(dense)


class ShardedSolution(NamedTuple):
    """What the sharded mesher needs of a solved sharded field: the mesh,
    the global and sliced plans, this rank's slab lattices and what the
    evaluator reads (the interpolators, the global basis features)."""
    mesh: object
    plan: LAT.LatticePlan
    splan: ShardedPlan
    xs_slab: Tuple[torch.Tensor, ...]
    interp: object
    basis_features: Tuple[torch.Tensor, ...]
    voxel_size: float
    compute_dtype: object
    approx_grad: bool
