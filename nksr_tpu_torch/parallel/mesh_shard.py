"""Dual marching cubes of a sharded field, slab by slab (counterpart of
nksr_tpu/parallel/mesh_shard.py).

After the sharded solve each rank holds its slab's coefficient lattices
(``lattice_shard.ShardedSolution``).  Each rank meshes its slab without
the global fine lattice, and every rank ends with the whole mesh:
``extract_dual_mesh`` on a sharded field is a collective that every rank
calls.

  * Each slab builds its evaluator tables (the ``av0_cascade`` kernel on
    its lattices, corner features, trust mask, extraction shell) on a
    slab + 2 halo-plane lattice; the two halo planes of coefficients,
    features and activity come from the right neighbour in one
    exchange.  Only right halos exist: a left halo would shift the local
    origin and break the zero-phase parent map (x >> d).
  * Vertex ownership is shifted two fine planes right of the slab's
    start: slab s owns the crossing cells at local fine x in [2, Wf + 2)
    (Wf = slab_x[0] * f), the cells whose corner values, candidate
    dilation and trust mask are exact without left data.  A quad's base
    cell is the largest of its four, so a slab owns the quads based in
    its extent, which also read the vertices at local fine x == 1: the
    duplicate plane, the left neighbour's last owned plane.  The world's
    first two fine planes are owned by nobody: the lattice's margin
    leaves them inactive.
  * Candidates, corner values, topology and the Newton step are the
    dense mesher's (``meshing/lattice_mc.py``) on the slab's lattice.
  * The host joins the slabs: the owned vertices in slab order, and the
    duplicate plane's vertices by a sorted merge of their world fine-cell
    keys into the left neighbour's owned keys.
  * With a UDF mask head the merged quads are trimmed as the dense
    mesher trims (``lattice_mc.trim_quads``), each vertex judged once,
    by its owner; the JAX package's sharded mesher ignores the mask.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..core import host_build as HB
from ..fields import lattice as LAT
from ..fields.lattice_eval import LatticeEvalContext, tables_from
from ..meshing import lattice_mc as LMC
from ..native import sorted_join
from . import lattice_shard as LS
from . import spatial as SP


def _mesh_spec(spec: LAT.LatticeSpec, slab_x) -> LAT.LatticeSpec:
    """Local spec with TWO halo x-planes per depth."""
    return dataclasses.replace(
        spec, dims=tuple((slab_x[d] + 2,) + spec.dims[d][1:]
                         for d in range(spec.depth)))


def _halo2(mesh, spec_m: LAT.LatticeSpec, bufs):
    """Per-depth slab buffers (slab_x[d] planes; depth after depth, any
    number of rounds) extended by the right neighbour's first TWO
    x-planes (the open chain's last rank reads zeros: the lattice's
    margin leaves those planes inactive)."""
    depth = spec_m.depth
    rows = [spec_m.dims[i % depth][1] * spec_m.dims[i % depth][2]
            for i in range(len(bufs))]
    return LS.append_right(mesh, bufs, rows, planes=2)


def _slab_tables(sol: LS.ShardedSolution, spec_m, r: int):
    """This slab's evaluator tables on the slab + 2 lattice."""
    depth, splan = spec_m.depth, sol.splan
    dev = sol.xs_slab[0].device
    spec_l = splan.spec_local
    fds, ads = LS.local_scatter(spec_l, sol.basis_features, splan, r, dev)
    # drop the scatter's (empty) halo plane: the slabs' planes only
    planes = [spec_l.dims[d][1] * spec_l.dims[d][2] for d in range(depth)]
    slabs = [t[:-planes[i % depth]] for i, t in enumerate(fds + ads)]
    ext = _halo2(sol.mesh, spec_m, list(sol.xs_slab) + slabs)
    xs_ext = ext[:depth]
    fdp = [LAT.corner_table(t, spec_m, d)
           for d, t in enumerate(ext[depth:2 * depth])]
    adp = [LAT.corner_table(t, spec_m, d)
           for d, t in enumerate(ext[2 * depth:])]
    return xs_ext, tables_from(spec_m, xs_ext, fdp, adp, sol.compute_dtype)


@torch.no_grad()
def extract_dual_mesh_sharded(sol: LS.ShardedSolution, mise_iter: int = 0,
                              grid_upsample: int = 1,
                              max_points: Optional[int] = None,
                              udf_mask: Optional[Callable] = None,
                              trim_stats: Optional[dict] = None,
                              texture=None) -> Optional[LMC.TriangleMesh]:
    """The dual mesh of a sharded field, the same on every rank (a
    collective).  Arguments as ``lattice_mc.extract_dual_mesh_dense``'s.
    Returns None, on every rank alike, where it does not apply: a depth's
    slab under 2 planes (the 2-plane halo would wrap), f == 1 (the
    duplicate plane's corner reads would reach the inexact second halo
    plane) or a slab's fine grid over ``DENSE_CELL_BUDGET``."""
    plan, splan = sol.plan, sol.splan
    spec = plan.spec
    depth = spec.depth
    slab_x, n = splan.slab_x, splan.n_shards
    f = max(int(grid_upsample), 1) * (2 ** max(int(mise_iter), 0))
    if any(slab_x[d] < 2 for d in range(depth)) or f < 2:
        return None
    spec_m = _mesh_spec(spec, slab_x)
    Xm, Ym, Zm = spec_m.dims[0]
    if Xm * Ym * Zm * f ** 3 > LMC.DENSE_CELL_BUDGET:
        return None
    r = SP.rank(sol.mesh)
    xs_ext, tables = _slab_tables(sol, spec_m, r)
    org = plan.origins.astype(np.int64).copy()
    org[:, 0] += r * np.asarray(slab_x, np.int64)
    ctx = LatticeEvalContext(
        spec_m, org, sol.interp, sol.basis_features, None, None,
        sol.voxel_size, sol.approx_grad, sol.compute_dtype, xs_ext,
        tables=tables)

    wf = slab_x[0] * f
    cand, corner = LMC.candidates(tables.shell0, spec_m.dims[0], f,
                                  x_range=(1, wf + 1))
    v_dense = LMC.corner_values(ctx, corner, f, max_points)
    del corner
    verts, centers, quads, flips, cc = LMC.topology(
        v_dense, cand, org[0], f, sol.voxel_size, quad_x_min=2,
        return_cells=True)
    del v_dense, cand
    if mise_iter > 0 and len(verts):
        verts = LMC.newton_step(ctx, verts, centers, f, max_points)
    wc = (cc + torch.as_tensor(org[0], device=cc.device) * f).cpu().numpy()
    # ownership: world fine planes [left_s, left_s + wf) of the lattice,
    # left_s = (ox + s slab_x[0]) f + 2; the duplicate plane precedes the
    # owned block in the x-ascending enumeration
    left = [(int(plan.origins[0][0]) + s * slab_x[0]) * f + 2
            for s in range(n)]
    n_dup = int((wc[:, 0] < left[r]).sum())
    keep = None
    t_trim = 0.0
    if udf_mask is not None:
        t0 = time.perf_counter()
        keep = udf_mask(verts[n_dup:]).cpu().numpy() if len(verts) > n_dup \
            else np.zeros(0, bool)
        t_trim += time.perf_counter() - t0
    part = dict(v=verts.float().cpu().numpy(), keys=HB.pack64(wc),
                n_dup=n_dup, quads=[q.cpu().numpy() for q in quads],
                flips=[fl.cpu().numpy() for fl in flips], keep=keep)
    del verts, centers, quads, flips, ctx, tables, xs_ext
    parts = SP.all_gather_object(sol.mesh, part)
    return _merge(parts, udf_mask is not None, trim_stats, t_trim,
                  texture, sol.xs_slab[0].device)


def _merge(parts, trim: bool, trim_stats, t_trim, texture, device
           ) -> LMC.TriangleMesh:
    """Join the slabs' vertex lists and quads on the host (every rank
    alike): owned vertices in slab order, the duplicate plane resolved
    into the left neighbour's owned vertices; then the trim, the
    triangles and the compaction of unreferenced vertices."""
    n = len(parts)
    n_own = [len(p["v"]) - p["n_dup"] for p in parts]
    base = np.concatenate([[0], np.cumsum(n_own)[:-1]]).astype(np.int64)
    lv2g = []
    for s, p in enumerate(parts):
        nd = p["n_dup"]
        g = np.full(len(p["v"]), -1, np.int64)
        # owned verts are the contiguous x-ascending suffix
        g[nd:] = base[s] + np.arange(n_own[s])
        if s > 0 and nd:
            # duplicate plane == left neighbour's LAST owned plane
            q = parts[s - 1]
            j = sorted_join(q["keys"][q["n_dup"]:], p["keys"][:nd])
            g[:nd] = np.where(j >= 0, base[s - 1] + j.astype(np.int64), -1)
        lv2g.append(g)
    keep_g = np.concatenate([p["keep"] for p in parts]) if trim else None

    quads, flips = [], []
    dropped = faces_before = 0
    for s, p in enumerate(parts):
        for q, fl in zip(p["quads"], p["flips"]):
            if not len(q):
                continue
            gq = lv2g[s][q]
            ok = (gq >= 0).all(1)
            dropped += int((~ok).sum())
            quads.append(gq[ok])
            flips.append(fl[ok])
    if trim:
        t0 = time.perf_counter()
        faces_before = 2 * sum(len(q) for q in quads)
        quads, flips = LMC.trim_quads(quads, flips, keep_g)
        t_trim += time.perf_counter() - t0
        if trim_stats is not None:
            trim_stats.update(
                seconds=t_trim, faces=faces_before,
                dropped=faces_before - 2 * sum(len(q) for q in quads))
    if dropped:
        warnings.warn(f"sharded mesh: {dropped} quads dropped at slab "
                      "seams (unresolved duplicate-vertex references)")
    tris = []
    for q, fl in zip(quads, flips):
        q = np.where(fl[:, None], q[:, ::-1], q)
        tris += [q[:, [0, 1, 2]], q[:, [0, 2, 3]]]
    fcs = np.concatenate(tris, 0) if tris else np.zeros((0, 3), np.int64)
    verts = np.concatenate([p["v"][p["n_dup"]:] for p in parts], 0) \
        if n else np.zeros((0, 3), np.float32)
    used = np.zeros(len(verts), bool)
    used[fcs.reshape(-1)] = True
    remap = np.cumsum(used, dtype=np.int64) - 1
    verts = np.ascontiguousarray(verts[used], np.float32)
    return LMC.TriangleMesh(
        v=verts, f=remap[fcs].astype(np.int32),
        c=LMC.vertex_colours(texture, torch.as_tensor(verts, device=device))
        if len(verts) else None)
