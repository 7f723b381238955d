"""Dense-lattice dual marching cubes (counterpart of
nksr_tpu/meshing/lattice_mc.py).

On the dense fine grid (depth-0 lattice refined ``f`` times) every
structure op is a shift:

  * candidate cells = the upsampled extraction shell, box-dilated by one
    cell;
  * corner values   = one field-evaluation wave at the candidate corners,
    written into a dense corner buffer (every other corner reads the
    sealed default ``-voxel_size / f``);
  * crossing cells  = cells whose 8 corner signs differ;
  * dual vertices   = means of the edge crossings of each crossing cell;
  * quads           = sign changes along +x/+y/+z corner edges whose 4
                      surrounding cells all cross; vertex ids are ranks
                      from a cumulative sum over the crossing cells;
  * UDF trim        = with a UDF mask head, after the Newton step, every
                      quad with a dual vertex outside the mask is
                      dropped (the JAX package's dense-mesher semantics:
                      open rims where the host mesher would seal);
  * colours         = with a texture field, its values at the vertices
                      the faces keep, after the compaction.

Compaction is ``torch.nonzero`` (ascending flat ids) and ``cumsum``.
Everything stays on the device until the one copy of the finished mesh
(the trim's host support join reads a copy of the vertices).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# cells around an a-axis corner edge, in quad winding order (cell =
# corner - offset)
_QUAD_VOX_OFFS = np.array([
    [[0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]],   # x-edge
    [[0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]],   # y-edge
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],   # z-edge
], dtype=np.int64)
_CORNER_OFFS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                        -1).reshape(8, 3)
_EDGES = np.array([[a, b] for a in range(8) for b in range(a + 1, 8)
                   if bin(a ^ b).count("1") == 1], np.int64)

# fine cells (X*Y*Z*f^3) the dense mesher may hold
DENSE_CELL_BUDGET = 140_000_000


class TriangleMesh(NamedTuple):
    """Host-side mesh result (.v / .f / .c as the reference returns)."""
    v: np.ndarray            # (Nv, 3) float32
    f: np.ndarray            # (Nf, 3) int32
    c: Optional[np.ndarray]  # (Nv, 3) vertex colors or None


def vertex_colours(tex, verts) -> Optional[np.ndarray]:
    """The texture field's (Nv, C) values at the vertices (numpy or a
    tensor; the field evaluates in waves on its own device), as numpy;
    None without a texture."""
    if tex is None:
        return None
    c = tex.evaluate_f(torch.as_tensor(verts, device=tex.device)).value
    return c.cpu().numpy()


def _dilate1(a: torch.Tensor) -> torch.Tensor:
    """Box dilation by one cell (separable: +-1 along each axis)."""
    for ax in range(3):
        n = a.shape[ax]
        b = a.clone()
        b.narrow(ax, 1, n - 1).logical_or_(a.narrow(ax, 0, n - 1))
        b.narrow(ax, 0, n - 1).logical_or_(a.narrow(ax, 1, n - 1))
        a = b
    return a


def candidates(shell0: torch.Tensor, dims0, f: int, x_range=None):
    """Candidate fine cells and the corners they use: (Xf, Yf, Zf) and
    (Xf+1, Yf+1, Zf+1) bool.  ``x_range`` (lo, hi): keep only the cells
    with fine x in [lo, hi] (a slab of the sharded mesher)."""
    X, Y, Z = dims0
    m = shell0.view(X, Y, Z)
    for ax in range(3):
        m = m.repeat_interleave(f, dim=ax)
    cand = _dilate1(m)
    if x_range is not None:
        cand[:x_range[0]] = False
        cand[x_range[1] + 1:] = False
    Xf, Yf, Zf = cand.shape
    cg = torch.zeros((Xf + 1, Yf + 1, Zf + 1), dtype=torch.bool,
                     device=cand.device)
    cg[:-1, :-1, :-1] = cand
    corner = cg.clone()
    for o in _CORNER_OFFS[1:]:
        a, b, c = (int(v) for v in o)
        corner[a:, b:, c:] |= cg[:Xf + 1 - a, :Yf + 1 - b, :Zf + 1 - c]
    return cand, corner


def _unravel(ids: torch.Tensor, shape) -> torch.Tensor:
    _, Y, Z = shape
    return torch.stack([ids // (Y * Z), (ids // Z) % Y, ids % Z], -1)


def corner_values(ctx, corner: torch.Tensor, f: int,
                  max_points: Optional[int] = None) -> torch.Tensor:
    """f_bar at every candidate corner, the sealed default elsewhere."""
    s_f = ctx.voxel_size / f
    dev = corner.device
    ids = torch.nonzero(corner.reshape(-1))[:, 0]
    origin0 = torch.as_tensor(ctx.origins[0].astype(np.int64), device=dev)
    cw = _unravel(ids, corner.shape) + origin0 * f
    pos = (cw.float() - 0.5) * s_f
    val, mask = ctx.evaluate(pos, max_chunk=max_points)
    v_dense = torch.full((corner.numel(),), -abs(s_f), device=dev)
    v_dense[ids] = torch.where(mask, val, -ctx.voxel_size)
    return v_dense.view(corner.shape)


def topology(v_dense: torch.Tensor, cand: torch.Tensor, origin0, f: int,
             voxel_size: float, quad_x_min: int = 0,
             return_cells: bool = False):
    """Dual vertices at the crossing cells (edge-crossing means), their
    cell centers, and per axis the quads (4 vertex ids) with their flip
    flags.  ``quad_x_min``: only quads whose base cell has fine x >= it
    (a slab of the sharded mesher owns the quads based in its extent);
    ``return_cells``: the crossing cells' fine coordinates (V, 3) too."""
    Xf, Yf, Zf = cand.shape
    s_f = voxel_size / f
    dev = v_dense.device
    S = v_dense > 0
    any_pos = torch.zeros_like(cand)
    all_pos = torch.ones_like(cand)
    for o in _CORNER_OFFS:
        a, b, c = (int(v) for v in o)
        so = S[a:a + Xf, b:b + Yf, c:c + Zf]
        any_pos |= so
        all_pos &= so
    cross = any_pos & ~all_pos & cand
    flatc = cross.reshape(-1)
    cid = torch.nonzero(flatc)[:, 0]
    cc = _unravel(cid, cand.shape)                            # (V, 3)

    offs = torch.as_tensor(_CORNER_OFFS, device=dev)
    cn = cc[:, None, :] + offs                                # (V, 8, 3)
    fv = v_dense[cn[..., 0], cn[..., 1], cn[..., 2]]          # (V, 8)
    cw = cc + torch.as_tensor(np.asarray(origin0, np.int64), device=dev) * f
    corner_pos = ((cw[:, None, :] + offs).float() - 0.5) * s_f
    ea = torch.as_tensor(_EDGES[:, 0], device=dev)
    eb = torch.as_tensor(_EDGES[:, 1], device=dev)
    fa, fb = fv[:, ea], fv[:, eb]
    ecross = (fa > 0) != (fb > 0)
    t = fa / (fa - fb + 1e-20)
    pa, pb = corner_pos[:, ea], corner_pos[:, eb]
    pc = pa + t[..., None] * (pb - pa)
    w = ecross.float()
    wsum = w.sum(1, keepdim=True)
    centers = cw.float() * s_f
    verts = torch.where(wsum > 0, (pc * w[..., None]).sum(1)
                        / torch.clamp(wsum, min=1e-20), centers)

    # quads: every quad's base corner is a crossing cell's min corner, so
    # candidates enumerate the crossing cells (ascending flat ids)
    rank = torch.cumsum(flatc.int(), 0) - 1                   # vertex id
    s_base = S[cc[:, 0], cc[:, 1], cc[:, 2]]
    quads, flips = [], []
    for a in range(3):
        e = [0, 0, 0]
        e[a] = 1
        sa = S[cc[:, 0] + e[0], cc[:, 1] + e[1], cc[:, 2] + e[2]]
        ok = s_base != sa
        if quad_x_min:
            ok &= cc[:, 0] >= quad_x_min
        vids = []
        for off in _QUAD_VOX_OFFS[a]:
            nb = cc - torch.as_tensor(off, device=dev)
            inb = (nb >= 0).all(-1)
            nflat = (nb[:, 0] * Yf + nb[:, 1]) * Zf + nb[:, 2]
            nflat = torch.where(inb, nflat, 0)
            ok &= inb & flatc[nflat]
            vids.append(rank[nflat])
        quads.append(torch.stack(vids, -1)[ok])
        flips.append(~s_base[ok])
    if return_cells:
        return verts, centers, quads, flips, cc
    return verts, centers, quads, flips


def newton_step(ctx, verts: torch.Tensor, centers: torch.Tensor, f: int,
                max_points: Optional[int] = None) -> torch.Tensor:
    """One Newton step toward the zero set, clipped to the dual cell."""
    s_f = ctx.voxel_size / f
    val, _, g = ctx.evaluate(verts, grad=True, max_chunk=max_points)
    step = val[:, None] * g / ((g * g).sum(1, keepdim=True) + 1e-12)
    out = verts - torch.clamp(step, -0.5 * s_f, 0.5 * s_f)
    return torch.minimum(torch.maximum(out, centers - 0.5 * s_f),
                         centers + 0.5 * s_f)


def trim_quads(quads, flips, keep_vertex: torch.Tensor):
    """The quads (and their flip flags) whose 4 vertices all pass
    ``keep_vertex``."""
    kept_q, kept_f = [], []
    for q, fl in zip(quads, flips):
        keep = keep_vertex[q].all(1)
        kept_q.append(q[keep])
        kept_f.append(fl[keep])
    return kept_q, kept_f


@torch.no_grad()
def extract_dual_mesh_dense(ctx, mise_iter: int = 0, grid_upsample: int = 1,
                            max_points: Optional[int] = None,
                            udf_mask: Optional[Callable] = None,
                            trim_stats: Optional[dict] = None,
                            texture=None) -> Optional[TriangleMesh]:
    """Dense-lattice extraction.  ``mise_iter`` rounds double the
    extraction resolution and add a Newton polish; ``max_points`` bounds
    each evaluation wave.  ``udf_mask`` (device vertices -> device bool)
    trims the quads with a vertex it rejects; ``trim_stats`` then gets
    the trim's "seconds" and the triangles before it ("faces") and
    dropped by it ("dropped").  ``texture`` (a ``PCNNField`` or None)
    colours the vertices the faces keep.  None when the fine grid is over
    ``DENSE_CELL_BUDGET``: the host mesher (``meshing/host_mc.py``) takes
    over."""
    spec = ctx.spec
    f = max(int(grid_upsample), 1) * (2 ** max(int(mise_iter), 0))
    X, Y, Z = spec.dims[0]
    if X * Y * Z * f ** 3 > DENSE_CELL_BUDGET:
        return None
    tables = ctx.tables()
    cand, corner = candidates(tables.shell0, spec.dims[0], f)
    v_dense = corner_values(ctx, corner, f, max_points)
    verts, centers, quads, flips = topology(
        v_dense, cand, ctx.origins[0], f, ctx.voxel_size)
    if mise_iter > 0 and len(verts):
        verts = newton_step(ctx, verts, centers, f, max_points)

    if udf_mask is not None:
        sync = verts.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(verts.device)
        t0 = time.perf_counter()
        n_before = 2 * sum(len(q) for q in quads)
        if len(verts):
            quads, flips = trim_quads(quads, flips, udf_mask(verts))
        if sync:
            torch.cuda.synchronize(verts.device)
        if trim_stats is not None:
            trim_stats.update(
                seconds=time.perf_counter() - t0, faces=n_before,
                dropped=n_before - 2 * sum(len(q) for q in quads))

    tris = []
    for q, fl in zip(quads, flips):
        q = torch.where(fl[:, None], q.flip(1), q)
        tris += [q[:, [0, 1, 2]], q[:, [0, 2, 3]]]
    fcs = torch.cat(tris, 0)
    # drop unreferenced vertices (crossing cells without quads)
    used = torch.zeros(len(verts), dtype=torch.bool, device=verts.device)
    used[fcs.reshape(-1)] = True
    remap = torch.cumsum(used.long(), 0) - 1
    verts = verts[used]
    # the JAX package colours a mesh with a face, after the compaction
    return TriangleMesh(
        v=verts.float().cpu().numpy(), f=remap[fcs].int().cpu().numpy(),
        c=vertex_colours(texture, verts) if len(verts) else None)
