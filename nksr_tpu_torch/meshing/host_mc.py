"""Host-orchestrated sparse dual marching cubes (counterpart of
nksr_tpu/meshing/host_mc.py).

The structure half (extraction lattice, MISE subdivision, corner dedup,
edge topology) runs in numpy and the native sorted joins on the host;
the math half (field values and gradients) is the field's own device
evaluator, called in waves.  It meshes the support-row field, and the
lattice field when the dense fine grid is over ``DENSE_CELL_BUDGET``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native
from ..core import host_build as HB
from ..utils.profiling import PhaseTimer
from .lattice_mc import _CORNER_OFFS, _EDGES, _QUAD_VOX_OFFS, TriangleMesh


def _ring27_deltas() -> np.ndarray:
    r = np.arange(-1, 2, dtype=np.int64)
    d27 = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return np.sort(np.array([HB._offset_delta(o) for o in d27], np.int64))


def extraction_lattice_host(host_grids, adaptive_depth: int,
                            grid_upsample: int = 1) -> np.ndarray:
    """Union of the adaptive-depth voxels at the finest resolution times
    ``grid_upsample``, dilated by the full 27-ring (dual-MC quads reach
    diagonal voxels)."""
    u = max(int(grid_upsample), 1)
    parts = []
    for d in range(adaptive_depth):
        g = host_grids[d]
        f = (2 ** d) * u
        if f == 1:
            parts.append(g.coords.astype(np.int64))
        else:
            r = np.arange(f) - (f - 1) // 2
            offs = np.stack(np.meshgrid(r, r, r, indexing="ij"),
                            -1).reshape(-1, 3).astype(np.int64)
            parts.append((g.coords.astype(np.int64)[:, None, :] * f
                          + offs[None]).reshape(-1, 3))
    base = native.sort_unique(HB.pack64(np.concatenate(parts, 0)))
    return HB.unpack64(native.merge_unique(base, _ring27_deltas())
                       ).astype(np.int64)


def host_extract_dual_mesh(hf, mise_iter: int = 0, grid_upsample: int = 1,
                           max_points=None) -> TriangleMesh:
    """Dual mesh of ``hf`` (a ``recon.host_field.HostField``) on its
    extraction lattice; ``max_points`` bounds each field-evaluation
    wave.  Seconds per stage go into ``hf.phase_times`` as "mc: ..."."""
    times: dict = {}
    tm = PhaseTimer(hf.device, times, accumulate=True)
    u = max(int(grid_upsample), 1)
    s = hf.host_grids[0].voxel_size / u
    vox = extraction_lattice_host(hf.host_grids, hf.cfg.adaptive_depth, u)
    tm.lap("mc: extraction lattice")

    def _waves(pts, fn):
        if max_points is None or len(pts) <= max_points:
            return fn(pts)
        outs = [fn(pts[i:i + int(max_points)])
                for i in range(0, len(pts), int(max_points))]
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate([o[j] for o in outs], 0)
                         for j in range(len(outs[0])))
        return np.concatenate(outs, 0)

    eval_grad = (lambda pts: _waves(
        pts, lambda p: hf._eval_batched(p, grad=True, tm=tm))
    ) if mise_iter else None
    mesh = dual_mc_on_lattice(
        vox, s, lambda pts: _waves(pts, lambda p: hf.eval_fbar_batched(
            p, tm=tm)), eval_grad, mise_iter, tm)
    hf.phase_times.update(times)
    return mesh


def dual_mc_on_lattice(vox: np.ndarray, s: float, eval_fbar,
                       eval_grad=None, mise_iter: int = 0,
                       tm: Optional[PhaseTimer] = None) -> TriangleMesh:
    """Dual MC on an int64 voxel lattice of cell size ``s`` with host
    field evaluators.  ``mise_iter`` rounds keep the sign-crossing voxels
    (27-ring dilated), subdivide them 2x and halve the cell size; a
    single Newton polish toward the zero set follows when gradients are
    given.  ``tm`` times the stages."""
    if tm is None:
        tm = PhaseTimer("cpu", {})
    if len(vox) == 0:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32), None)
    corner_offs = _CORNER_OFFS.astype(np.int64)
    corner_deltas = np.sort(np.array(
        [HB._offset_delta(o) for o in corner_offs], np.int64))

    def corner_fields(vox_keys, s):
        """Unique corner lattice (8-way sorted merge), field values at
        the corners and the (V, 8) per-voxel corner value table."""
        corner_keys = native.merge_unique(vox_keys, corner_deltas)
        cc = HB.unpack64(corner_keys).astype(np.int64)
        tm.lap("mc: corner lattice")
        f_corner = np.asarray(
            eval_fbar((cc.astype(np.float32) - 0.5) * s), np.float32)
        tm.lap("mc: field eval")
        cidx = HB._stencil_tables(corner_keys, corner_offs,
                                  base_keys=vox_keys)
        fvals = np.where(cidx >= 0, f_corner[np.maximum(cidx, 0)],
                         np.float32(-abs(s)))
        tm.lap("mc: corner lattice")
        return corner_keys, f_corner, fvals

    vox = vox.astype(np.int64)
    vox_keys = HB.pack64(vox)

    d27k = _ring27_deltas()
    for _ in range(int(mise_iter)):
        # pack64 holds 21 bits an axis; doubling must stay well inside
        if np.abs(vox).max(initial=0) >= (1 << 19):
            raise ValueError(
                "MISE subdivision would overflow the 21-bit-per-axis "
                "lattice key budget (|coord| >= 2^19); reduce mise_iter "
                "or grid_upsample, or recentre/rescale the scene")
        _, _, fvals = corner_fields(vox_keys, s)
        sign_v = fvals > 0
        cross_v = sign_v.any(1) & ~sign_v.all(1)
        if not cross_v.any():
            break
        # dilate the crossing set one coarse 27-ring before subdividing
        # (the fine field can cross just outside the coarse crossing
        # voxels), take the 27 children 2v + {-1, 0, 1} of each, and
        # seal with a fine 27-ring; all in key space by k-way merges
        ck = native.merge_unique(native.sort_unique(HB.pack64(vox[cross_v])),
                                 d27k)
        kids_keys = native.merge_unique(HB.pack64(HB.unpack64(ck) * 2), d27k)
        vox_keys = native.merge_unique(kids_keys, d27k)
        vox = HB.unpack64(vox_keys).astype(np.int64)
        s *= 0.5
        tm.lap("mc: mise subdivision")

    neg_default = -abs(s)
    corner_keys, f_corner, fvals = corner_fields(vox_keys, s)

    # dual vertices: means of the edge crossings, for the sign-crossing
    # voxels only (the only ones a quad can reference)
    sign_vv = fvals > 0
    crossing = sign_vv.any(1) & ~sign_vv.all(1)
    ci = np.nonzero(crossing)[0]
    centers = vox.astype(np.float32) * s
    verts = centers.copy()
    ea, eb = _EDGES[:, 0], _EDGES[:, 1]
    fa, fb = fvals[ci][:, ea], fvals[ci][:, eb]
    cross = (fa > 0) != (fb > 0)
    t = fa / (fa - fb + 1e-20)
    vc_ci = vox[ci][:, None, :] + corner_offs[None]        # (Ci, 8, 3)
    pa = (vc_ci[:, ea].astype(np.float32) - 0.5) * s
    pb = (vc_ci[:, eb].astype(np.float32) - 0.5) * s
    pc = pa + t[..., None] * (pb - pa)
    w = cross.astype(np.float32)
    wsum = w.sum(1, keepdims=True)
    verts[ci] = np.where(
        wsum > 0, (pc * w[..., None]).sum(1) / np.maximum(wsum, 1e-20),
        centers[ci]).astype(np.float32)

    tm.lap("mc: dual vertices")

    # one Newton polish toward the zero set, clipped to the dual cell
    if eval_grad is not None and int(mise_iter) > 0 and len(ci):
        v, g = eval_grad(verts[ci])
        step = v[:, None] * g / (np.sum(g * g, 1, keepdims=True) + 1e-12)
        nv = verts[ci] - np.clip(step, -0.5 * s, 0.5 * s)
        verts[ci] = np.clip(nv, centers[ci] - 0.5 * s,
                            centers[ci] + 0.5 * s)
    tm.lap("mc: newton")

    # quads over sign-changing corner edges
    tris = []
    sign = f_corner > 0
    for a in range(3):
        nb = HB._stencil_tables(corner_keys,
                                np.eye(3, dtype=np.int64)[a][None],
                                base_keys=corner_keys)[:, 0]
        f1 = np.where(nb >= 0, f_corner[np.maximum(nb, 0)], neg_default)
        rows = np.nonzero(sign != (f1 > 0))[0]
        if len(rows) == 0:
            continue
        vidx = HB._stencil_tables(vox_keys, -_QUAD_VOX_OFFS[a],
                                  base_keys=corner_keys[rows])
        ok = (vidx >= 0).all(1)
        vidx = vidx[ok]
        flip = ~sign[rows][ok]
        vidx = np.where(flip[:, None], vidx[:, ::-1], vidx)
        tris.append(vidx[:, [0, 1, 2]])
        tris.append(vidx[:, [0, 2, 3]])
    if not tris:
        return TriangleMesh(verts, np.zeros((0, 3), np.int32), None)
    f = np.concatenate(tris, 0).astype(np.int32)
    # drop the dual vertices no face references
    used, inv = np.unique(f.reshape(-1), return_inverse=True)
    mesh = TriangleMesh(v=verts[used], f=inv.reshape(-1, 3).astype(np.int32),
                        c=None)
    tm.lap("mc: quads")
    return mesh
