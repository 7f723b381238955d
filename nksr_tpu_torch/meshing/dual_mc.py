"""Sparse dual marching cubes of the in-graph fields (counterpart of
nksr_tpu/meshing/dual_mc.py ``extract_dual_mesh``), the mesher of
``Reconstructor(structure="predicted_ingraph")`` and of the training
forward's fields.

The JAX package meshes such a field as one static-capacity program; here
the structure half runs in numpy and the native sorted joins, the field
values and gradients on the field's device in waves, each wave's supports
joined on the host (``core/host_build.support_indices``):

  1. the extraction lattice: the adaptive-depth decoder voxels expanded
     to the finest resolution times ``grid_upsample``, sorted by packed
     key (the JAX package's ``SparseGrid.from_coords`` order, so vertex
     and face arrays compare directly);
  2. the unique corner lattice, cut at twice the lattice's capacity;
  3. the masked field ``evaluate_f_bar`` at the corners, -1 at a corner
     the cut dropped;
  4. one dual vertex per extraction voxel at the mean of its edge
     crossings (the voxel centre where there is none), then ``mise_iter``
     Newton steps ``v <- v - clip(f grad f / |grad f|^2, +-s/2)``, their
     supports joined again after every step (a vertex may move into
     another voxel's support), and the clip to the voxel;
  5. one quad per sign-changing corner edge whose four voxels exist,
     wound by the base corner's sign, kept in corner-lattice order up to
     ``max_quads`` (the lattice's capacity by default) and split into two
     interleaved triangles;
  6. with a texture field (``set_texture_field``), the colour of every
     extraction vertex (``vertex_colours``; the JAX package colours its
     whole padded vertex array and trims it with the mesh).

The JAX package's static capacities are part of the output and are kept:
every extraction voxel has a vertex (``n_vertices`` is the lattice's
size), the corner and quad cuts are the same.  ``mise_iter`` means Newton
steps here, taken only where the field has coefficients (a
``KernelField``; the neural geometry head has none, as in the JAX
package); in ``meshing/host_mc.py`` it means MISE subdivision.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..core import host_build as HB
from .lattice_mc import (_CORNER_OFFS, _EDGES, _QUAD_VOX_OFFS, TriangleMesh,
                         vertex_colours)

# points per field-evaluation wave (its supports are joined on the host)
WAVE = 1 << 20


def _expand(coords: np.ndarray, factor: int) -> np.ndarray:
    """Each voxel's factor^3 descendants at voxel_size / factor (the
    node-centred convention)."""
    if factor == 1:
        return coords.astype(np.int64)
    r = np.arange(factor) - (factor - 1) // 2
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int64)
    return (coords.astype(np.int64)[:, None, :] * factor
            + offs[None]).reshape(-1, 3)


def extraction_lattice(field, grid_upsample: int):
    """(sorted packed keys, capacity, fine cell size) of the union of the
    adaptive-depth decoder voxels at the finest resolution; the capacity
    is the JAX package's, the sum over those depths of capacity x
    (2^d u)^3."""
    u = max(int(grid_upsample), 1)
    ad = field.mesh_adaptive_depth
    grids, caps = field.host_grids, field.capacities
    fine = np.float32(np.float32(field.voxel_sizes[0]) / np.float32(u))
    cap = sum(caps[d] * (2 ** d * u) ** 3 for d in range(ad))
    keys = native.sort_unique(HB.pack64(np.concatenate(
        [_expand(grids[d].coords, 2 ** d * u) for d in range(ad)], 0)))
    return keys[:cap], cap, fine


def _waves(x: np.ndarray, fn, wave: int):
    outs = [fn(x[i:i + wave]) for i in range(0, max(len(x), 1), wave)]
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([o[j] for o in outs], 0)
                     for j in range(len(outs[0])))
    return np.concatenate(outs, 0)


def extract_dual_mesh(field, mise_iter: int = 0, grid_upsample: int = 1,
                      max_points: Optional[int] = None,
                      max_quads: Optional[int] = None) -> TriangleMesh:
    """Dual-MC mesh of ``field.evaluate_f_bar == 0``; ``max_points``
    bounds a field-evaluation wave, ``max_quads`` the quads kept."""
    tex = getattr(field, "texture_field", None)
    wave = int(max_points or WAVE)
    ext_keys, cap_v, s = extraction_lattice(field, grid_upsample)
    vox = HB.unpack64(ext_keys).astype(np.int64)
    n_vox = len(ext_keys)
    if n_vox == 0:
        v = np.zeros((0, 3), np.float32)
        return TriangleMesh(v, np.zeros((0, 3), np.int32),
                            vertex_colours(tex, v))
    cap_quad = max_quads or cap_v

    # ---- unique corner lattice -------------------------------------------
    corner_offs = _CORNER_OFFS.astype(np.int64)
    deltas = np.array([HB._offset_delta(o) for o in corner_offs], np.int64)
    corner_keys = native.merge_unique(ext_keys, np.sort(deltas))[:2 * cap_v]
    cc = HB.unpack64(corner_keys).astype(np.int64)
    f_corner = _waves((cc.astype(np.float32) - np.float32(0.5)) * s,
                      lambda p: _to_np(field.evaluate_f_bar(p)), wave)
    cidx = HB._stencil_tables(corner_keys, corner_offs, base_keys=ext_keys)
    fvals = np.where(cidx >= 0, f_corner[np.maximum(cidx, 0)],
                     np.float32(-1.0))

    # ---- dual vertex per voxel: mean of edge crossings -------------------
    ea, eb = _EDGES[:, 0], _EDGES[:, 1]
    fa, fb = fvals[:, ea], fvals[:, eb]                       # (V, 12)
    cross = (fa > 0) != (fb > 0)
    t = fa / (fa - fb + np.float32(1e-20))
    vc = vox[:, None, :] + corner_offs[None]                  # (V, 8, 3)
    pa = (vc[:, ea].astype(np.float32) - np.float32(0.5)) * s
    pb = (vc[:, eb].astype(np.float32) - np.float32(0.5)) * s
    pc = pa + t[..., None] * (pb - pa)
    w = cross.astype(np.float32)
    wsum = w.sum(1, keepdims=True)
    centers = vox.astype(np.float32) * s
    verts = np.where(wsum > 0,
                     (pc * w[..., None]).sum(1) / (wsum + np.float32(1e-20)),
                     centers).astype(np.float32)

    # ---- Newton refinement (mise_iter) -----------------------------------
    half = np.float32(0.5) * s
    for _ in range(int(mise_iter) if field.alpha is not None else 0):
        v, g = _waves(verts, lambda p: tuple(
            _to_np(a) for a in field.evaluate_at(p, grad=True)), wave)
        step = v[:, None] * g / (np.sum(g * g, 1, keepdims=True)
                                 + np.float32(1e-12))
        verts = (verts - np.clip(step, -half, half)).astype(np.float32)
    verts = np.clip(verts, centers - half, centers + half)

    # ---- quads over sign-changing corner edges ---------------------------
    quads, flips = [], []
    for a in range(3):
        nb = HB._stencil_tables(corner_keys,
                                np.eye(3, dtype=np.int64)[a][None],
                                base_keys=corner_keys)[:, 0]
        f1 = np.where(nb >= 0, f_corner[np.maximum(nb, 0)], np.float32(-1.0))
        rows = np.nonzero((f_corner > 0) != (f1 > 0))[0]
        vidx = HB._stencil_tables(ext_keys, -_QUAD_VOX_OFFS[a],
                                  base_keys=corner_keys[rows])
        ok = (vidx >= 0).all(1)
        quads.append(vidx[ok])
        flips.append(f_corner[rows[ok]] <= 0)
    quads = np.concatenate(quads, 0)[:cap_quad]
    flip = np.concatenate(flips, 0)[:cap_quad]
    quads = np.where(flip[:, None], quads[:, ::-1], quads)
    # two triangles per quad, interleaved
    tris = np.stack([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]],
                    1).reshape(-1, 3).astype(np.int32)
    verts = verts[:n_vox]
    return TriangleMesh(v=verts, f=tris, c=vertex_colours(tex, verts))


def _to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
