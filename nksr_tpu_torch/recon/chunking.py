"""Chunked out-of-core reconstruction for scenes that exceed one solve
(counterpart of nksr_tpu/recon/chunking.py).

The scene is split into ``chunk_size`` cubes, each reconstructed alone
through ``Reconstructor.reconstruct`` with a halo of neighbouring points
(the kernel support's reach at the coarsest level plus the dual-MC
stencil).  Each chunk's field is parked on ``recon.chunk_tmp_device``
(the CPU) after its solve, and the mesh is one global dual MC over the
union of the chunks' extraction lattices, every corner and vertex read
from the chunks' partition-of-unity blend, so the seams need no welding.
``extract_dual_mesh`` moves every chunk back to the Reconstructor's
device first: a chunk left on the CPU would mesh on the CPU.

Chunks of the in-graph route (``structure="predicted_ingraph"``, whose
fields are ``KernelField``s, not ``HostField``s) mesh one by one instead,
each by its own ``extract_dual_mesh`` (``meshing/dual_mc.py``): a chunk
keeps the triangles whose centroid lies in its own cell, and the
appended meshes are welded at 1e-4 voxel (the JAX package's
``_extract_per_chunk``); their field is each point's owning chunk's.

Colours: the union mesh takes the first chunk's texture field (None if
that chunk has none, as in the JAX package); per-chunk meshing appends
each chunk's colours over the vertices it keeps (a chunk's texture is
set on its field, ``chunks[i]["field"].set_texture_field``).

The orchestration is numpy, line for line the JAX package's (the rows'
unique taken through packed keys, the same rows in the same order), so
the chunk set, halos and point selections are the same.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core import host_build as HB
from ..meshing.host_mc import dual_mc_on_lattice, extraction_lattice_host
from ..meshing.lattice_mc import TriangleMesh
from ..utils.profiling import PhaseTimer
from .host_field import HostField


class ChunkedField:
    """Stitched view over per-chunk fields (host-orchestrated).  Each
    chunk is a dict: ``cid`` (its integer cell), ``lo``, ``hi`` (its
    bounds), ``field`` (a ``HostField``), ``n_points`` (with its halo),
    ``engine`` and ``seconds`` (its reconstruction and parking).
    ``device``: where the chunks are evaluated; ``phase_times``: seconds
    per stage of the reconstruction ("chunks: ...") and of the last mesh
    extraction ("mc: ...")."""

    def __init__(self, chunks, chunk_size: float, voxel_size: float,
                 origin=None, id_lo=None, id_hi=None, device="cpu",
                 phase_times: Optional[dict] = None):
        self.chunks = chunks
        self.chunk_size = chunk_size
        self.voxel_size = voxel_size
        self.origin = origin
        self.id_lo = id_lo
        self.id_hi = id_hi
        self.device = torch.device(device)
        self.phase_times = {} if phase_times is None else phase_times

    def _host_chunks(self):
        """The chunks whose fields are ``HostField``s (all or none)."""
        return [ch for ch in self.chunks if isinstance(ch["field"], HostField)]

    def _own_cell(self, pts: np.ndarray) -> np.ndarray:
        """Chunk cell owning each point, clamped so that geometry at the
        boundary maps onto an existing cell."""
        cell = np.floor((pts - self.origin) / self.chunk_size).astype(
            np.int64)
        return np.clip(cell, self.id_lo, self.id_hi)

    # ------------------------------------------------------------- queries
    def evaluate_f_bar(self, x: np.ndarray) -> np.ndarray:
        """Partition-of-unity blended field, the same field the mesher
        extracts; chunks without host grids route each point to its
        owning chunk's field."""
        x = np.asarray(x, np.float32)
        host_chunks = self._host_chunks()
        if host_chunks:
            return self._blend_eval(host_chunks, x)
        out = np.full(x.shape[0], -self.voxel_size, np.float32)
        cells = self._own_cell(x)
        for ch in self.chunks:
            own = np.all(cells == ch["cid"], axis=1)
            if own.any():
                f = ch["field"].to(self.device)
                out[own] = f.evaluate_f_bar(x[own]).cpu().numpy()
        return out

    def _chunk_weight(self, ch, pts, blend):
        """Partition-of-unity weight: linear ramps of width 2*blend at
        interior cell boundaries (neighbors' ramps sum to 1), extended
        past the scene edge at extreme cells."""
        lo = self.origin + ch["cid"] * self.chunk_size
        hi = lo + self.chunk_size
        w = np.ones(pts.shape[0], np.float32)
        for a in range(3):
            rise = np.clip((pts[:, a] - lo[a]) / (2 * blend) + 0.5, 0, 1)
            fall = np.clip((hi[a] - pts[:, a]) / (2 * blend) + 0.5, 0, 1)
            if ch["cid"][a] == self.id_lo[a]:
                rise = np.ones_like(rise)
            if ch["cid"][a] == self.id_hi[a]:
                fall = np.ones_like(fall)
            w *= rise * fall
        return w

    def _blend_eval(self, host_chunks, pts, grad=False, tm=None):
        """The chunks' blend at ``pts``: values (and gradients); ``tm``
        (a ``PhaseTimer``) splits the values' time into "mc: field eval"
        and the UDF mask's stages."""
        blend = 2.0 * self.voxel_size
        acc = np.zeros(pts.shape[0], np.float32)
        gacc = np.zeros((pts.shape[0], 3), np.float32)
        wsum = np.zeros(pts.shape[0], np.float32)
        for ch in host_chunks:
            w = self._chunk_weight(ch, pts, blend)
            sel = w > 0
            if not sel.any():
                continue
            hf = ch["field"]
            if grad:
                v, g = hf._eval_batched(pts[sel], grad=True)
            else:
                v = hf._eval_batched(pts[sel])
                if tm is not None:
                    tm.lap("mc: field eval")
                m = hf._mask_host(pts[sel], tm)
                v = np.where(m, v, -self.voxel_size)
            acc[sel] += w[sel] * v
            if grad:
                gacc[sel] += w[sel, None] * g
            wsum[sel] += w[sel]
        vals = np.where(wsum > 0, acc / np.maximum(wsum, 1e-12),
                        -self.voxel_size).astype(np.float32)
        if grad:
            return vals, gacc / np.maximum(wsum[:, None], 1e-12)
        return vals

    # ------------------------------------------------------------- meshing
    def extract_dual_mesh(self, mise_iter: int = 0, grid_upsample: int = 1,
                          max_points: Optional[int] = None) -> TriangleMesh:
        """One GLOBAL dual MC over the union lattice (the host mesher);
        every corner and vertex reads the chunks' blend.  Every chunk is
        moved to ``device`` first; each chunk's evaluator tables are built
        there at its first evaluation.  Seconds per stage go into
        ``phase_times`` ("mc: ...").  In-graph chunks mesh one by one
        (``_extract_per_chunk``; ``max_points`` bounds their waves)."""
        host_chunks = self._host_chunks()
        if not host_chunks:
            return self._extract_per_chunk(mise_iter, grid_upsample,
                                           max_points)
        times: dict = {}
        tm = PhaseTimer(self.device, times, accumulate=True)
        for ch in host_chunks:
            ch["field"].to(self.device)
        tm.lap("mc: chunks to device")
        u = max(int(grid_upsample), 1)
        s = self.voxel_size / u
        # union of all chunks' lattices (the lattice is a global integer
        # grid, so overlapping halo regions dedup exactly via the keys)
        vox_parts = [extraction_lattice_host(ch["field"].host_grids,
                                             ch["field"].cfg.adaptive_depth,
                                             u)
                     for ch in host_chunks]
        vox = HB.unpack64(np.unique(HB.pack64(
            np.concatenate(vox_parts, 0)))).astype(np.int64)
        tm.lap("mc: extraction lattice")

        # the first chunk's texture, even None (the JAX package's
        # ``next`` over the chunks yields the first chunk's value)
        mesh = dual_mc_on_lattice(
            vox, s, lambda p: self._blend_eval(host_chunks, p, tm=tm),
            eval_grad=lambda p: self._blend_eval(host_chunks, p, grad=True),
            mise_iter=mise_iter, tm=tm,
            texture=host_chunks[0]["field"].texture_field)
        self.phase_times.update(times)
        return mesh

    def _extract_per_chunk(self, mise_iter, grid_upsample, max_points
                           ) -> TriangleMesh:
        """Each chunk's own dual mesh on ``device``, cut to the triangles
        whose centroid its cell owns, appended and welded at 1e-4
        voxel; the colours of the chunks that have a texture, appended
        in the same order (the JAX package's)."""
        times: dict = {}
        tm = PhaseTimer(self.device, times, accumulate=True)
        verts, tris, cols = [], [], []
        off = 0
        for ch in self.chunks:
            field = ch["field"].to(self.device)
            tm.lap("mc: chunks to device")
            mesh = field.extract_dual_mesh(mise_iter=mise_iter,
                                           grid_upsample=grid_upsample,
                                           max_points=max_points)
            tm.lap("mc: chunk meshes")
            if mesh.v.shape[0] == 0 or mesh.f.shape[0] == 0:
                continue
            tri_c = mesh.v[mesh.f].mean(1)
            own = np.all(self._own_cell(tri_c) == ch["cid"], axis=1)
            used, inv = np.unique(mesh.f[own], return_inverse=True)
            verts.append(mesh.v[used])
            tris.append(inv.reshape(-1, 3) + off)
            if mesh.c is not None:
                cols.append(mesh.c[used])
            off += used.shape[0]
        if not verts:
            return TriangleMesh(v=np.zeros((0, 3), np.float32),
                                f=np.zeros((0, 3), np.int32), c=None)
        if cols and len(cols) != len(verts):
            raise ValueError("some chunks have a texture field and some do "
                             "not: set one on every chunk or on none")
        mesh = weld_vertices(TriangleMesh(
            v=np.concatenate(verts, 0),
            f=np.concatenate(tris, 0).astype(np.int32),
            c=np.concatenate(cols, 0) if cols else None),
            eps=1e-4 * self.voxel_size)
        tm.lap("mc: weld")
        self.phase_times.update(times)
        return mesh


def weld_vertices(mesh: TriangleMesh, eps: float) -> TriangleMesh:
    """Merge vertices closer than eps (chunk-seam duplicates)."""
    if mesh.v.shape[0] == 0:
        return mesh
    q = np.round(mesh.v / max(eps, 1e-12)).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    v = mesh.v[first]
    c = None if mesh.c is None else mesh.c[first]
    f = inv[mesh.f].astype(np.int32)
    # drop degenerate triangles created by welding
    keep = ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
            & (f[:, 0] != f[:, 2]))
    return TriangleMesh(v=v, f=f[keep], c=c)


def unique_rows(ids: np.ndarray) -> np.ndarray:
    """``np.unique(ids, axis=0)`` of non-negative (n, 3) int64 chunk ids
    (the same rows in the same lexicographic order) through packed
    int64 keys: the row sort takes seconds at 1M points."""
    dims = ids.max(0) + 1
    if float(np.prod(dims.astype(np.float64))) >= 2.0 ** 62:
        return np.unique(ids, axis=0)
    keys = np.unique(np.ravel_multi_index(ids.T, dims))
    return np.stack(np.unravel_index(keys, dims), 1).astype(np.int64)


def reconstruct_chunked(recon, xyz: np.ndarray,
                        normal: Optional[np.ndarray],
                        sensor: Optional[np.ndarray], chunk_size: float,
                        approx_kernel_grad: bool = False,
                        solver_tol: float = 1e-5, mesh=None) -> ChunkedField:
    """The scene in chunks, each reconstructed alone and parked.  With
    ``mesh`` (``parallel.spatial.reconstruct_chunks_sharded``) chunk i is
    reconstructed on rank i % n and then broadcast from it, so every
    rank returns the whole field."""
    cfg = recon.config
    vs = cfg.voxel_size
    # halo: kernel support reach at the coarsest level + DMC stencil
    halo = vs * (2 ** cfg.tree_depth) + 2 * vs
    times: dict = {}
    tm = PhaseTimer(recon.device, times, accumulate=True)

    lo = xyz.min(0)
    ids = np.floor((xyz - lo) / chunk_size).astype(np.int64)
    uniq = unique_rows(ids)
    tm.lap("chunks: split")

    kept = []
    for cid in uniq:
        c_lo = lo + cid * chunk_size
        sel = np.all((xyz >= c_lo - halo) & (xyz < c_lo + chunk_size + halo),
                     axis=1)
        tm.lap("chunks: select")
        if sel.sum() >= 16:
            kept.append((cid, c_lo, sel))

    n, r = 1, 0
    if mesh is not None:
        from ..parallel import spatial as SP
        n, r = SP.size(mesh), SP.rank(mesh)
    chunks = []
    for i, (cid, c_lo, sel) in enumerate(kept):
        if i % n != r:
            chunks.append(None)
            continue
        t0 = time.perf_counter()
        field = recon.reconstruct(
            xyz[sel],
            None if normal is None else normal[sel],
            sensor=None if sensor is None else sensor[sel],
            detail_level=None, voxel_size=vs,
            approx_kernel_grad=approx_kernel_grad, solver_tol=solver_tol)
        engine = (recon._last_pred_engine if cfg.structure_mode == "predicted"
                  else recon._last_unet_engine)
        tm.lap("chunks: reconstruct")
        # park the chunk off the card until the mesh
        field.to(recon.chunk_tmp_device)
        tm.lap("chunks: park")
        chunks.append({"cid": cid, "lo": c_lo, "hi": c_lo + chunk_size,
                       "field": field, "n_points": int(sel.sum()),
                       "engine": engine,
                       "seconds": time.perf_counter() - t0})
    if mesh is not None:
        chunks = SP.share_chunks(mesh, chunks, recon.network,
                                 recon.chunk_tmp_device)
        tm.lap("chunks: share")
    return ChunkedField(chunks, chunk_size, vs, origin=lo,
                        id_lo=uniq.min(0), id_hi=uniq.max(0),
                        device=recon.device, phase_times=times)
