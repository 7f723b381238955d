"""Host-side (numpy) hierarchies and index tables: the integer structure
the lattice plan, the gather-conv UNet and the support-row solve are
built from.  A numpy-only copy of the functions of
nksr_tpu/core/host_build.py that the port's routes use (that module
imports JAX through its package): the splat hierarchy, the adaptive
(normal-variation) hierarchy, and the pruning and child expansion of
the predicted hierarchy; tests hold the two byte-identical.

Every table is built here, on the host, by sorted joins; the device
programs that read them do no sort and no search.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .. import native

_OFFS2 = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                  -1).reshape(8, 3).astype(np.int64)


# A voxel's 64-bit key: each coordinate plus KEY_BIAS in a 21-bit field,
# i in the top one, so that keys sort in (i, j, k) order.
KEY_BIAS = 1 << 20
KEY_MASK = (1 << 21) - 1


def pack64(coords: np.ndarray) -> np.ndarray:
    c = coords.astype(np.int64) + KEY_BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def unpack64(keys: np.ndarray) -> np.ndarray:
    if keys.ndim == 1:
        out = native.unpack_keys(keys)
        if out is not None:
            return out
    i = (keys >> 42) - KEY_BIAS
    j = ((keys >> 21) & KEY_MASK) - KEY_BIAS
    k = (keys & KEY_MASK) - KEY_BIAS
    return np.stack([i, j, k], -1).astype(np.int32)


def pack_floor64(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """``pack64(floor(xyz / voxel_size))`` (f32 division + floor)."""
    out = native.pack_floor_keys(xyz, voxel_size)
    if out is not None:
        return out
    return pack64(np.floor(xyz / voxel_size).astype(np.int64))


class HostGrid(NamedTuple):
    coords: np.ndarray   # (n, 3) int32, sorted by packed key
    keys: np.ndarray     # (n,) int64 sorted
    voxel_size: float


def _half_keys(keys: np.ndarray) -> np.ndarray:
    """pack64(c) -> pack64(c >> 1) per component (arithmetic shift)."""
    out = native.half_keys(keys)
    if out is not None:
        return out
    b = np.int64(1 << 20)
    m = np.int64((1 << 21) - 1)
    i = (keys >> 42) - b
    j = ((keys >> 21) & m) - b
    k = (keys & m) - b
    return (((i >> 1) + b) << 42) | (((j >> 1) + b) << 21) | ((k >> 1) + b)


def _offset_delta(off: np.ndarray) -> int:
    """pack64(c + off) - pack64(c): packing is linear in the coords."""
    return (int(off[0]) << 42) + (int(off[1]) << 21) + int(off[2])


def build_splat_grids_ex(xyz: np.ndarray, voxel_size: float, depth: int):
    """Splat hierarchy (the 8 voxel corners around each point, per level)
    plus the per-level sorted point-base keys and point order.

    One radix sort of the depth-0 base keys; each coarser level halves
    the sorted keys (cell_d = cell_0 >> d), re-sorts the 8 near-sorted
    parity runs stably, dedups, and corner-expands by an 8-way merge."""
    grids, orders = [], []
    deltas = np.array([_offset_delta(o) for o in _OFFS2], np.int64)
    base = pack_floor64(xyz, voxel_size)
    order = native.radix_argsort(base)
    sb = base[order]
    for d in range(depth):
        vs = voxel_size * (2.0 ** d)
        if d > 0:
            h = _half_keys(sb)
            rep = np.argsort(h, kind="stable")
            sb = h[rep]
            order = order[rep]
        if len(sb):
            first = np.concatenate([[True], sb[1:] != sb[:-1]])
            ub = sb[first]
        else:
            ub = sb
        keys = native.merge_unique(ub, deltas)
        grids.append(HostGrid(coords=unpack64(keys), keys=keys,
                              voxel_size=vs))
        orders.append((sb, order))
    return grids, orders


def build_adaptive_grids(xyz: np.ndarray, normal: np.ndarray,
                         voxel_size: float, depth: int, tau: float = 0.1,
                         adaptive_depth: int = 1,
                         splat=None) -> List[HostGrid]:
    """Normal-variation hierarchy: levels >= adaptive_depth - 1 are the
    splat levels; a finer level keeps a splat corner only where its
    parent's normal variation ``max_p (1 - n_p . nbar)`` over the points
    nearest to it exceeds ``tau``.  ``splat``: the output of
    ``build_splat_grids_ex`` on the same points, reused."""
    grids: List[Optional[HostGrid]] = [None] * depth
    if splat is None:
        splat = build_splat_grids_ex(xyz, voxel_size, depth)
    splat, orders = splat
    for d in range(max(adaptive_depth - 1, 0), depth):
        grids[d] = splat[d]
    deltas = np.array([_offset_delta(o) for o in _OFFS2], np.int64)
    for d in range(adaptive_depth - 2, -1, -1):
        parent = grids[d + 1]
        pvs = parent.voxel_size
        # nearest parent voxel center per point (round = node-centered)
        pcell = pack64(np.round(xyz / pvs).astype(np.int64))
        pidx = keys_lookup(parent, pcell)
        ok = pidx >= 0
        seg = pidx[ok]
        npar = len(parent.keys)
        nn = normal[ok]
        nsum = np.stack([np.bincount(seg, weights=nn[:, c],
                                     minlength=npar) for c in range(3)], 1)
        nbar = nsum / (np.linalg.norm(nsum, axis=1, keepdims=True) + 1e-6)
        dev = 1.0 - np.sum(nn * nbar[seg], axis=1)
        sigma = np.zeros(npar, np.float64)
        np.maximum.at(sigma, seg, dev)
        cnt = np.bincount(seg, minlength=npar)
        refine = (sigma > tau) & (cnt > 0)
        # candidates at level d: the splat corners whose parent refines
        sb, _ = orders[d]
        ub = sb[np.concatenate([[True], sb[1:] != sb[:-1]])] if len(sb) \
            else sb
        corners = native.merge_unique(ub, deltas)
        cpar = pack64(np.floor_divide(unpack64(corners).astype(np.int64),
                                      2))
        cpi = keys_lookup(parent, cpar)
        # an empty parent level refines nothing (the JAX package's copy
        # raises IndexError there: a take from an empty array)
        keep = (cpi >= 0) & np.take(refine, np.clip(cpi, 0, None)) \
            if npar else np.zeros(len(corners), bool)
        keys = corners[keep]
        grids[d] = HostGrid(coords=unpack64(keys), keys=keys,
                            voxel_size=voxel_size * (2.0 ** d))
    return grids


def prune(grid: HostGrid, keep: np.ndarray) -> HostGrid:
    """The rows of a grid where ``keep`` holds, in their (sorted) order."""
    return HostGrid(coords=grid.coords[keep], keys=grid.keys[keep],
                    voxel_size=grid.voxel_size)


def children_of(grid: HostGrid, refined_rows: np.ndarray
                ) -> Tuple[HostGrid, np.ndarray, np.ndarray]:
    """The 8 children (one level finer) of the given rows of a grid:
    (the child grid sorted by key, the parent row of each child, the
    octant of each child in ``child_offsets`` order).  Children of
    distinct parents never collide, so nothing is deduplicated."""
    pk = grid.keys[refined_rows]
    doubled = 2 * pk - pack64(np.zeros((1, 3), np.int64))
    deltas = np.array([_offset_delta(o) for o in _OFFS2], np.int64)
    ckeys = (doubled[:, None] + deltas[None]).ravel()
    parent = np.repeat(refined_rows, 8)
    order = native.radix_argsort(ckeys)
    ckeys = ckeys[order]
    coords = unpack64(ckeys)
    oct_ = coords - 2 * np.floor_divide(coords, 2)
    oct_id = (oct_[:, 0] * 4 + oct_[:, 1] * 2 + oct_[:, 2]).astype(np.int32)
    return (HostGrid(coords=coords, keys=ckeys,
                     voxel_size=grid.voxel_size * 0.5),
            parent[order].astype(np.int32), oct_id)


def lookup(grid: HostGrid, coords: np.ndarray) -> np.ndarray:
    """Index of each (n, 3) coord in the sorted grid, -1 if absent."""
    return native.keysearch(grid.keys, pack64(coords))


def keys_lookup(grid: HostGrid, keys: np.ndarray) -> np.ndarray:
    """Index of each packed key in the sorted grid, -1 if absent."""
    return native.keysearch(grid.keys, keys)


def _stencil_tables(keys: np.ndarray, offsets: np.ndarray,
                    base_keys: Optional[np.ndarray] = None,
                    cap: Optional[int] = None) -> np.ndarray:
    """(len(base), K) indices of base + offset in the sorted key set (-1
    absent; with ``cap``, indices >= cap also fold to -1).  The shifted
    query keys stay sorted per offset, so the table is K merge joins in
    one pass."""
    base = keys if base_keys is None else base_keys
    deltas = np.array([_offset_delta(o) for o in offsets], np.int64)
    return native.stencil_join(keys, base, deltas, cap=cap)


def nbr_table(grid: HostGrid, cap: int, stencil: np.ndarray) -> np.ndarray:
    """(cap, K) stencil table of one grid, -1 past its voxels."""
    n = min(len(grid.keys), cap)
    t = np.full((cap, stencil.shape[0]), -1, np.int32)
    if n:
        t[:n] = _stencil_tables(grid.keys, stencil.astype(np.int64),
                                base_keys=grid.keys[:n], cap=cap)
    return t


class UNetTables(NamedTuple):
    """Index tables of the gather-conv UNet (numpy int32).

    ``nbr[d]`` (cap_d, 27) stencil rows of level d; ``child[d]``
    (cap_{d+1}, 8) children of level d+1 in level d; ``parent[d]`` and
    ``skip[d]`` (cap_d,) for d < depth - 1: the row of each level-d
    voxel's parent in level d+1 and its encoder skip row in level d (the
    two lookups the JAX UNet's teacher-forced decoder makes on the
    device, ``cand.lookup(floor(c / 2))`` and ``enc.lookup(c)``; padding
    rows look up coordinate 0 as there)."""
    nbr: Tuple[np.ndarray, ...]
    child: Tuple[np.ndarray, ...]
    parent: Tuple[np.ndarray, ...]
    skip: Tuple[np.ndarray, ...]


def _padded_coords(grid: HostGrid, cap: int) -> np.ndarray:
    n = min(len(grid.keys), cap)
    c = np.zeros((cap, 3), np.int64)
    c[:n] = grid.coords[:n]
    return c


def build_unet_tables(grids: Sequence[HostGrid], capacities: Sequence[int],
                      stencil: np.ndarray, decoder: bool = True
                      ) -> UNetTables:
    """The UNet's tables; ``decoder=False`` leaves ``parent`` and ``skip``
    empty (an engine that builds its decoder's own tables)."""
    nbr = tuple(nbr_table(g, cap, stencil)
                for g, cap in zip(grids, capacities))
    child, parent, skip = [], [], []
    for d in range(len(grids) - 1):
        fine, coarse = grids[d], grids[d + 1]
        cap_c, cap_f = capacities[d + 1], capacities[d]
        n = min(len(coarse.keys), cap_c)
        # child keys = pack64(2c + off) = 2 * pack64(c) - pack64(0) + delta
        doubled = 2 * coarse.keys[:n] - pack64(np.zeros((1, 3), np.int64))
        t = np.full((cap_c, 8), -1, np.int32)
        t[:n] = _stencil_tables(fine.keys, _OFFS2, base_keys=doubled,
                                cap=cap_f)
        child.append(t)
        if not decoder:
            continue
        c = _padded_coords(fine, cap_f)
        parent.append(lookup(coarse, np.floor_divide(c, 2)))
        skip.append(lookup(fine, c))
    return UNetTables(nbr=nbr, child=tuple(child), parent=tuple(parent),
                      skip=tuple(skip))


def support_indices(grids: Sequence[HostGrid], capacities: Sequence[int],
                    x: np.ndarray, presorted=None) -> Tuple[np.ndarray, ...]:
    """Per depth, the (Q, 8) rows of each query's 8 surrounding voxel
    centers (the field's basis support), -1 where absent or >= cap.
    Queries are sorted once per depth so the 8 offset columns become
    merge joins; ``presorted[d]`` = (sorted base keys, order) reuses the
    sort of ``build_splat_grids_ex``."""
    out = []
    for i, (g, cap) in enumerate(zip(grids, capacities)):
        if len(g.keys) == 0:
            out.append(np.full((x.shape[0], 8), -1, np.int32))
            continue
        if presorted is not None:
            sorted_base, order = presorted[i]
        else:
            base = pack64(np.floor(x / g.voxel_size).astype(np.int64))
            order = native.radix_argsort(base)
            sorted_base = base[order]
        idx_sorted = _stencil_tables(g.keys, _OFFS2, base_keys=sorted_base,
                                     cap=cap)
        idx = np.empty_like(idx_sorted)
        idx[order] = idx_sorted
        out.append(idx)
    return tuple(out)
