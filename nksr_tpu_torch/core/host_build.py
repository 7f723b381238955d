"""Host-side (numpy) splat hierarchy: the integer structure the lattice
plan is built from.  A numpy-only copy of the functions of
nksr_tpu/core/host_build.py that the splat path uses (that module
imports JAX through its package); tests hold the two byte-identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import native

_OFFS2 = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                  -1).reshape(8, 3).astype(np.int64)


def pack64(coords: np.ndarray) -> np.ndarray:
    c = coords.astype(np.int64) + (1 << 20)
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def unpack64(keys: np.ndarray) -> np.ndarray:
    if keys.ndim == 1:
        out = native.unpack_keys(keys)
        if out is not None:
            return out
    i = (keys >> 42) - (1 << 20)
    j = ((keys >> 21) & ((1 << 21) - 1)) - (1 << 20)
    k = (keys & ((1 << 21) - 1)) - (1 << 20)
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
