"""Host sort, join and lattice-index ops, the kd-tree of the mesh metrics
and the ray-cast occupancy test: ctypes over this package's copy of the
JAX package's C++ host sources, ``host_src/sortops.cpp``,
``host_src/kdtree.cpp`` and ``host_src/raycast.cpp``, compiled with
``g++`` into one library in this package's build directory at first
use.  The copies are the JAX package's code line for line (a test holds
them equal), so the port builds from its own tree alone.

Every op keeps the fallback the original module has
(nksr_tpu/native/__init__.py: numpy, and scipy's cKDTree for the
kd-tree), taken when no C++ toolchain is present.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(_PKG / "host_src" / name
                for name in ("sortops.cpp", "kdtree.cpp", "raycast.cpp"))
BUILD_DIR = _PKG / "_build"

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def _build(lib_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-fPIC", "-pthread", "-shared", "-o", tmp,
                        *map(str, SOURCES)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    lib_path = BUILD_DIR / "libnksr_host.so"
    if (not lib_path.exists()
            or any(lib_path.stat().st_mtime < src.stat().st_mtime
                   for src in SOURCES)):
        try:
            _build(lib_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.radix_argsort_i64.argtypes = [_I64P, ctypes.c_int64, _I64P]
    lib.merge_unique_i64.restype = ctypes.c_int64
    lib.merge_unique_i64.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                     ctypes.c_int32, _I64P]
    lib.flat_cells_i64.argtypes = [
        _I64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _I32P]
    lib.pack_floor_keys_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        _I64P]
    lib.half_keys_i64.argtypes = [_I64P, ctypes.c_int64, _I64P]
    lib.unpack_keys_i64.argtypes = [_I64P, ctypes.c_int64, _I32P]
    lib.minmax_i32.argtypes = [_I32P, ctypes.c_int64, _I32P]
    lib.radix_sort_unique_i64.restype = ctypes.c_int64
    lib.radix_sort_unique_i64.argtypes = [_I64P, ctypes.c_int64]
    lib.stencil_join_i64.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                     ctypes.c_int64, _I64P, ctypes.c_int32,
                                     ctypes.c_int32, _I32P]
    lib.keysearch_i64.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                  ctypes.c_int64, _I32P, ctypes.c_int32]
    lib.sorted_join_i64.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                    ctypes.c_int64, _I32P]
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [_F32P, ctypes.c_int64]
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_query.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64,
                                 ctypes.c_int32, _F32P, _I32P,
                                 ctypes.c_int32]
    lib.raycast_inside.argtypes = [
        _F32P, ctypes.c_int64, _I32P, ctypes.c_int64, _F32P, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
    return lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of int64 keys."""
    lib = _load()
    k = np.ascontiguousarray(keys, np.int64)
    if lib is None:
        return np.argsort(k, kind="stable")
    out = np.empty(k.shape[0], np.int64)
    lib.radix_argsort_i64(_p64(k), k.shape[0], _p64(out))
    return out


def sort_unique(keys: np.ndarray) -> np.ndarray:
    """Sorted unique int64 keys."""
    lib = _load()
    k = np.ascontiguousarray(keys, np.int64).copy()
    if lib is None:
        return np.unique(k)
    m = lib.radix_sort_unique_i64(_p64(k), k.shape[0])
    return k[:m]


def _searchsorted_join(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    if len(keys) == 0:      # nothing to find (and no keys[pos] to read)
        return np.full(q.shape[0], -1, np.int32)
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, len(keys) - 1)
    return np.where(keys[pos_c] == q, pos_c, -1).astype(np.int32)


def sorted_join(sorted_keys: np.ndarray,
                sorted_queries: np.ndarray) -> np.ndarray:
    """Positions of sorted queries in sorted keys (-1 absent); O(n+m)."""
    lib = _load()
    keys = np.ascontiguousarray(sorted_keys, np.int64)
    q = np.ascontiguousarray(sorted_queries, np.int64)
    if lib is None:
        return _searchsorted_join(keys, q)
    out = np.empty(q.shape[0], np.int32)
    lib.sorted_join_i64(_p64(keys), keys.shape[0], _p64(q), q.shape[0],
                        _p32(out))
    return out


def keysearch(sorted_keys: np.ndarray, queries: np.ndarray,
              n_threads: int = 0) -> np.ndarray:
    """Index of each (unsorted) query in sorted int64 keys, -1 if absent
    (a multithreaded binary search)."""
    lib = _load()
    keys = np.ascontiguousarray(sorted_keys, np.int64)
    q = np.ascontiguousarray(queries, np.int64)
    if lib is None:
        return _searchsorted_join(keys, q)
    out = np.empty(q.shape[0], np.int32)
    lib.keysearch_i64(_p64(keys), keys.shape[0], _p64(q), q.shape[0],
                      _p32(out), n_threads)
    return out


def stencil_join(sorted_keys: np.ndarray, sorted_base: np.ndarray,
                 deltas: np.ndarray, cap: Optional[int] = None
                 ) -> np.ndarray:
    """(len(base), K) positions of base + delta_k in sorted keys, -1 if
    absent or >= cap: K monotone merge cursors in one pass."""
    lib = _load()
    keys = np.ascontiguousarray(sorted_keys, np.int64)
    base = np.ascontiguousarray(sorted_base, np.int64)
    d = np.ascontiguousarray(deltas, np.int64)
    capv = (1 << 31) - 1 if cap is None else int(cap)
    out = np.empty((base.shape[0], d.shape[0]), np.int32)
    if lib is None:
        for k in range(d.shape[0]):
            col = sorted_join(keys, base + d[k])
            out[:, k] = np.where(col < capv, col, -1)
        return out
    lib.stencil_join_i64(_p64(keys), keys.shape[0], _p64(base),
                         base.shape[0], _p64(d), d.shape[0], capv,
                         _p32(out))
    return out


def merge_unique(sorted_base: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Sorted unique union of {sorted_base + d for d in deltas} (a k-way
    merge: each shifted copy of a sorted array is sorted)."""
    lib = _load()
    base = np.ascontiguousarray(sorted_base, np.int64)
    d = np.ascontiguousarray(deltas, np.int64)
    if lib is None:
        return np.unique((base[:, None] + d[None]).ravel())
    out = np.empty(base.shape[0] * d.shape[0], np.int64)
    m = lib.merge_unique_i64(_p64(base), base.shape[0], _p64(d),
                             d.shape[0], _p64(out))
    return out[:m]


def pack_floor_keys(xyz: np.ndarray, voxel_size: float
                    ) -> Optional[np.ndarray]:
    """Fused ``pack64(floor(xyz / voxel_size))`` (f32 division + floorf);
    None without the native library."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(xyz, np.float32)
    out = np.empty(x.shape[0], np.int64)
    lib.pack_floor_keys_f32(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            x.shape[0], ctypes.c_float(voxel_size),
                            _p64(out))
    return out


def half_keys(keys: np.ndarray) -> Optional[np.ndarray]:
    """Per-component halving of packed keys; None without the library."""
    lib = _load()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, np.int64)
    out = np.empty(k.shape[0], np.int64)
    lib.half_keys_i64(_p64(k), k.shape[0], _p64(out))
    return out


def unpack_keys(keys: np.ndarray) -> Optional[np.ndarray]:
    """Packed int64 keys -> (n, 3) int32 coords; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, np.int64)
    out = np.empty((k.shape[0], 3), np.int32)
    lib.unpack_keys_i64(_p64(k), k.shape[0], _p32(out))
    return out


def coord_minmax(coords: np.ndarray) -> Optional[tuple]:
    """Componentwise (min, max) of (n, 3) int32 coords; None without the
    library or when n == 0."""
    lib = _load()
    c = np.ascontiguousarray(coords, np.int32)
    if lib is None or c.shape[0] == 0:
        return None
    out = np.empty(6, np.int32)
    lib.minmax_i32(_p32(c), c.shape[0], _p32(out))
    return out[:3].copy(), out[3:].copy()


def flat_cells(coords: np.ndarray, shift: int, origin, dims,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Shift (n, 3) integer coords by ``shift`` (>= 0: <<, < 0:
    arithmetic >>), subtract ``origin``, bounds-check against ``dims``
    and emit the row-major flat index (0 outside).  ``out`` may be a
    preallocated int32 view to write into."""
    lib = _load()
    c = np.ascontiguousarray(coords, np.int64)
    n = c.shape[0]
    ox, oy, oz = (int(origin[i]) for i in range(3))
    X, Y, Z = (int(dims[i]) for i in range(3))
    if lib is None:
        cd = (c << shift) if shift >= 0 else (c >> -shift)
        loc = cd - np.array([ox, oy, oz], np.int64)
        ok = ((loc >= 0) & (loc < np.array([X, Y, Z]))).all(-1)
        f = (loc[:, 0] * Y + loc[:, 1]) * Z + loc[:, 2]
        r = np.where(ok, f, 0).astype(np.int32)
        if out is not None:
            out[:n] = r
            return out
        return r
    if out is None:
        out = np.empty(n, np.int32)
    if not (out.flags["C_CONTIGUOUS"] and out.dtype == np.int32):
        raise ValueError("flat_cells: out must be a contiguous int32 array")
    lib.flat_cells_i64(_p64(c), n, shift, ox, oy, oz, X, Y, Z, _p32(out))
    return out


class KDTree:
    """CPU kd-tree over (n, 3) points (the C++ tree, or scipy's cKDTree
    without a toolchain)."""

    def __init__(self, points: np.ndarray):
        self._pts = np.ascontiguousarray(points, np.float32)
        self._lib = _load()
        self._h = None
        self._scipy = None
        if self._lib is not None:
            self._h = self._lib.kdtree_build(self._pts.ctypes.data_as(_F32P),
                                             self._pts.shape[0])
        else:
            from scipy.spatial import cKDTree
            self._scipy = cKDTree(self._pts)

    def query(self, q: np.ndarray, k: int = 1, n_threads: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(dist (m, k) f32, idx (m, k) int32) of the k nearest points,
        2-D also for k == 1."""
        q = np.ascontiguousarray(q, np.float32)
        m = q.shape[0]
        if self._lib is not None:
            d2 = np.empty((m, k), np.float32)
            idx = np.empty((m, k), np.int32)
            self._lib.kdtree_query(self._h, q.ctypes.data_as(_F32P), m, k,
                                   d2.ctypes.data_as(_F32P), _p32(idx),
                                   n_threads)
            return np.sqrt(d2), idx
        d, i = self._scipy.query(q, k=k)
        return (d.reshape(m, k).astype(np.float32),
                i.reshape(m, k).astype(np.int32))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kdtree_free(self._h)
            self._h = None


def raycast_inside(verts: np.ndarray, faces: np.ndarray,
                   queries: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """(n_q,) bool occupancy of query points in a (near-)watertight mesh
    by +z ray parity, grid-accelerated in C++; the numpy fallback counts
    the same crossings with the same half-open edge rule."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    q = np.ascontiguousarray(queries, np.float32)
    if lib is not None:
        out = np.empty(q.shape[0], np.uint8)
        lib.raycast_inside(v.ctypes.data_as(_F32P), v.shape[0], _p32(f),
                           f.shape[0], q.ctypes.data_as(_F32P), q.shape[0],
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           n_threads)
        return out.astype(bool)
    if f.shape[0] == 0 or q.shape[0] == 0:
        return np.zeros(q.shape[0], bool)
    tri = v[f].astype(np.float64)              # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    inside = np.zeros(q.shape[0], bool)
    step = max(1, int(2e7 // max(f.shape[0], 1)))
    for s in range(0, q.shape[0], step):
        qq = q[s:s + step].astype(np.float64)  # (B, 3)
        px, py = qq[:, None, 0], qq[:, None, 1]
        e0 = (b[:, 0] - a[:, 0]) * (py - a[:, 1]) \
            - (b[:, 1] - a[:, 1]) * (px - a[:, 0])
        e1 = (c[:, 0] - b[:, 0]) * (py - b[:, 1]) \
            - (c[:, 1] - b[:, 1]) * (px - b[:, 0])
        e2 = (a[:, 0] - c[:, 0]) * (py - c[:, 1]) \
            - (a[:, 1] - c[:, 1]) * (px - c[:, 0])
        hit = ((e0 > 0) & (e1 > 0) & (e2 > 0)) | \
              ((e0 < 0) & (e1 < 0) & (e2 < 0))
        area = e0 + e1 + e2
        safe = np.where(area == 0, 1.0, area)
        z = (e1 * a[:, 2] + e2 * b[:, 2] + e0 * c[:, 2]) / safe
        cross = hit & (area != 0) & (z > qq[:, 2:3])
        inside[s:s + step] = (cross.sum(1) & 1).astype(bool)
    return inside
