"""Host sort, join and lattice-index ops: ctypes over the JAX package's
own C++ sources ``nksr_tpu/native/sortops.cpp`` and ``kdtree.cpp`` (for
its key searches), compiled with ``g++`` into one library in this
package's build directory at first use.  Importing ``nksr_tpu`` would
import JAX, so only the source files are shared, read by path.

Every op keeps the numpy fallback the original module has
(nksr_tpu/native/__init__.py), taken when no C++ toolchain is present;
results are identical either way.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE = Path(__file__).resolve().parent.parent / "nksr_tpu" / "native"
SOURCES = (_NATIVE / "sortops.cpp", _NATIVE / "kdtree.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


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
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, max(len(keys) - 1, 0))
    found = (len(keys) > 0) & (keys[pos_c] == q)
    return np.where(found, pos_c, -1).astype(np.int32)


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
