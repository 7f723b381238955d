"""PLY read and write, ASCII and binary (counterpart of nksr_tpu/data/
io.py ``read_ply``, ``read_ply_full`` and ``write_ply``): dependency-free
readers of vertices with normals and colours, and faces."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "ushort": "<u2", "char": "<i1", "uchar": "<u1",
    "int8": "<i1", "uint8": "<u1", "int16": "<i2", "uint16": "<u2",
}


def read_ply(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read vertex positions (+ normals if present) from a PLY file."""
    verts, _, normals, _ = read_ply_full(path)
    return verts, normals


def read_ply_full(path):
    """Returns (vertices, faces, normals, colors); missing fields None."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop, dtype) or ('list', ...)]...)
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur[2].append(("list", _PLY_DTYPES[parts[2]],
                                   _PLY_DTYPES[parts[3]], parts[4]))
                else:
                    cur[2].append((parts[2], _PLY_DTYPES[parts[1]]))

        verts = faces = normals = colors = None
        for name, count, props in elements:
            if name == "vertex":
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.array(rows, dtype=np.float64)
                    cols = {p[0]: arr[:, i]
                            for i, p in enumerate(props)}
                else:
                    dt = np.dtype([(p[0], p[1]) for p in props])
                    raw = f.read(count * dt.itemsize)
                    rec = np.frombuffer(raw, dtype=dt, count=count)
                    if fmt == "binary_big_endian":
                        rec = rec.byteswap()
                    cols = {p[0]: rec[p[0]] for p in props}
                verts = np.stack([cols["x"], cols["y"], cols["z"]],
                                 1).astype(np.float32)
                if all(k in cols for k in ("nx", "ny", "nz")):
                    normals = np.stack(
                        [cols["nx"], cols["ny"], cols["nz"]],
                        1).astype(np.float32)
                if all(k in cols for k in ("red", "green", "blue")):
                    colors = np.stack(
                        [cols["red"], cols["green"], cols["blue"]],
                        1).astype(np.float32)
                    if colors.max() > 1.5:
                        colors = colors / 255.0
            elif name == "face":
                if not props or props[0][0] != "list":
                    raise ValueError(f"{path}: a face element without a "
                                     "vertex index list")
                _, cnt_t, idx_t, _ = props[0]
                if fmt == "ascii":
                    fl = []
                    for _ in range(count):
                        row = f.readline().split()
                        k = int(row[0])
                        fl.append([int(x) for x in row[1:1 + k]])
                    faces = np.array([r[:3] for r in fl], np.int32)
                else:
                    cnt_sz = np.dtype(cnt_t).itemsize
                    idx_sz = np.dtype(idx_t).itemsize
                    fl = []
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_sz), cnt_t)[0])
                        idx = np.frombuffer(f.read(k * idx_sz), idx_t)
                        fl.append(idx[:3])
                    faces = np.asarray(fl, np.int32)
    return verts, faces, normals, colors




def write_ply(path, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    """Write a binary-little-endian PLY mesh/point cloud."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = vertices.shape[0]
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        props += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        props += [("red", "<u1"), ("green", "<u1"), ("blue", "<u1")]
    rec = np.empty(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = vertices.T.astype(np.float32)
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals.T.astype(np.float32)
    if colors is not None:
        c = colors
        if c.max() <= 1.5:
            c = c * 255.0
        rec["red"], rec["green"], rec["blue"] = \
            c.T.clip(0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}"]
        type_names = {"<f4": "float", "<u1": "uchar"}
        hdr += [f"property {type_names[d]} {p}" for p, d in props]
        if faces is not None:
            hdr += [f"element face {faces.shape[0]}",
                    "property list uchar int vertex_indices"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            fr = np.empty(faces.shape[0],
                          dtype=np.dtype([("k", "u1"), ("v", "<i4", (3,))]))
            fr["k"] = 3
            fr["v"] = faces.astype(np.int32)
            f.write(fr.tobytes())
