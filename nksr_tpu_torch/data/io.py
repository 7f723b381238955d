"""Mesh and point-cloud output (counterpart of ``write_ply`` in
nksr_tpu/data/io.py)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


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
