"""Simplest end-to-end reconstruction, the port's counterpart of
examples/recons_simple.py: an oriented point cloud from a PLY file ->
``Reconstructor.reconstruct(detail_level=1.0, structure="splat")`` ->
``extract_dual_mesh(mise_iter=1)`` -> a PLY mesh.

    python -m nksr_tpu_torch.examples.recons_simple bunny.ply \\
        [--out bunny_mesh.ply] [--device cpu]

The weights are the seeded random ones of ``Reconstructor()``.
"""

from __future__ import annotations

import argparse

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.data import read_ply, write_ply


def main(ply: str, out: str = "bunny_mesh.ply", device: str = "cuda",
         reconstructor=None):
    """Reconstruct the cloud (points and normals) of ``ply`` and write
    the mesh to ``out``; returns the mesh."""
    xyz, normal = read_ply(ply)
    if normal is None:
        raise ValueError(f"{ply} holds no normals (nx, ny, nz)")
    reconstructor = reconstructor or Reconstructor(device=device)
    field = reconstructor.reconstruct(xyz, normal, detail_level=1.0,
                                      structure="splat")
    mesh = field.extract_dual_mesh(mise_iter=1)
    print(f"mesh: {mesh.v.shape[0]} verts, {mesh.f.shape[0]} tris")
    write_ply(out, mesh.v, mesh.f)
    return mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ply")
    ap.add_argument("--out", default="bunny_mesh.ply")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.ply, args.out, args.device)
