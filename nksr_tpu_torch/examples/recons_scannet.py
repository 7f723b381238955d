"""Indoor-scan reconstruction at a fixed fine voxel size, the port's
counterpart of examples/recons_scannet.py (the reference's scannet
recipe: voxel_size=0.02, mise_iter=2): a mesh's vertices and normals
from a PLY file, scaled to room extent, reconstructed on the splat
structure.

    python -m nksr_tpu_torch.examples.recons_scannet spot.ply \\
        [--scale 2.0] [--out scannet_like_mesh.ply] [--device cpu]

The weights are the seeded random ones of ``Reconstructor()``.
"""

from __future__ import annotations

import argparse

import numpy as np

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.data import read_ply_full, write_ply


def main(ply: str, scale: float = 2.0, out: str = "scannet_like_mesh.ply",
         device: str = "cuda", reconstructor=None):
    """Reconstruct the scaled vertices and normals of ``ply`` at voxel
    0.02 and write the mesh to ``out``; returns the mesh."""
    v, _, normal, _ = read_ply_full(ply)
    if normal is None:
        raise ValueError(f"{ply} holds no normals (nx, ny, nz)")
    xyz = np.asarray(v, np.float32) * np.float32(scale)
    reconstructor = reconstructor or Reconstructor(device=device)
    field = reconstructor.reconstruct(xyz, normal, voxel_size=0.02,
                                      structure="splat")
    mesh = field.extract_dual_mesh(mise_iter=2)
    print(f"mesh: {mesh.v.shape[0]} verts, {mesh.f.shape[0]} tris")
    write_ply(out, mesh.v, mesh.f)
    return mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ply")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--out", default="scannet_like_mesh.ply")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.ply, args.scale, args.out, args.device)
