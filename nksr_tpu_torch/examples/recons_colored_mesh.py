"""Coloured reconstruction through a texture field, the port's
counterpart of examples/recons_colored_mesh.py: an oriented point cloud
from a PLY file (its colours, or without any a colour by position) ->
``Reconstructor.reconstruct(detail_level=0.6, structure="splat")`` ->
``set_texture_field(PCNNField.build(xyz, colour, cell_size=4 * voxel,
capacity=1 << 16))`` -> ``extract_dual_mesh(mise_iter=1)`` -> a PLY mesh
with vertex colours.

    python -m nksr_tpu_torch.examples.recons_colored_mesh spot.ply \\
        [--out spot_colored.ply] [--device cpu]

The weights are the seeded random ones of ``Reconstructor()``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.data import read_ply_full, write_ply
from nksr_tpu_torch.fields.neural_field import PCNNField


def main(ply: str, out: str = "spot_colored.ply", device: str = "cuda",
         reconstructor=None):
    """Reconstruct the cloud (points, normals, colours) of ``ply``, colour
    the mesh by the nearest input point and write it to ``out``; returns
    the mesh."""
    xyz, _, normal, color = read_ply_full(ply)
    if normal is None:
        raise ValueError(f"{ply} holds no normals (nx, ny, nz)")
    if color is None:          # colour by position as a stand-in
        color = ((xyz - xyz.min(0)) / (xyz.max(0) - xyz.min(0))).astype(
            np.float32)
    reconstructor = reconstructor or Reconstructor(device=device)
    field = reconstructor.reconstruct(xyz, normal, detail_level=0.6,
                                      structure="splat")
    dev = reconstructor.device
    cell = 4 * float(np.float32(field.host_grids[0].voxel_size))
    tex = PCNNField.build(torch.as_tensor(xyz, device=dev),
                          torch.as_tensor(color, device=dev),
                          torch.ones(len(xyz), dtype=torch.bool, device=dev),
                          cell_size=cell, capacity=1 << 16)
    field = field.set_texture_field(tex)
    mesh = field.extract_dual_mesh(mise_iter=1)
    print(f"colored mesh: {mesh.v.shape[0]} verts; has colors: "
          f"{mesh.c is not None}")
    write_ply(out, mesh.v, mesh.f, colors=mesh.c)
    return mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ply")
    ap.add_argument("--out", default="spot_colored.ply")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.ply, args.out, args.device)
