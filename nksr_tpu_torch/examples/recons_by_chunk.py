"""Chunked out-of-core reconstruction of a large synthetic scene, the
port's counterpart of examples/recons_by_chunk.py: normals estimated
from the sensor positions, the scene split into ``chunk_size`` cubes
(each parked on the CPU after its solve), one stitched mesh.

    python -m nksr_tpu_torch.examples.recons_by_chunk [--device cpu]

The weights are the seeded random ones of ``Reconstructor()``: the
recipe, not a trained model, is what this shows.
"""

from __future__ import annotations

import argparse

from nksr_tpu_torch import Reconstructor, get_estimate_normal_preprocess_fn
from nksr_tpu_torch.data import write_ply
from nksr_tpu_torch.utils.scenes import make_terrain_scene


def main(n: int = 300000, extent: float = 40.0, chunk_size: float = 12.0,
         device: str = "cuda", out: str = "terrain_mesh.ply",
         reconstructor=None):
    """Run the recipe on ``device`` (or on ``reconstructor``'s) and write
    the mesh to ``out``; returns the chunked field and the mesh."""
    xyz, sensor = make_terrain_scene(n=n, extent=extent)
    reconstructor = reconstructor or Reconstructor(device=device)
    device = reconstructor.device
    field = reconstructor.reconstruct(
        xyz, sensor=sensor, chunk_size=chunk_size,
        preprocess_fn=get_estimate_normal_preprocess_fn(32, 85.0,
                                                        device=device))
    mesh = field.extract_dual_mesh(mise_iter=1)
    print(f"stitched mesh: {mesh.v.shape[0]} verts, {mesh.f.shape[0]} tris "
          f"from {len(field.chunks)} chunks")
    write_ply(out, mesh.v, mesh.f)
    return field, mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="terrain_mesh.ply")
    args = ap.parse_args()
    main(device=args.device, out=args.out)
