"""Scene-scale lidar reconstruction with sensor-based normal estimation,
the port's counterpart of examples/recons_waymo.py: no normals in, a
``preprocess_fn`` estimates them from the sensor positions, with the
efficiency flags ``approx_kernel_grad``, ``fused_mode`` and a loose
solver tolerance.  A synthetic lidar-like terrain stands in for the
Waymo asset.

    python -m nksr_tpu_torch.examples.recons_waymo [--device cpu]

The weights are the seeded random ones of ``Reconstructor()``.
"""

from __future__ import annotations

import argparse

from nksr_tpu_torch import Reconstructor, get_estimate_normal_preprocess_fn
from nksr_tpu_torch.data import write_ply
from nksr_tpu_torch.utils.scenes import make_terrain_scene


def main(n: int = 300000, extent: float = 40.0, device: str = "cuda",
         out: str = "waymo_like_mesh.ply", reconstructor=None):
    """Run the recipe on ``device`` (or on ``reconstructor``'s) and write
    the mesh to ``out``; returns the field and the mesh."""
    xyz, sensor = make_terrain_scene(n=n, extent=extent)
    reconstructor = reconstructor or Reconstructor(device=device)
    device = reconstructor.device
    field = reconstructor.reconstruct(
        xyz, sensor=sensor, detail_level=None,
        # minor configs for better efficiency (not necessary)
        approx_kernel_grad=True, solver_tol=1e-4, fused_mode=True,
        # chunked reconstruction (if out of memory): chunk_size=51.2,
        preprocess_fn=get_estimate_normal_preprocess_fn(64, 85.0,
                                                        device=device),
        structure="splat")
    mesh = field.extract_dual_mesh(mise_iter=1)
    print(f"mesh: {mesh.v.shape[0]} verts, {mesh.f.shape[0]} tris")
    write_ply(out, mesh.v, mesh.f)
    return field, mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="waymo_like_mesh.ply")
    args = ap.parse_args()
    main(device=args.device, out=args.out)
