"""GIS / aerial-lidar reconstruction from a LAS tile, the port's
counterpart of examples/gis_app.py: read the tile, recentre it, crop a
20 m region of interest, put a sensor 50 m overhead, estimate normals
from it and reconstruct at coarse detail with the efficiency flags.
Without ``laspy`` or the tile it falls back to the synthetic terrain.

    python -m nksr_tpu_torch.examples.gis_app [--las assets/las/example.las] \\
        [--out gis_mesh.ply] [--device cpu]

The weights are the seeded random ones of ``Reconstructor()``.
"""

from __future__ import annotations

import argparse

import numpy as np

from nksr_tpu_torch import Reconstructor, get_estimate_normal_preprocess_fn
from nksr_tpu_torch.data import write_ply
from nksr_tpu_torch.utils.scenes import make_terrain_scene


def load_las(path: str) -> np.ndarray:
    import laspy  # optional dependency, as in the reference
    las = laspy.read(path)
    return np.vstack((las.x, las.y, las.z)).T.astype(np.float64)


def load_points(path: str, n_fallback: int = 60000) -> np.ndarray:
    """The tile's points recentred and cropped to 20 m, or the synthetic
    terrain when ``laspy`` or the tile is missing."""
    try:
        xyz = load_las(path)
    except (ImportError, FileNotFoundError):
        print("laspy / LAS tile unavailable; using synthetic terrain")
        return make_terrain_scene(n=n_fallback, extent=30.0)[0]
    print("point stats (mean/min/max)", xyz.mean(0), xyz.min(0), xyz.max(0))
    xyz -= (xyz.max(0) + xyz.min(0))[None] / 2.0
    return xyz[np.linalg.norm(xyz, axis=1) < 20.0].astype(np.float32)


def main(las: str = "assets/las/example.las", out: str = "gis_mesh.ply",
         device: str = "cuda", n_fallback: int = 60000, reconstructor=None):
    """Run the recipe and write the mesh to ``out``; returns the mesh."""
    xyz = load_points(las, n_fallback)
    sensor = np.zeros_like(xyz)
    sensor[:, 2] = 50.0
    reconstructor = reconstructor or Reconstructor(device=device)
    field = reconstructor.reconstruct(
        xyz, sensor=sensor, detail_level=0.1, approx_kernel_grad=True,
        solver_tol=1e-4, fused_mode=True,
        preprocess_fn=get_estimate_normal_preprocess_fn(
            64, 85.0, device=reconstructor.device),
        structure="splat")
    mesh = field.extract_dual_mesh(mise_iter=1)
    print(f"mesh: {mesh.v.shape[0]} verts, {mesh.f.shape[0]} tris")
    write_ply(out, mesh.v, mesh.f)
    return mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--las", default="assets/las/example.las")
    ap.add_argument("--out", default="gis_mesh.ply")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.las, args.out, args.device)
