"""Sharded single-scene reconstruction, the port's counterpart of
examples/recons_sharded.py: ONE lattice solved in x-slabs over every
GPU of the job, halo planes exchanged in each CG iteration
(``nksr_tpu_torch/parallel/lattice_shard.py``), then the mesh extracted
slab by slab; rank 0 writes it.

    torchrun --nproc_per_node=N -m nksr_tpu_torch.examples.recons_sharded \\
        [--out terrain_sharded.ply] [--points 20000] [--voxel-size 0.1] \
        [--max-iters N]
    python -m nksr_tpu_torch.examples.recons_sharded      # a world of one

Every rank runs this script with the same cloud.  ``--device cpu`` runs
the ranks on the CPU over gloo; ``--dist-init`` names another rendezvous
than torchrun's ``MASTER_ADDR``/``MASTER_PORT`` (e.g. ``file:///tmp/s``,
with ``WORLD_SIZE`` and ``RANK`` set by hand).  The weights are the
seeded random ones of ``Reconstructor()``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.data import write_ply
from nksr_tpu_torch.parallel import init_distributed, make_mesh


def terrain(n: int = 20000, seed: int = 0):
    """An 8 m x 8 m wavy terrain with analytic normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-4.0, 4.0, size=(n, 2)).astype(np.float32)
    h = np.sin(0.8 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    xyz = np.concatenate([xy, h[:, None].astype(np.float32)], 1)
    dx = 0.8 * np.cos(0.8 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    dy = -0.7 * np.sin(0.8 * xy[:, 0]) * np.sin(0.7 * xy[:, 1])
    nrm = np.stack([-dx, -dy, np.ones(n, np.float32)], 1)
    return xyz, (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)) \
        .astype(np.float32)


def main(out: str = "terrain_sharded.ply", device: str = "cuda",
         n_points: int = 20000, dist_init=None, voxel_size: float = 0.1,
         max_iters=None):
    """Reconstruct the terrain over every rank; rank 0 writes ``out``.
    Returns the mesh (the same on every rank)."""
    init_distributed(backend="gloo" if device == "cpu" else None,
                     init_method=dist_init)
    mesh_devices = make_mesh(device)
    xyz, normal = terrain(n_points)
    field = Reconstructor(device=device).reconstruct(
        xyz, normal, voxel_size=voxel_size, detail_level=None,
        structure="splat", solver_max_iters=max_iters, mesh=mesh_devices)
    mesh = field.extract_dual_mesh(mise_iter=1)
    if dist.get_rank() == 0:
        print(f"mesh: {mesh.v.shape[0]} verts, {mesh.f.shape[0]} tris "
              f"(solved over {dist.get_world_size()} ranks)")
        write_ply(out, mesh.v, mesh.f)
    dist.destroy_process_group()
    return mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="terrain_sharded.ply")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--dist-init", default=None)
    ap.add_argument("--voxel-size", type=float, default=0.1)
    ap.add_argument("--max-iters", type=int, default=None,
                    help="CG iterations (default: the configuration's)")
    args = ap.parse_args()
    main(args.out, args.device, args.points, args.dist_init, args.voxel_size,
         args.max_iters)
