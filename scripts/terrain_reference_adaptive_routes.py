"""The JAX package's interior terrain vertex error with the adaptive
(normal-variation) structure on the two sparse routes, under the
configuration ``chip_smoke.py`` phase 14 gives the PyTorch port:
``PipelineConfig(conv_dtype="bfloat16", adaptive_depth=2)`` (UDF head
off), the ``runs/scene_big`` checkpoint, ``structure="adaptive"``, voxel
0.1, 16 CG iterations at tol 1e-4, ``extract_dual_mesh(mise_iter=1)``.

    env -u PYTHONPATH JAX_PLATFORMS=cpu python \\
        scripts/terrain_reference_adaptive_routes.py --route A
    env -u PYTHONPATH JAX_PLATFORMS=cpu python \\
        scripts/terrain_reference_adaptive_routes.py --route B [--tau 0.001]

``--route A`` takes route A's scene, the 60 m tile
(``synthetic_scene(1_000_000, half_extent=30)``), with the dense UNet's
and the dense mesher's budgets set to 0 (the gather-conv UNet, the
lattice solve and the host mesher).  ``--route B`` takes route B's scene,
the 100 m tile (``half_extent=50``), with ``NKSR_LATTICE=0`` set in this
process (the gather-conv UNet, the support-row solve and the host
mesher).  Either way the tile's four central 20 m sub-tiles (x, y in
[-20, 20], split at 0) are reconstructed each alone (a whole-tile CPU
run does not fit).  The error is ``|v_z - h(v_x, v_y)|`` over the used
vertices 1 m inside each sub-tile, pooled over the four.  Prints one
line per sub-tile (with its decoder voxels per depth) and the pooled
mean, q90 and max.

``--tau`` sets ``adaptive_tau`` (the configuration's 0.1 by default).  On
this terrain no depth-1 voxel's normals vary by 0.1, nor by 0.005, so
the decoder keeps no depth-0 voxel there; at 0.001 it keeps about 12% of
the splat's depth-0 voxels on route A's sub-tiles and 4% on route B's
(the curved parts), the structure ``chip_smoke.py`` phase 14 runs.
"""

import argparse
import dataclasses
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", required=True, choices=("A", "B"))
    ap.add_argument("--tau", type=float, default=None)
    args = ap.parse_args()
    if args.route == "B":
        # read by the JAX package's reconstructor at each call
        os.environ["NKSR_LATTICE"] = "0"
    from flax.serialization import msgpack_restore

    from bench import synthetic_scene
    from nksr_tpu import Reconstructor
    from nksr_tpu.meshing import lattice_mc
    from nksr_tpu.models.pipeline import PipelineConfig
    from nksr_tpu.recon import reconstructor

    half_extent = 30.0 if args.route == "A" else 50.0
    if args.route == "A":
        reconstructor.DENSE_UNET_CELLMAP_BUDGET = 0
        lattice_mc.DENSE_CELL_BUDGET = 0

    root = Path(__file__).resolve().parent.parent
    tree = msgpack_restore((root / "runs/scene_big/best.ckpt").read_bytes())
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]
    cfg = PipelineConfig(conv_dtype="bfloat16", adaptive_depth=2)
    if args.tau is not None:
        cfg = dataclasses.replace(cfg, adaptive_tau=args.tau)
    recon = Reconstructor(config=cfg, params={"params": tree})
    xyz, nrm = synthetic_scene(1_000_000, half_extent=half_extent)
    errs = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            m = (np.sign(xyz[:, 0]) == sx) & (np.sign(xyz[:, 1]) == sy) \
                & (np.abs(xyz[:, 0]) < 20) & (np.abs(xyz[:, 1]) < 20)
            t0 = time.time()
            f = recon.reconstruct(xyz[m], nrm[m], structure="adaptive",
                                  detail_level=None, voxel_size=0.1,
                                  solver_tol=1e-4, solver_max_iters=16)
            assert recon._last_unet_engine == "sparse"
            assert (f.lattice_ctx is not None) == (args.route == "A")
            mesh = f.extract_dual_mesh(mise_iter=1)
            v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
            ax, ay = np.abs(v[:, 0]), np.abs(v[:, 1])
            v = v[(ax > 1) & (ax < 19) & (ay > 1) & (ay < 19)
                  & (np.sign(v[:, 0]) == sx) & (np.sign(v[:, 1]) == sy)]
            d = np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))
            errs.append(d)
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
            print(f"sub-tile ({sx},{sy}): {int(m.sum())} points, decoder "
                  f"voxels {[len(g.keys) for g in f.host_grids]}, "
                  f"{len(mesh.v)} vertices, {len(mesh.f)} faces, {len(v)} "
                  f"interior, error mean {d.mean():.6f} max {d.max():.6f} "
                  f"in {time.time() - t0:.1f} s; peak RSS {rss:.2f} GiB",
                  flush=True)
    d = np.concatenate(errs)
    print(f"adaptive (depth 2, tau {cfg.adaptive_tau}), route {args.route}, "
          f"all sub-tiles: {len(d)} "
          f"interior vertices, error mean {d.mean():.6f} q90 "
          f"{np.quantile(d, 0.9):.6f} max {d.max():.6f}", flush=True)


if __name__ == "__main__":
    main()
