"""The JAX package's interior terrain vertex error on the bench terrain
under the checkpoint's own configuration, UDF mask head on, as
``bench.py``'s predicted row runs it: ``runs/scene_big/config.yaml``
through ``load_config`` and ``driver.pipeline_config_from_yaml``, with
``conv_dtype="bfloat16"``, the ``runs/scene_big`` checkpoint, voxel 0.1,
16 CG iterations at tol 1e-4, ``extract_dual_mesh(mise_iter=1)``.  The
dense mesher trims the faces the UDF mask rejects.

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/terrain_reference_udf.py
    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/terrain_reference_udf.py \
        --structure splat
    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/terrain_reference_udf.py \
        --route-a

The scene is ``synthetic_scene(1_000_000)`` (a 40 m tile), reconstructed
as its four 20 m quadrants, each alone (a whole-tile CPU run does not
fit).  ``--route-a`` takes route A's scene instead, the 60 m tile
(``half_extent=30``), and reconstructs its four central 20 m sub-tiles
(x, y in [-20, 20], split at 0) each alone with the splat structure on
route A (the gather-conv UNet, the lattice solve and the host mesher,
which seals at the UDF mask), forced by setting the dense UNet's and
the dense mesher's budgets to 0.  The error is ``|v_z - h(v_x, v_y)|``
over the used vertices 1 m inside each quadrant or sub-tile, pooled over
the four.  Prints one line per quadrant and the pooled mean, q90 and
max.
"""

import argparse
import dataclasses
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
    ap.add_argument("--structure", default="predicted",
                    choices=("predicted", "splat"))
    ap.add_argument("--route-a", action="store_true")
    args = ap.parse_args()
    from flax.serialization import msgpack_restore

    from bench import synthetic_scene
    from nksr_tpu import Reconstructor
    from nksr_tpu.meshing import lattice_mc
    from nksr_tpu.recon import reconstructor
    from nksr_tpu.train.driver import pipeline_config_from_yaml
    from nksr_tpu.utils.config import load_config

    half_extent = 20.0
    if args.route_a:
        args.structure, half_extent = "splat", 30.0
        reconstructor.DENSE_UNET_CELLMAP_BUDGET = 0
        lattice_mc.DENSE_CELL_BUDGET = 0

    root = Path(__file__).resolve().parent.parent
    cfg = dataclasses.replace(pipeline_config_from_yaml(load_config(
        root / "runs/scene_big/config.yaml")), conv_dtype="bfloat16")
    assert cfg.udf_enabled
    tree = msgpack_restore((root / "runs/scene_big/best.ckpt").read_bytes())
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]
    recon = Reconstructor(config=cfg, params={"params": tree})
    xyz, nrm = synthetic_scene(1_000_000, half_extent=half_extent)
    errs = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            m = (np.sign(xyz[:, 0]) == sx) & (np.sign(xyz[:, 1]) == sy) \
                & (np.abs(xyz[:, 0]) < 20) & (np.abs(xyz[:, 1]) < 20)
            t0 = time.time()
            f = recon.reconstruct(xyz[m], nrm[m], structure=args.structure,
                                  detail_level=None, voxel_size=0.1,
                                  solver_tol=1e-4, solver_max_iters=16)
            mesh = f.extract_dual_mesh(mise_iter=1)
            v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
            ax, ay = np.abs(v[:, 0]), np.abs(v[:, 1])
            v = v[(ax > 1) & (ax < 19) & (ay > 1) & (ay < 19)
                  & (np.sign(v[:, 0]) == sx) & (np.sign(v[:, 1]) == sy)]
            d = np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))
            errs.append(d)
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
            if args.route_a:
                assert f.lattice_ctx is not None and \
                    recon._last_unet_engine == "sparse"
            print(f"quadrant ({sx},{sy}): {int(m.sum())} points, "
                  f"{len(mesh.v)} vertices, {len(mesh.f)} faces, {len(v)} "
                  f"interior, error mean {d.mean():.6f} in "
                  f"{time.time() - t0:.1f} s; peak RSS {rss:.2f} GiB",
                  flush=True)
    d = np.concatenate(errs)
    print(f"{'route A' if args.route_a else args.structure}, UDF on, all "
          f"{'sub-tiles' if args.route_a else 'quadrants'}: {len(d)} interior "
          f"vertices, error mean {d.mean():.6f} q90 "
          f"{np.quantile(d, 0.9):.6f} max {d.max():.6f}", flush=True)


if __name__ == "__main__":
    main()
