"""The JAX package's interior terrain vertex error on the bench terrain with
the dual (row-space) lattice solve, under the configuration
``chip_smoke.py`` phase 10 gives the PyTorch port:
``PipelineConfig(conv_dtype="bfloat16", solver_formulation="dual")`` (UDF
head off), the ``runs/scene_big`` checkpoint, ``structure="splat"``,
voxel 0.1, at most 64 CG iterations at tol 1e-4,
``extract_dual_mesh(mise_iter=1)``.

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/terrain_reference_dual.py \
        [--solver-compute-dtype bfloat16]

The scene is ``synthetic_scene(1_000_000)`` (a 40 m tile), reconstructed
as its four 20 m quadrants, each alone, as ``scripts/terrain_reference.py``
does for the primal.  The error is ``|v_z - h(v_x, v_y)|`` over the used
vertices 1 m inside each quadrant, pooled over the four.  Prints one line
per quadrant (with its CG iterations and relative residual) and the
pooled mean, q90 and max.  The row blocks are f32 on the CPU (the
configuration's "auto"); ``--solver-compute-dtype bfloat16`` holds them
in bf16 values, as the card does.
"""

import argparse
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOL, MAX_ITERS = 1e-4, 64


def height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver-compute-dtype", default="auto")
    args = ap.parse_args()
    from flax.serialization import msgpack_restore

    from bench import synthetic_scene
    from nksr_tpu import Reconstructor
    from nksr_tpu.models.pipeline import PipelineConfig

    root = Path(__file__).resolve().parent.parent
    tree = msgpack_restore((root / "runs/scene_big/best.ckpt").read_bytes())
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]
    recon = Reconstructor(config=PipelineConfig(
        conv_dtype="bfloat16", solver_formulation="dual",
        solver_compute_dtype=args.solver_compute_dtype),
        params={"params": tree})
    xyz, nrm = synthetic_scene(1_000_000)
    errs = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            m = (np.sign(xyz[:, 0]) == sx) & (np.sign(xyz[:, 1]) == sy)
            t0 = time.time()
            f = recon.reconstruct(xyz[m], nrm[m], structure="splat",
                                  detail_level=None, voxel_size=0.1,
                                  solver_tol=TOL, solver_max_iters=MAX_ITERS)
            mesh = f.extract_dual_mesh(mise_iter=1)
            v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
            ax, ay = np.abs(v[:, 0]), np.abs(v[:, 1])
            v = v[(ax > 1) & (ax < 19) & (ay > 1) & (ay < 19)
                  & (np.sign(v[:, 0]) == sx) & (np.sign(v[:, 1]) == sy)]
            d = np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))
            errs.append(d)
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
            print(f"quadrant ({sx},{sy}): {int(m.sum())} points, "
                  f"{f.solver_stats}, {len(mesh.v)} vertices, {len(v)} "
                  f"interior, error mean {d.mean():.6f} in "
                  f"{time.time() - t0:.1f} s; peak RSS {rss:.2f} GiB",
                  flush=True)
    d = np.concatenate(errs)
    print(f"all quadrants: {len(d)} interior vertices, error mean "
          f"{d.mean():.6f} q90 {np.quantile(d, 0.9):.6f} max "
          f"{d.max():.6f}", flush=True)


if __name__ == "__main__":
    main()
