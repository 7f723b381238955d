"""The JAX package's interior terrain vertex error on the bench terrain
for the README's lidar recipe: no normals in, one sensor position per
point at (0, 0, 10), ``get_estimate_normal_preprocess_fn(64, 85.0)``,
chunked reconstruction and ``ChunkedField.extract_dual_mesh(mise_iter=1)``
under the checkpoint's own configuration (``runs/scene_big/config.yaml``
through ``load_config`` and ``driver.pipeline_config_from_yaml``, UDF
mask head on, ``conv_dtype="bfloat16"``, the ``runs/scene_big``
checkpoint), with the recipe's defaults otherwise (the configuration's
structure, voxel 0.1 and 16 CG iterations, solver tolerance 1e-5).

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/terrain_reference_chunked.py
    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/terrain_reference_chunked.py \
        --chunk-size 10.0 --quadrants 0 3

The scene is ``synthetic_scene(1_000_000)`` (a 40 m tile) without its
normals; each of its four 20 m quadrants runs the recipe alone with
``chunk_size=10.0`` (a whole-tile CPU run does not fit).  The chunked
mesh always takes the host mesher, which seals at each chunk's UDF mask
(a second sheet at the mask's edge, as route A's does).  The error is
``|v_z - h(v_x, v_y)|`` over the used vertices 1 m inside each quadrant,
pooled over the quadrants run.  Prints one line per quadrant (its kept
share, chunks and error) and the pooled mean, q90 and max.
"""

import argparse
import dataclasses
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

QUADRANTS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk-size", type=float, default=10.0)
    ap.add_argument("--quadrants", type=int, nargs="*", default=[0, 1, 2, 3],
                    help="indices into (-1,-1), (-1,1), (1,-1), (1,1)")
    args = ap.parse_args()
    from flax.serialization import msgpack_restore

    from bench import synthetic_scene
    from nksr_tpu import Reconstructor, get_estimate_normal_preprocess_fn
    from nksr_tpu.train.driver import pipeline_config_from_yaml
    from nksr_tpu.utils.config import load_config

    root = Path(__file__).resolve().parent.parent
    cfg = dataclasses.replace(pipeline_config_from_yaml(load_config(
        root / "runs/scene_big/config.yaml")), conv_dtype="bfloat16")
    assert cfg.udf_enabled
    tree = msgpack_restore((root / "runs/scene_big/best.ckpt").read_bytes())
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]
    recon = Reconstructor(config=cfg, params={"params": tree})
    xyz, _ = synthetic_scene(1_000_000)
    sensor = np.zeros_like(xyz)
    sensor[:, 2] = 10.0
    errs = []
    for q in args.quadrants:
        sx, sy = QUADRANTS[q]
        m = (np.sign(xyz[:, 0]) == sx) & (np.sign(xyz[:, 1]) == sy)
        t0 = time.time()
        outs = []

        def pre(x, n, s, fn=get_estimate_normal_preprocess_fn(64, 85.0)):
            outs.append(fn(x, n, s))
            return outs[-1]

        cf = recon.reconstruct(xyz[m], sensor=sensor[m],
                               chunk_size=args.chunk_size,
                               preprocess_fn=pre)
        kept = len(outs[0][0])
        t1 = time.time()
        mesh = cf.extract_dual_mesh(mise_iter=1)
        v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
        ax, ay = np.abs(v[:, 0]), np.abs(v[:, 1])
        v = v[(ax > 1) & (ax < 19) & (ay > 1) & (ay < 19)
              & (np.sign(v[:, 0]) == sx) & (np.sign(v[:, 1]) == sy)]
        d = np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))
        errs.append(d)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f"quadrant ({sx},{sy}): {int(m.sum())} points, {kept} kept "
              f"({kept / m.sum():.4%}), {len(cf.chunks)} chunks, "
              f"{len(mesh.v)} vertices, {len(mesh.f)} faces, {len(v)} "
              f"interior, error mean {d.mean():.6f} q90 "
              f"{np.quantile(d, 0.9):.6f} max {d.max():.6f}; reconstruct "
              f"{t1 - t0:.1f} s, mesh {time.time() - t1:.1f} s; peak RSS "
              f"{rss:.2f} GiB", flush=True)
    d = np.concatenate(errs)
    print(f"chunked lidar recipe (chunk_size {args.chunk_size}), UDF on, "
          f"quadrants {args.quadrants}: {len(d)} interior vertices, error "
          f"mean {d.mean():.6f} q90 {np.quantile(d, 0.9):.6f} max "
          f"{d.max():.6f}", flush=True)


if __name__ == "__main__":
    main()
