"""The JAX package's in-graph route, ``Reconstructor.reconstruct(
structure="predicted_ingraph")`` then ``extract_dual_mesh(mise_iter=1)``
(the in-graph dual MC, Newton steps), under ``runs/scene_big``'s own
configuration (UDF mask head on, f32 convs), 16 CG iterations at tol
1e-4, on the CPU: the reference numbers of the port's in-graph route.

    env -u PYTHONPATH JAX_PLATFORMS=cpu \
        python scripts/quality_reference_ingraph.py \
        [--scenes [--skip-reads N]] [--quadrant] [--chunked]

``--scenes``: the held-out scenes of ``scripts/make_synth_scenes.py
data/synth_scene_eval 40`` (its test split, 5 terrain patches of 30,000
points, 8,000 input points each as the config's ``test_dataset`` draws
them; written if missing), ``MeshEvaluator`` at 5e6 samples per scene:
chamfer-L1 and f-score per scene; ``--skip-reads N`` reads each scene N
times first (the dataset draws another input subsample at each read:
``nksr_tpu_torch.scripts.make_scene_quality`` meshes the in-graph route
as its fourth route, on each scene's fourth read).  ``--quadrant``: the
(-x, -y) 20 m quadrant of ``synthetic_scene(1_000_000)`` alone, the
interior terrain vertex error mean (|v_z - h(v_x, v_y)| over the used
vertices 1 m inside the quadrant).  ``--chunked``: the same quadrant with ``chunk_size=10``
(four 10 m chunks, each meshed alone and welded).  Prints one line per
item, with seconds and peak RSS.
"""

import argparse
import dataclasses
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SCENES = ROOT / "data" / "synth_scene_eval"
KW = dict(detail_level=None, voxel_size=0.1, solver_tol=1e-4,
          solver_max_iters=16)


def height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def rss() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def quadrant_error(mesh) -> np.ndarray:
    v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
    v = v[(v[:, 0] < -1) & (v[:, 0] > -19) & (v[:, 1] < -1)
          & (v[:, 1] > -19)]
    return np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", action="store_true")
    ap.add_argument("--quadrant", action="store_true")
    ap.add_argument("--chunked", action="store_true")
    ap.add_argument("--skip-reads", type=int, default=0)
    args = ap.parse_args()
    from flax.serialization import msgpack_restore

    from bench import synthetic_scene
    from nksr_tpu import Reconstructor
    from nksr_tpu.data import DatasetSpec as DS, build_dataset
    from nksr_tpu.train.driver import pipeline_config_from_yaml
    from nksr_tpu.utils.config import load_config
    from nksr_tpu.utils.metrics import MeshEvaluator

    yc = load_config(ROOT / "runs/scene_big/config.yaml")
    cfg = pipeline_config_from_yaml(yc)
    assert cfg.udf_enabled
    tree = msgpack_restore((ROOT / "runs/scene_big/best.ckpt").read_bytes())
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]
    recon = Reconstructor(config=cfg, params={"params": tree})

    if args.scenes:
        if not (SCENES / "terrain" / "test.lst").exists():
            subprocess.run([sys.executable, str(ROOT / "scripts" /
                                                "make_synth_scenes.py"),
                            str(SCENES), "40"], check=True)
        spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL,
                DS.GT_DENSE_PC, DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
        te = dict(yc["test_dataset"]["args"], root=str(SCENES))
        ds = build_dataset("ShapeNet", spec, **te)
        ev = MeshEvaluator(n_points=MeshEvaluator.N_POINTS_SCENE)
        for i in range(len(ds)):
            for _ in range(args.skip_reads):
                ds[i]
            item = ds[i]
            t0 = time.time()
            f = recon.reconstruct(item[DS.INPUT_PC], item[DS.TARGET_NORMAL],
                                  structure="predicted_ingraph", **KW)
            mesh = f.extract_dual_mesh(mise_iter=1)
            t1 = time.time()
            m = ev.eval_mesh(mesh, item[DS.GT_DENSE_PC],
                             item[DS.GT_DENSE_NORMAL],
                             onet_samples=item.get(DS.GT_ONET_SAMPLE))
            print(f"scene {item[DS.SHAPE_NAME]}: {len(mesh.v)} vertices, "
                  f"{len(mesh.f)} faces, chamfer-L1 {m['chamfer-L1']:.6f} "
                  f"f-score {m['f-score']:.6f} iou {m.get('iou', 0):.6f} "
                  f"({t1 - t0:.1f} s + {time.time() - t1:.1f} s; peak RSS "
                  f"{rss():.2f} GiB)", flush=True)

    if args.quadrant or args.chunked:
        xyz, nrm = synthetic_scene(1_000_000)
        m = (xyz[:, 0] < 0) & (xyz[:, 1] < 0)
        xyz, nrm = xyz[m], nrm[m]
    if args.quadrant:
        t0 = time.time()
        f = recon.reconstruct(xyz, nrm, structure="predicted_ingraph", **KW)
        mesh = f.extract_dual_mesh(mise_iter=1)
        d = quadrant_error(mesh)
        print(f"quadrant (-x, -y), in-graph: {len(xyz)} points, "
              f"capacities {[g.capacity for g in f.svh.grids]}, "
              f"{len(mesh.v)} vertices, {len(mesh.f)} faces, {len(d)} "
              f"interior, error mean {d.mean():.6f} q90 "
              f"{np.quantile(d, 0.9):.6f} max {d.max():.6f} in "
              f"{time.time() - t0:.1f} s; peak RSS {rss():.2f} GiB",
              flush=True)
    if args.chunked:
        crec = Reconstructor(config=dataclasses.replace(
            cfg, structure_mode="predicted_ingraph"),
            params={"params": tree})
        t0 = time.time()
        f = crec.reconstruct(xyz, nrm, chunk_size=10.0,
                             solver_tol=KW["solver_tol"])
        mesh = f.extract_dual_mesh(mise_iter=1)
        d = quadrant_error(mesh)
        print(f"quadrant (-x, -y), in-graph, chunk_size 10: "
              f"{len(f.chunks)} chunks, {len(mesh.v)} vertices, "
              f"{len(mesh.f)} faces, {len(d)} interior, error mean "
              f"{d.mean():.6f} q90 {np.quantile(d, 0.9):.6f} max "
              f"{d.max():.6f} in {time.time() - t0:.1f} s; peak RSS "
              f"{rss():.2f} GiB", flush=True)


if __name__ == "__main__":
    main()
