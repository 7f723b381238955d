"""The port's scene quality rows (counterpart of the repository's
scripts/make_scene_quality.py): the held-out synthetic scenes of a scene
checkpoint's ``test_dataset`` at the scene eval density (5e6 mesh
samples), and the 1M-point bench terrain against its analytic height
field, with the solver at the bench's operating point (16 iterations,
tol 1e-4), on the predicted, splat and adaptive structures
(``--structures`` adds others, e.g. predicted_ingraph).

    python -m nksr_tpu_torch.scripts.make_scene_quality \\
        runs/scene_big/config.yaml runs/scene_big/best.ckpt --limit 8 \\
        --out_md runs/quality_torch/QUALITY_scene_port.md [--device cpu]

Per-scene JSON goes to ``--out_dir`` (runs/quality_torch/); the markdown
tables, with the JAX package's QUALITY.md rows beside them and the gates
(chamfer-L1 at most 1.1x, f-score at least the JAX row's minus 0.01, the
terrain vertex error mean at most 1.5x), to ``--out_md``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .make_quality_report import device_name, run_rows, table

STRUCTURES = ("predicted", "splat", "adaptive")
# The JAX package's rows (QUALITY.md, "Scene-scale quality", the same
# checkpoint, limit 8 of 5 held-out scenes, MeshEvaluator 5e6)
JAX_SCENE = {
    "scene/predicted": {"chamfer-L1": 0.0094, "f-score": 0.4275},
    "scene/splat": {"chamfer-L1": 0.0094, "f-score": 0.4229},
    "scene/adaptive": {"chamfer-L1": 0.0094, "f-score": 0.4224},
    # the in-graph route on the 5 held-out scenes of a 40-patch corpus,
    # each scene's fourth read, as this script's fourth route reads it
    # (scripts/quality_reference_ingraph.py --scenes --skip-reads 3, the
    # mean of its per-scene lines; terrain_037's draw meshes at 0.0583 in
    # both packages)
    "scene/predicted_ingraph": {"chamfer-L1": 0.0191938,
                                "f-score": 0.4245074},
}
# ... and its bench-terrain vertex error means (QUALITY.md)
JAX_TERRAIN = {"predicted": 0.0052, "splat": 0.0050, "adaptive": 0.0050}
TERRAIN_GATE = 1.5


def terrain_height(x, y):
    return (np.sin(0.3 * x) * np.cos(0.25 * y)
            + 0.3 * np.sin(1.1 * x + 0.7 * y))


def terrain_rows(recon, structures, n_points: int = 1_000_000,
                 half_extent: float = 20.0):
    """The 1M-point bench terrain (a 40 m tile) reconstructed whole per
    structure: the vertical distance |v_z - h(v_x, v_y)| of the mesh's
    used vertices 1 m inside the tile's edge."""
    from ..utils.scenes import synthetic_scene
    xyz, nrm = synthetic_scene(n_points, half_extent=half_extent)
    inner = half_extent - 1.0
    rows = []
    for structure in structures:
        f = recon.reconstruct(xyz, nrm, detail_level=None, voxel_size=0.1,
                              solver_tol=1e-4, solver_max_iters=16,
                              structure=structure)
        mesh = f.extract_dual_mesh(mise_iter=1)
        v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
        v = v[(np.abs(v[:, 0]) < inner) & (np.abs(v[:, 1]) < inner)]
        d = np.abs(v[:, 2] - terrain_height(v[:, 0], v[:, 1]))
        rows.append({"structure": structure, "verts": int(len(v)),
                     "vert_err_mean": float(d.mean()),
                     "vert_err_q90": float(np.quantile(d, 0.9)),
                     "vert_err_max": float(d.max())})
        print(f"  [terrain/{structure}] verts {len(v)} err mean "
              f"{d.mean():.5f} q90 {np.quantile(d, 0.9):.5f}", flush=True)
        del f, mesh
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("ckpt")
    ap.add_argument("--limit", type=int, default=8)
    ap.add_argument("--out_md", required=True)
    ap.add_argument("--out_dir", default="runs/quality_torch")
    ap.add_argument("--structures", nargs="*", default=list(STRUCTURES))
    ap.add_argument("--terrain_points", type=int, default=1_000_000,
                    help="0 skips the terrain rows")
    ap.add_argument("--eval_points", type=int, default=None,
                    help="mesh samples (default MeshEvaluator.N_POINTS_SCENE)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data import DatasetSpec as DS, build_dataset
    from ..recon.reconstructor import Reconstructor
    from ..train import driver
    from ..utils.checkpoint import load_tree, model_params
    from ..utils.config import load_config
    from ..utils.metrics import MeshEvaluator

    cfg = load_config(args.config)
    pcfg = driver.pipeline_config_from_yaml(cfg)
    recon = Reconstructor(device=args.device, config=pcfg, params={
        "params": model_params(load_tree(args.ckpt))})
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    te = cfg.get("test_dataset", cfg.get("val_dataset"))
    ds = build_dataset(te.get("name", "ShapeNet"), spec,
                       **te.get("args", {}))
    ev = MeshEvaluator(n_points=args.eval_points
                       or MeshEvaluator.N_POINTS_SCENE)
    kw = dict(voxel_size=pcfg.voxel_size, solver_max_iters=16,
              solver_tol=1e-4)
    results = {f"scene/{s}": run_rows(recon, ds, ev, s, args.limit,
                                      dict(kw, structure=s))
               for s in args.structures}
    terrain = terrain_rows(recon, args.structures, args.terrain_points) \
        if args.terrain_points else []

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, (rows, agg) in results.items():
        (out_dir / f"metrics_{label.replace('/', '_')}.json").write_text(
            json.dumps({"rows": rows, "aggregate": agg}, indent=1,
                       default=float))
    (out_dir / "terrain.json").write_text(json.dumps(terrain, indent=1))
    lines = table(results, JAX_SCENE,
                  f"Scene rows: `{args.ckpt}` under `{args.config}`, "
                  f"held-out scenes (limit {args.limit}), MeshEvaluator "
                  f"{ev.n_points} samples, 16 CG iterations at tol 1e-4, "
                  f"on {device_name(recon)}.")
    lines += ["", f"Bench terrain ({args.terrain_points} points, voxel "
              "0.1, vertices 1 m inside the edge):", "",
              "| route | verts | vert err mean | q90 | max | JAX mean | "
              "gate |", "|---|---|---|---|---|---|---|"]
    for r in terrain:
        ref = JAX_TERRAIN.get(r["structure"])
        ok = "-" if ref is None else (
            "ok" if r["vert_err_mean"] <= TERRAIN_GATE * ref else
            f"MISS: {r['vert_err_mean'] / ref:.3f}x")
        lines.append(
            f"| terrain/{r['structure']} | {r['verts']} | "
            f"{r['vert_err_mean']:.5f} | {r['vert_err_q90']:.5f} | "
            f"{r['vert_err_max']:.5f} | {ref if ref else '-'} | {ok} |")
    Path(args.out_md).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out_md).write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return results, terrain


if __name__ == "__main__":
    main()
