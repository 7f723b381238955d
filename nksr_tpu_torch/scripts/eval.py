"""Evaluate a trained model (counterpart of the repository's eval.py):
for each test sample of the config's ``test_dataset`` (or
``val_dataset``), the inference forward with no GT
(``models/pipeline.infer``: the predicted structure at the config's
capacities, the support-row solve), the in-graph mesher
``extract_dual_mesh(mise_iter, grid_upsample)`` and ``MeshEvaluator``;
per-sample rows to ``<run_dir>/metrics.csv``, the aggregate printed.

    python -m nksr_tpu_torch.scripts.eval runs/synth_r3c/config.yaml \\
        --ckpt runs/synth_r3c/best.ckpt --run_dir runs/eval_port \\
        [--limit N] [--focus NAME_OR_INDEX] [--save_meshes] \\
        [--eval_points 500000] [--device cpu]

Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--run_dir", default="runs/eval")
    ap.add_argument("--exec", nargs="*", default=[], dest="execs")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--focus", default=None,
                    help="evaluate only the sample(s) whose index or "
                         "shape name contains this string")
    ap.add_argument("--mise_iter", type=int, default=1)
    ap.add_argument("--upsample", type=int, default=1)
    ap.add_argument("--save_meshes", action="store_true")
    ap.add_argument("--eval_points", type=int, default=int(5e5),
                    help="mesh samples for the metrics (5e5 for objects, "
                         "5e6 for scenes with GT geometry)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..data import DatasetSpec as DS, build_dataset, to_device_batch
    from ..data.io import write_ply
    from ..models import pipeline as P
    from ..recon.reconstructor import Reconstructor
    from ..train import driver
    from ..utils.checkpoint import load_tree, model_params
    from ..utils.config import load_config
    from ..utils.metrics import MeshEvaluator
    from .train import apply_overrides

    cfg = apply_overrides(load_config(args.config), args.execs)
    pcfg = driver.pipeline_config_from_yaml(cfg)
    recon = Reconstructor(device=args.device, config=pcfg, params={
        "params": model_params(load_tree(args.ckpt))})
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    te = cfg.get("test_dataset", cfg.get("val_dataset"))
    ds = build_dataset(te.get("name", "ShapeNet"), spec,
                       **te.get("args", {}))
    run = Path(args.run_dir)
    run.mkdir(parents=True, exist_ok=True)

    evaluator = MeshEvaluator(n_points=args.eval_points)
    n = min(len(ds), args.limit) if args.limit else len(ds)
    indices = list(range(n))
    if args.focus is not None:
        if args.focus.isdigit():
            indices = [int(args.focus)]
        else:
            indices = [i for i in indices
                       if args.focus in str(ds[i][DS.SHAPE_NAME])]
        if not indices:
            raise SystemExit(f"--focus {args.focus!r} matched no sample")
        n = len(indices)
    rows = []
    for j, i in enumerate(indices):
        item = ds[i]
        # the padded batch's real rows: a cloud over point_bucket is cut
        # there, as the JAX package's padded forward cuts it
        batch = to_device_batch(item, cfg.get("point_bucket"),
                                cfg.get("gt_bucket"))
        m = batch["mask"].numpy()
        xyz = np.ascontiguousarray(batch["xyz"].numpy()[m])
        dev = recon.device

        def real(key):
            return None if key not in batch else \
                torch.as_tensor(batch[key].numpy()[m], device=dev)
        feat = P.point_features(pcfg, torch.as_tensor(xyz, device=dev),
                                normal=real("normal"), sensor=real("sensor"))
        out = P.infer(pcfg, recon.network, xyz, feat)
        mesh = out.field.extract_dual_mesh(mise_iter=args.mise_iter,
                                           grid_upsample=args.upsample)
        gtn = item.get(DS.GT_DENSE_NORMAL)
        res = evaluator.eval_mesh(
            mesh, np.asarray(item[DS.GT_DENSE_PC]),
            None if gtn is None else np.asarray(gtn),
            onet_samples=item.get(DS.GT_ONET_SAMPLE))
        res["source"] = item[DS.SHAPE_NAME]
        rows.append(res)
        print(f"[{j + 1}/{n}] {res['source']}: " +
              ", ".join(f"{k}={v:.4f}" for k, v in res.items()
                        if isinstance(v, float)), flush=True)
        if args.save_meshes:
            write_ply(run / f"{res['source'].replace('/', '_')}.ply",
                      mesh.v, mesh.f)

    with open(run / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted(rows[0]))
        w.writeheader()
        w.writerows(rows)
    agg = {k: float(np.nanmean([r[k] for r in rows]))
           for k in rows[0] if k != "source"}
    print("AGGREGATE:", json.dumps(agg, indent=2))
    return rows, agg


if __name__ == "__main__":
    main()
