"""The port's object quality rows (counterpart of the repository's
scripts/make_quality_report.py): a trained checkpoint through
``Reconstructor.reconstruct`` and ``extract_dual_mesh(mise_iter=1)`` on
each test shape of its config's ``test_dataset``, ``MeshEvaluator`` at
5e5 samples (one evaluator, one sample stream, over the rows in the JAX
script's order), per shape and aggregated:

  trained/predicted, trained/splat, trained/predicted+noise,
  trained/splat+noise, noise-trained/predicted+noise,
  noise-trained/splat+noise (with ``--noise_ckpt``), untrained/splat.

``+noise`` rows perturb the input cloud only, as the training noise
recipe does (sigma 0.005 jitter, then 1% bounding-box outliers, from one
numpy stream seeded 1234 a row).  ``untrained/splat`` runs the port's
seeded init (``models.pipeline.init_params``), not the JAX package's.

    python -m nksr_tpu_torch.scripts.make_quality_report \\
        runs/synth_r3c/config.yaml runs/synth_r3c/best.ckpt \\
        --noise_ckpt runs/synth_noise/best.ckpt --limit 16 \\
        --out_md runs/quality_torch/QUALITY_port.md [--device cpu]

Per-shape JSON goes to ``--out_dir`` (runs/quality_torch/); the markdown
table, with the JAX package's row from runs/quality/ beside each row and
the gates (chamfer-L1 at most 1.1x, f-score at least the JAX row's minus
0.01), to ``--out_md``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

KEYS = ["chamfer-L1", "chamfer-L2", "f-score", "f-score-15", "f-score-20",
        "normals", "iou"]
NOISE = (0.005, 0.01)        # the train_noise.yaml operating point
CHAMFER_GATE = 1.1
FSCORE_GATE = 0.01
# the JAX package's per-shape rows and aggregates (its QUALITY.md run)
JAX_ROWS = Path(__file__).resolve().parents[2] / "runs" / "quality"


def run_rows(recon, ds, ev, label, limit, kw, noise=None, n_points=None):
    """One row: reconstruct and evaluate each of the first ``limit``
    items (``noise=(stddev, outlier_ratio)`` perturbs the input cloud);
    returns (per-item metrics, aggregate)."""
    from ..data import DatasetSpec as DS
    from ..data.transforms import PointcloudNoise, PointcloudOutliers
    rows = []
    nrng = np.random.default_rng(1234)
    for i in range(min(len(ds), limit)):
        item = ds[i]
        xyz = np.asarray(item[DS.INPUT_PC], np.float32)
        nrm = np.asarray(item[DS.TARGET_NORMAL], np.float32)
        if noise is not None:
            d = PointcloudNoise(noise[0])({DS.INPUT_PC: xyz}, nrng)
            xyz = PointcloudOutliers(noise[1])(d, nrng)[DS.INPUT_PC]
        try:
            f = recon.reconstruct(xyz, nrm, detail_level=None, **kw)
            mesh = f.extract_dual_mesh(mise_iter=1)
            if mesh.v.shape[0] < 10:
                raise RuntimeError("empty mesh")
            m = ev.eval_mesh(mesh, np.asarray(item[DS.GT_DENSE_PC]),
                             np.asarray(item[DS.GT_DENSE_NORMAL]),
                             onet_samples=item.get(DS.GT_ONET_SAMPLE))
        except (RuntimeError, ValueError) as e:
            print(f"  [{label}] {item[DS.SHAPE_NAME]}: FAILED {e}",
                  flush=True)
            continue
        m["source"] = item[DS.SHAPE_NAME]
        rows.append(m)
        print(f"  [{label}] {m['source']}: chamfer-L1 "
              f"{m['chamfer-L1']:.5f} f-score {m['f-score']:.4f}",
              flush=True)
    agg = {k: float(np.nanmean([r[k] for r in rows]))
           for k in rows[0] if k != "source"} if rows else {}
    return rows, agg


def gate(agg, ref, chamfer=CHAMFER_GATE, fscore=FSCORE_GATE):
    """"ok" or what misses: chamfer-L1 at most ``chamfer`` x the JAX
    row's, f-score at least the JAX row's minus ``fscore``."""
    if not agg or not ref:
        return "no row" if not agg else "no JAX row"
    miss = []
    if agg["chamfer-L1"] > chamfer * ref["chamfer-L1"]:
        miss.append(f"chamfer-L1 {agg['chamfer-L1'] / ref['chamfer-L1']:.3f}"
                    "x")
    if agg["f-score"] < ref["f-score"] - fscore:
        miss.append(f"f-score {agg['f-score'] - ref['f-score']:+.4f}")
    return "ok" if not miss else "MISS: " + ", ".join(miss)


def table(results, refs, header):
    """Markdown rows: the port's aggregate, the JAX row and the gate."""
    lines = [header, "",
             "| row | " + " | ".join(KEYS) + " | n | JAX chamfer-L1 | "
             "JAX f-score | gate |",
             "|---|" + "---|" * (len(KEYS) + 4)]
    for label, (rows, agg) in results.items():
        ref = refs.get(label, {})
        cells = [f"{agg.get(k, float('nan')):.5f}" for k in KEYS]
        lines.append(
            f"| {label} | " + " | ".join(cells) + f" | {len(rows)} | "
            + (f"{ref['chamfer-L1']:.5f} | {ref['f-score']:.5f}"
               if ref else "- | -")
            + f" | {gate(agg, ref)} |")
    return lines


def device_name(recon) -> str:
    import torch
    return torch.cuda.get_device_name(recon.device) \
        if recon.device.type == "cuda" else "the CPU"


def jax_rows(quality_dir: Path):
    """The JAX package's aggregates by row label (runs/quality/)."""
    out = {}
    for p in sorted(quality_dir.glob("metrics_*.json")):
        label = p.stem[len("metrics_"):].replace("_", "/", 1)
        out[label] = json.loads(p.read_text())["aggregate"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("ckpt")
    ap.add_argument("--noise_ckpt", default=None)
    ap.add_argument("--limit", type=int, default=16)
    ap.add_argument("--out_md", required=True)
    ap.add_argument("--out_dir", default="runs/quality_torch")
    ap.add_argument("--eval_points", type=int, default=None,
                    help="mesh samples (default "
                         "MeshEvaluator.N_POINTS_OBJECT)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data import DatasetSpec as DS, build_dataset
    from ..models.pipeline import init_params
    from ..recon.reconstructor import Reconstructor
    from ..train import driver
    from ..utils.checkpoint import load_tree, model_params
    from ..utils.config import load_config
    from ..utils.metrics import MeshEvaluator

    cfg = load_config(args.config)
    pcfg = driver.pipeline_config_from_yaml(cfg)
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    te = cfg.get("test_dataset", cfg.get("val_dataset"))
    ds = build_dataset(te.get("name", "ShapeNet"), spec,
                       **te.get("args", {}))
    ev = MeshEvaluator(n_points=args.eval_points
                       or MeshEvaluator.N_POINTS_OBJECT)
    kw = dict(voxel_size=pcfg.voxel_size, solver_max_iters=64,
              solver_tol=1e-5)

    def recon(ckpt):
        params = init_params(pcfg, 0) if ckpt is None else \
            {"params": model_params(load_tree(ckpt))}
        return Reconstructor(device=args.device, config=pcfg, params=params)

    trained = recon(args.ckpt)
    plan = [("trained/predicted", trained, "predicted", None),
            ("trained/splat", trained, "splat", None),
            ("trained/predicted+noise", trained, "predicted", NOISE),
            ("trained/splat+noise", trained, "splat", NOISE)]
    if args.noise_ckpt:
        noisy = recon(args.noise_ckpt)
        plan += [("noise-trained/predicted+noise", noisy, "predicted", NOISE),
                 ("noise-trained/splat+noise", noisy, "splat", NOISE)]
    plan.append(("untrained/splat", recon(None), "splat", None))
    results = {}
    for label, rec, structure, noise in plan:
        results[label] = run_rows(rec, ds, ev, label, args.limit,
                                  dict(kw, structure=structure), noise)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, (rows, agg) in results.items():
        (out_dir / f"metrics_{label.replace('/', '_')}.json").write_text(
            json.dumps({"rows": rows, "aggregate": agg}, indent=1,
                       default=float))
    lines = table(results, jax_rows(JAX_ROWS),
                  f"Object rows: `{args.ckpt}` under `{args.config}`, "
                  f"{min(len(ds), args.limit)} shapes, MeshEvaluator "
                  f"{ev.n_points} samples, on {device_name(trained)}.")
    Path(args.out_md).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out_md).write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return results


if __name__ == "__main__":
    main()
