"""Overfit one sample (counterpart of the repository's overfit.py): train
on one cloud of the config's ``train_dataset``, print the loss, every
``--interval`` steps reconstruct that cloud with the current weights
(splat structure) and write the mesh; the losses go to ``loss.csv``.

    python -m nksr_tpu_torch.scripts.overfit runs/scene_big/config.yaml \\
        --sample 0 --steps 300 --interval 50

Runs on the card unless given ``--device cpu``.  Each test mesh's
chamfer-L1 to the sample's GT cloud (``MeshEvaluator``, 1e5 samples, as
the JAX package's overfit.py) is printed with its vertex count.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--sample", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--interval", type=int, default=50)
    ap.add_argument("--run_dir", default="runs/overfit")
    ap.add_argument("--exec", nargs="*", default=[], dest="execs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data import DatasetSpec as DS, build_dataset, to_device_batch
    from ..data.io import write_ply
    from ..recon.reconstructor import Reconstructor
    from ..train import driver, loop as T
    from ..utils.checkpoint import torch_to_params
    from ..utils.config import load_config
    from ..utils.metrics import MeshEvaluator
    from .train import apply_overrides

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("overfit: no CUDA device is available (pass "
                           "--device cpu to run on the CPU)")
    cfg = apply_overrides(load_config(args.config), args.execs)
    pcfg = driver.pipeline_config_from_yaml(cfg)
    lcfg = driver.loss_config_from_yaml(cfg)
    tcfg = driver.train_config_from_yaml(cfg)
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL]
    tr = cfg.get("train_dataset", {})
    ds = build_dataset(tr.get("name", "ShapeNet"), spec,
                       **tr.get("args", {}))
    batch = to_device_batch(ds[args.sample], cfg.get("point_bucket"),
                            cfg.get("gt_bucket"))
    run = Path(args.run_dir)
    run.mkdir(parents=True, exist_ok=True)
    state = T.init_state(pcfg, tcfg, args.seed, device=device)
    evaluator = MeshEvaluator(n_points=100000)
    gt = batch["gt_xyz"].numpy()[batch["gt_mask"].numpy()]
    hist = []
    m = batch["mask"].numpy()
    for i in range(args.steps):
        state, losses, _ = T.train_step(
            pcfg, tcfg, lcfg, state, batch,
            torch.Generator().manual_seed(i), use_gt_structure=True)
        hist.append({"step": i, **losses})
        if i % 10 == 0:
            print(f"[{i}] sum={losses['sum']:.4f}", flush=True)
        if args.interval and (i + 1) % args.interval == 0:
            recon = Reconstructor(device=device, config=pcfg, params={
                "params": torch_to_params(state.net.state_dict())})
            field = recon.reconstruct(
                batch["xyz"].numpy()[m], batch["normal"].numpy()[m],
                detail_level=None, voxel_size=pcfg.voxel_size,
                structure="splat")
            mesh = field.extract_dual_mesh(mise_iter=1)
            cd = evaluator.eval_mesh(mesh, gt)["chamfer-L1"]
            print(f"[test {i + 1}] chamfer-L1={cd:.5f} v={mesh.v.shape[0]}",
                  flush=True)
            write_ply(run / f"mesh_{i + 1}.ply", mesh.v, mesh.f)
    with open(run / "loss.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted(hist[0]))
        w.writeheader()
        w.writerows(hist)
    print(f"wrote {run}/loss.csv")
    return hist


if __name__ == "__main__":
    main()
