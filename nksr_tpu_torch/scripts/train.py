"""Train a model from a config (counterpart of the repository's
train.py; past the config's ``structure_schedule.start_step`` the
teacher-forcing coin sends a growing share of steps to the predicted
structure):

    python -m nksr_tpu_torch.scripts.train runs/scene_big/config.yaml \\
        --run_dir runs/port_scene --max_steps 100 --val_every 50

Data-parallel on N GPUs of one host, ``--batch_size`` clouds a step in
all (a multiple of N; each rank reads its own stride of the train set):

    torchrun --nproc_per_node=N -m nksr_tpu_torch.scripts.train \\
        runs/scene_big/config.yaml --batch_size B

The config's ``train_dataset`` / ``val_dataset`` (ShapeNet layout, e.g.
the corpus ``scripts/make_synth_scenes.py`` writes) feed the loop;
``--include`` merges more config files on top, ``--exec key.sub=value``
overrides keys; the merged config is saved as the run directory's
``config.yaml``; ``--resume`` continues from the run's ``last.ckpt``
(either package's).  Runs on the card unless given ``--device cpu``
(then a world over gloo: torchrun's environment set by hand,
``MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=2 RANK=r``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..utils.config import apply_overrides  # noqa: F401  (eval, overfit)


def datasets(cfg: dict, spec):
    from ..data import build_dataset
    tr = cfg.get("train_dataset", {})
    va = cfg.get("val_dataset", tr)
    return (build_dataset(tr.get("name", "ShapeNet"), spec,
                          **tr.get("args", {})),
            build_dataset(va.get("name", "ShapeNet"), spec,
                          **va.get("args", {})))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--run_dir", default=None)
    ap.add_argument("--exec", nargs="*", default=[], dest="execs",
                    help="dotted key=value config overrides")
    ap.add_argument("--include", nargs="*", default=[],
                    help="extra config files merged on top")
    ap.add_argument("--max_steps", type=int, default=10 ** 9)
    ap.add_argument("--val_every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--batch_size", type=int, default=None,
                    help="clouds a step over all ranks (data-parallel "
                         "above 1; a multiple of the world size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..data import DatasetSpec as DS, PrefetchLoader
    from ..parallel import init_distributed
    from ..train import driver
    from ..utils.config import load_config, save_config

    distributed = init_distributed(
        backend=None if args.device == "cuda" else "gloo")
    rank, world = ((dist.get_rank(), dist.get_world_size()) if distributed
                   else (0, 1))
    cfg = load_config(args.config, overrides=args.execs,
                      includes=args.include)
    run_dir = Path(args.run_dir or f"runs/{cfg.get('name', 'untitled')}")
    if rank == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, run_dir / "config.yaml")
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    train_ds, val_ds = datasets(cfg, spec)
    pb, gb = cfg.get("point_bucket"), cfg.get("gt_bucket")
    if args.batch_size and args.batch_size > 1:
        # the clouds of a step are stacked: one shape for all of them
        pb = pb or cfg.get("capacities", [65536])[0]
        gb = gb or pb
    # each rank its own stride of the train set (DistributedSampler's)
    train_loader = PrefetchLoader(train_ds,
                                  indices=range(rank, len(train_ds), world),
                                  shuffle=True, seed=args.seed,
                                  point_bucket=pb, gt_bucket=gb,
                                  epochs=10 ** 6)

    class Revalidating:
        def __iter__(self):
            return iter(PrefetchLoader(
                val_ds, indices=range(min(len(val_ds), 8)),
                shuffle=False, point_bucket=pb, gt_bucket=gb))

    return driver.fit(cfg, train_loader, Revalidating(), run_dir,
                      max_steps=args.max_steps, val_every=args.val_every,
                      seed=args.seed, resume=args.resume,
                      batch_size=args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
