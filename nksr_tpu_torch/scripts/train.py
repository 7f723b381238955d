"""Train a model from a run config on one GPU (counterpart of the
repository's train.py; past the config's ``structure_schedule.
start_step`` the teacher-forcing coin sends a growing share of steps
to the predicted structure):

    python -m nksr_tpu_torch.scripts.train runs/scene_big/config.yaml \\
        --run_dir runs/port_scene --max_steps 100 --val_every 50

The config's ``train_dataset`` / ``val_dataset`` (ShapeNet layout, e.g.
the corpus ``scripts/make_synth_scenes.py`` writes) feed the loop;
``--exec key.sub=value`` overrides config keys; ``--resume`` continues
from the run's ``last.ckpt`` (either package's).  Runs on the card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def apply_overrides(cfg: dict, execs) -> dict:
    """``key.sub=value`` overrides, each value read as a YAML scalar."""
    from ..utils.config import _scalar
    for e in execs:
        key, _, text = e.partition("=")
        node = cfg
        *head, last = key.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = _scalar(text.strip(), f"--exec {e}")
    return cfg


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
    ap.add_argument("--max_steps", type=int, default=10 ** 9)
    ap.add_argument("--val_every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data import DatasetSpec as DS, PrefetchLoader
    from ..train import driver
    from ..utils.config import load_config

    cfg = apply_overrides(load_config(args.config), args.execs)
    run_dir = Path(args.run_dir or f"runs/{cfg.get('name', 'untitled')}")
    run_dir.mkdir(parents=True, exist_ok=True)
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    train_ds, val_ds = datasets(cfg, spec)
    pb, gb = cfg.get("point_bucket"), cfg.get("gt_bucket")
    train_loader = PrefetchLoader(train_ds, shuffle=True, seed=args.seed,
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
