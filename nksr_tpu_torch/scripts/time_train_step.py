"""Time warm training steps on the card: ``chip_smoke.py`` phase 11's
teacher-forced step at runs/scene_big's width (its config.yaml and
best.ckpt, item 0 of the checkout's 5 m terrain corpus, one fixed set of
draws).

    python nksr_tpu_torch/scripts/time_train_step.py [ROOT ...]

The corpus is written once under the checkout's data/ (as phase 11
writes it).  Each ROOT (default: this checkout) is a directory holding
an ``nksr_tpu_torch`` package, and each runs in a process of its own,
in the order given, so ``a b b a`` times two versions in turns on one
card; the step's driver code (``chip_smoke.scene_train_setup``) is this
checkout's, the package the ROOT's.  A turn builds that tree's kernels,
runs one step and then STEPS warm steps, each ended by a synchronize,
and prints one JSON line: their seconds, the fastest and the median of
the warm ones, the loss sums (equal across ROOTs when their sums are)
and the segment sum's launches in one step.  Exits 2 without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 30


def _turn(root: str) -> dict:
    sys.path[:0] = [root, HERE]
    import numpy as np
    import torch
    import chip_smoke as CS
    from nksr_tpu_torch.ops import segment_sum as SEG
    from nksr_tpu_torch.train import driver
    from nksr_tpu_torch.train import loop as T
    from nksr_tpu_torch.utils.checkpoint import load_tree

    yc, cfg, lcfg, _, _, batch, samples, _ = CS.scene_train_setup()
    tc = driver.train_config_from_yaml(yc)
    params = load_tree(os.path.join(HERE, "runs", "scene_big",
                                    "best.ckpt"))
    state = T.init_state(cfg, tc, params=params, device="cuda")
    seconds, sums, launches = [], [], 0
    for i in range(STEPS + 1):
        before = SEG.segment_sum.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses, _ = T.train_step(cfg, tc, lcfg, state, batch, None,
                                        samples=samples)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        sums.append(float(losses["sum"]))
        launches = SEG.segment_sum.launches - before
    warm = seconds[1:]
    return {"root": root, "seconds": seconds, "warm_s": min(warm),
            "median_s": float(np.median(warm)), "sums": sums,
            "segsum_launches": launches}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--turn":
        print(json.dumps(_turn(os.path.abspath(argv[1]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_train_step: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_train_step: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sys.path.insert(0, HERE)
    import chip_smoke as CS
    corpus = os.path.join(HERE, CS.TRAIN_ROOT)
    if not os.path.exists(os.path.join(corpus, "terrain", "train.lst")):
        CS.make_corpus(corpus)
    rc = 0
    for root in argv or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
