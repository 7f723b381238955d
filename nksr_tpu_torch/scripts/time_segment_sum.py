"""Time the fixed-order segment sum on the card at the encoder splat's
real input: the rows and cells of a splat lap's ``index_sum`` on the 40 m
tile (1M points of ``utils.scenes.synthetic_scene``, the
``runs/scene_big`` checkpoint, as ``chip_smoke.py`` phase 3 runs it),
8M rows of 7 onto the 8.6M cells of the dense lattice.

    python nksr_tpu_torch/scripts/time_segment_sum.py [ROOT ...]

The lap runs once, in a process of its own with this checkout's
package; its inputs go to a temporary file.  Each ROOT (default: this
checkout) is a directory holding an ``nksr_tpu_torch`` package, and each
runs in a process of its own, in the order given, so ``a b b a`` times
two versions in turns on one card.  A turn builds that tree's kernels,
builds the order (``segment_order``), checks the dense sum
(``segment_sum``) bit-equal to its plain version on CPU copies and
prints one JSON line: milliseconds per call from CUDA events of the sum
(the fastest of three runs of 20 calls, after a warm-up call) and of
the order's build (one run of 3).  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _capture(path: str) -> None:
    """One splat lap; saves the first ``index_sum`` call's rows, cells and
    cell count to ``path``."""
    sys.path.insert(0, HERE)
    import torch
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.ops import segment_sum as SEG
    from nksr_tpu_torch.scripts.time_rows import capture_first
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.scenes import synthetic_scene

    params = load_tree(os.path.join(HERE, "runs", "scene_big", "best.ckpt"))
    recon = Reconstructor(config=PipelineConfig(conv_dtype="bfloat16"),
                          params=params)
    xyz, nrm = synthetic_scene(1_000_000)
    _, (values, index, n) = capture_first(
        SEG, "index_sum", lambda: recon.reconstruct(
            xyz, nrm, structure="splat", detail_level=None,
            voxel_size=0.1, solver_tol=1e-4, solver_max_iters=16))
    torch.save({"values": values.cpu(), "index": index.cpu(), "n": n},
               path)


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _turn(root: str, path: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from nksr_tpu_torch.ops import segment_sum as SEG

    rec = torch.load(path)
    n = rec["n"]
    values, index = rec["values"].cuda(), rec["index"].cuda()
    order = SEG.segment_order(index, n)
    ref = SEG.segment_sum_plain(rec["values"],
                                SEG.segment_order(rec["index"], n))
    if not torch.equal(SEG.segment_sum(values, order).cpu(), ref):
        raise AssertionError(f"{root}: segment_sum differs from plain")
    runs = [_ms(lambda: SEG.segment_sum(values, order), 20)
            for _ in range(3)]
    return {"root": root, "rows": index.numel(), "cols": values.shape[1],
            "targets": n, "ms": min(runs), "runs_ms": runs,
            "order_ms": _ms(lambda: SEG.segment_order(index, n), 3)}


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--turn":
        print(json.dumps(_turn(os.path.abspath(argv[1]), argv[2])),
              flush=True)
        return 0
    if len(argv) >= 2 and argv[0] == "--capture":
        _capture(argv[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_segment_sum: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_segment_sum: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "splat_input.pt")
        if subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--capture", path]).returncode:
            return 1
        for root in argv or [HERE]:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--turn", root, path]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
