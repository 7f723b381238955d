"""Time the AV0 slot-row wrapper on the card at the lattice solve's real
input: the slot cells and first-matvec coefficients of a splat lap on the
40 m tile (1M points of ``utils.scenes.synthetic_scene``, the
``runs/scene_big`` checkpoint, as ``chip_smoke.py`` phase 3 runs it).

    python nksr_tpu_torch/scripts/time_rows.py [ROOT ...]

The lap runs once, in a process of its own with this checkout's
package; its inputs go to a temporary file.  Each ROOT (default: this
checkout) is a directory holding an ``nksr_tpu_torch`` package, and each
runs in a process of its own, in the order given, so ``a b b a`` times
two versions in turns on one card.  A turn builds that tree's kernels,
checks ``av0_rows`` bit-equal to its plain version in bf16 (the solve's
form) and prints one JSON line: milliseconds per call from CUDA events
(the faster of two runs of 20 calls, after a warm-up call).  Exits 2
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _copy(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_copy(x) for x in a)
    return a.clone() if hasattr(a, "clone") else a


def capture_first(module, name: str, fn):
    """Run ``fn`` with ``module.<name>`` recording its first call.
    Returns (fn's result, copies of the call's positional arguments).
    The recorder puts the function back before calling it: a kernel
    wrapper counts its launches on its module-level name."""
    real, rec = getattr(module, name), {}

    def recorder(*args):
        setattr(module, name, real)
        rec["args"] = _copy(args)
        return real(*args)

    setattr(module, name, recorder)
    try:
        res = fn()
    finally:
        setattr(module, name, real)
    return res, rec["args"]


def capture_rows(LK, fn):
    """Run ``fn`` with ``LK.av0_rows`` (the module ``LK``'s wrapper)
    recording its first call.  Returns (fn's result, the call's spec,
    a copy of its cells, a copy of its coefficient lattices)."""
    res, (spec, xs, cells, _) = capture_first(LK, "av0_rows", fn)
    return res, spec, cells, xs


def _capture(path: str) -> None:
    """One splat lap; saves the spec's dims and point-slot count, the
    slot cells and the coefficients of the first ``av0_rows`` call, and
    the slot cells of the adjoint's tables (-1 at the dropped pad
    slots), to ``path``."""
    sys.path.insert(0, HERE)
    import torch
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.fields import lattice_kernels as LK
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.scenes import synthetic_scene

    params = load_tree(os.path.join(HERE, "runs", "scene_big", "best.ckpt"))
    recon = Reconstructor(config=PipelineConfig(conv_dtype="bfloat16"),
                          params=params)
    xyz, nrm = synthetic_scene(1_000_000)
    (_, spec, cells, xs), (_, adj_cells) = capture_first(
        LK, "adjoint_rows_tables", lambda: capture_rows(
            LK, lambda: recon.reconstruct(
                xyz, nrm, structure="splat", detail_level=None,
                voxel_size=0.1, solver_tol=1e-4, solver_max_iters=16)))
    torch.save({"dims": spec.dims, "k": spec.k, "s_pt": spec.s_pt,
                "cells": cells.cpu(), "xs": [x.cpu() for x in xs],
                "adj_cells": adj_cells.cpu()}, path)


def _turn(root: str, path: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK

    rec = torch.load(path)
    spec = LAT.LatticeSpec(dims=rec["dims"], k=rec["k"],
                           depth=len(rec["dims"]), adaptive_depth=1,
                           s_pt=8, p_rows=4, s_gr=8, n_pts_cap=8)
    cells = rec["cells"].cuda()
    xs = [x.cuda() for x in rec["xs"]]
    bf = torch.bfloat16
    if not torch.equal(LK.av0_rows(spec, xs, cells, bf),
                       LK.av0_rows_plain(spec, xs, cells, bf)):
        raise AssertionError(f"{root}: av0_rows differs from plain")
    runs = []
    for _ in range(2):
        LK.av0_rows(spec, xs, cells, bf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            LK.av0_rows(spec, xs, cells, bf)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 20)
    return {"root": root, "rows": cells.numel(), "ms": min(runs),
            "runs_ms": runs}


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
        print("time_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_rows: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows_input.pt")
        if subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--capture", path]).returncode:
            return 1
        for root in argv or [HERE]:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--turn", root, path]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
