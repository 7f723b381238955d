"""Time the lattice routes' laps on the card, trees in turns: the splat
lap's phases and its row assembly, and route A's lap with its host
mesher's stages (``chip_smoke.py`` phases 3 and 5).

    python nksr_tpu_torch/scripts/time_laps.py [ROOT ...]

Each ROOT (default: this checkout) is a directory holding an
``nksr_tpu_torch`` package, and each runs in a process of its own, in
the order given, so ``a b b a`` times two versions in turns on one card.
A turn builds that tree's kernels and loads the ``runs/scene_big``
checkpoint with bf16 convs; on the 40 m tile (1M points of
``utils.scenes.synthetic_scene``) it runs a warm-up lap and LAPS laps,
each ``reconstruct(structure="splat", voxel_size=0.1, solver_tol=1e-4,
solver_max_iters=16)`` then ``extract_dual_mesh(mise_iter=1)``, timing
every ``fields.lattice.assemble_rows`` call (the solve's row assembly)
by CUDA events and on the host's clock between two synchronizes; then
one lap of route A on the 60 m tile.  It prints one JSON line: each
lap's reconstruct_s, extract_mesh_s, phases and row-assembly ms.  Exits
2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LAPS = 2
KW = dict(structure="splat", detail_level=None, voxel_size=0.1,
          solver_tol=1e-4, solver_max_iters=16)


def _turn(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch import cuda_build as CB
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.scenes import synthetic_scene

    CB.build_kernels()
    params = load_tree(os.path.join(HERE, "runs", "scene_big",
                                    "best.ckpt"))
    recon = Reconstructor(config=PipelineConfig(conv_dtype="bfloat16"),
                          params=params)
    real, rows = LAT.assemble_rows, []

    def timed_rows(*args, **kw):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = real(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        rows.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                     "events_ms": start.elapsed_time(end)})
        return out

    def lap(xyz, nrm):
        rows.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        field = recon.reconstruct(xyz, nrm, **KW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        field.extract_dual_mesh(mise_iter=1)
        torch.cuda.synchronize()
        return {"reconstruct_s": t1 - t0,
                "extract_mesh_s": time.perf_counter() - t1,
                "phases": {k: round(v, 4)
                           for k, v in field.phase_times.items()},
                "assemble_rows": list(rows)}

    LAT.assemble_rows = timed_rows
    try:
        xyz, nrm = synthetic_scene(1_000_000)
        splat = [lap(xyz, nrm) for _ in range(LAPS + 1)]
        route_a = lap(*synthetic_scene(1_000_000, half_extent=30.0))
    finally:
        LAT.assemble_rows = real
    return {"root": root, "splat": splat, "route_a": route_a}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--turn":
        print(json.dumps(_turn(os.path.abspath(argv[1]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_laps: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_laps: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for root in argv or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
