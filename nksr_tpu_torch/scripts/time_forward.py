"""Time the dense AV0 forward (``av0_cascade``, the evaluator's table) on
the card at the lattice plans of two 1M-point terrain tiles of
``utils.scenes.synthetic_scene``: the 40 m tile (the splat path's plan)
and the 60 m tile (route A's plan), both as ``Reconstructor`` plans them
(voxel 0.1, depth 4, k = 4).

    python nksr_tpu_torch/scripts/time_forward.py [ROOT ...]

The plans are made once on the host, with this checkout's package (the
scene's splat grids and ``plan_lattice``; no device stage), and their
dims go to a temporary file.  Each ROOT (default: this checkout) is a
directory holding an ``nksr_tpu_torch`` package, and each runs in a
process of its own, in the order given, so ``old new new old`` times two
versions in turns on one card.  A turn builds that tree's kernels and, on
seeded random f32 coefficients of each plan's spec, checks
``av0_cascade`` bit-equal to its plain version in bf16 and f32 and times
by CUDA events (the faster of two runs of 10 calls, after a warm-up
call)

  bf16, f32        the forward in each output type;
  ceiling_bf16,    ``torch.empty_like(out).zero_()`` of the forward's
  ceiling_f32      output: a plain write of the same bytes, the
                   yardstick of what the card's memory takes to write
                   them (the port never calls it; not a library time);

beside the bound (every coefficient row read once in f32, every lane
written once, over 3.35 TB/s).  It prints the card's name and power
limit, then one JSON line a turn.  Exits 2 without a CUDA device.

To time a parent commit against this tree, unpack it into a directory
that .gitignore lists (``git archive <commit> | tar -x -C _archive/p``)
and pass ``_archive/p . . _archive/p``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# terrain tiles of 1M points: half extents of the splat path's plan and of
# route A's (chip_smoke.py phases 3 and 5)
PLANS = {"tile40": 20.0, "tile60_route_a": 30.0}
HBM_B_PER_MS = 3.35e12 / 1e3


def plan_dims(half_extent: float):
    """Per-depth lattice dims of ``Reconstructor``'s plan for 1M points of
    the terrain tile of side 2 * half_extent (host code only)."""
    sys.path.insert(0, HERE)
    from nksr_tpu_torch import PipelineConfig
    from nksr_tpu_torch.core import host_build as HB
    from nksr_tpu_torch.fields.lattice import plan_lattice
    from nksr_tpu_torch.recon.reconstructor import _next_pow2
    from nksr_tpu_torch.utils.scenes import synthetic_scene

    cfg = PipelineConfig(conv_dtype="bfloat16")
    xyz, _ = synthetic_scene(1_000_000, half_extent=half_extent)
    grids, orders = HB.build_splat_grids_ex(xyz, 0.1, cfg.tree_depth)
    caps = tuple(max(_next_pow2(int(len(g.keys) * 1.05)), 512)
                 for g in grids)
    plan = plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1], 0.1,
                        cfg.tree_depth, cfg.adaptive_depth,
                        k=cfg.kernel_dim)
    return [list(d) for d in plan.spec.dims], plan.spec.k


def _ms(torch, fn, reps: int = 10):
    runs = []
    for _ in range(2):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return min(runs), runs


def _turn(root: str, path: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK

    with open(path) as f:
        plans = json.load(f)
    out = {"root": root}
    for name, (dims, k) in plans.items():
        dims = tuple(tuple(d) for d in dims)
        spec = LAT.LatticeSpec(dims=dims, k=k, depth=len(dims),
                               adaptive_depth=1, s_pt=8, p_rows=4, s_gr=8,
                               n_pts_cap=8)
        gen = torch.Generator(device="cuda").manual_seed(0)
        xs = [torch.randn((spec.n_cells(d), k), device="cuda", generator=gen)
              for d in range(spec.depth)]
        coef = sum(spec.n_cells(d) for d in range(spec.depth)) * k * 4
        rec = {"dims": dims, "cells": spec.n_cells(0), "lanes": spec.lanes}
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            got = LK.av0_cascade(spec, xs, dt)
            if not torch.equal(got, LK.av0_cascade_plain(spec, xs, dt)):
                raise AssertionError(f"{root}: av0_cascade {tag} differs from"
                                     f" plain at {name}")
            torch.cuda.empty_cache()
            rec[tag], rec[tag + "_runs"] = _ms(
                torch, lambda: LK.av0_cascade(spec, xs, dt))
            rec["ceiling_" + tag], rec["ceiling_" + tag + "_runs"] = _ms(
                torch, lambda: torch.empty_like(got).zero_())
            rec["bound_" + tag] = (coef + got.numel() * got.element_size()) \
                / HBM_B_PER_MS
            del got
            torch.cuda.empty_cache()
        out[name] = rec
    return out


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--turn":
        print(json.dumps(_turn(os.path.abspath(argv[1]), argv[2])),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_forward: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_forward: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        with open(path, "w") as f:
            json.dump({name: plan_dims(h) for name, h in PLANS.items()}, f)
        for root in argv or [HERE]:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--turn", root, path]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
