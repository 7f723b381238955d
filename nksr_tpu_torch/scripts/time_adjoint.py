"""Time the slot-row adjoint of the lattice matvec on the card against the
chain it replaces, at the solve's real slot cells: those of a splat lap
on the 40 m tile (1M points of ``utils.scenes.synthetic_scene``, the
``runs/scene_big`` checkpoint, as ``chip_smoke.py`` phase 3 runs it).

    python nksr_tpu_torch/scripts/time_adjoint.py [ROOT ...]

The lap runs once, in a process of its own with this checkout's
package (``time_rows.py``'s capture); its slot cells go to a temporary
file.  Each ROOT (default: this checkout) is a directory holding an
``nksr_tpu_torch`` package, and each runs in a process of its own, in
the order given, so ``old new new old`` times two versions in turns on
one card.  A turn builds that tree's kernels and, on seeded random f32
slot rows at those cells (zero at the pad slots, as in the solve),
times by CUDA events (the faster of two runs of 10 calls, after a
warm-up call)

  chain      the matvec's adjoint before the slot-row form: a zeroed
             (cells_0, lanes) f32 buffer, the point and gradient slot
             rows ``index_add_``-ed into it, the dense adjoint kernel
             reading it in bf16 (every tree);
  rows_bf16  ``av0_adjoint_rows`` in the solve's form, over the
             solve's tables (pad slots dropped), all its kernels (trees
             that have it);
  rows_f32   the same in the Jacobi diagonal's form (f32, no rounding);
  tables     ``adjoint_rows_tables``, built once a solve;

and, under torch.profiler, the device milliseconds a call of each kernel
that ``av0_adjoint_rows`` runs in the solve's form (``kernels_bf16``),

and checks the slot-row adjoint, in both forms, equal to the dense
kernel on the buffer CPU ``index_add_`` builds (bit for bit up to the
sign of a zero).  It prints one JSON line a turn.  Exits 2 without a
CUDA device.

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


def _ms(torch, fn, reps: int = 10) -> float:
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
    return min(runs)


def kernel_ms(torch, fn, reps: int = 10) -> dict:
    """Device milliseconds a call of ``fn`` by kernel name, from
    torch.profiler over ``reps`` calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:60]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0}


def _turn(root: str, path: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK

    rec = torch.load(path)
    spec = LAT.LatticeSpec(dims=rec["dims"], k=rec["k"],
                           depth=len(rec["dims"]), adaptive_depth=1,
                           s_pt=rec["s_pt"], p_rows=4, s_gr=8, n_pts_cap=8)
    cells, kept = rec["cells"].cuda(), rec["adj_cells"].cuda()
    s_pt, n0 = spec.s_pt, spec.n_cells(0)
    pt, gr = cells[:s_pt].long(), cells[s_pt:].long()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the solve's pad slots hold zero rows
    y = torch.randn((cells.numel(), spec.lanes), device="cuda",
                    generator=gen) * (kept >= 0)[:, None]
    bf = torch.bfloat16

    def chain():
        z = torch.zeros((n0, spec.lanes), device="cuda")
        z.index_add_(0, pt, y[:s_pt]).index_add_(0, gr, y[s_pt:])
        return LK.av0_adjoint_cascade(spec, z, bf)

    out = {"root": root, "rows": cells.numel(), "ms": {"chain": _ms(
        torch, chain)}}
    if hasattr(LK, "av0_adjoint_rows"):
        tab = LK.adjoint_rows_tables(spec, kept)
        z0 = torch.zeros((n0, spec.lanes))
        z0.index_add_(0, cells.cpu().long(), y.cpu())
        z0 = z0.cuda()
        for dt in (bf, torch.float32):
            got = LK.av0_adjoint_rows(spec, tab, y, dt)
            ref = LK.av0_adjoint_cascade(spec, z0, dt)
            if not all(torch.equal(g + 0.0, r + 0.0)
                       for g, r in zip(got, ref)):
                raise AssertionError(f"{root}: av0_adjoint_rows {dt} differs "
                                     "from the dense kernel")
        del z0, got, ref
        torch.cuda.empty_cache()
        out["ms"].update(
            rows_bf16=_ms(torch, lambda: LK.av0_adjoint_rows(spec, tab, y,
                                                             bf), 20),
            rows_f32=_ms(torch, lambda: LK.av0_adjoint_rows(
                spec, tab, y, torch.float32), 20),
            tables=_ms(torch, lambda: LK.adjoint_rows_tables(spec, kept),
                       3))
        out["kernels_bf16"] = kernel_ms(
            torch, lambda: LK.av0_adjoint_rows(spec, tab, y, bf))
        # the tables' distinct cells: ``cells`` since the brick-major
        # tables, ``order.targets`` in the segment-sum form before them
        out["distinct_cells"] = (tab.cells if hasattr(tab, "cells")
                                 else tab.order.targets).numel()
        out["bricks"] = [tab.bricks.numel(), tab.brick_occ.numel()]
    return out


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--turn":
        print(json.dumps(_turn(os.path.abspath(argv[1]), argv[2])),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_adjoint: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_adjoint: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rows_script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "time_rows.py")
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "adjoint_input.pt")
        if subprocess.run([sys.executable, rows_script, "--capture",
                           path]).returncode:
            return 1
        for root in argv or [HERE]:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--turn", root, path]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
