"""Time the AV0 adjoint cascade wrapper on the card in the three input
forms the port calls it with, at the splat lap's plan at the 40 m tile.

    python nksr_tpu_torch/scripts/time_adjoint.py [ROOT ...]

Each ROOT (default: this checkout) is a directory holding an
``nksr_tpu_torch`` package.  Each runs in a process of its own, in the
order given, so ``old new new old`` times two versions in turns on one
card.  A turn builds that tree's kernels, checks the wrapper against its
plain version in each form (rtol 1e-5, atol 1e-5 of the largest output:
f32 sums in another order) and prints one JSON line: milliseconds per
call from CUDA events (the faster of two runs of 10 calls, after a
warm-up call) for

  f32_bf16   an f32 buffer read in bf16: the lattice solve's matvec and
             right-hand side (``fields/lattice.py:541``);
  bf16_bf16  a bf16 buffer read in bf16 (the kernel table's older row);
  f32_f32    an f32 buffer read in f32: the Jacobi diagonal
             (``fields/lattice.py:558``).

The wrapper is timed whole, so a cast it makes before its launch is part
of the time.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# chip_smoke.py phase 3 prints this plan: 1M points on the 40 m tile,
# voxel 0.1, depth 4, kernel dim 4 (8,629,248 depth-0 cells x 128 lanes)
DIMS_40M = ((424, 424, 48), (216, 216, 32), (112, 112, 16), (56, 56, 16))
FORMS = (("f32_bf16", "float32", "bfloat16"),
         ("bf16_bf16", "bfloat16", "bfloat16"),
         ("f32_f32", "float32", "float32"))


def _turn(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK

    spec = LAT.LatticeSpec(dims=DIMS_40M, k=4, depth=len(DIMS_40M),
                           adaptive_depth=1, s_pt=8, p_rows=4, s_gr=8,
                           n_pts_cap=8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    z32 = torch.randn((spec.n_cells(0), spec.lanes), device="cuda",
                      generator=gen)
    out = {"root": root, "ms": {}, "max_abs_err": 0.0}
    for name, zdt, cdt in FORMS:
        z = z32 if zdt == "float32" else z32.to(torch.bfloat16)
        cdt = getattr(torch, cdt)
        got = LK.av0_adjoint_cascade(spec, z, cdt)
        ref = LK.av0_adjoint_cascade_plain(spec, z, cdt)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-5,
                                       atol=1e-5 * float(r.abs().max()))
            out["max_abs_err"] = max(out["max_abs_err"],
                                     float((g - r).abs().max()))
        del got, ref
        runs = []
        for _ in range(2):
            LK.av0_adjoint_cascade(spec, z, cdt)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                LK.av0_adjoint_cascade(spec, z, cdt)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        out["ms"][name] = min(runs)
        del z
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--turn":
        print(json.dumps(_turn(os.path.abspath(argv[1]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_adjoint: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("time_adjoint: nvidia-smi failed", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for root in argv or [here]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
