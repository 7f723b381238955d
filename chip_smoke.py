#!/usr/bin/env python3
"""Smoke run of nksr_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the AV0 cascade kernels from nksr_tpu_torch/csrc with nvcc
     for sm_90a;
  2. hold each kernel against its plain PyTorch version on the card, at
     a small test spec and at the main path's plan spec, and time both;
  3. the main path at the bench's size: the scene_big checkpoint,
     bench.synthetic_scene(1_000_000), reconstruct(structure="splat",
     voxel_size=0.1, solver_tol=1e-4, solver_max_iters=16) and
     extract_dual_mesh(mise_iter=1); one warm-up lap and two timed laps,
     the kernels' launch counts, and the terrain vertex error against
     the analytic height field.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing any
result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 1_000_000
KW = dict(detail_level=None, voxel_size=0.1, solver_tol=1e-4,
          solver_max_iters=16)
# 1.5x the JAX package's interior terrain vertex error mean (QUALITY.md,
# terrain/splat row: 0.0050)
ERR_LIMIT = 0.0075
SMALL_DIMS = ((24, 24, 16), (16, 16, 8), (8, 8, 8))


def _height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events over ``reps`` calls,
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernels(LK, spec, gen, timed: bool):
    """Kernel vs plain version on the same random inputs.  Forward: exact
    in f32 and bf16 (pure selection).  Adjoint: rtol 1e-5, atol 1e-5 of
    the largest output (f32 sums in another order), in f32 and with the
    bf16 read the solve uses.  Pair <fwd(x), z> = <x, adj(z)> to 1e-5
    relative."""
    dev = "cuda"
    xs = [torch.randn((spec.n_cells(d), spec.k), device=dev, generator=gen)
          for d in range(spec.depth)]
    z = torch.randn((spec.n_cells(0), spec.lanes), device=dev, generator=gen)
    out = {"fwd_err": 0.0, "adj_err": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        got = LK.av0_cascade(spec, xs, dt)
        ref = LK.av0_cascade_plain(spec, xs, dt)
        if not torch.equal(got, ref):
            raise AssertionError(f"av0_cascade {dt} differs from plain: max "
                                 f"{(got.float() - ref.float()).abs().max()}")
        del got, ref
        zt = z.to(dt)
        got = LK.av0_adjoint_cascade(spec, zt, dt)
        ref = LK.av0_adjoint_cascade_plain(spec, zt, dt)
        for g, r in zip(got, ref):
            err = float((g - r).abs().max())
            torch.testing.assert_close(g, r, rtol=1e-5,
                                       atol=1e-5 * float(r.abs().max()))
            out["adj_err"] = max(out["adj_err"], err)
        del got, ref, zt
    fwd = LK.av0_cascade(spec, xs, torch.float32)
    lhs = float((fwd.double() * z.double()).sum())
    del fwd
    adj = LK.av0_adjoint_cascade(spec, z, torch.float32)
    rhs = float(sum((a.double() * x.double()).sum() for a, x in zip(adj, xs)))
    if abs(lhs - rhs) > 1e-5 * abs(lhs):
        raise AssertionError(f"adjoint pair: {lhs} vs {rhs}")
    out["pair_rel"] = abs(lhs - rhs) / abs(lhs)
    if timed:
        zb = z.to(torch.bfloat16)
        del z
        bf = torch.bfloat16
        # plain, kernel, kernel, plain: each version timed in two turns
        p1 = cuda_ms(lambda: LK.av0_cascade_plain(spec, xs, bf), 2)
        k1 = cuda_ms(lambda: LK.av0_cascade(spec, xs, bf), 10)
        k2 = cuda_ms(lambda: LK.av0_cascade(spec, xs, bf), 10)
        p2 = cuda_ms(lambda: LK.av0_cascade_plain(spec, xs, bf), 2)
        out["fwd_ms"], out["fwd_plain_ms"] = min(k1, k2), min(p1, p2)
        p1 = cuda_ms(lambda: LK.av0_adjoint_cascade_plain(spec, zb, bf), 2)
        k1 = cuda_ms(lambda: LK.av0_adjoint_cascade(spec, zb, bf), 10)
        k2 = cuda_ms(lambda: LK.av0_adjoint_cascade(spec, zb, bf), 10)
        p2 = cuda_ms(lambda: LK.av0_adjoint_cascade_plain(spec, zb, bf), 2)
        out["adj_ms"], out["adj_plain_ms"] = min(k1, k2), min(p1, p2)
    return out


def main_path_lap(recon, xyz, nrm):
    """One reconstruct + extract_dual_mesh; (t_recon, t_mesh, field, mesh)."""
    t0 = time.perf_counter()
    field = recon.reconstruct(xyz, nrm, structure="splat", **KW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mesh = field.extract_dual_mesh(mise_iter=1)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, field, mesh


def terrain_error(mesh):
    """|v_z - h(v_x, v_y)| over used vertices with |x|, |y| < 19
    (scripts/make_scene_quality.py)."""
    v = mesh.v[np.unique(mesh.f)]
    v = v[(np.abs(v[:, 0]) < 19.0) & (np.abs(v[:, 1]) < 19.0)]
    return np.abs(v[:, 2] - _height(v[:, 0], v[:, 1])), len(v)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bench import synthetic_scene
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK
    from nksr_tpu_torch.utils.checkpoint import load_tree

    # ---- phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[phase 0] {kind}  torch {torch.__version__}  CUDA "
          f"{torch.version.cuda}  devices {torch.cuda.device_count()}",
          flush=True)

    # ---- phase 1: build
    lib, build_s, ptxas = LK.build_kernels()
    print(f"[phase 1] nvcc sm_90a build of {os.path.relpath(LK.SOURCE, REPO)}"
          f" -> {os.path.relpath(lib, REPO)} in {build_s:.2f} s", flush=True)
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    # ---- phase 2: kernels vs plain versions (test spec, then the plan
    # spec of the main path, taken from a warm-up lap of phase 3)
    small = LAT.LatticeSpec(dims=SMALL_DIMS, k=4, depth=3, adaptive_depth=1,
                            s_pt=64, p_rows=4, s_gr=32, n_pts_cap=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res_small = compare_kernels(LK, small, gen, timed=False)
    print(f"[phase 2] test spec {SMALL_DIMS}: forward exact (f32, bf16), "
          f"adjoint max err {res_small['adj_err']:.3e}, pair rel "
          f"{res_small['pair_rel']:.2e}", flush=True)

    xyz, nrm = synthetic_scene(N_POINTS)
    params = load_tree(os.path.join(REPO, "runs", "scene_big", "best.ckpt"))
    recon = Reconstructor(config=PipelineConfig(conv_dtype="bfloat16"),
                          params=params)
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm)   # warm-up
    print(f"[phase 3] warm-up lap: reconstruct_s {tr:.3f} extract_mesh_s "
          f"{tm:.3f}", flush=True)
    spec = field.lattice_ctx.spec
    del field, mesh
    torch.cuda.empty_cache()
    res = compare_kernels(LK, spec, gen, timed=True)
    print(f"[phase 2] main-path spec {spec.dims} lanes {spec.lanes}: "
          f"forward exact (f32, bf16), adjoint max err {res['adj_err']:.3e},"
          f" pair rel {res['pair_rel']:.2e}", flush=True)
    print(f"[phase 2] bf16 forward {res['fwd_ms']:.3f} ms (plain "
          f"{res['fwd_plain_ms']:.3f}); bf16-read adjoint {res['adj_ms']:.3f}"
          f" ms (plain {res['adj_plain_ms']:.3f})", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at the bench's size, two timed laps
    laps = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        LK.av0_cascade.launches = 0
        LK.av0_adjoint_cascade.launches = 0
        tr, tm, field, mesh = main_path_lap(recon, xyz, nrm)
        launches = (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches)
        laps.append((tr, tm))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[phase 3] lap: reconstruct_s {tr:.3f} extract_mesh_s "
              f"{tm:.3f} phases "
              + json.dumps({k: round(v, 4)
                            for k, v in field.phase_times.items()}),
              flush=True)
    tr, tm = min(t[0] for t in laps), min(t[1] for t in laps)
    err, n_inner = terrain_error(mesh)
    print(f"[phase 3] {N_POINTS} points: reconstruct_s {tr:.3f} "
          f"extract_mesh_s {tm:.3f} pts/s {N_POINTS / (tr + tm):.1f} "
          f"mesh verts {len(mesh.v)} faces {len(mesh.f)}", flush=True)
    print(f"[phase 3] {field.solver_stats}  launches fwd {launches[0]} adj "
          f"{launches[1]}  peak memory {peak:.2f} GiB", flush=True)
    print(f"[phase 3] terrain vertex error on {n_inner} interior vertices: "
          f"mean {err.mean():.5f} q90 {np.quantile(err, 0.9):.5f} max "
          f"{err.max():.5f} (limit {ERR_LIMIT})", flush=True)
    if min(launches) <= 0:
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{launches}")
    if not len(mesh.f) or not np.isfinite(mesh.v).all():
        raise AssertionError("empty or non-finite mesh")
    if not err.mean() <= ERR_LIMIT:
        raise AssertionError(f"terrain error mean {err.mean()} > {ERR_LIMIT}")

    kernels = [
        {"name": "av0_cascade", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:189",
         "launches": launches[0], "max_abs_err": res["fwd_err"],
         "ms": res["fwd_ms"], "plain_ms": res["fwd_plain_ms"]},
        {"name": "av0_adjoint_cascade", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:279",
         "launches": launches[1], "max_abs_err": res["adj_err"],
         "ms": res["adj_ms"], "plain_ms": res["adj_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
