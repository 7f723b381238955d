#!/usr/bin/env python3
"""Smoke run of nksr_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every kernel of nksr_tpu_torch/csrc with nvcc for sm_90a (one
     nvcc per source, all at once);
  2. hold each kernel against its plain PyTorch version on the card, at
     a small size and at the size its route gives it, and time both;
  3. the splat path on the dense lattice at the bench's size: the
     scene_big checkpoint, bench.synthetic_scene(1_000_000),
     reconstruct(structure="splat", voxel_size=0.1, solver_tol=1e-4,
     solver_max_iters=16) and extract_dual_mesh(mise_iter=1); one
     warm-up lap and two timed laps, the kernels' launch counts, and the
     terrain vertex error against the analytic height field;
  4. route B, the sparse fallback: the same call on a 100 m x 100 m tile
     of 1M points, whose lattice plan is over budget (gather-conv UNet,
     support-row solve with the window kernel, host dual MC);
  5. route A: a 60 m x 60 m tile of 1M points, whose feature lattices are
     over the dense UNet's budget (gather-conv UNet, lattice solve with
     the cascade kernels, host dual MC over the lattice evaluator).
Each path is driven with every launch count set to 0 just before it and
read just after.

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
# 1.5x the JAX package's sparse-route error mean at the 100 m tile's
# density (0.00562, 160k points on 40 m x 40 m, measured on the CPU)
ROUTE_ERR_LIMIT = 0.0085
SMALL_DIMS = ((24, 24, 16), (16, 16, 8), (8, 8, 8))
# H100 SXM data-sheet peaks: HBM bytes and f32 operations per millisecond
HBM_B_PER_MS = 3.35e12 / 1e3
F32_OP_PER_MS = 67e12 / 1e3


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


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work: bytes over HBM rate or f32 operations
    over the f32 peak, whichever is larger; and which one bounds it."""
    tb, to = n_bytes / HBM_B_PER_MS, n_ops / F32_OP_PER_MS
    return (tb, "bytes") if tb >= to else (to, "operations")


def av0_bounds(spec):
    """Bytes and operations of the bf16 forward and the bf16-read adjoint
    at ``spec``: every coefficient row read (written) once in f32, every
    cell-0 lane written (read) once in bf16; the adjoint adds each lane
    into its coefficient once."""
    coef = sum(spec.n_cells(d) for d in range(spec.depth)) * spec.k * 4
    lanes = spec.n_cells(0) * spec.lanes
    return (bound_ms(coef + 2 * lanes, 0), bound_ms(coef + 2 * lanes, lanes))


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


def compare_window(WB, q: int, gen, timed: bool):
    """Window kernel vs plain version on local offsets in [-1.25, 1.25]
    (the support's [-1, 1) plus the clamped margin): rtol 1e-5 / atol
    1e-6, the bound of the JAX package's own window test (FMA contraction
    may move an ulp)."""
    x = torch.rand((q, 8, 3), device="cuda", generator=gen) * 2.5 - 1.25
    w, dw = WB.window_and_grad_fused(x)
    rw, rdw = WB.window_and_grad_plain(x)
    torch.testing.assert_close(w, rw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-6)
    out = {"err": max(float((w - rw).abs().max()),
                      float((dw - rdw).abs().max()))}
    del w, dw, rw, rdw
    if timed:
        p1 = cuda_ms(lambda: WB.window_and_grad_plain(x), 10)
        k1 = cuda_ms(lambda: WB.window_and_grad_fused(x), 50)
        k2 = cuda_ms(lambda: WB.window_and_grad_fused(x), 50)
        p2 = cuda_ms(lambda: WB.window_and_grad_plain(x), 10)
        out["ms"], out["plain_ms"] = min(k1, k2), min(p1, p2)
        # 96 B read, 128 B written and 26 f32 operations a (query, corner)
        out["bound"] = bound_ms(q * 224, q * 8 * 26)
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


def terrain_error(mesh, inner: float = 19.0):
    """|v_z - h(v_x, v_y)| over used vertices with |x|, |y| < ``inner``
    (scripts/make_scene_quality.py)."""
    v = mesh.v[np.unique(mesh.f)]
    v = v[(np.abs(v[:, 0]) < inner) & (np.abs(v[:, 1]) < inner)]
    return np.abs(v[:, 2] - _height(v[:, 0], v[:, 1])), len(v)


def reset_counts(counters):
    for fn in counters:
        fn.launches = 0


def route_lap(recon, synthetic_scene, counters, half_extent: float):
    """One lap of a sparse route on 1M points of a terrain tile of side
    2 * half_extent.  Returns (field, mesh, launches, lap record)."""
    xyz, nrm = synthetic_scene(N_POINTS, half_extent=half_extent)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm)
    launches = [fn.launches for fn in counters]
    err, n_inner = terrain_error(mesh, half_extent - 1.0)
    lap = {"reconstruct_s": tr, "extract_mesh_s": tm,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "verts": len(mesh.v), "faces": len(mesh.f),
           "err_mean": float(err.mean()),
           "err_q90": float(np.quantile(err, 0.9)),
           "err_max": float(err.max()), "n_inner": n_inner}
    return field, mesh, launches, lap


def print_route(tag, recon, field, launches, lap):
    solve = "lattice" if field.lattice_ctx is not None else "support-row"
    mesher = "host" if "host dual mc" in field.phase_times else "dense"
    print(f"[{tag}] route: unet {recon._last_unet_engine}, solve {solve}, "
          f"mesher {mesher}", flush=True)
    print(f"[{tag}] reconstruct_s {lap['reconstruct_s']:.3f} extract_mesh_s "
          f"{lap['extract_mesh_s']:.3f} phases "
          + json.dumps({k: round(v, 4) for k, v in field.phase_times.items()}),
          flush=True)
    print(f"[{tag}] {field.solver_stats}  launches fwd {launches[0]} adj "
          f"{launches[1]} window {launches[2]}  peak memory "
          f"{lap['peak_gib']:.2f} GiB  mesh verts {lap['verts']} faces "
          f"{lap['faces']}", flush=True)
    print(f"[{tag}] terrain vertex error on {lap['n_inner']} interior "
          f"vertices: mean {lap['err_mean']:.5f} q90 {lap['err_q90']:.5f} "
          f"max {lap['err_max']:.5f} (limit {ROUTE_ERR_LIMIT})", flush=True)
    if not lap["faces"] or not lap["err_mean"] <= ROUTE_ERR_LIMIT:
        raise AssertionError(f"[{tag}] empty mesh or terrain error mean "
                             f"{lap['err_mean']} > {ROUTE_ERR_LIMIT}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bench import synthetic_scene
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch import cuda_build as CB
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK
    from nksr_tpu_torch.fields import support as S
    from nksr_tpu_torch.ops import window_basis as WB
    from nksr_tpu_torch.utils.checkpoint import load_tree
    counters = (LK.av0_cascade, LK.av0_adjoint_cascade,
                WB.window_and_grad_fused)

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
    for name, (lib, build_s, ptxas) in CB.build_kernels().items():
        print(f"[phase 1] nvcc sm_90a build of csrc/{name}.cu -> "
              f"{os.path.relpath(lib, REPO)} in {build_s:.2f} s", flush=True)
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
    win_small = compare_window(WB, 1000, gen, timed=False)
    print(f"[phase 2] window kernel at Q 1000: max err "
          f"{win_small['err']:.3e}", flush=True)

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
        reset_counts(counters)
        tr, tm, field, mesh = main_path_lap(recon, xyz, nrm)
        launches = [fn.launches for fn in counters]
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
    if min(launches[:2]) <= 0:
        raise AssertionError(f"a cascade kernel did not run on the splat "
                             f"path: {launches}")
    if not len(mesh.f) or not np.isfinite(mesh.v).all():
        raise AssertionError("empty or non-finite mesh")
    if not err.mean() <= ERR_LIMIT:
        raise AssertionError(f"terrain error mean {err.mean()} > {ERR_LIMIT}")
    splat_launches = launches
    del field, mesh
    torch.cuda.empty_cache()

    # ---- phase 4: route B (plan over the lattice budget)
    field, mesh, b_launches, lap = route_lap(recon, synthetic_scene, counters,
                                             50.0)
    print_route("phase 4", recon, field, b_launches, lap)
    if not (recon._last_unet_engine == "sparse" and field.lattice_ctx is None
            and "host dual mc" in field.phase_times):
        raise AssertionError("[phase 4] the 100 m tile did not take route B")
    if b_launches[2] <= 0:
        raise AssertionError(f"[phase 4] the window kernel did not run on "
                             f"route B: {b_launches}")
    cfg = recon.config
    q_b = min(S._MLP_CHUNK, sum(len(g.keys) for g in
                                field.host_grids[:cfg.adaptive_depth]))
    del field, mesh
    torch.cuda.empty_cache()
    win = compare_window(WB, q_b, gen, timed=True)
    print(f"[phase 2] window kernel at route B's Q {q_b}: max err "
          f"{win['err']:.3e}; {win['ms']:.4f} ms (plain {win['plain_ms']:.4f}"
          f", bound {win['bound'][0]:.4f} by {win['bound'][1]})", flush=True)

    # ---- phase 5: route A (feature lattices over the dense UNet budget)
    field, mesh, a_launches, lap = route_lap(recon, synthetic_scene, counters,
                                             30.0)
    print_route("phase 5", recon, field, a_launches, lap)
    if not (recon._last_unet_engine == "sparse"
            and field.lattice_ctx is not None
            and "host dual mc" in field.phase_times):
        raise AssertionError("[phase 5] the 60 m tile did not take route A")
    if min(a_launches[:2]) <= 0:
        raise AssertionError(f"[phase 5] a cascade kernel did not run on "
                             f"route A: {a_launches}")
    del field, mesh

    (fb, fby), (ab, aby) = av0_bounds(spec)
    kernels = [
        {"name": "av0_cascade", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:189",
         "launches": splat_launches[0], "max_abs_err": res["fwd_err"],
         "ms": res["fwd_ms"], "plain_ms": res["fwd_plain_ms"],
         "bound_ms": fb, "bound_by": fby, "library_ms": None},
        {"name": "av0_adjoint_cascade", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:279",
         "launches": splat_launches[1], "max_abs_err": res["adj_err"],
         "ms": res["adj_ms"], "plain_ms": res["adj_plain_ms"],
         "bound_ms": ab, "bound_by": aby, "library_ms": None},
        {"name": "window_and_grad_fused", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/window_basis.cu",
         "replaces": "nksr_tpu/ops/pallas/window_basis.py:53",
         "launches": b_launches[2], "max_abs_err": win["err"],
         "ms": win["ms"], "plain_ms": win["plain_ms"],
         "bound_ms": win["bound"][0], "bound_by": win["bound"][1],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
