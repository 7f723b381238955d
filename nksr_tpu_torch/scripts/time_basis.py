"""The fused basis kernels (``fields/basis_kernels.py``) against their
plain versions: seeded small cases, the comparison and timing of each
kernel, their bounds, and the capture of the main path's inputs.

    python -m nksr_tpu_torch.scripts.time_basis

runs one splat lap on the 40 m tile (1M points of
``utils.scenes.synthetic_scene``, the ``runs/scene_big`` checkpoint, as
``chip_smoke.py`` phase 3 runs it), captures the solve's ``basis_rows``
call and the dual mesher's ``basis_field`` calls (its corner values and
its Newton step), holds each kernel against its plain version there and
prints one JSON line a kernel: kernel and plain milliseconds from CUDA
events, the bound and the largest difference.  Exits 2 without a CUDA
device.  ``chip_smoke.py`` phase 2 calls the same functions.
"""

from __future__ import annotations

import json
import os
import sys
import types
from typing import Dict, Optional

import numpy as np
import torch

from ..fields import basis_kernels as BK
from ..utils.profiling import bound_ms

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# kernel against plain: the MLP's sums run in another order (the
# kernel's FMAs against F.linear's), a few ulps of its f32 activations;
# every other operation is rounded alike.  Rows and field values are held
# within this share of the largest |output| of the call.
ROWS_TOL = 1e-5
FIELD_TOL = 1e-5
# f32 operations of the window and its gradient, a (query, corner)
WINDOW_OPS = 26


def seeded_interp(depth: int, k: int, cb: int, hidden: int, layers: int,
                  rng: np.random.Generator):
    """``Interpolators`` of the given widths with weights from ``rng``
    (N(0, 1/fan_in), biases N(0, 0.1^2)), frozen."""
    from ..models.network import Interpolators
    cfg = types.SimpleNamespace(tree_depth=depth, basis_dim=cb,
                                interp_hidden=hidden, interp_layers=layers,
                                kernel_dim=k)
    interp = Interpolators(cfg)
    for d in range(depth):
        for layer in interp.level(d).layers():
            fan_in = layer.in_features
            layer.weight.data = torch.as_tensor(rng.normal(
                0, fan_in ** -0.5, size=tuple(layer.weight.shape)),
                dtype=torch.float32)
            layer.bias.data = torch.as_tensor(rng.normal(
                0, 0.1, size=tuple(layer.bias.shape)), dtype=torch.float32)
    return interp.requires_grad_(False)


def basis_case(depth: int = 3, k: int = 4, cb: int = 8, hidden: int = 8,
               layers: int = 2, seed: int = 0, n_points: int = 1500,
               compute_dtype=torch.float32, device="cpu",
               voxel_size: float = 0.1, approx_grad: bool = False
               ) -> types.SimpleNamespace:
    """A small lattice plan on a terrain patch and seeded weights:
    ``rows`` the positional arguments of ``basis_rows``, ``field(x,
    grad)`` those of ``basis_field``, ``queries`` (n, 3) f32 points (the
    cloud jittered, points around the lattice and a few outside it)."""
    from ..core import host_build as HB
    from ..fields import lattice as LAT
    from ..fields import lattice_eval as LE
    from ..utils.scenes import synthetic_scene
    rng = np.random.default_rng(seed)
    xyz, _ = synthetic_scene(n_points, seed=seed, half_extent=1.5)
    grids, orders = HB.build_splat_grids_ex(xyz, voxel_size, depth)
    caps = tuple(max(64, 1 << int(np.ceil(np.log2(len(g.keys) * 1.05))))
                 for g in grids)
    plan = LAT.plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            voxel_size, depth, min(2, depth), k=k)
    spec = plan.spec
    interp = seeded_interp(depth, k, cb, hidden, layers, rng).to(device)
    i64 = torch.int64

    def up(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    basis = [up(rng.normal(0, 0.5, size=(c, cb)), torch.float32)
             for c in caps]
    vox_cell = tuple(up(v, i64) for v in plan.vox_cell)
    vox_active = tuple(up(v) for v in plan.vox_active)
    fdp, adp = LAT.scatter_tables(spec, basis, vox_cell, vox_active)
    rows = (spec, interp, fdp, adp, up(xyz[plan.pt_perm]),
            up(plan.pt_cell0, i64), up(plan.pt_dest, i64),
            up(plan.slot_cell_pt, i64), up(plan.gr_coords, i64),
            up(plan.gr_depth, i64), up(plan.gr_active),
            up(plan.slot_cell_gr, i64), voxel_size, approx_grad)
    dense_xs = [up(rng.normal(0, 0.3, size=(spec.n_cells(d), k)),
                   torch.float32) for d in range(depth)]
    tab = LE.prepare_tables(spec, dense_xs, basis, vox_cell, vox_active,
                            compute_dtype)
    lo, hi = xyz.min(0) - 0.5, xyz.max(0) + 0.5
    queries = np.concatenate([
        xyz + rng.normal(0, 0.05, size=xyz.shape),
        rng.uniform(lo, hi, size=(400, 3)),
        rng.uniform(lo - 3, hi + 3, size=(40, 3))]).astype(np.float32)

    def field(x, grad):
        return (spec, interp, tab, plan.origins, x, voxel_size, grad,
                approx_grad, compute_dtype)

    return types.SimpleNamespace(spec=spec, plan=plan, interp=interp,
                                 rows=rows, field=field,
                                 queries=up(queries), tab=tab)


def capture(names, fn):
    """Run ``fn`` with ``BK.<name>`` for each name recording its calls'
    positional arguments (references, not copies: the lattice path does
    not write its inputs).  Returns (fn's result, {name: [args, ...]}).
    Each recorder puts the wrapper back on its module-level name for the
    call (a wrapper counts its launches there) and itself after it."""
    real = {n: getattr(BK, n) for n in names}
    rec: Dict[str, list] = {n: [] for n in names}

    def recorder(name):
        def call(*args):
            rec[name].append(args)
            setattr(BK, name, real[name])
            try:
                return real[name](*args)
            finally:
                setattr(BK, name, call)
        return call

    for n in names:
        setattr(BK, n, recorder(n))
    try:
        res = fn()
    finally:
        for n, f in real.items():
            setattr(BK, n, f)
    return res, rec


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds a call from CUDA events over ``reps`` calls,
    after one warm-up call when ``warm``."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn) -> Dict[str, float]:
    """Device milliseconds of each kernel ``fn`` launches, by name, from
    one warm call under torch.profiler (empty where the profiler sees no
    device time)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        if e.self_device_time_total > 0:
            out[e.key[:60]] = e.self_device_time_total / 1e3
    return out


def _rows_touched(spec, cells: torch.Tensor, d: int) -> int:
    """Distinct padded-table rows the corners of ``cells`` read."""
    strides = torch.tensor(spec.corner_strides(d), device=cells.device)
    return int(torch.unique((cells.reshape(-1, 1) + strides).reshape(-1))
               .numel())


def rows_bound(args):
    """Bounds of the two row launches at ``args`` (``basis_rows``'s):
    ((ms, by) of the points, (ms, by) of the gradients).  Operations: a
    (query, corner, depth) MLP, window and row products; bytes: every
    input read once (the feature and activity rows the corners touch),
    every row written once."""
    (spec, interp, fdp, adp, xyz, _, _, slots_pt, coords, _, _, slots_gr,
     _, approx) = args
    packed = BK.pack_mlps(interp, spec.depth)
    n, s_gr, k, cb = xyz.shape[0], spec.s_gr, spec.k, packed.dims[0] - 3
    wbytes = packed.buf.numel() * 4

    def touched(slots, m):
        return sum(_rows_touched(spec, slots[d, :m], d)
                   for d in range(spec.depth)) * (cb + 1) * 4

    pt_ops = n * 8 * spec.depth * (BK.mlp_flops(packed, False) + WINDOW_OPS
                                   + 1 + k + 12)
    pt_bytes = n * (12 + 24 + 8) + spec.depth * spec.s_pt * 8 + \
        touched(slots_pt, spec.s_pt) + wbytes + \
        spec.s_pt * spec.p_rows * spec.lanes * 4
    gr_ops = s_gr * 8 * spec.depth * (
        BK.mlp_flops(packed, not approx) + WINDOW_OPS + 1 + 3 + 12
        + 3 * k * 5)
    gr_bytes = s_gr * (24 + 8 + 1) + spec.depth * s_gr * 8 + \
        touched(slots_gr, s_gr) + wbytes + s_gr * 3 * spec.lanes * 4
    return bound_ms(pt_bytes, pt_ops), bound_ms(gr_bytes, gr_ops)


def field_bound(args, packed=None):
    """Bound of one ``basis_field`` launch at ``args``: operations of a
    (query, corner, depth) MLP (with the tangents where the gradient
    asks for them), window and sums; bytes: the queries, the AV0 rows and
    feature rows their cells read, the outputs."""
    (spec, interp, tab, origins, x, vs, grad, approx, cdt) = args[:9]
    packed = packed or BK.pack_mlps(interp, spec.depth)
    n, k, cb = x.shape[0], spec.k, packed.dims[0] - 3
    esz = torch.finfo(cdt).bits // 8
    c0 = BK.query_cells0(x, vs)
    org = torch.as_tensor(np.asarray(origins, np.int64), device=x.device)
    feat = 0
    cells0 = None
    for d in range(spec.depth):
        _, Y, Z = spec.dims[d]
        loc = (c0 >> d) - org[d]
        dims = torch.tensor(spec.dims[d], device=x.device)
        ok = ((loc >= 0) & (loc < dims)).all(-1)
        cells = torch.where(ok, (loc[:, 0] * Y + loc[:, 1]) * Z + loc[:, 2],
                            0)
        if d == 0:
            cells0 = cells
        feat += _rows_touched(spec, cells, d) * cb * esz
    av_rows = int(torch.unique(cells0).numel())
    tan = grad and not approx
    per = BK.mlp_flops(packed, tan) + WINDOW_OPS + 3 * k + \
        (3 * k * (5 if tan else 3) + 6 if grad else 0) + 12
    ops = n * 8 * spec.depth * per
    n_bytes = n * 12 + av_rows * (spec.lanes * esz + 1) + feat + \
        packed.buf.numel() * 4 + n * (5 + (12 if grad else 0))
    return bound_ms(n_bytes, ops)


def _err(got, ref) -> float:
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(got, ref))


def _scale(ref) -> float:
    return max(float(b.float().abs().max()) if b.numel() else 0.0
               for b in ref)


def compare_rows(args, timed: bool, reps: int = 5) -> dict:
    """``basis_rows`` on CUDA tensors against ``basis_rows_plain`` on the
    same tensors: b_pt, m_pt and b_gr within ROWS_TOL of the largest
    |row| (m_pt exact), and two calls bit-equal.  Timed: both in turns
    (plain, kernel, kernel, plain) by CUDA events, and the bound."""
    got = BK.basis_rows(*args)
    again = BK.basis_rows(*args)
    ref = BK.basis_rows_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("basis_rows: two calls differ")
    if not torch.equal(got[1], ref[1]):
        raise AssertionError("basis_rows: the row mask differs from plain")
    err = {"b_pt": _err(got[:1], ref[:1]), "b_gr": _err(got[2:], ref[2:])}
    scale = {"b_pt": _scale(ref[:1]), "b_gr": _scale(ref[2:])}
    for key in err:
        if not err[key] <= ROWS_TOL * max(scale[key], 1e-30):
            raise AssertionError(
                f"basis_rows {key}: max err {err[key]:.3e} over "
                f"{ROWS_TOL} x {scale[key]:.3e}")
    out = {"err": max(err.values()), "err_pt": err["b_pt"],
           "err_gr": err["b_gr"], "scale": scale}
    del got, again, ref
    if timed:
        p1 = cuda_ms(lambda: BK.basis_rows_plain(*args), 1, warm=False)
        k1 = cuda_ms(lambda: BK.basis_rows(*args), reps)
        k2 = cuda_ms(lambda: BK.basis_rows(*args), reps)
        p2 = cuda_ms(lambda: BK.basis_rows_plain(*args), 1, warm=False)
        (pb, pby), (gb, gby) = rows_bound(args)
        out.update(ms=min(k1, k2), ms_turns=(k1, k2), plain_ms=min(p1, p2),
                   bound=(pb + gb, pby if pb >= gb else gby),
                   bound_points=(pb, pby), bound_grads=(gb, gby),
                   kernel_ms=kernel_device_ms(lambda: BK.basis_rows(*args)))
    return out


def plain_field(args, wave: int = 1 << 17):
    """``basis_field_plain`` over ``args``' queries in waves of ``wave``
    (the plain version holds some 6 KB of temporaries a query), its
    outputs concatenated."""
    x = args[4]
    parts = [BK.basis_field_plain(*args[:4], x[s:s + wave], *args[5:9])
             for s in range(0, max(x.shape[0], 1), wave)]
    return tuple(torch.cat(p) for p in zip(*parts))


def compare_field(args, timed: bool, reps: int = 5, packed=None) -> dict:
    """``basis_field`` on CUDA tensors against ``basis_field_plain`` on
    the same tensors: values (and gradients) within FIELD_TOL of the
    largest |output|, the mask equal, and two calls bit-equal.  Timed as
    ``compare_rows``."""
    args = tuple(args[:9])
    packed = packed or BK.pack_mlps(args[1], args[0].depth)
    got = BK.basis_field(*args, packed)
    again = BK.basis_field(*args, packed)
    ref = plain_field(args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("basis_field: two calls differ")
    if not torch.equal(got[1], ref[1]):
        raise AssertionError("basis_field: the mask differs from plain")
    vals = [0] + ([2] if args[6] else [])
    err = _err([got[i] for i in vals], [ref[i] for i in vals])
    scale = _scale([ref[i] for i in vals])
    if not err <= FIELD_TOL * max(scale, 1e-30):
        raise AssertionError(f"basis_field: max err {err:.3e} over "
                             f"{FIELD_TOL} x {scale:.3e}")
    out = {"err": err, "scale": scale, "q": int(args[4].shape[0])}
    del got, again, ref
    if timed:
        p1 = cuda_ms(lambda: plain_field(args), 1, warm=False)
        k1 = cuda_ms(lambda: BK.basis_field(*args, packed), reps)
        k2 = cuda_ms(lambda: BK.basis_field(*args, packed), reps)
        p2 = cuda_ms(lambda: plain_field(args), 1, warm=False)
        out.update(ms=min(k1, k2), ms_turns=(k1, k2), plain_ms=min(p1, p2),
                   bound=field_bound(args, packed),
                   kernel_ms=kernel_device_ms(
                       lambda: BK.basis_field(*args, packed)))
    return out


def capture_main_path(lap) -> dict:
    """Run ``lap()`` capturing the first ``basis_rows`` call, the largest
    ``basis_field`` value call (the dense mesher's corner values) and the
    first gradient call (its Newton step).  Returns {"result", "rows",
    "values", "newton"} (None where no such call ran)."""
    res, rec = capture(("basis_rows", "basis_field"), lap)
    vals = [a for a in rec["basis_field"] if not a[6]]
    grads = [a for a in rec["basis_field"] if a[6]]
    return {"result": res,
            "rows": rec["basis_rows"][0] if rec["basis_rows"] else None,
            "values": max(vals, key=lambda a: a[4].shape[0]) if vals
            else None,
            "newton": grads[0] if grads else None}


def main(argv: Optional[list] = None) -> int:
    if not torch.cuda.is_available():
        print("time_basis: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.scenes import synthetic_scene
    params = load_tree(os.path.join(HERE, "runs", "scene_big", "best.ckpt"))
    recon = Reconstructor(config=PipelineConfig(conv_dtype="bfloat16"),
                          params=params)
    xyz, nrm = synthetic_scene(1_000_000)

    def lap():
        field = recon.reconstruct(xyz, nrm, structure="splat",
                                  detail_level=None, voxel_size=0.1,
                                  solver_tol=1e-4, solver_max_iters=16)
        return field.extract_dual_mesh(mise_iter=1)

    cap = capture_main_path(lap)
    del cap["result"]
    print(json.dumps({"name": "basis_rows",
                      **_jsonable(compare_rows(cap["rows"], True))}))
    for key in ("values", "newton"):
        if cap[key] is not None:
            print(json.dumps({"name": f"basis_field ({key})", **_jsonable(
                compare_field(cap[key], True))}))
    print(torch.cuda.get_device_name(0))
    return 0


def _jsonable(d: dict) -> dict:
    return json.loads(json.dumps(d, default=str))


if __name__ == "__main__":
    sys.exit(main())
