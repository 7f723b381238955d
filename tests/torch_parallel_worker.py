"""One rank of a gloo world of ``tests/test_torch_parallel.py``: every
sharded scenario on CPU tensors, its arrays saved for the test to check.

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT \
        --routes splat,adaptive,predicted [--refs]

``STORE``: the world's ``FileStore`` file; ``OUT``: where the rank writes
``rank{RANK}.npz``; ``--refs``: the ranks also share out the
single-device references (the same scenes without ``mesh=``, the serial
chunked field) after the sharded work.  Imports the port, never JAX;
``tests/data/parallel_reference.npz`` holds the JAX package's side.
"""

import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch_parallel_cases as C  # noqa: E402
from nksr_tpu_torch import Reconstructor  # noqa: E402
from nksr_tpu_torch.core import host_build as HB  # noqa: E402
from nksr_tpu_torch.fields import lattice as LAT  # noqa: E402
from nksr_tpu_torch.meshing.lattice_mc import \
    extract_dual_mesh_dense  # noqa: E402
from nksr_tpu_torch.models import pipeline as P  # noqa: E402
from nksr_tpu_torch.parallel import halo_exchange_1d, make_mesh  # noqa: E402
from nksr_tpu_torch.parallel import lattice_shard as LS  # noqa: E402
from nksr_tpu_torch.parallel import spatial as SP  # noqa: E402
from nksr_tpu_torch.parallel.mesh_shard import \
    extract_dual_mesh_sharded  # noqa: E402

REF = os.path.join(HERE, "data", "parallel_reference.npz")
# the routes ``routes`` runs (``--routes``)
ROUTES = ()


def recon(name, **cfg_kw):
    scene, cfg, kw, _ = _scene(name)
    return (Reconstructor(device="cpu",
                          config=P.PipelineConfig(**dict(cfg, **cfg_kw)),
                          params=C.scene_params(name)), scene(), kw)


def _scene(name):
    if name == "predicted":
        return C.sphere, C.PRED_CFG, C.PRED_KW, None
    return C.SCENES[name]


def halo(mesh, out):
    """The ring and the open chain on 4 rows a rank (JAX's test_halo_ring
    layout: row values are global row numbers)."""
    r = SP.rank(mesh)
    x = torch.arange(4 * r, 4 * r + 4, dtype=torch.float32)[:, None]
    for ring in (True, False):
        right, left = halo_exchange_1d(mesh, x, 1, ring=ring)
        out[f"halo_{'ring' if ring else 'open'}"] = \
            torch.cat([left, x, right])[:, 0].numpy()


def global_plan(name, n):
    rec, (xyz, nrm), kw = recon(name)
    cfg = rec.config
    grids, orders = HB.build_splat_grids_ex(xyz, kw["voxel_size"],
                                            cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    plan, splan = LS.plan_sharded(grids, caps, xyz, orders[0][0],
                                  orders[0][1], kw["voxel_size"],
                                  cfg.tree_depth, cfg.adaptive_depth, n,
                                  k=cfg.kernel_dim)
    return rec, xyz, caps, plan, splan


def operator(mesh, out):
    """The sharded matvec (and rhs) of the splat scene's aligned plan on
    seeded inputs, gathered; rank 0 adds the single-device operator's."""
    n, r = SP.size(mesh), SP.rank(mesh)
    rec, xyz, caps, plan, splan = global_plan("splat", n)
    cfg, spec = rec.config, plan.spec
    vs = C.SPLAT_KW["voxel_size"]
    rng = np.random.default_rng(9)
    basis = tuple(torch.as_tensor(0.05 * rng.normal(size=(c, cfg.basis_dim)),
                                  dtype=torch.float32) for c in caps)
    targets = torch.as_tensor(0.5 * rng.normal(size=(spec.s_gr, 3)),
                              dtype=torch.float32)
    xs = tuple(torch.as_tensor(rng.normal(size=(spec.n_cells(d), spec.k)),
                               dtype=torch.float32)
               for d in range(spec.depth))
    kw = dict(voxel_size=vs, pos_weight=cfg.pos_weight,
              normal_weight=cfg.normal_weight, reg_weight=cfg.reg_weight)
    matvec, rhs, _ = LS.sharded_system(
        mesh, splan, rec.network.interpolators, basis, targets,
        approx_grad=False, **kw)
    slab = [spec.n_cells(d) // n for d in range(spec.depth)]
    y = matvec(tuple(x[r * s:(r + 1) * s] for x, s in zip(xs, slab)))
    for key, part in (("op", y), ("op_rhs", rhs)):
        g = SP.all_gather_cat(mesh, torch.cat([p.reshape(-1) for p in part]))
        out[key + "_sharded"] = g.numpy()
    if r:
        return
    i64 = torch.int64

    def up(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype)
    vc = tuple(up(v, i64) for v in plan.vox_cell)
    va = tuple(up(v) for v in plan.vox_active)
    fdp, adp = LAT.scatter_tables(spec, basis, vc, va)
    b_pt, m_pt, b_gr = LAT.assemble_rows(
        spec, rec.network.interpolators, fdp, adp, up(xyz[plan.pt_perm]),
        up(plan.pt_cell0, i64), up(plan.pt_dest, i64),
        up(plan.slot_cell_pt, i64), up(plan.gr_coords, i64),
        up(plan.gr_depth, i64), up(plan.gr_active),
        up(plan.slot_cell_gr, i64), vs, False)
    gr_a = up(plan.gr_active)
    w_pt = m_pt * (cfg.pos_weight / float(len(xyz)))
    w_gr = gr_a.float() * (cfg.normal_weight / gr_a.float().sum() * vs ** 2)
    op = LAT.SlotOperator(spec, b_pt, b_gr, up(plan.slot_cell0_pt),
                          up(plan.slot_cell0_gr),
                          torch.cat([m_pt.amax(1) > 0, gr_a]), torch.float32)
    matvec, rhs, _ = LAT.primal_system(op, w_pt, w_gr,
                                       targets[up(plan.gr_perm, i64)],
                                       cfg.reg_weight)
    # the single-device lattices in the sharded order: slab after slab
    for key, part in (("op", matvec(xs)), ("op_rhs", rhs)):
        out[key + "_single"] = np.stack([
            np.concatenate([p[q * s:(q + 1) * s].reshape(-1).numpy()
                            for p, s in zip(part, slab)])
            for q in range(n)])


def routes(mesh, out):
    """The ``ROUTES`` of splat (with the UDF mask head on), adaptive and
    predicted with ``mesh=``: the field at the probes, the sharded mesh and (rank 0) the
    dense mesher's mesh of the same gathered field, trimmed alike."""
    r = SP.rank(mesh)
    for name in ROUTES:
        rec, (xyz, nrm), kw = recon(name)
        hf = rec.reconstruct(xyz, nrm, mesh=mesh, **kw)
        out[f"{name}_sharded"] = np.int64(hf.sharded is not None)
        out[f"{name}_iters"] = np.int64(hf.solver_stats.iters)
        out[f"{name}_f"] = hf.evaluate_f(C.probes(xyz)).value
        m = hf.extract_dual_mesh(mise_iter=1)
        out[f"{name}_mesh_v"], out[f"{name}_mesh_f"] = m.v, m.f
        if hf.trim_stats is not None:
            out[f"{name}_trim"] = np.array([hf.trim_stats["faces"],
                                            hf.trim_stats["dropped"]])
        if r == 0:
            stats = {}
            d = extract_dual_mesh_dense(
                hf.lattice_ctx, mise_iter=1, trim_stats=stats,
                udf_mask=(lambda v: hf.udf_mask(v.cpu().numpy()))
                if hf.has_udf_mask else None)
            out[f"{name}_dense_v"], out[f"{name}_dense_f"] = d.v, d.f
            if stats:
                out[f"{name}_dense_trim"] = np.array([stats["faces"],
                                                      stats["dropped"]])


def jax_coefficients_mesh(mesh, out):
    """The sharded mesher on the JAX package's sharded solution of the
    mesh scene (its slab coefficients and basis features)."""
    n, r = SP.size(mesh), SP.rank(mesh)
    ref = np.load(REF)
    rec, xyz, caps, plan, splan = global_plan("mesh", n)
    depth = plan.spec.depth
    k = plan.spec.k
    sol = LS.ShardedSolution(
        mesh, plan, splan,
        tuple(torch.as_tensor(ref[f"mesh_n{n}_xs{d}"][r]).reshape(-1, k)
              for d in range(depth)),
        rec.network.interpolators,
        tuple(torch.as_tensor(ref[f"mesh_n{n}_basis{d}"])
              for d in range(depth)),
        C.SPLAT_KW["voxel_size"], torch.float32, False)
    m = extract_dual_mesh_sharded(sol, mise_iter=1)
    out["jax_mesh_v"], out["jax_mesh_f"] = m.v, m.f


def chunk_alphas(cf):
    return np.concatenate([np.concatenate([a.numpy() for a in
                                           ch["field"].alpha])
                           for ch in cf.chunks])


def chunks(mesh, out):
    xyz, nrm = C.chunk_scene()
    rec = Reconstructor(device="cpu", config=P.PipelineConfig(**C.CHUNK_CFG),
                        params=C.scene_params("chunks"))
    cf = rec.reconstruct(xyz, nrm, chunk_size=C.CHUNK_SIZE,
                         detail_level=None, mesh=mesh)
    out["chunks_n"] = np.int64(len(cf.chunks))
    out["chunks_alpha"] = chunk_alphas(cf)
    out["chunks_f"] = cf.evaluate_f_bar(C.chunk_probes())


def dual(mesh, out):
    """``solver_formulation="dual"`` with ``mesh=``: ValueError, with and
    without chunks."""
    rec, (xyz, nrm), kw = recon("splat", solver_formulation="dual")
    raised = []
    for extra in (kw, dict(chunk_size=C.CHUNK_SIZE, detail_level=None)):
        try:
            rec.reconstruct(xyz, nrm, mesh=mesh, **extra)
            raised.append(0)
        except ValueError as e:
            raised.append(int("dual" in str(e)))
    out["dual_raised"] = np.array(raised)


def references(mesh, out):
    """The single-device side, shared out over the ranks: each scene's
    field at the probes and mesh, and the serial chunked field."""
    n, r = SP.size(mesh), SP.rank(mesh)
    jobs = ["chunks", "splat", "adaptive", "predicted"]
    for name in jobs[r::n]:
        if name == "chunks":
            xyz, nrm = C.chunk_scene()
            rec = Reconstructor(device="cpu",
                                config=P.PipelineConfig(**C.CHUNK_CFG),
                                params=C.scene_params("chunks"))
            cf = rec.reconstruct(xyz, nrm, chunk_size=C.CHUNK_SIZE,
                                 detail_level=None)
            out["ref_chunks_alpha"] = chunk_alphas(cf)
            out["ref_chunks_f"] = cf.evaluate_f_bar(C.chunk_probes())
            continue
        rec, (xyz, nrm), kw = recon(name)
        hf = rec.reconstruct(xyz, nrm, **kw)
        out[f"ref_{name}_f"] = hf.evaluate_f(C.probes(xyz)).value
        m = hf.extract_dual_mesh(mise_iter=1)
        out[f"ref_{name}_mesh_v"], out[f"ref_{name}_mesh_f"] = m.v, m.f


def main(argv):
    r, n, store, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=r,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh("cpu")
    out = {}
    global ROUTES
    ROUTES = argv[argv.index("--routes") + 1].split(",")
    steps = [halo, operator, routes, jax_coefficients_mesh, chunks, dual] + \
        ([references] if "--refs" in argv else [])
    try:
        for step in steps:
            t0 = time.perf_counter()
            step(mesh, out)
            out[f"seconds_{step.__name__}"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
