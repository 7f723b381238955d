"""Public reconstruction API (counterpart of
nksr_tpu/recon/reconstructor.py, splat structure):

    recon = Reconstructor()                     # device="cuda"
    field = recon.reconstruct(xyz, normal, structure="splat")
    mesh  = field.extract_dual_mesh(mise_iter=1)   # mesh.v / mesh.f

Stages: host grid build and lattice plan (numpy + C++), the UNet, the
kernel solve, the field evaluator and dual marching cubes.  The route is
chosen as the JAX package chooses it, by the same budgets in the same
order:

  * lattice: the plan exists and its feature lattices fit
    ``DENSE_UNET_CELLMAP_BUDGET``: the dense conv3d UNet, the primal
    lattice CG solve and the lattice evaluator;
  * route A: the plan exists but the feature lattices do not fit: the
    gather-conv UNet over host tables, then the lattice solve;
  * route B (the sparse fallback): ``plan_lattice`` returns None (the
    dense coefficients would exceed its budget): the gather-conv UNet,
    the support-row kernel solve and the host dual MC.

The dense mesher meshes a lattice field whose fine grid fits
``meshing.lattice_mc.DENSE_CELL_BUDGET``, the host mesher any other
field.  ``_last_unet_engine`` records "dense" or "sparse".  Routes that
are not ported yet raise ``NotImplementedError`` naming the ROADMAP item
that ports them; nothing falls back to another engine or to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import host_build as HB
from ..fields.lattice import lattice_solve, plan_lattice
from ..fields.lattice_eval import LatticeEvalContext
from ..models import dense_unet as DU
from ..models import pipeline as P
from ..models import sparse_unet as SU
from ..models.network import NKSRNetwork
from ..ops.gather_scatter import stencil_offsets
from ..utils.checkpoint import params_to_torch
from ..utils.profiling import PhaseTimer
from .host_field import HostField, SolverStats

# total dense cells (all depths) x f_maps the conv3d UNet may hold;
# beyond it the gather-conv UNet runs
DENSE_UNET_CELLMAP_BUDGET = 400_000_000


def _next_pow2(n: int) -> int:
    return 1 << max(8, int(math.ceil(math.log2(max(n, 1)))))


def resolve_solver_dtype(dt: str, device: torch.device) -> str:
    """'auto' -> bf16 on CUDA (half the bytes of the matvec's dominant
    streams; sums stay f32), f32 on the CPU."""
    if dt != "auto":
        return dt
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to nksr_tpu_torch yet (ROADMAP.md queue 1, "
        f"{item})")


def _splat_normals_dense(spec, origins, d, voxel_size, xyz, normal,
                         vox_cell, vox_active):
    """Normal prior per voxel: trilinear splat of the input normals onto
    the depth-d lattice, read at the voxel cells and normalized."""
    g = xyz / (voxel_size * (2.0 ** d))
    base = torch.floor(g).long()
    acc, _ = DU.trilinear_splat(spec.dims[d], origins[d], base,
                                g - base.float(), normal)
    rows = torch.where(vox_active[:, None], acc[vox_cell], 0.0)
    return rows / (torch.linalg.norm(rows, dim=-1, keepdim=True) + 1e-6)


def _dense_unet_fits(spec, cfg) -> bool:
    """The dense conv3d UNet's feature lattices fit the budget."""
    total = sum(spec.n_cells(d) for d in range(spec.depth))
    return total * cfg.f_maps <= DENSE_UNET_CELLMAP_BUDGET


def _set_matmul_precision() -> None:
    """Full f32 in f32 matmuls and convs on the card: cuDNN would run
    f32 convs in TF32 by default.  bf16 work stays bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Reconstructor:
    """Neural-kernel surface reconstruction on one device.

    ``device`` defaults to ``"cuda"`` and has no fallback: without a GPU
    the constructor raises; the CPU runs only when asked for
    (``device="cpu"``).  ``params``: a flax-layout parameter tree (e.g.
    ``utils.checkpoint.load_tree`` of a JAX checkpoint); None draws
    seeded random weights (``models.pipeline.init_params``)."""

    def __init__(self, device="cuda", config: Optional[P.PipelineConfig] = None,
                 params=None, seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Reconstructor(device='cuda'): no CUDA "
                                   "device is available")
            _set_matmul_precision()
        self.config = config or P.PipelineConfig()
        if params is None:
            params = P.init_params(self.config, seed)
        net = NKSRNetwork(self.config)
        net.load_state_dict(params_to_torch(params), strict=True)
        self.network = net.to(self.device).eval()

    # ------------------------------------------------------------------ api
    @torch.no_grad()
    def reconstruct(self, input_xyz, input_normal=None, *, sensor=None,
                    detail_level: Optional[float] = 0.0,
                    voxel_size: Optional[float] = None,
                    chunk_size: Optional[float] = None,
                    preprocess_fn: Optional[Callable] = None,
                    approx_kernel_grad: bool = False,
                    solver_tol: float = 1e-5,
                    solver_max_iters: Optional[int] = None,
                    fused_mode: bool = False,
                    structure: Optional[str] = None,
                    mesh=None) -> HostField:
        """Reconstruct an implicit field from a point cloud (parameter
        semantics of ``nksr_tpu.Reconstructor.reconstruct``).
        ``fused_mode`` selects the support-row solve that recomputes its
        supports in every matvec; the lattice solve is matrix-free
        either way."""
        xyz = np.asarray(input_xyz, np.float32)
        normal = None if input_normal is None else np.asarray(
            input_normal, np.float32)
        sens = None if sensor is None else np.asarray(sensor, np.float32)
        if preprocess_fn is not None:
            xyz, normal, sens = preprocess_fn(xyz, normal, sens)
            xyz = np.asarray(xyz, np.float32)
            normal = None if normal is None else np.asarray(normal,
                                                            np.float32)
        if chunk_size is not None:
            raise _not_ported("chunked reconstruction (chunk_size=)",
                              "item 11")
        if mesh is not None:
            raise _not_ported("multi-device reconstruction (mesh=)",
                              "item 15")
        if self.config.udf_enabled:
            raise _not_ported("the UDF mask head (udf_enabled)", "item 10")
        if self.config.solver_formulation != "primal":
            raise _not_ported("solver_formulation="
                              f"{self.config.solver_formulation!r}", "item 13")
        if self.config.geometry != "kernel":
            raise _not_ported(f"geometry={self.config.geometry!r}",
                              "item 17")
        cfg = self._runtime_config(
            self._pick_voxel_size(xyz, detail_level, voxel_size),
            approx_kernel_grad, solver_tol, solver_max_iters,
            feature="normal" if normal is not None else "sensor",
            fused_mode=fused_mode)
        if structure is not None:
            cfg = dataclasses.replace(cfg, structure_mode=structure)
        if cfg.structure_mode != "splat":
            raise _not_ported(f"structure={cfg.structure_mode!r}",
                              "items 8-9 (adaptive, predicted)")
        return self._reconstruct_host(cfg, xyz, normal, sens)

    def _reconstruct_host(self, cfg, xyz, normal, sens) -> HostField:
        """Host-built grids, plan and tables, then the device stages of
        the route the budgets pick (see the module docstring)."""
        dev = self.device
        times: dict = {}
        tm = PhaseTimer(dev, times)
        grids, orders = HB.build_splat_grids_ex(xyz, cfg.voxel_size,
                                                cfg.tree_depth)
        caps = tuple(max(_next_pow2(int(len(g.keys) * 1.05)), 512)
                     for g in grids)
        plan = plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            cfg.voxel_size, cfg.tree_depth,
                            cfg.adaptive_depth, k=cfg.kernel_dim)
        dense_unet = plan is not None and _dense_unet_fits(plan.spec, cfg)
        self._last_unet_engine = "dense" if dense_unet else "sparse"

        def up(a, dtype=None):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

        i64 = torch.int64
        xyz_t = up(xyz)
        feat = P.point_features(
            cfg, xyz_t, normal=None if normal is None else up(normal),
            sensor=None if sens is None else up(sens))
        input_normal = feat if cfg.feature == "normal" else None
        tm.lap("host build + plan + upload")

        if dense_unet:
            tables = DU.build_tables(plan.spec, plan.origins, grids, caps,
                                     dev)
            perm = up(orders[0][1], i64)
            base0 = up(HB.unpack64(orders[0][0]), i64)
            basis_f, normal_f = DU.dense_unet_apply(
                cfg, self.network, plan.spec, plan.origins, tables,
                xyz_t[perm], None if feat is None else feat[perm], base0)
            tm.lap("dense unet")
        else:
            # the points' splat rows: the encoder's depth-0 table, the
            # normal prior's (adaptive depths) and route B's value rows
            # (every depth)
            n_sup = cfg.tree_depth if plan is None else cfg.adaptive_depth
            pt_sup = tuple(up(t, i64) for t in HB.support_indices(
                grids[:n_sup], caps[:n_sup], xyz, presorted=orders[:n_sup]))
            ut = HB.build_unet_tables(grids, caps, stencil_offsets(3))
            ut = HB.UNetTables(*(tuple(up(t, i64) for t in part)
                                 for part in ut))
            coords = tuple(up(g.coords, i64) for g in grids)
            tm.lap("unet tables")
            basis_f, normal_f = SU.sparse_unet_apply(
                cfg, self.network, ut, [len(g.keys) for g in grids], caps,
                coords, xyz_t, feat, pt_sup[0])
            del ut, coords
            tm.lap("sparse unet")

        if plan is None:
            return self._support_row_solve(cfg, grids, caps, xyz_t,
                                           input_normal, basis_f, normal_f,
                                           pt_sup, tm, times)

        spec = plan.spec
        vox_cell = tuple(up(v, i64) for v in plan.vox_cell)
        vox_active = tuple(up(v) for v in plan.vox_active)
        nvals = []
        for d in range(cfg.adaptive_depth):
            nv = normal_f[d]
            if input_normal is not None:
                if dense_unet:
                    nv = nv + _splat_normals_dense(
                        spec, plan.origins, d, cfg.voxel_size, xyz_t,
                        input_normal, vox_cell[d], vox_active[d])
                else:
                    nv = nv + P.splat_normals_to_grid(
                        P.level_voxel_size(cfg, d), caps[d], xyz_t,
                        input_normal, pt_sup[d])
            nvals.append(nv)
        cdt = getattr(torch, cfg.solver_compute_dtype)
        alphas, dense_xs, (iters, rel_res) = lattice_solve(
            spec, self.network.interpolators, basis_f,
            up(xyz[plan.pt_perm]), up(plan.pt_cell0, i64),
            up(plan.pt_dest, i64), up(plan.slot_cell_pt, i64),
            up(plan.slot_cell_gr, i64), up(plan.gr_coords, i64),
            up(plan.gr_depth, i64), up(plan.gr_active),
            -torch.cat(nvals, 0), vox_cell, vox_active,
            voxel_size=cfg.voxel_size, pos_weight=cfg.pos_weight,
            normal_weight=cfg.normal_weight, reg_weight=cfg.reg_weight,
            tol=cfg.solver_tol, max_iters=cfg.solver_max_iters,
            approx_grad=cfg.approx_kernel_grad,
            slot_cell0_pt=up(plan.slot_cell0_pt, i64),
            slot_cell0_gr=up(plan.slot_cell0_gr, i64),
            gr_perm=up(plan.gr_perm, i64), compute_dtype=cdt)
        tm.lap("lattice solve")

        ctx = LatticeEvalContext(
            spec, plan.origins, self.network.interpolators, basis_f,
            vox_cell, vox_active, cfg.voxel_size, cfg.approx_kernel_grad,
            compute_dtype=cdt, dense_xs=dense_xs)
        return HostField(cfg, grids, alphas, ctx,
                         SolverStats(iters, rel_res, cfg.solver_tol,
                                     cfg.solver_max_iters),
                         phase_times=times)

    def _support_row_solve(self, cfg, grids, caps, xyz_t, input_normal,
                           basis_f, normal_f, pt_sup, tm, times
                           ) -> HostField:
        """Route B: the support-row kernel solve on the splat hierarchy
        (value rows at the points, gradient rows at the voxel centers of
        the adaptive depths)."""
        grad_sup = tuple(
            torch.as_tensor(t.astype(np.int64), device=self.device)
            for t in HB.support_indices(grids, caps,
                                        P.grad_row_centers(cfg, grids)))
        tm.lap("support tables")
        field = P.solve_kernel_field(cfg, self.network, grids, caps, xyz_t,
                                     input_normal, basis_f, normal_f,
                                     pt_sup, grad_sup)
        tm.lap("support-row solve")
        iters, rel_res = field.cg_stats
        return HostField(cfg, grids, field.alpha, None,
                         SolverStats(iters, rel_res, cfg.solver_tol,
                                     cfg.solver_max_iters),
                         phase_times=times, field=field, capacities=caps)

    # -------------------------------------------------------------- helpers
    def _pick_voxel_size(self, xyz: np.ndarray,
                         detail_level: Optional[float],
                         voxel_size: Optional[float]) -> float:
        """``voxel_size`` wins; ``detail_level`` in [0, 1] sweeps coarse ->
        fine around the sampling density; None means the network's
        native scale."""
        if voxel_size is not None:
            return float(voxel_size)
        if detail_level is None:
            return self.config.voxel_size
        sub = xyz[:: max(1, xyz.shape[0] // 5000)]
        from scipy.spatial import cKDTree  # host-side heuristic only
        d, _ = cKDTree(sub).query(sub, k=2)
        spacing = float(np.median(d[:, 1])) + 1e-9
        lo, hi = 1.5 * spacing, 6.0 * spacing
        return float(hi * (1 - detail_level) + lo * detail_level)

    def _runtime_config(self, vs: float, approx_kernel_grad: bool,
                        solver_tol: float, solver_max_iters: Optional[int],
                        feature: str, fused_mode: bool = False
                        ) -> P.PipelineConfig:
        return dataclasses.replace(
            self.config, voxel_size=vs,
            approx_kernel_grad=approx_kernel_grad, solver_tol=solver_tol,
            solver_max_iters=solver_max_iters or self.config.solver_max_iters,
            feature=feature, fused_mode=fused_mode,
            solver_compute_dtype=resolve_solver_dtype(
                self.config.solver_compute_dtype, self.device))
