"""The end of every route: the kernel solve on the decoder hierarchy and
the field it returns (counterpart of the solve tails of
nksr_tpu/recon/reconstructor.py, predicted_dense.py and
host_predicted.py).

  * ``lattice_field``: the dense-lattice CG solve in the configuration's
    formulation (``solver_formulation``, primal or dual), then the
    lattice evaluator; the normal prior is splatted onto the solve
    lattice (``dense_prior``) or through the points' host splat rows;
  * ``support_row_field``: the support-row kernel solve for a hierarchy
    whose lattice plan is refused, meshed on the host; it solves the
    primal whatever the formulation, as the JAX package's does.

The field's mask follows the decoder grids it is handed, as the JAX
package's ``LayerField(dec_svh, adaptive_depth)`` does; a model with a
UDF head (``cfg.udf_enabled``) hands its features instead (``UdfHead``),
and the mask is the UDF's ``NeuralField`` at level set ``2 *
voxel_size`` (nksr_tpu/recon/reconstructor.py:352-359).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import host_build as HB
from ..fields.lattice import lattice_solve
from ..fields.lattice_eval import LatticeEvalContext
from ..fields.neural_field import NeuralField
from ..models import dense_unet as DU
from ..models import pipeline as P
from .host_field import HostField, SolverStats


class UdfHead(NamedTuple):
    """The UDF head's per-depth features (cap_d, udf_dim) and the host
    grids and capacities they live on: the encoder's splat hierarchy on
    the splat and adaptive routes, the candidate hierarchy on the
    predicted one."""
    grids: Sequence[HB.HostGrid]
    caps: Tuple[int, ...]
    features: Tuple[torch.Tensor, ...]


def udf_mask_kw(cfg, net, udf: Optional[UdfHead]) -> dict:
    """``HostField`` arguments of the UDF mask (none without a head)."""
    if udf is None:
        return {}
    mf = NeuralField([P.level_voxel_size(cfg, d)
                      for d in range(len(udf.features))], udf.features,
                     net.udf_decoder).set_level_set(2.0 * cfg.voxel_size)
    return dict(udf_host=list(udf.grids), udf_caps=tuple(udf.caps),
                mask_field=mf)


def resolve_solver_dtype(dt: str, device: torch.device) -> str:
    """'auto' -> bf16 on CUDA (half the bytes of the matvec's dominant
    streams; sums stay f32), f32 on the CPU."""
    if dt != "auto":
        return dt
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def splat_normals_dense(spec, origins, d, voxel_size, xyz, normal,
                        vox_cell, vox_active):
    """Normal prior per voxel: trilinear splat of the input normals onto
    the depth-d lattice, read at the voxel cells and normalized."""
    g = xyz / (voxel_size * (2.0 ** d))
    base = torch.floor(g).long()
    acc, _ = DU.trilinear_splat(spec.dims[d], origins[d], base,
                                g - base.float(), normal)
    rows = torch.where(vox_active[:, None], acc[vox_cell], 0.0)
    return rows / (torch.linalg.norm(rows, dim=-1, keepdim=True) + 1e-6)


def gradient_targets(cfg, plan, xyz_t: torch.Tensor,
                     input_normal: Optional[torch.Tensor], normal_f,
                     vox_cell, vox_active, dense_prior: bool, pt_sup=None,
                     dec_caps: Optional[Sequence[int]] = None
                     ) -> torch.Tensor:
    """The solve's gradient targets (s_gr, 3) in hierarchy order: minus
    the residual normal head plus the input normals' prior, splatted
    onto the solve lattice (``dense_prior``) or through ``pt_sup[d]``,
    the points' (N, 8) splat rows into the depth-d decoder voxels of
    capacity ``dec_caps[d]``."""
    nvals = []
    for d in range(cfg.adaptive_depth):
        nv = normal_f[d]
        if input_normal is not None:
            if dense_prior:
                nv = nv + splat_normals_dense(
                    plan.spec, plan.origins, d, cfg.voxel_size, xyz_t,
                    input_normal, vox_cell[d], vox_active[d])
            else:
                nv = nv + P.splat_normals_to_grid(
                    P.level_voxel_size(cfg, d), dec_caps[d], xyz_t,
                    input_normal, pt_sup[d])
        nvals.append(nv)
    return -torch.cat(nvals, 0)


def lattice_field(cfg, net, plan, dec_grids, xyz: np.ndarray,
                  xyz_t: torch.Tensor, input_normal: Optional[torch.Tensor],
                  basis_f, normal_f, tm, times: dict, *,
                  dense_prior: bool, pt_sup=None,
                  dec_caps: Optional[Sequence[int]] = None,
                  label: str = "lattice solve",
                  udf: Optional[UdfHead] = None) -> HostField:
    """Lattice solve on ``plan`` (built on ``dec_grids``) and the lattice
    field.  Gradient targets: the residual normal head plus the input
    normals' prior, splatted onto the solve lattice (``dense_prior``) or
    through ``pt_sup[d]``, the points' (N, 8) splat rows into the depth-d
    decoder voxels of capacity ``dec_caps[d]``.  ``label``: the solve's
    phase name; ``udf``: the UDF head, whose mask the field carries."""
    dev = xyz_t.device
    i64 = torch.int64

    def up(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    spec = plan.spec
    vox_cell = tuple(up(v, i64) for v in plan.vox_cell)
    vox_active = tuple(up(v) for v in plan.vox_active)
    gr_targets = gradient_targets(cfg, plan, xyz_t, input_normal, normal_f,
                                  vox_cell, vox_active, dense_prior, pt_sup,
                                  dec_caps)
    cdt = getattr(torch, resolve_solver_dtype(cfg.solver_compute_dtype,
                                              dev))
    alphas, dense_xs, (iters, rel_res) = lattice_solve(
        spec, net.interpolators, basis_f,
        up(xyz[plan.pt_perm]), up(plan.pt_cell0, i64),
        up(plan.pt_dest, i64), up(plan.slot_cell_pt, i64),
        up(plan.slot_cell_gr, i64), up(plan.gr_coords, i64),
        up(plan.gr_depth, i64), up(plan.gr_active),
        gr_targets, vox_cell, vox_active,
        voxel_size=cfg.voxel_size, pos_weight=cfg.pos_weight,
        normal_weight=cfg.normal_weight, reg_weight=cfg.reg_weight,
        tol=cfg.solver_tol, max_iters=cfg.solver_max_iters,
        approx_grad=cfg.approx_kernel_grad,
        slot_cell0_pt=up(plan.slot_cell0_pt, i64),
        slot_cell0_gr=up(plan.slot_cell0_gr, i64),
        gr_perm=up(plan.gr_perm, i64), compute_dtype=cdt,
        formulation=cfg.solver_formulation)
    tm.lap(label)
    ctx = LatticeEvalContext(
        spec, plan.origins, net.interpolators, basis_f, vox_cell,
        vox_active, cfg.voxel_size, cfg.approx_kernel_grad,
        compute_dtype=cdt, dense_xs=dense_xs)
    return HostField(cfg, dec_grids, alphas, ctx,
                     SolverStats(iters, rel_res, cfg.solver_tol,
                                 cfg.solver_max_iters),
                     phase_times=times, **udf_mask_kw(cfg, net, udf))


def support_row_field(cfg, net, grids, caps, xyz_t: torch.Tensor,
                      input_normal, basis_f, normal_f, pt_sup, tm,
                      times: dict, udf: Optional[UdfHead] = None
                      ) -> HostField:
    """The support-row kernel solve on the hierarchy ``grids`` (value rows
    at the points through ``pt_sup``, gradient rows at the voxel centers
    of the adaptive depths) and its field, with the mask of ``udf``."""
    grad_sup = tuple(
        torch.as_tensor(t.astype(np.int64), device=xyz_t.device)
        for t in HB.support_indices(grids, caps,
                                    P.grad_row_centers(cfg, grids)))
    tm.lap("support tables")
    field = P.solve_kernel_field(cfg, net, grids, caps, xyz_t, input_normal,
                                 basis_f, normal_f, pt_sup, grad_sup)
    tm.lap("support-row solve")
    iters, rel_res = field.cg_stats
    return HostField(cfg, grids, field.alpha, None,
                     SolverStats(iters, rel_res, cfg.solver_tol,
                                 cfg.solver_max_iters),
                     phase_times=times, field=field, capacities=caps,
                     **udf_mask_kw(cfg, net, udf))


def sharded_lattice_field(cfg, net, plan, splan, mesh, dec_grids,
                          xyz_t: torch.Tensor,
                          input_normal: Optional[torch.Tensor], basis_f,
                          normal_f, tm, times: dict,
                          udf: Optional[UdfHead] = None) -> HostField:
    """``lattice_field`` with the solve in x-slabs over ``mesh``
    (``parallel/lattice_shard.py``): the network's outputs and the
    gradient targets are every rank's (replicated), the solve is the
    slab's, and every rank ends with the whole field; the field meshes
    slab by slab (``parallel/mesh_shard.py``, a collective)."""
    from ..parallel import lattice_shard as LS
    dev = xyz_t.device
    vox_cell = tuple(torch.as_tensor(v, device=dev, dtype=torch.int64)
                     for v in plan.vox_cell)
    vox_active = tuple(torch.as_tensor(v, device=dev)
                       for v in plan.vox_active)
    gr_targets = gradient_targets(cfg, plan, xyz_t, input_normal, normal_f,
                                  vox_cell, vox_active, dense_prior=True)
    cdt = getattr(torch, resolve_solver_dtype(cfg.solver_compute_dtype,
                                              dev))
    xs_slab, (iters, rel_res) = LS.sharded_lattice_solve(
        mesh, splan, net.interpolators, basis_f, gr_targets,
        voxel_size=cfg.voxel_size, pos_weight=cfg.pos_weight,
        normal_weight=cfg.normal_weight, reg_weight=cfg.reg_weight,
        tol=cfg.solver_tol, max_iters=cfg.solver_max_iters,
        approx_grad=cfg.approx_kernel_grad, compute_dtype=cdt)
    tm.lap("sharded solve")
    alphas, dense_xs = LS.gather_alphas(mesh, plan, splan, xs_slab,
                                        vox_cell, vox_active)
    tm.lap("gather")
    ctx = LatticeEvalContext(
        plan.spec, plan.origins, net.interpolators, basis_f, vox_cell,
        vox_active, cfg.voxel_size, cfg.approx_kernel_grad,
        compute_dtype=cdt, dense_xs=dense_xs)
    hf = HostField(cfg, dec_grids, alphas, ctx,
                   SolverStats(iters, rel_res, cfg.solver_tol,
                               cfg.solver_max_iters),
                   phase_times=times, **udf_mask_kw(cfg, net, udf))
    hf.sharded = LS.ShardedSolution(
        mesh, plan, splan, xs_slab, net.interpolators, tuple(basis_f),
        cfg.voxel_size, cdt, cfg.approx_kernel_grad)
    return hf
