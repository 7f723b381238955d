"""Static configuration, input features, seeded parameter init, the
solve rows of the support-row kernel field, the geometry head
(``geometry_field``: the solved kernel field, or with
``geometry="neural"`` the SDF decoder over the basis features), the
training forward (``prepare_inputs``, ``forward``), teacher-forced or
on the predicted structure, and the inference forward with no GT
(``infer``).

``PipelineConfig`` has the fields and defaults of
nksr_tpu/models/pipeline.py so configurations carry over unchanged;
the fields that only the JAX package reads (``cascade_engine``) are
kept for that reason.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import host_build as HB
from ..core import svh as SVH
from ..core.grid import get_voxel_centers, point_splat_coords
from ..fields.kernel_field import KernelField
from ..fields.neural_field import NeuralField
from ..ops import segment_sum as SEG
from ..ops.gather_scatter import stencil_offsets
from ..utils.checkpoint import torch_to_params
from .network import NKSRNetwork


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    voxel_size: float = 0.1
    tree_depth: int = 4
    adaptive_depth: int = 1
    kernel_dim: int = 4
    f_maps: int = 32
    basis_dim: int = 16
    udf_dim: int = 16
    interp_hidden: int = 16
    interp_layers: int = 2
    feature: str = "normal"          # 'normal' | 'sensor' | 'none'
    geometry: str = "kernel"
    udf_enabled: bool = False
    pos_weight: float = 1e4
    normal_weight: float = 1e4
    reg_weight: float = 1.0
    solver_tol: float = 1e-5
    solver_max_iters: int = 128
    approx_kernel_grad: bool = False
    fused_mode: bool = False
    conv_dtype: str = "float32"      # 'bfloat16': bf16 UNet convs
    # dtype of the CG matvec's row blocks and AV0 buffer (f32 sums
    # regardless); 'auto' = bf16 on CUDA, f32 on the CPU
    solver_compute_dtype: str = "auto"
    solver_formulation: str = "primal"
    cascade_engine: str = "auto"
    capacities: Tuple[int, ...] = (65536, 32768, 16384, 8192)
    adaptive_tau: float = 0.1
    structure_mode: str = "predicted"


def point_features(cfg: PipelineConfig, xyz: torch.Tensor,
                   normal: Optional[torch.Tensor] = None,
                   sensor: Optional[torch.Tensor] = None):
    """Per-point input features (normals, or unit view directions)."""
    if cfg.feature == "normal":
        if normal is None:
            raise ValueError("config expects normals as input feature")
        return normal
    if cfg.feature == "sensor":
        if sensor is None:
            raise ValueError("config expects sensor positions")
        view = sensor - xyz
        return view / (torch.linalg.norm(view, dim=-1, keepdim=True) + 1e-6)
    return None


def init_params(cfg: PipelineConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded flax-layout parameter tree (numpy) for ``cfg``, by the rules
    of ``nksr_tpu.models.pipeline.init_params``: the residual normal heads
    are zero, ``kernel`` leaves of rank >= 2 glorot-uniform (fan-in =
    product of the leading dims), ``scale`` ones, everything else zero.
    The tree's shapes are those of ``models.network.NKSRNetwork(cfg)``.
    Each leaf draws from its own ``torch.Generator`` seeded with the
    CRC32 of ``seed`` and its path, so the values do not depend on leaf
    order.  (JAX's generator gives other numbers from the same seed.)"""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        shape, name = node.shape, path[-1]
        pathstr = "/".join(path)
        if "normal_" in pathstr:
            return np.zeros(shape, np.float32)
        if name == "kernel" and len(shape) >= 2:
            fan_in, fan_out = int(np.prod(shape[:-1])), int(shape[-1])
            lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
            gen = torch.Generator().manual_seed(
                zlib.crc32(f"{seed}:{pathstr}".encode()))
            u = torch.rand(shape, generator=gen, dtype=torch.float64)
            return ((2.0 * u - 1.0) * lim).numpy().astype(np.float32)
        if name == "scale":
            return np.ones(shape, np.float32)
        return np.zeros(shape, np.float32)
    shapes = torch_to_params(NKSRNetwork(cfg).state_dict())
    return {"params": build(shapes, ())}


def level_voxel_size(cfg: PipelineConfig, d: int) -> float:
    """Voxel size of depth d as the device holds it (f32)."""
    return float(np.float32(cfg.voxel_size * (2.0 ** d)))


def splat_normals_to_grid(voxel_size: float, cap: int, xyz: torch.Tensor,
                          normal: torch.Tensor, splat_idx: torch.Tensor
                          ) -> torch.Tensor:
    """(cap, 3) per-voxel unit normals: the input normals splatted
    trilinearly through the host splat rows ``splat_idx`` (N, 8), absent
    corners (-1) dropped, each voxel summing in a fixed order
    (``ops/segment_sum.index_sum``)."""
    _, w = point_splat_coords(voxel_size, xyz)
    n = SEG.index_sum((normal[:, None, :] * w[..., None]).reshape(-1, 3),
                      splat_idx.reshape(-1), cap)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-6)


def grad_row_centers(cfg: PipelineConfig, grids) -> np.ndarray:
    """World centers of the gradient rows (every voxel of the adaptive
    depths) as the host support join sees them: the JAX package
    multiplies in float64 there and rounds to f32."""
    return np.concatenate([
        (grids[d].coords * grids[d].voxel_size).astype(np.float32)
        for d in range(cfg.adaptive_depth)], 0)


def solve_kernel_field(cfg: PipelineConfig, net: NKSRNetwork, grids,
                       caps: Sequence[int], xyz: torch.Tensor,
                       input_normal: Optional[torch.Tensor],
                       basis_features, normal_features,
                       pos_sup_idx, grad_sup_idx) -> KernelField:
    """Assemble the solve rows and fit the support-row kernel field.

    Value rows are the N input points (target 0, weight pos_weight / N);
    gradient rows are the voxel centers of the adaptive depths (target
    minus the residual normal head on the splatted input normals, weight
    normal_weight / M * voxel_size^2).  The JAX package also carries
    capacity-padding rows of weight 0 for static shapes; they are
    trimmed here.  ``pos_sup_idx`` / ``grad_sup_idx`` are the rows' host
    support tables, per depth (rows, 8) int64.  Differentiable under
    autograd (the training forward; ``fields/kernel_field.py``)."""
    dev = xyz.device
    ad = cfg.adaptive_depth
    vss = [level_voxel_size(cfg, d) for d in range(cfg.tree_depth)]
    field = KernelField(vss, caps, basis_features,
                        [net.interpolators.level(d)
                         for d in range(cfg.tree_depth)],
                        cfg.kernel_dim, cfg.approx_kernel_grad,
                        host_grids=grids, adaptive_depth=ad)
    centers, nvals = [], []
    for d in range(ad):
        n = len(grids[d].keys)
        centers.append(torch.as_tensor(
            get_voxel_centers(grids[d].coords, vss[d]), device=dev))
        nv = normal_features[d][:n]
        if input_normal is not None:
            prior = splat_normals_to_grid(vss[d], caps[d], xyz, input_normal,
                                          pos_sup_idx[d])
            nv = prior[:n] + nv
        nvals.append(nv)
    centers = torch.cat(centers, 0)
    nvals = torch.cat(nvals, 0)
    n_pts = torch.tensor(float(max(xyz.shape[0], 1)), device=dev)
    m_vox = torch.tensor(float(max(centers.shape[0], 1)), device=dev)
    pos_w = torch.full((xyz.shape[0],), cfg.pos_weight, device=dev) / n_pts
    normal_w = torch.full((centers.shape[0],), cfg.normal_weight,
                          device=dev) / m_vox * cfg.voxel_size ** 2
    return field.solve(
        xyz, pos_w, centers, normal_w, -nvals, reg_weight=cfg.reg_weight,
        solver_tol=cfg.solver_tol, max_iters=cfg.solver_max_iters,
        pos_sup_idx=pos_sup_idx, normal_sup_idx=grad_sup_idx,
        fused=cfg.fused_mode)


def geometry_field(cfg: PipelineConfig, net: NKSRNetwork, grids,
                   caps: Sequence[int], xyz: torch.Tensor,
                   input_normal: Optional[torch.Tensor], basis_features,
                   normal_features, pos_sup_idx, grad_sup_idx):
    """The field of ``cfg.geometry`` on the decoder hierarchy ``grids``:
    "kernel", the solved support-row ``KernelField``
    (``solve_kernel_field``); "neural", the ``NeuralField`` of the basis
    features under the network's SDF decoder, with no solve (the solve
    rows' supports are not read and may be None).  Its mask is set by
    the caller."""
    if cfg.geometry == "kernel":
        return solve_kernel_field(cfg, net, grids, caps, xyz, input_normal,
                                  basis_features, normal_features,
                                  pos_sup_idx, grad_sup_idx)
    if cfg.geometry == "neural":
        return NeuralField(
            [level_voxel_size(cfg, d) for d in range(cfg.tree_depth)],
            basis_features, net.sdf_decoder, host_grids=grids,
            capacities=caps, adaptive_depth=cfg.adaptive_depth)
    raise ValueError(f"unknown geometry {cfg.geometry!r}: 'kernel' or "
                     "'neural'")


# ------------------------------------------------------- training forward
class TrainInputs(NamedTuple):
    """One cloud's inputs to the training forward: the device tensors and
    the host hierarchies and tables built from them (``prepare_inputs``).

    ``xyz`` (N, 3) the real input points (``host_xyz`` the same in
    numpy), ``feat`` their input features,
    ``input_normal`` the normals the prior splats (or None);
    ``gt_xyz`` / ``gt_normal`` (M, 3) the real GT cloud; ``enc_grids``
    the input's splat hierarchy, ``enc_tables`` its ``nbr`` / ``child``
    tables on the device, ``n_vox`` its voxel counts, ``splat_idx`` (N,
    8) the points' depth-0 splat rows; ``gt_grids`` the GT hierarchy
    (``build_gt_svh``); ``onet`` the occupancy samples (points,
    occupancy) or None.  The teacher-forced decoder's part (None when
    the inputs were prepared for the predicted structure): ``levels``
    its tables (``core/svh.TeacherLevel``, host), ``levels_t`` the same
    on the device, ``pt_sup`` / ``grad_sup`` the solve rows' supports in
    the GT hierarchy (None for the neural head, which solves nothing)."""
    xyz: torch.Tensor
    feat: Optional[torch.Tensor]
    input_normal: Optional[torch.Tensor]
    gt_xyz: torch.Tensor
    gt_normal: torch.Tensor
    enc_grids: Sequence[Any]
    enc_tables: Any
    n_vox: Tuple[int, ...]
    splat_idx: torch.Tensor
    gt_grids: Sequence[Any]
    levels: Optional[Tuple[Any, ...]]
    levels_t: Optional[Tuple[Any, ...]]
    pt_sup: Optional[Tuple[torch.Tensor, ...]]
    grad_sup: Optional[Tuple[torch.Tensor, ...]]
    onet: Optional[Tuple[torch.Tensor, torch.Tensor]]
    host_xyz: np.ndarray


class ForwardOutput(NamedTuple):
    """The training forward's result: the solved, differentiable
    ``field`` on the decoder hierarchy (a ``KernelField``, or with
    ``geometry="neural"`` a ``NeuralField``), the UDF ``mask_field`` on the
    candidate hierarchy (None without the UDF head), per depth the
    structure logits and GT statuses of the candidate rows, the UNet's
    basis features on the decoder voxels, and the host ``dec_grids``
    (the GT hierarchy when teacher-forced, else the predicted one) and
    ``cand_grids`` (the candidates of each level)."""
    field: Any
    mask_field: Any
    structure_logits: Tuple[torch.Tensor, ...]
    structure_status: Tuple[torch.Tensor, ...]
    basis_features: Tuple[torch.Tensor, ...]
    dec_grids: Tuple[Any, ...]
    cand_grids: Tuple[Any, ...]


def build_gt_svh(cfg: PipelineConfig, gt_xyz: np.ndarray,
                 gt_normal: np.ndarray):
    """GT hierarchy for supervision (nksr_tpu/models/pipeline.py
    ``build_gt_svh``): the normal-variation hierarchy of the GT cloud at
    the configuration's capacities, as host grids."""
    return SVH.build_adaptive_normal_variation(
        gt_xyz, gt_normal, cfg.voxel_size, cfg.tree_depth, cfg.capacities,
        tau=cfg.adaptive_tau, adaptive_depth=cfg.adaptive_depth)


def _real(batch: Dict[str, Any], key: str, mask_key: str) -> np.ndarray:
    """The real rows of a padded batch array, as f32 numpy."""
    a = batch[key]
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    m = batch[mask_key]
    m = m.detach().cpu().numpy() if isinstance(m, torch.Tensor) \
        else np.asarray(m)
    return np.ascontiguousarray(a[m.astype(bool)], np.float32)


def _dev_i64(tables, dev) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.asarray(t, np.int64), device=dev)
                 for t in tables)


def checked_rows(table, n: int, what: str) -> np.ndarray:
    """``table`` as an array, its rows checked to lie below ``n`` (-1
    marks an absent row).  The fixed-order sums over an index table on
    the card read no bound back (``ops/segment_sum.table_order``), so
    each table a step or a lap sums over is checked here, on the host,
    before its upload."""
    a = np.asarray(table)
    if a.size and int(a.max()) >= n:
        raise ValueError(f"{what}: row {int(a.max())} outside [0, {n})")
    return a


def teacher_levels_on(levels, n_vox: Sequence[int], up):
    """The teacher-forced decoder's tables (``core/svh.TeacherLevel``)
    through ``up`` onto the device, their rows checked: ``nbr``,
    ``dec_rows`` and ``parent`` index the level's candidates, ``skip``
    the encoder level below (``n_vox``)."""
    def rows(a, n, what):
        return None if a is None else up(checked_rows(a, n, what))
    out = []
    for d, lv in enumerate(levels):
        nc = len(lv.cand.keys)
        out.append(lv._replace(
            cand=None, status=up(lv.status),
            nbr=rows(lv.nbr, nc, f"level {d} nbr"),
            dec_rows=rows(lv.dec_rows, nc, f"level {d} dec_rows"),
            parent=rows(lv.parent, nc, f"level {d} parent"),
            octant=None if lv.octant is None else up(lv.octant),
            skip=rows(lv.skip, n_vox[d - 1] if d else 0,
                      f"level {d} skip")))
    return tuple(out)


def solve_supports(cfg: PipelineConfig, grids, xyz: np.ndarray, dev):
    """The solve rows' host supports in a decoder hierarchy, on ``dev``:
    the points' at every depth (the value rows; at the adaptive depths
    also the normal prior's splat) and the gradient rows' (the voxel
    centers of the adaptive depths)."""
    caps = tuple(cfg.capacities)
    centers = np.concatenate([
        get_voxel_centers(grids[d].coords, level_voxel_size(cfg, d))
        for d in range(cfg.adaptive_depth)], 0)

    def checked(sup, what):
        return _dev_i64([checked_rows(t, cap, f"{what} rows of depth {d}")
                         for d, (t, cap) in enumerate(zip(sup, caps))], dev)
    return (checked(HB.support_indices(grids, caps, xyz), "point"),
            checked(HB.support_indices(grids, caps, centers), "gradient"))


def encoder_inputs(cfg: PipelineConfig, xyz: np.ndarray, dev):
    """The input's splat hierarchy cut at the configuration's capacities
    (host), its ``nbr`` / ``child`` tables and the points' depth-0 splat
    rows (N, 8) on ``dev``."""
    caps = tuple(cfg.capacities)
    enc, orders = SVH.build_point_splatting(xyz, cfg.voxel_size,
                                            cfg.tree_depth, caps)
    ut = HB.build_unet_tables(enc, caps, stencil_offsets(3), decoder=False)
    n = [len(g.keys) for g in enc]
    for d, t in enumerate(ut.nbr):
        checked_rows(t[:n[d]], n[d], f"encoder nbr of depth {d}")
    for d, t in enumerate(ut.child):
        checked_rows(t[:n[d + 1]], n[d], f"encoder child of depth {d}")
    enc_tables = HB.UNetTables(nbr=_dev_i64(ut.nbr, dev),
                               child=_dev_i64(ut.child, dev),
                               parent=(), skip=())
    splat = HB.support_indices(enc[:1], caps[:1], xyz, presorted=orders[:1])
    splat_idx = _dev_i64([checked_rows(splat[0], n[0], "splat rows")],
                         dev)[0]
    return enc, enc_tables, splat_idx


def prepare_inputs(cfg: PipelineConfig, batch: Dict[str, Any],
                   device, use_gt_structure: bool = True) -> TrainInputs:
    """Host hierarchies and tables of one padded train batch (the keys of
    ``data.loader.to_device_batch``: ``xyz``, ``mask``, ``normal`` or
    ``sensor``, ``gt_xyz``, ``gt_normal``, ``gt_mask``, optionally
    ``onet_*``), and its real rows on ``device``.  The teacher-forced
    decoder's tables and supports only when ``use_gt_structure``; the
    predicted forward builds its own level by level."""
    dev = torch.device(device)
    caps = tuple(cfg.capacities)

    def up(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    xyz = _real(batch, "xyz", "mask")
    normal = _real(batch, "normal", "mask") if "normal" in batch else None
    sensor = _real(batch, "sensor", "mask") if "sensor" in batch else None
    gt_xyz = _real(batch, "gt_xyz", "gt_mask")
    gt_normal = _real(batch, "gt_normal", "gt_mask")
    xyz_t = up(xyz)
    feat = point_features(cfg, xyz_t,
                          normal=None if normal is None else up(normal),
                          sensor=None if sensor is None else up(sensor))
    input_normal = feat if cfg.feature == "normal" else None

    enc, enc_tables, splat_idx = encoder_inputs(cfg, xyz, dev)
    gt = build_gt_svh(cfg, gt_xyz, gt_normal)
    levels = levels_t = pt_sup = grad_sup = None
    if use_gt_structure:
        levels = SVH.teacher_hierarchy(enc, gt, caps, stencil_offsets(3))
        levels_t = teacher_levels_on(levels, [len(g.keys) for g in enc],
                                     up)
        if cfg.geometry == "kernel":
            pt_sup, grad_sup = solve_supports(cfg, gt, xyz, dev)
    onet = None
    if "onet_xyz" in batch:
        onet = (up(_real(batch, "onet_xyz", "onet_mask")),
                up(_real(batch, "onet_occ", "onet_mask")))
    return TrainInputs(
        xyz=xyz_t, feat=feat, input_normal=input_normal, gt_xyz=up(gt_xyz),
        gt_normal=up(gt_normal), enc_grids=enc, enc_tables=enc_tables,
        n_vox=tuple(len(g.keys) for g in enc), splat_idx=splat_idx,
        gt_grids=gt, levels=levels, levels_t=levels_t, pt_sup=pt_sup,
        grad_sup=grad_sup, onet=onet, host_xyz=xyz)


def forward(cfg: PipelineConfig, net: NKSRNetwork, inp: TrainInputs,
            use_gt_structure: bool = True, tm=None) -> ForwardOutput:
    """The training forward (nksr_tpu/models/pipeline.py ``forward`` with
    ``gt_svh`` given): the UNet's decoder teacher-forced onto the GT
    hierarchy (``use_gt_structure``) or on its own predicted hierarchy,
    the geometry head on that decoder hierarchy (``geometry_field``: the
    differentiable support-row solve, or the neural field), and the UDF
    head's field on the candidate hierarchy.  Differentiable in
    every parameter the losses reach.  In predicted mode the structure
    losses' targets are the GT statuses of the predicted candidates, and
    ``tm`` (an accumulating ``PhaseTimer``) gets the level loop's phases
    (``models/sparse_unet.predicted_unet``); the solve's supports and
    those statuses, built on the host after the UNet, are summed into
    "train: structure tables"."""
    from . import sparse_unet as SU   # it imports this module
    caps = tuple(cfg.capacities)
    if use_gt_structure:
        if inp.levels is None:
            raise ValueError("forward(use_gt_structure=True) needs inputs "
                             "prepared with use_gt_structure=True")
        dec_grids = tuple(inp.gt_grids)
        cand_grids = tuple(lv.cand for lv in inp.levels)
        basis, normal, logits, udf = SU.teacher_forced_unet(
            cfg, net, inp.enc_tables, inp.n_vox, inp.levels_t,
            [len(g.keys) for g in dec_grids], caps, inp.xyz, inp.feat,
            inp.splat_idx)
        status = tuple(lv.status for lv in inp.levels_t)
        pt_sup, grad_sup = inp.pt_sup, inp.grad_sup
    else:
        pred = SU.predicted_unet(cfg, net, inp.enc_grids, inp.enc_tables,
                                 inp.n_vox, caps, inp.xyz, inp.feat,
                                 inp.splat_idx, tm=tm)
        basis, normal, logits, udf = pred[:4]
        dec_grids, cand_grids = pred.dec_grids, pred.cand_grids
        dev = inp.xyz.device
        pt_sup = grad_sup = None
        if cfg.geometry == "kernel":
            pt_sup, grad_sup = solve_supports(cfg, dec_grids, inp.host_xyz,
                                              dev)
        status = _dev_i64([
            SVH.evaluate_voxel_status(inp.gt_grids, c.coords, d)
            for d, c in enumerate(cand_grids)], dev)
        if tm is not None:
            tm.lap("train: structure tables")
    field = geometry_field(cfg, net, dec_grids, caps, inp.xyz,
                           inp.input_normal, basis, normal, pt_sup, grad_sup)
    mask_field = udf_mask_field(cfg, net, udf, cand_grids)
    field.mask_field = mask_field
    return ForwardOutput(
        field=field, mask_field=mask_field, structure_logits=logits,
        structure_status=status, basis_features=basis,
        dec_grids=dec_grids, cand_grids=cand_grids)


def udf_mask_field(cfg: PipelineConfig, net: NKSRNetwork, udf, cand_grids
                   ) -> Optional[NeuralField]:
    """The UDF head's mask on the candidate hierarchy (level set twice the
    voxel size), None without the head."""
    if not cfg.udf_enabled:
        return None
    return NeuralField(
        [level_voxel_size(cfg, d) for d in range(cfg.tree_depth)], udf,
        net.udf_decoder, host_grids=cand_grids).set_level_set(
            2.0 * cfg.voxel_size)


@torch.no_grad()
def infer(cfg: PipelineConfig, net: NKSRNetwork, xyz: np.ndarray,
          feat: Optional[torch.Tensor], tm=None) -> ForwardOutput:
    """The inference forward with no GT (nksr_tpu/models/pipeline.py
    ``forward`` with ``gt_svh=None``): the input's splat hierarchy at
    ``cfg.capacities``, the UNet's decoder on its own predicted
    structure, or teacher-forced onto the encoder hierarchy when
    ``cfg.structure_mode == "splat"`` (as the JAX package does without a
    GT), the geometry head on the decoder hierarchy (``geometry_field``)
    and the UDF head's mask.  ``xyz`` (N, 3) f32 numpy, ``feat`` the points' features on the
    device.  The field carries the host grids, so it meshes itself
    (``extract_dual_mesh``, the in-graph mesher).  ``structure_status``
    is empty: no GT, no targets.  ``tm`` an accumulating ``PhaseTimer``
    (the phases of ``models/sparse_unet.predicted_unet``, then "infer:
    supports" and "infer: solve", or "infer: field" for the neural
    head)."""
    from . import sparse_unet as SU   # it imports this module
    dev = next(net.parameters()).device
    caps = tuple(cfg.capacities)
    xyz_t = torch.as_tensor(xyz, device=dev)
    enc, enc_tables, splat_idx = encoder_inputs(cfg, xyz, dev)
    n_vox = tuple(len(g.keys) for g in enc)
    if cfg.structure_mode == "splat":
        levels = SVH.teacher_hierarchy(enc, enc, caps, stencil_offsets(3))

        levels_t = teacher_levels_on(levels, n_vox,
                                     lambda a: _dev_i64([a], dev)[0])
        basis, normal, logits, udf = SU.teacher_forced_unet(
            cfg, net, enc_tables, n_vox, levels_t, n_vox, caps, xyz_t, feat,
            splat_idx)
        dec_grids = tuple(enc)
        cand_grids = tuple(lv.cand for lv in levels)
    else:
        pred = SU.predicted_unet(cfg, net, enc, enc_tables, n_vox, caps,
                                 xyz_t, feat, splat_idx, tm=tm)
        basis, normal, logits, udf = pred[:4]
        dec_grids, cand_grids = pred.dec_grids, pred.cand_grids
    pt_sup = grad_sup = None
    if cfg.geometry == "kernel":
        pt_sup, grad_sup = solve_supports(cfg, dec_grids, xyz, dev)
    if tm is not None:
        tm.lap("infer: supports")
    input_normal = feat if cfg.feature == "normal" else None
    field = geometry_field(cfg, net, dec_grids, caps, xyz_t, input_normal,
                           basis, normal, pt_sup, grad_sup)
    mask_field = udf_mask_field(cfg, net, udf, cand_grids)
    field.mask_field = mask_field
    if tm is not None:
        tm.lap("infer: solve" if cfg.geometry == "kernel" else
               "infer: field")
    return ForwardOutput(
        field=field, mask_field=mask_field, structure_logits=logits,
        structure_status=(), basis_features=basis, dec_grids=dec_grids,
        cand_grids=cand_grids)
