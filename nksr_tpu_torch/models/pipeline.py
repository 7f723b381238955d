"""Static configuration, input features, seeded parameter init, and the
solve rows of the support-row kernel field.

``PipelineConfig`` has the fields and defaults of
nksr_tpu/models/pipeline.py so configurations carry over unchanged;
the fields that only the JAX package reads (``cascade_engine``,
``capacities``, ``fused_mode``) are kept for that reason.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grid import get_voxel_centers, point_splat_coords
from ..fields.kernel_field import KernelField
from ..ops import segment_sum as SEG
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
    support tables, per depth (rows, 8) int64."""
    dev = xyz.device
    ad = cfg.adaptive_depth
    vss = [level_voxel_size(cfg, d) for d in range(cfg.tree_depth)]
    field = KernelField(vss, caps, basis_features,
                        [net.interpolators.level(d)
                         for d in range(cfg.tree_depth)],
                        cfg.kernel_dim, cfg.approx_kernel_grad)
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
