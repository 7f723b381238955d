"""Static configuration, input features and seeded parameter init.

``PipelineConfig`` has the fields and defaults of
nksr_tpu/models/pipeline.py so configurations carry over unchanged;
the fields that only the JAX package reads (``cascade_engine``,
``capacities``, ``fused_mode``) are kept for that reason.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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
