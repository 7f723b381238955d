"""``nksr_tpu_torch.svh.SparseFeatureHierarchy`` (counterpart of
nksr_tpu/svh.py)."""

from .core.svh import (SparseFeatureHierarchy, VOXEL_EMPTY, VOXEL_LEAF,
                       VOXEL_REFINED)
from .core.grid import SparseGrid

__all__ = ["SparseFeatureHierarchy", "SparseGrid", "VOXEL_EMPTY",
           "VOXEL_LEAF", "VOXEL_REFINED"]
