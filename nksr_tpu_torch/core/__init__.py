"""core layer of the PyTorch port (see the package docstring): sparse
voxel grids and hierarchies (counterpart of nksr_tpu/core/__init__.py's
exports)."""

from .grid import SparseGrid, splat_coords, point_splat_coords
from .svh import (SparseFeatureHierarchy, VOXEL_EMPTY, VOXEL_LEAF,
                  VOXEL_REFINED)

__all__ = [
    "SparseGrid", "splat_coords", "point_splat_coords",
    "SparseFeatureHierarchy", "VOXEL_EMPTY", "VOXEL_LEAF", "VOXEL_REFINED",
]
