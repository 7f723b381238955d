"""Voxel geometry on host-built integer coordinates (counterpart of
nksr_tpu/core/grid.py ``splat_coords`` / ``point_splat_coords`` /
``grid_to_world`` and core/svh.py ``get_voxel_centers``).

Voxel ``(i, j, k)`` of a level with voxel size ``s`` has its center at
``ijk * s`` (node-centered, origin 0); a point splats to the 8 voxel
centers around it.  The JAX package's device key hashing is replaced by
the host tables of ``core/host_build.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def _corner_offsets(device) -> torch.Tensor:
    """(8, 3) int64 offsets of the 2x2x2 corners in (i, j, k) bit order,
    made on ``device`` (a host array would be a synchronising copy)."""
    i = torch.arange(8, device=device)
    return torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], -1)


def splat_coords(grid_xyz: torch.Tensor):
    """8 surrounding voxel coords and trilinear weights of (N, 3)
    positions in grid units: (N, 8, 3) int64, (N, 8) f32."""
    base = torch.floor(grid_xyz)
    frac = grid_xyz - base
    offs = _corner_offsets(grid_xyz.device)
    corner = base.long()[:, None, :] + offs[None]
    w = torch.where(offs[None].bool(), frac[:, None, :],
                    1.0 - frac[:, None, :]).prod(-1)
    return corner, w


def world_to_grid(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """``xyz / voxel_size`` as a correctly rounded f32 division, as numpy
    divides when it builds the host tables.  CUDA turns a division by a
    host scalar into a multiplication by its reciprocal, which can move
    ``floor`` across a cell boundary; a divisor on the device does not
    (filled there, so no host copy synchronises the stream)."""
    return xyz / xyz.new_full((), voxel_size)


def point_splat_coords(voxel_size: float, xyz: torch.Tensor):
    """Coords and weights of the 8 voxel centers around each world
    point."""
    return splat_coords(world_to_grid(xyz, voxel_size))


def grid_to_world(ijk: torch.Tensor, voxel_size: float) -> torch.Tensor:
    return ijk.float() * voxel_size


def get_voxel_centers(coords: np.ndarray, voxel_size: float) -> np.ndarray:
    """(n, 3) world centers of host voxel coords, f32 as the device
    computes them."""
    return coords.astype(np.float32) * np.float32(voxel_size)
