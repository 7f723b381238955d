"""Voxel geometry on host-built integer coordinates (counterpart of
nksr_tpu/core/grid.py ``splat_coords`` / ``point_splat_coords`` /
``grid_to_world`` and core/svh.py ``get_voxel_centers``).

Voxel ``(i, j, k)`` of a level with voxel size ``s`` has its center at
``ijk * s`` (node-centered, origin 0); a point splats to the 8 voxel
centers around it.  The JAX package's device key hashing is replaced by
the host tables of ``core/host_build.py``.

``SparseGrid`` (counterpart of nksr_tpu/core/grid.py ``SparseGrid``)
is one level as torch tensors on one device: its voxels sorted in (i,
j, k) order (the order of ``core/host_build.pack64``'s keys), zero rows
past the count up to its capacity, and a world ``origin``, so that
voxel ``ijk`` has its center at ``ijk * voxel_size + origin``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .host_build import KEY_BIAS, KEY_MASK


def host_array(x, dtype) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a contiguous host
    array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype)


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


def pack_keys(ijk: torch.Tensor) -> torch.Tensor:
    """(..., 3) integer voxels -> (...,) int64 keys, ``core/host_build.
    pack64`` on the device: they sort in (i, j, k) order."""
    c = ijk.long() + KEY_BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_keys``: (n,) int64 -> (n, 3) int32."""
    return torch.stack([(keys >> 42) - KEY_BIAS,
                        ((keys >> 21) & KEY_MASK) - KEY_BIAS,
                        (keys & KEY_MASK) - KEY_BIAS], -1).int()


def _in_key_range(ijk: torch.Tensor) -> torch.Tensor:
    return ((ijk >= -KEY_BIAS) & (ijk < KEY_BIAS)).all(-1)


@dataclass
class SparseGrid:
    """Sorted set of active voxels at one hierarchy level.

    ``coords`` (capacity, 3) int32, sorted in (i, j, k) order, zeros past
    ``num_voxels``; ``voxel_size`` (f32, as a float) and ``origin`` (3,)
    f32 on the coordinates' device."""

    coords: torch.Tensor
    num_voxels: int
    voxel_size: float
    origin: torch.Tensor

    def __post_init__(self):
        self.voxel_size = float(np.float32(self.voxel_size))
        self._keys = pack_keys(self.coords[:self.num_voxels])

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) \
            < self.num_voxels

    def active_grid_coords(self) -> torch.Tensor:
        """(capacity, 3) int32 ijk of the active voxels (zeros past
        ``num_voxels``)."""
        return self.coords

    # ------------------------------------------------------------ transforms
    def grid_to_world(self, ijk: torch.Tensor) -> torch.Tensor:
        return ijk.float() * self.voxel_size + self.origin

    def world_to_grid(self, xyz: torch.Tensor) -> torch.Tensor:
        return world_to_grid(xyz - self.origin, self.voxel_size)

    def voxel_centers(self) -> torch.Tensor:
        return self.grid_to_world(self.coords)

    def to(self, device) -> "SparseGrid":
        """The grid on ``device``."""
        return SparseGrid(self.coords.to(device), self.num_voxels,
                          self.voxel_size, self.origin.to(device))

    # --------------------------------------------------------------- queries
    def lookup(self, ijk: torch.Tensor) -> torch.Tensor:
        """Index (int64) of each (..., 3) integer voxel in this grid, -1
        where absent."""
        q = pack_keys(ijk)
        n = self.num_voxels
        if n == 0:
            return torch.full_like(q, -1)
        pos = torch.searchsorted(self._keys, q).clamp(max=n - 1)
        hit = (self._keys[pos] == q) & _in_key_range(ijk.long())
        return torch.where(hit, pos, -1)

    def contains_point(self, xyz: torch.Tensor) -> torch.Tensor:
        """True where a world point lies in the cube of an active voxel."""
        return self.lookup(torch.round(self.world_to_grid(xyz)).long()) >= 0

    # -------------------------------------------------------------- builders
    @staticmethod
    def _origin(origin, device) -> torch.Tensor:
        if origin is None:
            return torch.zeros(3, dtype=torch.float32, device=device)
        return torch.as_tensor(origin, dtype=torch.float32, device=device)

    @staticmethod
    def from_coords(ijk: torch.Tensor, mask: torch.Tensor, capacity: int,
                    voxel_size, origin=None) -> "SparseGrid":
        """The grid of the distinct voxels among (n, 3) integer ``ijk``
        where ``mask`` holds: sorted, cut at ``capacity`` (the first
        voxels in (i, j, k) order stay, as in the JAX package)."""
        ijk = ijk.reshape(-1, 3).long()
        keep = mask.reshape(-1).bool() & _in_key_range(ijk)
        keys = torch.unique(pack_keys(ijk[keep]))[:int(capacity)]
        return SparseGrid.from_keys(keys, capacity, voxel_size, origin)

    @staticmethod
    def from_keys(keys: torch.Tensor, capacity: int, voxel_size,
                  origin=None) -> "SparseGrid":
        """The grid of sorted distinct ``pack_keys`` keys (at most
        ``capacity``), on their device."""
        n = int(keys.numel())
        if n > capacity:
            raise ValueError(f"{n} voxels over the capacity {capacity}")
        coords = torch.zeros((int(capacity), 3), dtype=torch.int32,
                             device=keys.device)
        coords[:n] = unpack_keys(keys)
        return SparseGrid(coords, n, voxel_size,
                          SparseGrid._origin(origin, keys.device))

    @staticmethod
    def empty(capacity: int, voxel_size, origin=None,
              device="cuda") -> "SparseGrid":
        return SparseGrid(
            torch.zeros((int(capacity), 3), dtype=torch.int32,
                        device=device), 0, voxel_size,
            SparseGrid._origin(origin, device))
