"""Ground-truth geometry providers for scene-scale supervision
(counterpart of nksr_tpu/data/gt_geometry.py, the reference's
av_gt_geometry layer): a dense oriented point set that answers
``query_sdf`` through ``ops/sdf.sdf_from_points``, and a TSDF-volume
variant that also answers ``query_classification`` (0 near the surface,
1 observed empty space, 2 unknown) by nearest sampling of a volume.
Both crop to a box for chunked training pipelines.

Queries run on ``device`` (the card unless the caller asks for the
CPU); arrays are held in numpy and returned as tensors on that device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import knn as K
from ..ops import sdf as SDF

NEAR_SURFACE = 0
EMPTY_SPACE = 1
UNKNOWN = 2


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ground-truth geometry on device='cuda': no CUDA "
                           "device is available (pass device='cpu')")
    return device


class DensePointsGroundTruthGeometry:
    """GT = a dense oriented point cloud; SDF queries by the sdfgen op.

    ``mode='vote'`` (the default) is the reference's AV recipe: the
    majority-vote SDF with a per-point adaptive radius, 8 neighbours,
    stdv 3.0, 8-NN radius; ``mode='imls'`` the smooth IMLS estimator."""

    def __init__(self, xyz: np.ndarray, normal: np.ndarray,
                 voxel_size: float = 0.1, mode: str = "vote",
                 device="cuda"):
        self.xyz = np.asarray(xyz, np.float32)
        self.normal = np.asarray(normal, np.float32)
        self.voxel_size = float(voxel_size)
        self.mode = mode
        self.device = _device(device)
        self._table: Optional[K.BucketTable] = None
        self._ref_std: Optional[torch.Tensor] = None
        self._pts: Optional[torch.Tensor] = None
        self._nrm: Optional[torch.Tensor] = None

    def torch_attr(self):
        """(xyz, normal, aux): the reference's accessor."""
        return self.xyz, self.normal, None

    def _cloud(self):
        if self._pts is None:
            self._pts = torch.as_tensor(self.xyz, device=self.device)
            self._nrm = torch.as_tensor(self.normal, device=self.device)
        return self._pts, self._nrm

    def _get_table(self) -> K.BucketTable:
        if self._table is None:
            self._table = K.build_buckets(self._cloud()[0],
                                          4.0 * self.voxel_size, 32)
        return self._table

    def _get_ref_std(self) -> torch.Tensor:
        """Each point's mean distance to its 8 nearest (the adaptive
        radius), cached."""
        if self._ref_std is None:
            self._ref_std = SDF.reference_self_std(self._get_table(),
                                                   self._cloud()[0], 8)
        return self._ref_std

    def query_sdf(self, queries) -> torch.Tensor:
        """SDF at (Q, 3) queries, positive INSIDE (the sdfgen output
        negated, the reference's sign convention)."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        pts, nrm = self._cloud()
        if self.mode == "vote":
            return -SDF.sdf_from_points(
                q, pts, nrm, table=self._get_table(), nb_points=8,
                stdv=3.0, imls=False, ref_std=self._get_ref_std())
        return -SDF.sdf_from_points(q, pts, nrm, table=self._get_table())

    def query_classification(self, queries) -> torch.Tensor:
        d = self.query_sdf(queries).abs()
        return torch.where(d < 2 * self.voxel_size, NEAR_SURFACE,
                           UNKNOWN).to(torch.int32)

    def crop(self, lo, hi) -> "DensePointsGroundTruthGeometry":
        keep = np.all((self.xyz >= lo) & (self.xyz <= hi), axis=1)
        return DensePointsGroundTruthGeometry(
            self.xyz[keep], self.normal[keep], self.voxel_size,
            mode=self.mode, device=self.device)


class PointTSDFVolumeGroundTruthGeometry(DensePointsGroundTruthGeometry):
    """Adds a dense TSDF and weight volume (X, Y, Z) from ``origin`` at
    ``voxel_size`` for empty-space classification."""

    def __init__(self, xyz, normal, tsdf: np.ndarray, weight: np.ndarray,
                 origin, voxel_size: float, device="cuda"):
        super().__init__(xyz, normal, voxel_size, device=device)
        self.tsdf = np.asarray(tsdf, np.float32)
        self.weight = np.asarray(weight, np.float32)
        self.origin = np.asarray(origin, np.float32)

    def _sample_nearest(self, vol: np.ndarray, queries) -> torch.Tensor:
        dev = self.device
        q = (torch.as_tensor(np.asarray(queries, np.float32), device=dev)
             - torch.as_tensor(self.origin, device=dev)) \
            / torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        ijk = torch.round(q).to(torch.int32)
        shape = torch.as_tensor(vol.shape, dtype=torch.int32, device=dev)
        inb = ((ijk >= 0) & (ijk < shape)).all(-1)
        ijk = torch.minimum(ijk.clamp(min=0), shape - 1).long()
        flat = (ijk[:, 0] * vol.shape[1] + ijk[:, 1]) * vol.shape[2] \
            + ijk[:, 2]
        vals = torch.as_tensor(vol, device=dev).reshape(-1)[flat]
        return torch.where(inb, vals, torch.nan)

    def query_classification(self, queries) -> torch.Tensor:
        """0 near the surface, 1 observed empty, 2 unknown."""
        t = self._sample_nearest(self.tsdf, queries)
        w = self._sample_nearest(self.weight, queries)
        near = t.abs() < 2 * self.voxel_size
        observed = (w > 0.5) & ~torch.isnan(w)
        empty = observed & (t >= 2 * self.voxel_size)
        return torch.where(near & observed, NEAR_SURFACE,
                           torch.where(empty, EMPTY_SPACE,
                                       UNKNOWN)).to(torch.int32)

    def crop(self, lo, hi) -> "PointTSDFVolumeGroundTruthGeometry":
        keep = np.all((self.xyz >= lo) & (self.xyz <= hi), axis=1)
        lo_i = np.floor((np.asarray(lo) - self.origin)
                        / self.voxel_size).astype(int)
        hi_i = np.ceil((np.asarray(hi) - self.origin)
                       / self.voxel_size).astype(int) + 1
        lo_i = np.clip(lo_i, 0, np.asarray(self.tsdf.shape) - 1)
        hi_i = np.clip(hi_i, 1, np.asarray(self.tsdf.shape))
        sl = tuple(slice(a, b) for a, b in zip(lo_i, hi_i))
        return PointTSDFVolumeGroundTruthGeometry(
            self.xyz[keep], self.normal[keep], self.tsdf[sl],
            self.weight[sl], self.origin + lo_i * self.voxel_size,
            self.voxel_size, device=self.device)

    @staticmethod
    def from_points(xyz, normal, voxel_size: float, padding: int = 4,
                    device="cuda") -> "PointTSDFVolumeGroundTruthGeometry":
        """Bake a TSDF volume (at most 256 cells an axis) from the
        oriented cloud, by the IMLS estimator, for datasets that ship
        only points."""
        lo = xyz.min(0) - padding * voxel_size
        hi = xyz.max(0) + padding * voxel_size
        dims = np.minimum(np.ceil((hi - lo) / voxel_size).astype(int) + 1,
                          256)
        gx, gy, gz = [np.arange(d) * voxel_size + o
                      for d, o in zip(dims, lo)]
        grid = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"),
                        -1).reshape(-1, 3).astype(np.float32)
        g = DensePointsGroundTruthGeometry(xyz, normal, voxel_size,
                                           mode="imls", device=device)
        sdf = torch.cat([g.query_sdf(grid[i:i + (1 << 16)]).cpu()
                         for i in range(0, grid.shape[0], 1 << 16)]
                        ).numpy().reshape(tuple(dims))
        return PointTSDFVolumeGroundTruthGeometry(
            xyz, normal, sdf, np.ones_like(sdf), lo, voxel_size,
            device=device)


_GT_CLASSES = {
    "DensePoints": DensePointsGroundTruthGeometry,
    "PointTSDFVolume": PointTSDFVolumeGroundTruthGeometry,
}


def get_class(name: str):
    """The GT geometry class by its registry name."""
    return _GT_CLASSES[name]
