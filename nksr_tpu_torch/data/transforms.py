"""Point-cloud transforms (host-side numpy augmentation): a copy of
nksr_tpu/data/transforms.py, which the port does not import.

Fresh implementations of the reference transform semantics
(reference dataset/transforms.py): noise, outliers, subsampling,
best-of-N bbox crops, scaling/centering, axis rotation, and
density-targeted scale+sample.  Each transform is a callable
``(data: dict, rng) -> dict`` operating on DatasetSpec-keyed numpy arrays;
``ComposedTransforms`` builds a pipeline from config dicts by name.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import DatasetSpec as DS

_PC_KEYS = (DS.INPUT_PC, DS.GT_DENSE_PC)
_NRM_FOR = {DS.INPUT_PC: DS.TARGET_NORMAL, DS.GT_DENSE_PC: DS.GT_DENSE_NORMAL}


class Transform:
    def __call__(self, data: Dict, rng: np.random.Generator) -> Dict:
        raise NotImplementedError


class PointcloudNoise(Transform):
    """Gaussian jitter on the input cloud (transforms.py:34-56 behavior)."""

    def __init__(self, stddev: float):
        self.stddev = stddev

    def __call__(self, data, rng):
        if self.stddev > 0 and DS.INPUT_PC in data:
            pc = data[DS.INPUT_PC]
            data[DS.INPUT_PC] = pc + self.stddev * rng.standard_normal(
                pc.shape).astype(pc.dtype)
        return data


class PointcloudOutliers(Transform):
    """Replace a ratio of points with uniform bbox outliers."""

    def __init__(self, ratio: float):
        self.ratio = ratio

    def __call__(self, data, rng):
        if self.ratio <= 0 or DS.INPUT_PC not in data:
            return data
        pc = data[DS.INPUT_PC]
        n = pc.shape[0]
        k = int(n * self.ratio)
        if k == 0:
            return data
        idx = rng.integers(0, n, k)
        lo, hi = pc.min(0), pc.max(0)
        pc = pc.copy()
        pc[idx] = rng.uniform(lo, hi, (k, 3)).astype(pc.dtype)
        data[DS.INPUT_PC] = pc
        return data


class SubsamplePointcloud(Transform):
    def __init__(self, n: int):
        self.n = n

    def __call__(self, data, rng):
        if DS.INPUT_PC not in data:
            return data
        pc = data[DS.INPUT_PC]
        idx = rng.integers(0, pc.shape[0], self.n)
        data[DS.INPUT_PC] = pc[idx]
        for k in (DS.TARGET_NORMAL, DS.INPUT_SENSOR_POS, DS.INPUT_COLOR):
            if k in data and data[k] is not None and \
                    data[k].shape[0] == pc.shape[0]:
                data[k] = data[k][idx]
        return data


class BBoxCrop(Transform):
    """Random axis-aligned crop, retrying for a good kept-points ratio
    (reference retry-20 best-ratio behavior, transforms.py:137-212)."""

    def __init__(self, size: Sequence[float], retries: int = 20,
                 target_ratio: float = 0.5):
        self.size = np.asarray(size, np.float32)
        self.retries = retries
        self.target_ratio = target_ratio

    def _crop(self, data, lo, hi):
        out = dict(data)
        for pck in _PC_KEYS:
            if pck not in data:
                continue
            pc = data[pck]
            keep = np.all((pc >= lo) & (pc <= hi), axis=1)
            out[pck] = pc[keep]
            nk = _NRM_FOR.get(pck)
            for k in (nk, DS.INPUT_SENSOR_POS, DS.INPUT_COLOR,
                      DS.GT_DENSE_COLOR):
                if k in data and data[k] is not None and \
                        data[k].shape[:1] == pc.shape[:1]:
                    out[k] = data[k][keep]
        return out

    def __call__(self, data, rng):
        pc = data.get(DS.INPUT_PC)
        if pc is None or pc.shape[0] == 0:
            return data
        lo_all, hi_all = pc.min(0), pc.max(0)
        best, best_ratio = None, -1.0
        for _ in range(self.retries):
            center = rng.uniform(lo_all, hi_all).astype(np.float32)
            lo = center - self.size / 2
            hi = center + self.size / 2
            ratio = np.all((pc >= lo) & (pc <= hi), axis=1).mean()
            if ratio > best_ratio:
                best, best_ratio = (lo, hi), ratio
            if ratio >= self.target_ratio:
                break
        return self._crop(data, *best)


class FixedBBoxCrop(BBoxCrop):
    def __init__(self, min_bound, max_bound):
        self.lo = np.asarray(min_bound, np.float32)
        self.hi = np.asarray(max_bound, np.float32)

    def __call__(self, data, rng):
        return self._crop(data, self.lo, self.hi)


class FixedScale(Transform):
    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, data, rng):
        for k in _PC_KEYS + (DS.INPUT_SENSOR_POS,):
            if k in data and data[k] is not None:
                data[k] = data[k] * self.scale
        return data


class BoundScale(Transform):
    """Scale so the max extent lands in [min_bound, max_bound]."""

    def __init__(self, min_bound: float, max_bound: float):
        self.min_bound, self.max_bound = min_bound, max_bound

    def __call__(self, data, rng):
        pc = data.get(DS.INPUT_PC)
        if pc is None or pc.shape[0] == 0:
            return data
        extent = float((pc.max(0) - pc.min(0)).max())
        s = 1.0
        if extent > self.max_bound:
            s = self.max_bound / extent
        elif extent < self.min_bound:
            s = self.min_bound / extent
        return FixedScale(s)(data, rng)


class Centralize(Transform):
    def __call__(self, data, rng):
        pc = data.get(DS.INPUT_PC)
        if pc is None or pc.shape[0] == 0:
            return data
        c = (pc.max(0) + pc.min(0)) / 2
        for k in _PC_KEYS + (DS.INPUT_SENSOR_POS,):
            if k in data and data[k] is not None:
                data[k] = data[k] - c
        return data


class FixedAxisRotation(Transform):
    """Rotate about a coordinate axis by a (possibly random) angle."""

    def __init__(self, axis: int = 2, angle_deg: Optional[float] = None):
        self.axis = axis
        self.angle_deg = angle_deg

    def __call__(self, data, rng):
        ang = np.deg2rad(self.angle_deg if self.angle_deg is not None
                         else rng.uniform(0, 360))
        c, s = np.cos(ang), np.sin(ang)
        r = np.eye(3, dtype=np.float32)
        i, j = [(1, 2), (0, 2), (0, 1)][self.axis]
        r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
        for k in _PC_KEYS + (DS.INPUT_SENSOR_POS,):
            if k in data and data[k] is not None:
                data[k] = data[k] @ r.T
        for k in (DS.TARGET_NORMAL, DS.GT_DENSE_NORMAL):
            if k in data and data[k] is not None:
                data[k] = data[k] @ r.T
        return data


class UniformDensityFixedSampleScale(Transform):
    """Scale + subsample so points-per-voxel density hits a target range
    (reference density normalization, transforms.py:321-410): the trick
    that lets one model serve object- and km-scale inputs."""

    def __init__(self, voxel_size: float, min_density: float,
                 max_density: float):
        self.voxel_size = voxel_size
        self.min_density = min_density
        self.max_density = max_density

    def density(self, pc: np.ndarray, scale: float) -> float:
        vox = np.unique(np.floor(pc * scale / self.voxel_size).astype(
            np.int64), axis=0)
        return pc.shape[0] / max(len(vox), 1)

    def __call__(self, data, rng):
        pc = data.get(DS.INPUT_PC)
        if pc is None or pc.shape[0] == 0:
            return data
        target = float(rng.uniform(self.min_density, self.max_density))
        # bisection on scale so that density(scale) ~ target
        s_lo, s_hi = 1e-3, 1e3
        for _ in range(24):
            s = np.sqrt(s_lo * s_hi)
            if self.density(pc, s) > target:
                s_lo = s   # too dense -> scale up
            else:
                s_hi = s
        data = FixedScale(float(np.sqrt(s_lo * s_hi)))(data, rng)
        return data


class FixedScaleSample(Transform):
    """Fixed scale, then subsample to a density cap."""

    def __init__(self, scale: float, voxel_size: float, max_density: float):
        self.scale = scale
        self.voxel_size = voxel_size
        self.max_density = max_density

    def __call__(self, data, rng):
        data = FixedScale(self.scale)(data, rng)
        pc = data[DS.INPUT_PC]
        vox = np.unique(np.floor(pc / self.voxel_size).astype(np.int64),
                        axis=0)
        density = pc.shape[0] / max(len(vox), 1)
        if density > self.max_density:
            n = int(pc.shape[0] * self.max_density / density)
            data = SubsamplePointcloud(n)(data, rng)
        return data


_REGISTRY = {c.__name__: c for c in
             [PointcloudNoise, PointcloudOutliers, SubsamplePointcloud,
              BBoxCrop, FixedBBoxCrop, FixedScale, BoundScale, Centralize,
              FixedAxisRotation, UniformDensityFixedSampleScale,
              FixedScaleSample]}
# the reference's spelling, as configs/mixed/data.yaml names it
_REGISTRY["UniformDensityFixedScaleSample"] = UniformDensityFixedSampleScale


class ComposedTransforms(Transform):
    """Build a pipeline from [{'name': ..., 'args': {...}}, ...] config
    (reference by-name reflection, transforms.py:487-500)."""

    def __init__(self, specs: Optional[Sequence[Dict]]):
        self.transforms: List[Transform] = []
        for spec in (specs or []):
            cls = _REGISTRY[spec["name"]]
            self.transforms.append(cls(**spec.get("args", {})))

    def __call__(self, data, rng):
        for t in self.transforms:
            data = t(data, rng)
        return data


def pad_cloud(pc: np.ndarray, capacity: int):
    """Pad to a static capacity; returns (padded, mask)."""
    n = min(pc.shape[0], capacity)
    out = np.zeros((capacity,) + pc.shape[1:], pc.dtype)
    out[:n] = pc[:n]
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return out, mask
