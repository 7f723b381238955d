"""Synthetic input scenes (counterparts of ``synthetic_scene`` in the
repository's bench.py and ``make_terrain_scene`` in examples/common.py,
which the port does not import)."""

from __future__ import annotations

import numpy as np


def synthetic_scene(n: int, seed: int = 0, half_extent: float = 20.0):
    """A wavy terrain patch with analytic normals — scene-like input."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-half_extent, half_extent, size=(n, 2)) \
        .astype(np.float32)
    h = (np.sin(0.3 * xy[:, 0]) * np.cos(0.25 * xy[:, 1])
         + 0.3 * np.sin(1.1 * xy[:, 0] + 0.7 * xy[:, 1]))
    xyz = np.concatenate([xy, h[:, None].astype(np.float32)], 1)
    return xyz, terrain_normals(xy)


def terrain_normals(xy: np.ndarray) -> np.ndarray:
    """(n, 3) f32 unit normals of the terrain's height field at (n, 2)
    f32 positions."""
    dx = 0.3 * np.cos(0.3 * xy[:, 0]) * np.cos(0.25 * xy[:, 1]) \
        + 0.33 * np.cos(1.1 * xy[:, 0] + 0.7 * xy[:, 1])
    dy = -0.25 * np.sin(0.3 * xy[:, 0]) * np.sin(0.25 * xy[:, 1]) \
        + 0.21 * np.cos(1.1 * xy[:, 0] + 0.7 * xy[:, 1])
    nrm = np.stack([-dx, -dy, np.ones(len(xy), np.float32)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return nrm.astype(np.float32)


def make_terrain_scene(n: int = 200000, extent: float = 40.0, seed: int = 0):
    """Synthetic lidar-like terrain with sensor positions: (n, 3) points
    and (n, 3) sensor positions, one sensor at (0, 0, 10)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-extent / 2, extent / 2, size=(n, 2)).astype(np.float32)
    h = (np.sin(0.3 * xy[:, 0]) * np.cos(0.25 * xy[:, 1])
         + 0.3 * np.sin(1.1 * xy[:, 0] + 0.7 * xy[:, 1]))
    xyz = np.concatenate([xy, h[:, None].astype(np.float32)], 1)
    sensor = np.zeros_like(xyz)
    sensor[:, 2] = 10.0
    return xyz, sensor
