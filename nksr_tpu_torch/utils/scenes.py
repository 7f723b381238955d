"""Synthetic input scenes (counterpart of ``synthetic_scene`` in the
repository's bench.py, which the port does not import)."""

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
    dx = 0.3 * np.cos(0.3 * xy[:, 0]) * np.cos(0.25 * xy[:, 1]) \
        + 0.33 * np.cos(1.1 * xy[:, 0] + 0.7 * xy[:, 1])
    dy = -0.25 * np.sin(0.3 * xy[:, 0]) * np.sin(0.25 * xy[:, 1]) \
        + 0.21 * np.cos(1.1 * xy[:, 0] + 0.7 * xy[:, 1])
    nrm = np.stack([-dx, -dy, np.ones(n, np.float32)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, nrm.astype(np.float32)
