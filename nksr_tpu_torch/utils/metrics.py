"""Mesh evaluation metrics: chamfer, f-score, normal consistency and
occupancy IoU (counterpart of nksr_tpu/utils/metrics.py, the reference
evaluator's metric set).

Meshes are sampled uniformly by area with face normals, from a numpy
``default_rng(seed)`` stream; nearest neighbours both ways come from the
host kd-tree (``native.KDTree``) and occupancy from the host ray-cast
(``native.raycast_inside``), as in the JAX package, so one mesh, one
reference cloud and one seed give the same numbers in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..native import KDTree, raycast_inside


def sample_mesh(v: np.ndarray, f: np.ndarray, n: int,
                rng: Optional[np.random.Generator] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """n area-weighted uniform surface samples and their face normals."""
    rng = rng or np.random.default_rng(0)
    tri = v[f]                                  # (F, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    fn = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(fn, axis=1)
    total = area.sum()
    if total <= 0 or len(f) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    pick = rng.choice(len(f), size=n, p=area / total)
    u = rng.random(n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    flip = u + w > 1
    u[flip], w[flip] = 1 - u[flip], 1 - w[flip]
    pts = tri[pick, 0] + u[:, None] * e1[pick] + w[:, None] * e2[pick]
    nrm = fn[pick] / (np.linalg.norm(fn[pick], axis=1, keepdims=True)
                      + 1e-12)
    return pts.astype(np.float32), nrm.astype(np.float32)


def _nn(src: np.ndarray, dst: np.ndarray):
    """Distance to, and index of, each src point's nearest dst point."""
    d, i = KDTree(dst).query(src, 1)
    return d[:, 0], i[:, 0]


class MeshEvaluator:
    """The reference metric set: f-score thresholds are fractions of the
    unit scale, with the 10% outdoor one; 5e5 mesh samples for objects,
    5e6 for scenes with GT geometry."""

    ESSENTIAL_METRICS = ("chamfer-L1", "chamfer-L2", "f-score",
                         "f-score-15", "f-score-20", "normals")
    ALL_METRICS = ESSENTIAL_METRICS + ("f-score-02", "f-score-outdoor")
    THRESHOLDS = {"f-score": 0.01, "f-score-15": 0.015, "f-score-20": 0.02,
                  "f-score-02": 0.002, "f-score-outdoor": 0.1}
    N_POINTS_OBJECT = 500_000
    N_POINTS_SCENE = 5_000_000

    def __init__(self, n_points: int = N_POINTS_OBJECT,
                 metric_names: Sequence[str] = ESSENTIAL_METRICS,
                 seed: int = 0):
        self.n_points = n_points
        self.metric_names = tuple(metric_names)
        self.rng = np.random.default_rng(seed)

    def eval_mesh(self, mesh, ref_xyz: np.ndarray,
                  ref_normal: Optional[np.ndarray] = None,
                  onet_samples=None) -> Dict[str, float]:
        """Metrics of ``mesh`` (``.v``, ``.f``) against the reference
        cloud; ``onet_samples`` (points, occupancy) adds "iou"."""
        v = np.asarray(mesh.v, np.float32)
        f = np.asarray(mesh.f, np.int64)
        pd_pts, pd_nrm = sample_mesh(v, f, self.n_points, self.rng)
        if pd_pts.shape[0] == 0:
            return {m: float("nan") for m in self.metric_names}
        out: Dict[str, float] = {}
        ref_xyz = np.asarray(ref_xyz, np.float32)
        ref_nrm = None if ref_normal is None else np.asarray(ref_normal,
                                                             np.float32)
        if ref_xyz.shape[0] > self.n_points:
            sel = self.rng.choice(ref_xyz.shape[0], self.n_points,
                                  replace=False)
            ref_xyz = ref_xyz[sel]
            ref_nrm = None if ref_nrm is None else ref_nrm[sel]

        d_p2g, i_p2g = _nn(pd_pts, ref_xyz)    # prediction -> GT (accuracy)
        d_g2p, i_g2p = _nn(ref_xyz, pd_pts)    # GT -> prediction (complete)
        out["chamfer-L1"] = float(0.5 * (d_p2g.mean() + d_g2p.mean()))
        out["chamfer-L2"] = float(0.5 * ((d_p2g ** 2).mean()
                                         + (d_g2p ** 2).mean()))
        for name, thr in self.THRESHOLDS.items():
            if name not in self.metric_names:
                continue
            precision = (d_p2g < thr).mean()
            recall = (d_g2p < thr).mean()
            out[name] = float(2 * precision * recall
                              / (precision + recall + 1e-12))
        if "normals" in self.metric_names and ref_nrm is not None:
            dots1 = np.abs(np.sum(pd_nrm * ref_nrm[i_p2g], axis=1))
            dots2 = np.abs(np.sum(ref_nrm * pd_nrm[i_g2p], axis=1))
            out["normals"] = float(0.5 * (dots1.mean() + dots2.mean()))
        if onet_samples is not None:
            pts, occ_gt = onet_samples
            side = raycast_inside(v, f.astype(np.int32),
                                  np.asarray(pts, np.float32))
            occ_gt = np.asarray(occ_gt) > 0.5
            inter = np.logical_and(side, occ_gt).sum()
            union = np.logical_or(side, occ_gt).sum()
            out["iou"] = float(inter / (union + 1e-6))
        return out
