"""Signed distance from an oriented point cloud, the GT targets of the
training losses (counterpart of nksr_tpu/ops/sdf.py): kNN over the
bucket table of ``ops/knn.py``, then one of the reference's two
estimators.

* ``imls=True``: implicit moving least squares, Gaussian weights
  ``exp(-|q-p|^2/sigma^2)`` with the smallest exponent subtracted, value
  ``sum w (q-p).n / sum w`` (gradient ``sum w n / sum w``); with
  ``adaptive_knn`` the bandwidth widens with the neighbours' spread, as
  the JAX package's extension does.
* ``imls=False``: the majority vote, magnitude from the nearest
  neighbour (plane or euclidean distance by ``stdv * ref_std``), sign by
  the plane sides of the k neighbours.

Positive outside, as the reference extension; callers negate.  Every
operation is a gather and a per-query reduction, so the JAX package had
no kernel here and this is plain PyTorch on the points' device.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import knn as K


def _imls(queries, p, n, d2, valid, stdv: float, adaptive_sigma: bool,
          compute_grad: bool):
    diff = queries[:, None, :] - p
    plane = (diff * n).sum(-1)
    d2 = torch.where(valid, d2, torch.inf)
    if adaptive_sigma:
        spread = torch.where(valid, d2, 0.0).mean(1) / \
            valid.sum(1).clamp(min=1)
        sigma2 = spread.clamp(min=stdv ** 2)
    else:
        sigma2 = queries.new_full((queries.shape[0],), stdv ** 2)
    e = d2 / sigma2[:, None]
    e_min = torch.where(valid, e, torch.inf).min(1, keepdim=True).values
    w = torch.where(valid, torch.exp(-(e - torch.where(
        torch.isfinite(e_min), e_min, 0.0))), 0.0)
    wsum = w.sum(1)
    sdf = (w * plane).sum(1) / (wsum + 1e-12)
    far = torch.sqrt(d2.min(1).values)
    sdf = torch.where(wsum > 1e-10, sdf,
                      torch.where(torch.isfinite(far), far, 1e3))
    if not compute_grad:
        return sdf
    grad = (w[..., None] * n).sum(1) / (wsum[:, None] + 1e-12)
    return sdf, grad


def _vote(queries, p, n, d2, valid, stdv: float, ref_std_nn,
          compute_grad: bool):
    diff = queries[:, None, :] - p
    plane = (diff * n).sum(-1)
    d0 = torch.sqrt(d2[:, 0].clamp(min=0.0))
    near = d0 < stdv * ref_std_nn
    mag = torch.where(near, plane[:, 0].abs(), d0)
    pos = ((plane > 0) & valid).sum(1)
    kv = valid.sum(1).clamp(min=1)
    inside = pos <= kv // 2
    sdf = torch.where(inside, -mag, mag)
    any_valid = valid[:, 0]
    sdf = torch.where(any_valid, sdf, 1e3)
    if not compute_grad:
        return sdf
    g_plane = torch.where(plane[:, 0:1] > 0, n[:, 0], -n[:, 0])
    g_ray = diff[:, 0] / d0.clamp(min=1e-12)[:, None]
    grad = torch.where(near[:, None], g_plane, g_ray)
    grad = torch.where(inside[:, None], -grad, grad)
    grad = torch.where(any_valid[:, None], grad, 0.0)
    return sdf, grad


def reference_self_std(table: K.BucketTable, ref_xyz: torch.Tensor,
                       adaptive_knn: int) -> torch.Tensor:
    """Mean distance of each reference point to its ``adaptive_knn``
    nearest reference points, itself included."""
    _, d2 = K.knn_search(table, ref_xyz, ref_xyz, adaptive_knn)
    fin = torch.isfinite(d2)
    d = torch.sqrt(torch.where(fin, d2, 0.0).clamp(min=0.0))
    return d.sum(1) / fin.sum(1).clamp(min=1)


def sdf_from_points(queries: torch.Tensor, ref_xyz: torch.Tensor,
                    ref_normal: torch.Tensor,
                    table: Optional[K.BucketTable] = None,
                    nb_points: int = 8, stdv: float = 0.02,
                    compute_grad: bool = False, imls: bool = True,
                    adaptive_knn: Optional[int] = 8,
                    ref_std: Optional[torch.Tensor] = None,
                    cell_size: Optional[float] = None,
                    max_per_cell: int = 16):
    """Signed distance of (Q, 3) queries to the oriented cloud
    ``ref_xyz`` / ``ref_normal`` (its real points only; the JAX
    package's padding rows and mask have no counterpart), positive
    outside; with ``compute_grad`` also its gradient.  ``table``: the
    cloud's bucket table (built here from ``cell_size`` when None)."""
    if table is None:
        if cell_size is None:
            raise ValueError("sdf_from_points: pass a table or a cell_size")
        table = K.build_buckets(ref_xyz, cell_size, max_per_cell)
    idx, d2 = K.knn_search(table, ref_xyz, queries, nb_points)
    valid = idx >= 0
    safe = idx.clamp(min=0)
    p, n = ref_xyz[safe], ref_normal[safe]
    if imls:
        return _imls(queries, p, n, d2, valid, stdv,
                     adaptive_sigma=bool(adaptive_knn),
                     compute_grad=compute_grad)
    if ref_std is None:
        ref_std = reference_self_std(table, ref_xyz, adaptive_knn) \
            if adaptive_knn else ref_xyz.new_ones(ref_xyz.shape[0])
    return _vote(queries, p, n, d2, valid, stdv, ref_std[safe[:, 0]],
                 compute_grad)
