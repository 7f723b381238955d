"""Grid-bucket k-nearest-neighbour search and PCA normal estimation
(counterpart of nksr_tpu/ops/knn.py): the preprocess behind
``get_estimate_normal_preprocess_fn(knn, max_angle)``, kNN-PCA normals
flipped toward the sensor, grazing points dropped.

A bucketing grid with a fixed per-cell slot table: each query gathers
the 27 surrounding cells' candidates and keeps the k nearest.  Points
past ``max_per_cell`` in a cell are left out of its slots, the first
ones by point index kept (a stable sort), as in the JAX package, so the
neighbour sets are the same.  The JAX package's hashed ``SparseGrid`` is
a sorted table of packed cell keys here (``torch.unique``, then
``torch.searchsorted``); the sets do not depend on how cells are
numbered.  Queries run in waves of ``_WAVE`` (independent, so the result
is one pass's): one pass over 1M points at k = 64 would gather
(1M, 378, 3) f32 candidates.

The JAX package has no Pallas kernel here (gathers, ``top_k`` and a
batched ``eigh`` in plain jnp), so this stays plain PyTorch on the
device the points lie on; the 3x3 eigenproblem is solved in closed form
(``pca_normals`` says why).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import PhaseTimer

# queries a kNN wave (about 20 KB of candidates and temporaries each at
# max_per_cell 14)
_WAVE = 1 << 16
# packed cell keys: 21 bits an axis, coordinates offset by 2^20
_KEY_BITS = 21
_KEY_OFF = 1 << 20


class BucketTable(NamedTuple):
    keys: torch.Tensor       # (C,) sorted packed cell keys
    slots: torch.Tensor      # (C, max_per_cell) point indices, -1 empty
    cell_size: torch.Tensor  # () f32, on the points' device


def _cells(x: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    """``round(x / cell_size)`` as int64: a correctly rounded f32
    division (the divisor on the device; CUDA would multiply by the
    reciprocal of a host scalar), rounding half to even as jnp.round."""
    return torch.round(x / cell_size).long()


def _pack(ijk: torch.Tensor) -> torch.Tensor:
    k = ijk + _KEY_OFF
    return (k[..., 0] << (2 * _KEY_BITS)) | (k[..., 1] << _KEY_BITS) \
        | k[..., 2]


def _lookup(table: BucketTable, ijk: torch.Tensor) -> torch.Tensor:
    """Row of each cell in the table, -1 where it holds no point."""
    key = _pack(ijk)
    pos = torch.searchsorted(table.keys, key).clamp(max=len(table.keys) - 1)
    return torch.where(table.keys[pos] == key, pos, -1)


def build_buckets(xyz: torch.Tensor, cell_size: float,
                  max_per_cell: int) -> BucketTable:
    cs = xyz.new_full((), cell_size)
    ijk = _cells(xyz, cs)
    if len(ijk) and int(ijk.abs().max()) >= _KEY_OFF - 1:
        raise ValueError("kNN bucket coordinates exceed the key's 21 bits "
                         "an axis: recentre the cloud or raise cell_size")
    keys, cid = torch.unique(_pack(ijk), return_inverse=True)
    # stable sort of the points by cell: rank within a cell follows the
    # point index, so a full cell keeps its first max_per_cell points
    cid_sorted, order = torch.sort(cid, stable=True)
    counts = torch.bincount(cid, minlength=len(keys))
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(cid), device=xyz.device) - start[cid_sorted]
    ok = rank < max_per_cell
    slots = torch.full((len(keys) * max_per_cell,), -1, dtype=torch.int64,
                       device=xyz.device)
    slots[cid_sorted[ok] * max_per_cell + rank[ok]] = order[ok]
    return BucketTable(keys, slots.view(len(keys), max_per_cell), cs)


def _neighbour_offsets(device) -> torch.Tensor:
    """(27, 3) cell offsets in the JAX package's (meshgrid "ij") order,
    which fixes the candidates' order and so the ties."""
    r = np.arange(-1, 2)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return torch.as_tensor(offs, device=device)


def knn_search(table: BucketTable, xyz_ref: torch.Tensor,
               queries: torch.Tensor, k: int):
    """k nearest reference points for each query: (idx (Q, k) int64 with
    -1 padding, dist2 (Q, k) f32 with inf).  Ties go to the earlier
    candidate (a stable sort), as ``jax.lax.top_k`` breaks them."""
    offs = _neighbour_offsets(queries.device)
    m = table.slots.shape[1]
    idx_out = torch.empty((len(queries), k), dtype=torch.int64,
                          device=queries.device)
    d2_out = torch.empty((len(queries), k), device=queries.device)
    for s in range(0, len(queries), _WAVE):
        q = queries[s:s + _WAVE]
        cidx = _lookup(table, _cells(q, table.cell_size)[:, None, :] + offs)
        cand = torch.where(cidx[..., None] >= 0,
                           table.slots[cidx.clamp(min=0)], -1
                           ).view(len(q), 27 * m)
        d = xyz_ref[cand.clamp(min=0)] - q[:, None, :]
        # summed left to right, as XLA reduces the three terms
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        d2 = torch.where(cand >= 0, d2, torch.inf)
        d2s, o = torch.sort(d2, dim=1, stable=True)
        d2k = d2s[:, :k]
        idx_out[s:s + len(q)] = torch.where(
            torch.isfinite(d2k), torch.gather(cand, 1, o[:, :k]), -1)
        d2_out[s:s + len(q)] = d2k
    return idx_out, d2_out


def estimate_cell_size(xyz: np.ndarray, k: int) -> float:
    """Pick a bucket cell size so ~k candidates fall in the 27-cell hood.

    Point clouds are usually surface-like (locally 2-D), so estimate from
    the two largest bbox extents; degenerate (flat/linear) data stays
    well-conditioned.
    """
    n = max(xyz.shape[0], 1)
    ext = np.sort(np.maximum(np.ptp(xyz, axis=0), 1e-9))[::-1]
    if ext[2] < 0.05 * ext[0]:  # essentially planar
        area = ext[0] * ext[1]
        return float(np.sqrt(k * area / n))
    vol = float(np.prod(ext))
    return float((k * vol / n) ** (1.0 / 3.0))


def _smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each symmetric 3x3
    matrix, in closed form and float64: the eigenvalue by Smith's
    trigonometric formula, the vector as the longest cross product of
    two rows of ``cov - lambda I``.  A matrix with no such row pair (a
    multiple of the identity, e.g. zero) reads (1, 0, 0), the first
    column LAPACK's ``eigh`` returns there.  Where the two smallest
    eigenvalues nearly coincide the vector is any of their plane, as
    with ``eigh``."""
    a = cov.double()
    d0, d1, d2 = a[:, 0, 0], a[:, 1, 1], a[:, 2, 2]
    o01, o02, o12 = a[:, 0, 1], a[:, 0, 2], a[:, 1, 2]
    q = (d0 + d1 + d2) / 3
    p = torch.sqrt(((d0 - q) ** 2 + (d1 - q) ** 2 + (d2 - q) ** 2
                    + 2 * (o01 * o01 + o02 * o02 + o12 * o12)) / 6)
    ps = torch.where(p > 0, p, 1.0)
    b0, b1, b2 = (d0 - q) / ps, (d1 - q) / ps, (d2 - q) / ps
    c01, c02, c12 = o01 / ps, o02 / ps, o12 / ps
    det = b0 * (b1 * b2 - c12 * c12) - c01 * (c01 * b2 - c12 * c02) \
        + c02 * (c01 * c12 - b1 * c02)
    phi = torch.acos((det / 2).clamp(-1.0, 1.0)) / 3
    lam = q + 2 * p * torch.cos(phi + 2 * np.pi / 3)
    m = a - lam[:, None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = m[:, 0], m[:, 1], m[:, 2]
    c = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                     torch.linalg.cross(r1, r2)], 1)          # (Q, 3, 3)
    n2 = (c * c).sum(-1)
    best = n2.argmax(1, keepdim=True)
    v = torch.gather(c, 1, best[..., None].expand(-1, 1, 3))[:, 0]
    norm = torch.sqrt(torch.gather(n2, 1, best))
    first = torch.zeros_like(v)
    first[:, 0] = 1.0
    return torch.where(norm > 0, v / torch.where(norm > 0, norm, 1.0),
                       first).float()


def pca_normals(xyz: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Smallest-eigenvector normal of each point's neighbour covariance
    (sign arbitrary, as ``eigh``'s), in waves of ``_WAVE`` queries.  The
    JAX package calls a batched ``eigh``; cuSOLVER's batched solver
    (``cusolverDnXsyevBatched``, which ``torch.linalg.eigh`` calls for
    these batches) refuses them on an H100 (CUSOLVER_STATUS_INVALID_VALUE
    at 65,536 and at 1M matrices), so the 3x3 problem is solved in closed
    form, the same code on every device."""
    out = torch.empty((len(nbr_idx), 3), device=xyz.device)
    for s in range(0, len(nbr_idx), _WAVE):
        idx = nbr_idx[s:s + _WAVE]
        w = (idx >= 0)[..., None].to(xyz.dtype)
        p = xyz[idx.clamp(min=0)]                            # (Q, k, 3)
        cnt = torch.clamp(w.sum(1), min=1.0)
        mean = (p * w).sum(1) / cnt
        d = (p - mean[:, None, :]) * w
        cov = torch.einsum("qki,qkj->qij", d, d) / cnt[:, None]
        out[s:s + len(idx)] = _smallest_eigenvector(cov)
    return out


def estimate_normals(xyz: torch.Tensor, k: int, cell_size: float,
                     max_per_cell: int,
                     sensor: Optional[torch.Tensor] = None,
                     max_angle_deg: float = 85.0,
                     tm: Optional[PhaseTimer] = None):
    """The normal-estimation preprocess on every point of ``xyz``.

    Returns (normal (N, 3), keep (N,) bool): normals oriented toward the
    sensor, grazing points (angle over ``max_angle_deg``) dropped from
    ``keep``.  Without ``sensor`` the normals keep PCA's sign and every
    point is kept.  ``tm`` (a ``PhaseTimer``) splits the time into
    "knn: buckets", "knn: waves", "knn: pca eigh" and "knn: orientation".
    """
    def lap(name):
        if tm is not None:
            tm.lap(name)

    table = build_buckets(xyz, cell_size, max_per_cell)
    lap("knn: buckets")
    idx, _ = knn_search(table, xyz, xyz, k)
    del table
    lap("knn: waves")
    normal = pca_normals(xyz, idx)
    del idx
    lap("knn: pca eigh")
    keep = torch.ones(len(xyz), dtype=torch.bool, device=xyz.device)
    if sensor is not None:
        view = sensor - xyz
        view = view / (torch.linalg.norm(view, dim=-1, keepdim=True) + 1e-6)
        cos = (view * normal).sum(-1)
        normal = torch.where(cos[:, None] < 0.0, -normal, normal)
        keep = cos.abs() > torch.cos(torch.deg2rad(
            xyz.new_full((), max_angle_deg)))
    lap("knn: orientation")
    return normal, keep
