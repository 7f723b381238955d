"""Sparse basis-support evaluation of the support-row kernel field
(counterpart of nksr_tpu/fields/support.py).

For a query x and depth d, the supporting DoF are the ``kernel_dim``
basis functions of each of the 8 voxels whose centers surround x.  Each
basis is ``raw(x_loc, F_v) * window(x_loc)``, with the learned ``raw =
1 + MLP`` and the C1 window ``prod_a (1 - t_a^2)^2`` on ``|t| < 1``.
The support rows of a query are host-built (``core/host_build.
support_indices``); the device does gathers, the interpolator MLP and
scatter-adds that sum each coefficient's rows in a fixed order
(``scatter_orders``, built once per solve, and ``ops/segment_sum``).

Layouts follow the JAX package's public ones, so tests compare like with
like: ``idx_k (Q, 8K)`` flat-DoF indices, ``basis (Q, 8K)``, ``dbasis
(Q, 3 * 8K)`` as [d/dx | d/dy | d/dz] blocks, and flat coefficient
vectors (C_d * K,).

Everything here is differentiable in the basis features and the
interpolator MLPs (training); the gathers' backwards are fixed-order
(``ops/gather_scatter.gather_rows``).

Gradient rows take the window and its gradient from
``ops/window_basis.window_and_grad_fused``: the CUDA kernel on the card,
its plain version on the CPU.  Value rows keep the plain ``window``, as
the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grid import grid_to_world, point_splat_coords, world_to_grid
from ..models.network import MLP, Interpolators, mlp_with_tangents
from ..ops import segment_sum as SEG
from ..ops.gather_scatter import gather_rows, take_rows
from ..ops.window_basis import window_and_grad_fused
from ..ops.window_basis import window_and_grad_plain as window_and_grad

# the interpolators' handle: a torch module carries its own parameters,
# so the network's ``Interpolators`` (``level(d)`` its MLP at depth d) is
# the handle itself (the JAX package's ``InterpolatorFn``)
InterpolatorFn = Interpolators

# queries per support chunk.  The JAX package's 2^15 bounded the TPU's
# lane-padded temporaries; on the card a gradient chunk holds about
# 4 KB of MLP and tangent temporaries a query, so 2^20 queries keep it
# near 4 GB while a 100 m tile's 2.3M gradient rows take 3 chunks a
# depth (at 2^15 they would take 70, each a separate window launch).
_MLP_CHUNK = 1 << 20

__all__ = ["window", "window_and_grad", "DepthSupport", "depth_support",
           "svh_support", "predict", "scatter_order", "scatter_orders",
           "scatter_rows", "diag_contrib"]


def window(x_loc: torch.Tensor) -> torch.Tensor:
    """C1 bump: prod_a (max(0, 1 - t_a^2))^2, (..., 3) -> (...)."""
    t = torch.clamp(1.0 - x_loc * x_loc, min=0.0)
    s = t * t
    return s[..., 0] * s[..., 1] * s[..., 2]


class DepthSupport(NamedTuple):
    idx_k: torch.Tensor            # (Q, 8K) int64 flat-DoF indices, -1 absent
    basis: torch.Tensor            # (Q, 8K) f32
    dbasis: Optional[torch.Tensor]  # (Q, 3 * 8K) f32 [dx | dy | dz]
    kernel_dim: int


def _expand_idx(idx: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, 8) voxel rows -> (Q, 8K) flat-DoF indices (row * K + k), -1
    kept."""
    base = idx[:, :, None] * k + torch.arange(k, device=idx.device)
    base = torch.where(idx[:, :, None] >= 0, base, -1)
    return base.reshape(idx.shape[0], 8 * k)


def depth_support(voxel_size: float, features: torch.Tensor, mlp: MLP,
                  x: torch.Tensor, idx: torch.Tensor, grad: bool = False,
                  approx_grad: bool = False) -> DepthSupport:
    """Support of (Q, 3) world points at one depth with voxel size
    ``voxel_size``, from the host rows ``idx`` (Q, 8) into
    ``features`` (cap_d, Cb)."""
    q = x.shape[0]
    k = mlp.layers()[-1].out_features
    sk = 8 * k
    inv_vs = float(np.float32(1.0) / np.float32(voxel_size))
    basis = x.new_empty((q, sk))
    dbasis = x.new_empty((q, 3 * sk)) if grad else None
    for s in range(0, q, _MLP_CHUNK):
        xb, idxb = x[s:s + _MLP_CHUNK], idx[s:s + _MLP_CHUNK]
        r = xb.shape[0]
        corner, _ = point_splat_coords(voxel_size, xb)
        z0 = world_to_grid(xb[:, None, :] - grid_to_world(corner, voxel_size),
                           voxel_size)
        fv = take_rows(features, idxb)                       # (R, 8, Cb)
        act = (idxb >= 0).repeat_interleave(k, -1)           # (R, 8K)
        xin = torch.cat([z0, fv], -1)
        if not grad:
            raw, _ = mlp_with_tangents(mlp, xin, 0)
            b = (raw * window(z0)[..., None]).reshape(r, sk)
            basis[s:s + r] = torch.where(act, b, 0.0)
            continue
        w, dw = window_and_grad_fused(z0.contiguous())
        raw, draws = mlp_with_tangents(mlp, xin, 0 if approx_grad else 3)
        b = (raw * w[..., None]).reshape(r, sk)
        basis[s:s + r] = torch.where(act, b, 0.0)
        for a in range(3):
            db = raw * dw[..., a:a + 1]
            if not approx_grad:
                db = db + draws[a] * w[..., None]
            dbasis[s:s + r, a * sk:(a + 1) * sk] = torch.where(
                act, (db * inv_vs).reshape(r, sk), 0.0)
    return DepthSupport(_expand_idx(idx, k), basis, dbasis, k)


def svh_support(voxel_sizes: Sequence[float],
                features: Sequence[torch.Tensor], mlps: Sequence[MLP],
                x: torch.Tensor, sup_idx: Sequence[torch.Tensor],
                grad: bool = False, approx_grad: bool = False
                ) -> Tuple[DepthSupport, ...]:
    """Per-depth supports from host rows ``sup_idx[d]`` (Q, 8)."""
    return tuple(depth_support(vs, f, m, x, i, grad, approx_grad)
                 for vs, f, m, i in zip(voxel_sizes, features, mlps, sup_idx))


def _coeff_rows(a: torch.Tensor, idx_k: torch.Tensor) -> torch.Tensor:
    av = gather_rows(a, idx_k.clamp(min=0), order_idx=idx_k)
    return torch.where(idx_k >= 0, av, 0.0)


def predict(sup: Sequence[DepthSupport], alpha: Sequence[torch.Tensor],
            grad: bool = False):
    """f(x) (and grad f) from per-depth supports and flat coefficient
    vectors (C_d * K,)."""
    val, g = 0.0, 0.0
    for s, a in zip(sup, alpha):
        q, sk = s.basis.shape
        av = _coeff_rows(a, s.idx_k)                       # (Q, 8K)
        val = val + (s.basis * av).sum(-1)
        if grad:
            g = g + torch.einsum("qcs,qs->qc", s.dbasis.view(q, 3, sk), av)
    return (val, g) if grad else val


def scatter_order(s: DepthSupport, n_flat: int) -> SEG.SegmentOrder:
    """The fixed summation order of a support's (Q, 8K) contributions onto
    the n_flat = C_d * K flat coefficients, per voxel: row (q, corner) of
    K values goes to voxel ``idx_k[q, corner * K] // K``, an absent corner
    is dropped.  It depends on the host support rows only, so a solve
    builds it once."""
    k = s.kernel_dim
    vox = s.idx_k.reshape(s.idx_k.shape[0], 8, k)[..., 0] // k  # -1 stays
    return SEG.segment_order(vox, n_flat // k)


def _scatter(s: DepthSupport, n_flat: int, contrib: torch.Tensor,
             order: Optional[SEG.SegmentOrder] = None) -> torch.Tensor:
    """(Q, 8K) contributions summed onto the flat coefficients, each
    coefficient over its rows in (query, corner) order from 0.0 (the
    fixed-order segment sum on the card, CPU ``index_add_`` here)."""
    k = s.kernel_dim
    if order is None:
        order = scatter_order(s, n_flat)
    rows = contrib.reshape(-1, k)
    return SEG.segment_sum(rows.contiguous(), order).reshape(-1)


def scatter_orders(sup: Sequence[DepthSupport], shapes
                   ) -> Tuple[SEG.SegmentOrder, ...]:
    """``scatter_order`` of each depth's support."""
    return tuple(scatter_order(s, c * k) for s, (c, k) in zip(sup, shapes))


def scatter_rows(sup: Sequence[DepthSupport], shapes, weights_times_resid,
                 grad: bool = False, orders=None) -> Tuple[torch.Tensor, ...]:
    """A^T w r: per-row residuals (Q,) for value rows or (Q, 3) for
    gradient rows accumulated onto the flat coefficients; ``shapes`` the
    per-depth (C_d, K); ``orders`` the supports' ``scatter_orders``
    (built here when None)."""
    out = []
    for i, (s, (c, k)) in enumerate(zip(sup, shapes)):
        q, sk = s.basis.shape
        if grad:
            contrib = torch.einsum("qcs,qc->qs", s.dbasis.view(q, 3, sk),
                                   weights_times_resid)
        else:
            contrib = s.basis * weights_times_resid[:, None]
        out.append(_scatter(s, c * k, contrib,
                            None if orders is None else orders[i]))
    return tuple(out)


def diag_contrib(sup: Sequence[DepthSupport], shapes, w: torch.Tensor,
                 grad: bool = False, orders=None) -> Tuple[torch.Tensor, ...]:
    """Jacobi diagonal: sum over rows of w * basis^2 per flat
    coefficient."""
    out = []
    for i, (s, (c, k)) in enumerate(zip(sup, shapes)):
        q, sk = s.basis.shape
        if grad:
            d3 = s.dbasis.view(q, 3, sk)
            sq = (d3 * d3).sum(1)
        else:
            sq = s.basis * s.basis
        out.append(_scatter(s, c * k, sq * w[:, None],
                            None if orders is None else orders[i]))
    return tuple(out)
