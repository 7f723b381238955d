"""The non-kernel fields (counterpart of nksr_tpu/fields/neural_field.py):
``NeuralField``, the UDF mask head and the ``geometry="neural"`` head,
and ``PCNNField``, the nearest-point texture field.

``NeuralField``: ``f(x) = decoder(sum_d sum_c w_c(x) feat_d[sup_d(x,
c)])``, per depth the trilinear weights of the 8 voxel centers around x
times their feature rows, summed over the depths, then the MLP decoder.
The support rows ``sup_d`` come from the host join
(``core/host_build.support_indices``) over the hierarchy the features
live on; an absent row (-1) adds nothing, so a point with no support
reads ``decoder(0)``.  With a level set the field is a mask:
``evaluate_mask(x) = level_set - f(x)``, a point passing where it is
positive (near the surface, for a UDF).  As the geometry head (the
decoder the network's ``sdf_decoder``, the features its basis features)
it has no coefficients (``alpha`` is None, so the in-graph mesher takes
no Newton step) and its x-gradient is autograd's, as the JAX package
takes it with ``jax.vjp``.  The pool is a gather and a weighted sum (no
scatter), so it is the same from call to call on every device.  The
union-of-support mask of ``HostJoinedField.evaluate_f_bar`` plays the
JAX package's ``LayerField``.

``PCNNField``: the attribute (colour) of the nearest reference point,
found in the 27 cells of a bucketing grid around the query, one
representative point (the smallest index) per cell.  The cells are
the sorted unique set of ``round(xyz / cell_size)`` under the JAX
package's two-word key order, cut at ``capacity`` (the smallest keys
stay), so the same cells, representatives and colours come out.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.grid import point_splat_coords, world_to_grid
from ..models.network import MLP
from ..ops.gather_scatter import take_rows
from .kernel_field import FieldEval, HostJoinedField


class NeuralField(HostJoinedField):
    """Per-depth voxel sizes (as the device holds them) and feature rows
    ``features[d]`` (cap_d, C), the ``decoder`` MLP (C -> 1) and a level
    set (f32); optionally the host grids the features live on (with
    which ``host_supports`` joins arbitrary points) and their
    capacities, and as a geometry head its ``adaptive_depth`` and
    ``mask_field`` (see ``HostJoinedField``)."""

    alpha = None

    def __init__(self, voxel_sizes: Sequence[float],
                 features: Sequence[torch.Tensor], decoder: MLP,
                 level_set: float = 0.0, host_grids=None,
                 capacities: Optional[Sequence[int]] = None,
                 adaptive_depth: int = 1, mask_field=None):
        self.voxel_sizes = tuple(float(v) for v in voxel_sizes)
        self.features = tuple(features)
        self.decoder = decoder
        self.level_set = float(np.float32(level_set))
        self.host_grids: Optional[tuple] = \
            None if host_grids is None else tuple(host_grids)
        self.capacities = None if capacities is None else \
            tuple(int(c) for c in capacities)
        self.adaptive_depth = int(adaptive_depth)
        self.mask_field = mask_field
        self.texture_field = None

    @property
    def device(self) -> torch.device:
        return self.features[0].device

    def pooled(self, x: torch.Tensor, sup_idx) -> torch.Tensor:
        """(n, C) trilinear pool of the feature rows at (n, 3) points, with
        ``sup_idx[d]`` (n, 8) int64 their support rows at depth d."""
        h = 0.0
        for d, vs in enumerate(self.voxel_sizes):
            _, w = point_splat_coords(vs, x)
            idx = sup_idx[d]
            w = torch.where(idx >= 0, w, 0.0)
            h = h + (w[..., None] * take_rows(self.features[d], idx)).sum(1)
        return h

    def _value(self, x: torch.Tensor, sup_idx) -> torch.Tensor:
        return self.decoder(self.pooled(x, sup_idx))[..., 0]

    def evaluate_f(self, x: torch.Tensor, sup_idx, grad: bool = False
                   ) -> FieldEval:
        """(n,) field values at (n, 3) points, differentiable in the
        features and the decoder under autograd; with ``grad`` also the
        (n, 3) x-gradient by autograd, itself differentiable (a graph of
        the gradient, for the normal loss) where grad mode is on, a plain
        tensor under ``torch.no_grad()``."""
        if not grad:
            return FieldEval(value=self._value(x, sup_idx))
        outer = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            v = self._value(xg, sup_idx)
            (g,) = torch.autograd.grad(v, xg, torch.ones_like(v),
                                       create_graph=outer)
        if not outer:
            v, g = v.detach(), g.detach()
        return FieldEval(value=v, gradient=g)

    def to(self, device) -> "NeuralField":
        """Move the feature rows, the mask and the texture to ``device``
        in place (the decoder stays with the network)."""
        self.features = tuple(f.to(device) for f in self.features)
        return self._move_parts(device)

    def set_level_set(self, v: float) -> "NeuralField":
        out = NeuralField(self.voxel_sizes, self.features, self.decoder, v,
                          self.host_grids, self.capacities,
                          self.adaptive_depth, self.mask_field)
        out.texture_field = self.texture_field
        return out

    def evaluate_mask(self, x: torch.Tensor, sup_idx) -> torch.Tensor:
        """(n,) ``level_set - f(x)``: positive where the mask passes."""
        return self.level_set - self.evaluate_f(x, sup_idx).value


# ------------------------------------------------------------------ texture
_OFF = 1 << 15
_M32 = 0xFFFFFFFF
_INVALID = -1


def _key(ijk: torch.Tensor):
    """(..., 3) int64 cells -> (int64 keys in the JAX package's (hi, lo)
    uint32 word order, the hi words).  The words wrap as uint32 do
    (``nksr_tpu/core/coords.pack``); the key is ``(hi - 2^31) * 2^32 +
    lo``, which orders as (hi, lo) and fits int64."""
    u = (ijk + _OFF) & _M32
    hi = ((u[..., 0] << 16) & _M32) | u[..., 1]
    return (hi - (1 << 31)) * (1 << 32) + u[..., 2], hi


def _lookup(cells: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Index of each key ``q`` in the sorted unique ``cells``, -1 where
    absent."""
    if cells.numel() == 0:
        return torch.full_like(q, _INVALID)
    pos = torch.searchsorted(cells, q)
    pc = pos.clamp(max=cells.numel() - 1)
    return torch.where((pos < cells.numel()) & (cells[pc] == q), pc,
                       _INVALID)


def _offsets27(device) -> torch.Tensor:
    r = np.arange(-1, 2)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return torch.as_tensor(offs, dtype=torch.int64, device=device)


class PCNNField:
    """Nearest-point attribute (colour) field over a reference cloud:
    ``xyz`` (N, 3) and ``attr`` (N, C) the points, ``cells`` the sorted
    bucket keys (at most ``capacity``), ``cell_point`` the smallest
    point index of each cell, ``cell_size`` the bucket size.  Queries
    go in waves of ``WAVE`` points (a wave holds about 2 KB a point)."""

    WAVE = 1 << 20

    def __init__(self, xyz: torch.Tensor, attr: torch.Tensor,
                 cells: torch.Tensor, cell_point: torch.Tensor,
                 cell_size: float):
        self.xyz, self.attr = xyz, attr
        self.cells, self.cell_point = cells, cell_point
        self.cell_size = float(cell_size)

    @staticmethod
    def build(xyz: torch.Tensor, attr: torch.Tensor, mask: torch.Tensor,
              cell_size: float, capacity: int) -> "PCNNField":
        """The field over the points where ``mask`` holds: their bucket
        cells ``round(xyz / cell_size)`` (round half to even, f32
        division), the first ``capacity`` of the sorted unique cells, and
        per cell its smallest point index.  Tensors on one device."""
        key, hi = _key(torch.round(world_to_grid(xyz, cell_size)).long())
        valid = mask.bool() & (hi != _M32)
        cells = torch.unique(key[valid])[:int(capacity)]
        idx = _lookup(cells, key)
        n = cells.numel()
        seg = torch.where(mask.bool() & (idx >= 0), idx, n)
        order = torch.arange(xyz.shape[0], device=xyz.device)
        cell_point = torch.full((n + 1,), torch.iinfo(torch.int64).max,
                                dtype=torch.int64, device=xyz.device)
        cell_point = cell_point.scatter_reduce(0, seg, order, "amin")[:n]
        return PCNNField(xyz, attr, cells, cell_point, cell_size)

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def to(self, device) -> "PCNNField":
        """Move the points, attributes and cells to ``device`` in place."""
        for name in ("xyz", "attr", "cells", "cell_point"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    def _nearest(self, x: torch.Tensor) -> torch.Tensor:
        """Index of each query's nearest representative among the 27
        cells around ``round(x / cell_size)`` (a tie to the first cell in
        ``meshgrid(-1..1, indexing="ij")`` order), -1 where none."""
        if self.cells.numel() == 0:
            return torch.full((x.shape[0],), _INVALID, dtype=torch.int64,
                              device=x.device)
        ijk = torch.round(world_to_grid(x, self.cell_size)).long()
        key, _ = _key(ijk[:, None, :] + _offsets27(x.device)[None])
        cidx = _lookup(self.cells, key)                        # (Q, 27)
        pidx = torch.where(cidx >= 0,
                           self.cell_point[cidx.clamp(min=0)], _INVALID)
        cand = self.xyz[pidx.clamp(min=0)]                     # (Q, 27, 3)
        d = cand - x[:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        d2 = torch.where(pidx >= 0, d2, float("inf"))
        best = torch.argmin(d2, dim=1, keepdim=True)
        return pidx.gather(1, best)[:, 0]

    def nearest(self, x: torch.Tensor) -> torch.Tensor:
        """``_nearest`` in waves of ``WAVE`` queries."""
        return torch.cat([self._nearest(x[i:i + self.WAVE])
                          for i in range(0, max(x.shape[0], 1), self.WAVE)])

    def evaluate_f(self, x: torch.Tensor) -> FieldEval:
        """(Q, C) attributes of the nearest representatives of (Q, 3)
        queries, zeros where none is in the 27 cells."""
        x = torch.as_tensor(x, device=self.device)
        bidx = self.nearest(x)
        val = torch.where((bidx >= 0)[:, None],
                          self.attr[bidx.clamp(min=0)], 0.0)
        return FieldEval(value=val)
