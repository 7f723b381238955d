"""The neural field the UDF mask head reads (counterpart of
nksr_tpu/fields/neural_field.py ``NeuralField``, host-orchestrated form).

``f(x) = decoder(sum_d sum_c w_c(x) feat_d[sup_d(x, c)])``: per depth the
trilinear weights of the 8 voxel centers around x times their feature
rows, summed over the depths, then the MLP decoder.  The support rows
``sup_d`` come from the host join (``core/host_build.support_indices``)
over the hierarchy the features live on; an absent row (-1) adds
nothing, so a point with no support reads ``decoder(0)``.  With a level
set the field is a mask: ``evaluate_mask(x) = level_set - f(x)``, a
point passing where it is positive (near the surface, for a UDF).

The pool is a gather and a weighted sum (no scatter), so it is the same
from call to call on every device.  ``PCNNField`` (texture) is ROADMAP
item 17; the union-of-support mask of ``recon/host_field.py`` plays the
JAX package's ``LayerField``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import host_build as HB
from ..core.grid import point_splat_coords
from ..models.network import MLP
from ..ops.gather_scatter import take_rows


class NeuralField:
    """Per-depth voxel sizes (as the device holds them) and feature rows
    ``features[d]`` (cap_d, C), the ``decoder`` MLP (C -> 1) and a level
    set (f32); optionally the host grids the features live on, with
    which ``host_supports`` joins arbitrary points."""

    def __init__(self, voxel_sizes: Sequence[float],
                 features: Sequence[torch.Tensor], decoder: MLP,
                 level_set: float = 0.0, host_grids=None):
        self.voxel_sizes = tuple(float(v) for v in voxel_sizes)
        self.features = tuple(features)
        self.decoder = decoder
        self.level_set = float(np.float32(level_set))
        self.host_grids: Optional[tuple] = \
            None if host_grids is None else tuple(host_grids)

    def host_supports(self, x: np.ndarray):
        """Per depth the (n, 8) support rows of world points ``x`` (f32
        numpy) in the host grids, on the features' device."""
        if self.host_grids is None:
            raise ValueError("this NeuralField carries no host grids")
        caps = [len(g.keys) for g in self.host_grids]
        dev = self.features[0].device
        return tuple(torch.as_tensor(t.astype(np.int64), device=dev)
                     for t in HB.support_indices(self.host_grids, caps, x))

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

    def evaluate_f(self, x: torch.Tensor, sup_idx) -> torch.Tensor:
        """(n,) field values; differentiable in the features and the
        decoder under autograd (the training forward's UDF loss)."""
        return self.decoder(self.pooled(x, sup_idx))[..., 0]

    def to(self, device) -> "NeuralField":
        """Move the feature rows to ``device`` in place (the decoder stays
        with the network)."""
        self.features = tuple(f.to(device) for f in self.features)
        return self

    def set_level_set(self, v: float) -> "NeuralField":
        return NeuralField(self.voxel_sizes, self.features, self.decoder, v,
                           self.host_grids)

    def evaluate_mask(self, x: torch.Tensor, sup_idx) -> torch.Tensor:
        """(n,) ``level_set - f(x)``: positive where the mask passes."""
        return self.level_set - self.evaluate_f(x, sup_idx)
