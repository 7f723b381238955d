"""Gather building blocks of the sparse voxel convolutions (counterpart of
nksr_tpu/ops/gather_scatter.py): a convolution is a gather of each row's
stencil neighbours through a host-built table, then a matmul.

The matmuls are ``torch.matmul``: XLA computed them in the JAX package,
no TPU kernel did.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# rows per gather-conv chunk: the (rows, 27 * Cin) f32 gather of a
# 32-map conv is 3.4 KB a row, so 2^17 rows hold 450 MB of temporaries
_CONV_ROWS = 1 << 17


def stencil_offsets(size: int = 3) -> np.ndarray:
    """(size^3, 3) int32 offsets, e.g. the 27-point cube for size=3."""
    r = np.arange(size) - (size - 1) // 2
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return offs.reshape(-1, 3).astype(np.int32)


def child_offsets() -> np.ndarray:
    """(8, 3) int32 offsets of the 2x2x2 children of a parent voxel."""
    r = np.arange(2)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return offs.reshape(-1, 3).astype(np.int32)


def octant_id(coords: torch.Tensor) -> torch.Tensor:
    """Which of the 8 child slots a voxel occupies within its parent."""
    o = coords - torch.div(coords, 2, rounding_mode="floor") * 2
    return o[..., 0] * 4 + o[..., 1] * 2 + o[..., 2]


def take_rows(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``feat`` at ``idx``; idx < 0 yields zeros."""
    out = feat.index_select(0, idx.clamp(min=0).reshape(-1))
    out = out.reshape(*idx.shape, feat.shape[-1])
    return torch.where((idx >= 0)[..., None], out, 0.0)


def gather_conv(feat: torch.Tensor, nbr: torch.Tensor,
                weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse submanifold convolution: out[i] = sum_o W[o] @ feat[nbr[i,o]].

    feat (N, Cin) in the compute dtype; nbr (N, K), -1 for a missing
    neighbour; weights (K, Cin, Cout).  The neighbours are gathered in
    the compute dtype, every product and the sum over all K taps is f32
    (a bf16 product is exact in f32), and the sum plus ``bias`` is
    rounded once to ``feat.dtype``, as the JAX package's per-tap f32
    accumulation does.  Rows go in chunks of one (rows, K * Cin) gather
    and one matmul each."""
    n, k = nbr.shape
    cin, cout = weights.shape[1], weights.shape[2]
    w = weights.float().reshape(k * cin, cout)
    # a missing neighbour reads the zero row appended past the features
    zero_row = feat.shape[0]
    fp = torch.cat([feat, feat.new_zeros((1, cin))], 0)
    out = torch.empty((n, cout), dtype=feat.dtype, device=feat.device)
    for s in range(0, n, _CONV_ROWS):
        idx = nbr[s:s + _CONV_ROWS]
        idx = torch.where(idx >= 0, idx, zero_row)
        g = fp.index_select(0, idx.reshape(-1)).reshape(-1, k * cin)
        o = g.float() @ w
        if bias is not None:
            o = o + bias.float()
        out[s:s + _CONV_ROWS] = o.to(feat.dtype)
    return out
