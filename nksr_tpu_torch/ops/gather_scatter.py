"""Gather building blocks of the sparse voxel convolutions (counterpart of
nksr_tpu/ops/gather_scatter.py): a convolution is a gather of each row's
stencil neighbours through a host-built table, then a matmul.

The matmuls are ``torch.matmul``: XLA computed them in the JAX package,
no TPU kernel did.

Every row gather here is ``gather_rows``, whose backward (the scatter of
the cotangent rows onto the source) sums each source row's entries in
index order through the fixed-order segment sum (``ops/segment_sum``),
over an order sorted once per index table (``segment_sum.table_order``,
kept on the table, built without a host sync; the forward notes each
table, and the first backward builds all their orders in one sort).
Autograd's own backward of ``index_select`` is CUDA ``index_add_``,
whose f32 atomics add repeated rows in no fixed order, so two training
steps from one state would differ.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import segment_sum as SEG

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


class _GatherRows(torch.autograd.Function):
    """``src.index_select(0, idx)``; the backward sums the cotangent rows
    of each source row in index order (``segment_sum`` over the order of
    ``order_idx``, ``segment_sum.table_order``'s).  ``order_idx`` is
    ``idx`` with the entries whose cotangent is zero by construction (an
    absent neighbour reading a zero row) set to -1: dropped from the
    order, they change no sum, and kept they would make one long segment
    that a single warp walks."""

    @staticmethod
    def forward(ctx, src, idx, order_idx):
        ctx.save_for_backward(order_idx)
        ctx.src_shape, ctx.src_dtype = src.shape, src.dtype
        if ctx.needs_input_grad[0]:
            # the backward's order, built with the others a step needs
            SEG.expect_order(order_idx, src.shape[0])
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (order_idx,) = ctx.saved_tensors
        n = ctx.src_shape[0]
        g = grad.reshape(order_idx.shape[0], ctx.src_shape[1:].numel())
        g = g.float().contiguous()
        out = SEG.segment_sum(g, SEG.table_order(order_idx, n))
        return out.to(ctx.src_dtype).reshape(ctx.src_shape), None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                order_idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``src`` at ``idx`` (any shape, every index in range):
    (*idx.shape, *src.shape[1:]), with the fixed-order backward.
    ``order_idx`` (idx's shape): the backward's targets, -1 where the
    gathered row's cotangent is zero or discarded."""
    out = _GatherRows.apply(src, idx.reshape(-1), order_idx.reshape(-1))
    return out.reshape(*idx.shape, *src.shape[1:])


def take_rows(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``feat`` at ``idx``; idx < 0 yields zeros."""
    if feat.shape[0] == 0:          # every index is absent
        return feat.new_zeros((*idx.shape, feat.shape[-1]))
    out = gather_rows(feat, idx.clamp(min=0), order_idx=idx)
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
        raw = nbr[s:s + _CONV_ROWS]
        idx = torch.where(raw >= 0, raw, zero_row)
        g = gather_rows(fp, idx, order_idx=raw).reshape(-1, k * cin)
        o = g.float() @ w
        if bias is not None:
            o = o + bias.float()
        out[s:s + _CONV_ROWS] = o.to(feat.dtype)
    return out
