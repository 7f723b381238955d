"""Gather-conv UNet inference over host tables (counterpart of
nksr_tpu/models/network.py ``PointEncoder``, ``MaskedGroupNorm``,
``SparseConv``, ``ConvBlock`` and ``SparseUNet``, the teacher-forced
branch with host tables: the decoder hierarchy is the splat hierarchy).

It runs where the dense conv3d UNet would not fit (a bounding box over
the lattice or the feature-lattice budget), on the same parameters as
the dense UNet (``models/network.UNetParams``): each ``SparseConv_*``
conv3d weight reads back as 27 taps in ``stencil_offsets(3)`` order,
``down_d`` / ``up_d`` as (8, f, f) in ``child_offsets()`` order
(the inverse of ``utils/checkpoint._leaf_to_torch``).

Capacity-padding rows are trimmed: each level holds its n_d real voxels
only, so the masked GroupNorm is a plain GroupNorm over the rows.  The
heads are written back at (cap_d, C), padding rows as the JAX package
computes them (basis = the head's bias, normal = 0).

With ``conv_dtype="bfloat16"`` the 27-tap convs gather and multiply in
bf16 with f32 sums, rounded once (``ops/gather_scatter.gather_conv``);
the stride-2 convs and GroupNorm stay f32, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.grid import grid_to_world, point_splat_coords, world_to_grid
from ..ops import gather_scatter as gs
from .network import ConvBlock, NKSRNetwork
from .pipeline import PipelineConfig


def conv_taps(conv: torch.nn.Conv3d) -> torch.Tensor:
    """conv3d weight (Cout, Cin, 3, 3, 3) -> (27, Cin, Cout) taps."""
    w = conv.weight
    return w.permute(2, 3, 4, 1, 0).reshape(27, w.shape[1], w.shape[0])


def down_taps(conv: torch.nn.Conv3d) -> torch.Tensor:
    """Stride-2 conv3d weight (Cout, Cin, 2, 2, 2) -> (8, Cin, Cout)."""
    w = conv.weight
    return w.permute(2, 3, 4, 1, 0).reshape(8, w.shape[1], w.shape[0])


def up_taps(conv: torch.nn.ConvTranspose3d) -> torch.Tensor:
    """Transposed conv3d weight (Cin, Cout, 2, 2, 2) -> (8, Cin, Cout)."""
    w = conv.weight
    return w.permute(2, 3, 4, 0, 1).reshape(8, w.shape[0], w.shape[1])


def encode_points(cfg: PipelineConfig, net: NKSRNetwork, n0: int,
                  xyz: torch.Tensor, feat, splat_idx: torch.Tensor
                  ) -> torch.Tensor:
    """Point encoder onto the n0 depth-0 voxels: weighted mean of the
    (feature, offset) rows splatted through the host splat table
    ``splat_idx`` (N, 8), log1p of the weight sum, then the 2-layer MLP.
    Returns (n0, f_maps)."""
    vs = cfg.voxel_size
    n = xyz.shape[0]
    corner, w = point_splat_coords(vs, xyz)
    offset = world_to_grid(xyz[:, None, :] - grid_to_world(corner, vs), vs)
    pf = feat if feat is not None else xyz.new_zeros((n, 0))
    raw = torch.cat([pf[:, None, :].expand(n, 8, pf.shape[-1]), offset], -1)
    ok = splat_idx >= 0
    w = torch.where(ok, w, 0.0)
    seg = torch.where(ok, splat_idx, n0).reshape(-1)
    acc = xyz.new_zeros((n0 + 1, raw.shape[-1]))
    acc.index_add_(0, seg, (raw * w[..., None]).reshape(-1, raw.shape[-1]))
    wsum = xyz.new_zeros(n0 + 1)
    wsum.index_add_(0, seg, w.reshape(-1))
    vox = acc[:-1] / (wsum[:-1, None] + 1e-8)
    density = torch.log1p(wsum[:-1])[:, None]
    return net.encoder(torch.cat([vox, density], -1))


def group_norm(x: torch.Tensor, gn, num_groups: int = 8) -> torch.Tensor:
    """GroupNorm over all rows (every row is a real voxel), in f32."""
    n, c = x.shape
    g = min(num_groups, c)
    xg = x.reshape(n, g, c // g)
    cnt = max(n * (c // g), 1)
    mean = xg.sum((0, 2), keepdim=True) / cnt
    var = ((xg - mean) ** 2).sum((0, 2), keepdim=True) / cnt
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return xg.reshape(n, c) * gn.weight + gn.bias


def sparse_conv(conv, x: torch.Tensor, nbr: torch.Tensor, cdt
                ) -> torch.Tensor:
    """27-tap submanifold conv: f32 in, f32 out, the gathers and products
    in ``cdt``."""
    out = gs.gather_conv(x.to(cdt), nbr, conv_taps(conv).to(cdt), conv.bias)
    return out.float()


def conv_block(p: ConvBlock, x: torch.Tensor, nbr: torch.Tensor, cdt
               ) -> torch.Tensor:
    h = F.silu(group_norm(sparse_conv(p.SparseConv_0, x, nbr, cdt),
                          p.MaskedGroupNorm_0))
    h = F.silu(group_norm(sparse_conv(p.SparseConv_1, h, nbr, cdt),
                          p.MaskedGroupNorm_1))
    if x.shape[-1] == h.shape[-1]:
        h = h + x
    return h


def _pad_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    out = x.new_zeros((cap, x.shape[-1]))
    out[:x.shape[0]] = x
    return out


@torch.no_grad()
def sparse_unet_apply(cfg: PipelineConfig, net: NKSRNetwork, tables,
                      n_vox: Sequence[int], caps: Sequence[int],
                      coords: Sequence[torch.Tensor], xyz: torch.Tensor,
                      feat, splat_idx: torch.Tensor):
    """Encoder + UNet + heads over the splat hierarchy.

    ``tables``: ``core.host_build.UNetTables`` as int64 device tensors;
    ``n_vox[d]`` real voxels and ``caps[d]`` capacity of level d;
    ``coords[d]`` (n_d, 3) int64 voxel coords; ``splat_idx`` (N, 8) the
    points' depth-0 splat rows.  Returns per-depth (basis_features,
    normal_features) at (cap_d, C), the layout of the JAX package."""
    depth = cfg.tree_depth
    cdt = getattr(torch, cfg.conv_dtype)
    up = net.unet
    f = encode_points(cfg, net, n_vox[0], xyz, feat, splat_idx)

    enc_feats = []
    for d in range(depth):
        n = n_vox[d]
        f = conv_block(getattr(up, f"enc_{d}"), f, tables.nbr[d][:n], cdt)
        enc_feats.append(f)
        if d < depth - 1:
            down = getattr(up, f"down_{d}")
            f = gs.gather_conv(f, tables.child[d][:n_vox[d + 1]],
                               down_taps(down), down.bias)

    basis, normal = [None] * depth, [None] * depth
    g = enc_feats[depth - 1]
    for d in range(depth - 1, -1, -1):
        g = conv_block(getattr(up, f"dec_{d}"), g, tables.nbr[d][:n_vox[d]],
                       cdt)
        rows = _pad_rows(g, caps[d])
        basis[d] = getattr(up, f"basis_{d}")(rows)
        nf = getattr(up, f"normal_{d}")(rows)
        normal[d] = torch.where(
            (torch.arange(caps[d], device=g.device) < n_vox[d])[:, None],
            nf, 0.0)
        if d > 0:
            n = n_vox[d - 1]
            # transposed stride-2: each child takes its parent's features
            # through its octant's weight, plus the encoder skip row
            pfeat = gs.take_rows(g, tables.parent[d - 1][:n])
            w_up = up_taps(getattr(up, f"up_{d}"))
            octant = gs.octant_id(coords[d - 1])
            h = torch.zeros_like(pfeat)
            for o in range(8):
                h = torch.where((octant == o)[:, None], pfeat @ w_up[o], h)
            g = h + gs.take_rows(enc_feats[d - 1], tables.skip[d - 1][:n])
    return tuple(basis), tuple(normal)
