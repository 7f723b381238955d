"""Gather-conv UNet inference over host tables (counterpart of
nksr_tpu/models/network.py ``PointEncoder``, ``MaskedGroupNorm``,
``SparseConv``, ``ConvBlock`` and ``SparseUNet``, the teacher-forced
branch with host tables: the decoder's candidates are the splat
hierarchy at every level, and its heads read the rows of the decoder's
own voxels, the splat ones or the adaptive structure's subset of them).

It runs where the dense conv3d UNet would not fit (a bounding box over
the lattice or the feature-lattice budget), on the same parameters as
the dense UNet (``models/network.UNetParams``): each ``SparseConv_*``
conv3d weight reads back as 27 taps in ``stencil_offsets(3)`` order,
``down_d`` / ``up_d`` as (8, f, f) in ``child_offsets()`` order
(the inverse of ``utils/checkpoint._leaf_to_torch``).

Capacity-padding rows are trimmed: each level holds its n_d real voxels
only, so the masked GroupNorm is a plain GroupNorm over the rows.  The
heads are written back at (cap_d, C), padding rows as the JAX package
computes them (basis and UDF = the head's bias, normal = 0).

With ``conv_dtype="bfloat16"`` the 27-tap convs gather and multiply in
bf16 with f32 sums, rounded once (``ops/gather_scatter.gather_conv``);
the stride-2 convs and GroupNorm stay f32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import host_build as HB
from ..core import svh as SVH
from ..core.grid import grid_to_world, point_splat_coords, world_to_grid
from ..ops import gather_scatter as gs
from ..ops import segment_sum as SEG
from .network import ConvBlock, NKSRNetwork
from .pipeline import PipelineConfig, checked_rows


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
    The splat sums in a fixed order on every device
    (``ops/segment_sum.index_sum``).  Returns (n0, f_maps)."""
    vs = cfg.voxel_size
    n = xyz.shape[0]
    corner, w = point_splat_coords(vs, xyz)
    offset = world_to_grid(xyz[:, None, :] - grid_to_world(corner, vs), vs)
    pf = feat if feat is not None else xyz.new_zeros((n, 0))
    raw = torch.cat([pf[:, None, :].expand(n, 8, pf.shape[-1]), offset], -1)
    # the weighted rows and the weight as one (N*8, C+1) block, summed per
    # voxel in (point, corner) order; absent corners (-1) are dropped
    rows = torch.cat([raw * w[..., None], w[..., None]], -1)
    acc = SEG.index_sum(rows.reshape(-1, rows.shape[-1]),
                        splat_idx.reshape(-1), n0)
    vox = acc[:, :-1] / (acc[:, -1:] + 1e-8)
    density = torch.log1p(acc[:, -1:])
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


def encoder_path(cfg: PipelineConfig, net: NKSRNetwork, nbr, child,
                 n_vox: Sequence[int], xyz: torch.Tensor, feat,
                 splat_idx: torch.Tensor, cdt):
    """Point encoder, then the encoder's conv blocks and stride-2 convs
    over the splat hierarchy (``nbr[d]`` its stencil rows, ``child[d]``
    the children of level d+1 in level d).  Returns the per-depth
    encoder features (n_d, f_maps), f32."""
    up = net.unet
    f = encode_points(cfg, net, n_vox[0], xyz, feat, splat_idx)
    enc_feats = []
    for d in range(len(n_vox)):
        f = conv_block(getattr(up, f"enc_{d}"), f, nbr[d][:n_vox[d]], cdt)
        enc_feats.append(f)
        if d < len(n_vox) - 1:
            down = getattr(up, f"down_{d}")
            f = gs.gather_conv(f, child[d][:n_vox[d + 1]], down_taps(down),
                               down.bias)
    return enc_feats


def up_conv(up, d: int, g_parent: torch.Tensor, parent: torch.Tensor,
            octant: torch.Tensor) -> torch.Tensor:
    """Transposed stride-2 conv ``up_d`` onto level d-1: each child row
    takes its parent's row (``parent``) through its octant's weight."""
    pfeat = gs.take_rows(g_parent, parent)
    w_up = up_taps(getattr(up, f"up_{d}"))
    h = torch.zeros_like(pfeat)
    for o in range(8):
        h = torch.where((octant == o)[:, None], pfeat @ w_up[o], h)
    return h


def decoder_rows(grids, dec_grids) -> Tuple[Optional[np.ndarray], ...]:
    """Per level, the splat row of each decoder voxel (int64, in the
    decoder's key order): a host join of ``dec_grids[d].keys`` into
    ``grids[d].keys``; None where the level is the splat one itself.
    An adaptive level keeps a subset of the splat corners
    (``core/host_build.build_adaptive_grids``), so every decoder voxel
    has a row; a voxel without one raises rather than read a -1."""
    rows = []
    for g, dg in zip(grids, dec_grids):
        if dg is g:
            rows.append(None)
            continue
        r = HB.keys_lookup(g, dg.keys).astype(np.int64)
        if (r < 0).any():
            raise ValueError(
                f"{int((r < 0).sum())} decoder voxels at voxel size "
                f"{dg.voxel_size} are not voxels of the splat hierarchy")
        rows.append(r)
    return tuple(rows)


@torch.no_grad()
def sparse_unet_apply(cfg: PipelineConfig, net: NKSRNetwork, tables,
                      n_vox: Sequence[int], caps: Sequence[int],
                      coords: Sequence[torch.Tensor], xyz: torch.Tensor,
                      feat, splat_idx: torch.Tensor, dec_rows=None,
                      dec_caps: Optional[Sequence[int]] = None):
    """Encoder + UNet + heads over the splat hierarchy.

    ``tables``: ``core.host_build.UNetTables`` as int64 device tensors;
    ``n_vox[d]`` real voxels and ``caps[d]`` capacity of level d;
    ``coords[d]`` (n_d, 3) int64 voxel coords; ``splat_idx`` (N, 8) the
    points' depth-0 splat rows.  ``dec_rows[d]``: the decoder voxels'
    splat rows as an int64 device tensor (``decoder_rows``), None where
    the decoder level is the splat one; the basis and normal heads of
    such a level read those rows and are written at ``(dec_caps[d],
    C)``.  Returns per-depth (basis_features, normal_features,
    udf_features) at (cap_d, C), the layout of the JAX package; the UDF
    head (None unless ``cfg.udf_enabled``) at the decoder's candidate
    rows, which are the splat hierarchy's here."""
    depth = cfg.tree_depth
    cdt = getattr(torch, cfg.conv_dtype)
    up = net.unet
    if dec_rows is None:
        dec_rows = (None,) * depth
    enc_feats = encoder_path(cfg, net, tables.nbr, tables.child, n_vox, xyz,
                             feat, splat_idx, cdt)
    basis, normal, udf = [None] * depth, [None] * depth, [None] * depth
    g = enc_feats[depth - 1]
    for d in range(depth - 1, -1, -1):
        g = conv_block(getattr(up, f"dec_{d}"), g, tables.nbr[d][:n_vox[d]],
                       cdt)
        if dec_rows[d] is None:
            basis[d], normal[d] = heads(up, d, g, n_vox[d], caps[d])
        else:
            basis[d], normal[d] = heads(up, d, gs.take_rows(g, dec_rows[d]),
                                        len(dec_rows[d]), dec_caps[d])
        if cfg.udf_enabled:
            udf[d] = udf_head(up, d, g, n_vox[d], caps[d])
        if d > 0:
            n = n_vox[d - 1]
            # the encoder skip row of each child, after the up conv
            h = up_conv(up, d, g, tables.parent[d - 1][:n],
                        gs.octant_id(coords[d - 1]))
            g = h + gs.take_rows(enc_feats[d - 1], tables.skip[d - 1][:n])
    return tuple(basis), tuple(normal), \
        tuple(udf) if cfg.udf_enabled else None


def heads(up, d: int, rows: torch.Tensor, n: int, cap: int):
    """The depth-d basis and normal heads of the first ``n`` rows, written
    at (cap, C): padding rows as the JAX package computes them (basis =
    the head's bias, normal = 0)."""
    rows = _pad_rows(rows[:n], cap)
    basis = getattr(up, f"basis_{d}")(rows)
    nf = getattr(up, f"normal_{d}")(rows)
    live = (torch.arange(cap, device=rows.device) < n)[:, None]
    return basis, torch.where(live, nf, 0.0)


def udf_head(up, d: int, rows: torch.Tensor, n: int, cap: int):
    """The depth-d UDF head of the first ``n`` rows, written at (cap, C):
    padding rows as the JAX package computes them (the head's bias)."""
    return getattr(up, f"udf_{d}")(_pad_rows(rows[:n], cap))


def teacher_forced_unet(cfg: PipelineConfig, net: NKSRNetwork, enc_tables,
                        n_vox: Sequence[int], levels, gt_counts: Sequence[int],
                        caps: Sequence[int], xyz: torch.Tensor, feat,
                        splat_idx: torch.Tensor):
    """Encoder + UNet + heads with the decoder teacher-forced onto a GT
    hierarchy, differentiable (the training forward; nksr_tpu/models/
    network.py SparseUNet with ``use_gt_structure=True``).

    ``enc_tables`` the splat hierarchy's ``nbr`` and ``child`` tables as
    int64 device tensors, ``n_vox[d]`` its voxels; ``levels[d]`` the
    decoder level's tables (``core/svh.TeacherLevel`` fields as int64
    device tensors: ``nbr``, ``dec_rows``, ``parent``, ``octant``,
    ``skip``); ``gt_counts[d]`` the GT voxels of level d.  Returns per
    depth: basis and normal features on the GT voxels at (caps[d], C)
    (padding rows as the JAX package computes them), the structure
    logits (n_cand_d, 3) and the UDF features (n_cand_d, udf_dim) on the
    candidate rows."""
    depth = cfg.tree_depth
    cdt = getattr(torch, cfg.conv_dtype)
    up = net.unet
    enc_feats = encoder_path(cfg, net, enc_tables.nbr, enc_tables.child,
                             n_vox, xyz, feat, splat_idx, cdt)
    basis, normal = [None] * depth, [None] * depth
    logits, udf = [None] * depth, [None] * depth
    g = enc_feats[depth - 1]
    for d in range(depth - 1, -1, -1):
        lv = levels[d]
        g = conv_block(getattr(up, f"dec_{d}"), g, lv.nbr, cdt)
        logits[d] = getattr(up, f"struct_{d}")(g)
        udf[d] = getattr(up, f"udf_{d}")(g)
        basis[d], normal[d] = heads(up, d, gs.take_rows(g, lv.dec_rows),
                                    gt_counts[d], caps[d])
        if d > 0:
            h = up_conv(up, d, g, lv.parent, lv.octant)
            g = h + gs.take_rows(enc_feats[d - 1], lv.skip)
    return tuple(basis), tuple(normal), tuple(logits), tuple(udf)


class PredictedUNet(NamedTuple):
    """The structure-predicting UNet's outputs: per depth the basis and
    normal features on the decoder voxels at (caps[d], C), the structure
    logits (n_cand_d, 3) and UDF features (n_cand_d, udf_dim) on the
    candidate rows, and the host ``dec_grids`` and ``cand_grids``."""
    basis: Tuple[torch.Tensor, ...]
    normal: Tuple[torch.Tensor, ...]
    logits: Tuple[torch.Tensor, ...]
    udf: Tuple[torch.Tensor, ...]
    dec_grids: Tuple
    cand_grids: Tuple


def predicted_unet(cfg: PipelineConfig, net: NKSRNetwork, enc_grids,
                   enc_tables, n_vox: Sequence[int], caps: Sequence[int],
                   xyz: torch.Tensor, feat, splat_idx: torch.Tensor,
                   tm=None) -> PredictedUNet:
    """Encoder + UNet + heads with the decoder on its own predicted
    structure, differentiable (nksr_tpu/models/network.py SparseUNet with
    ``use_gt_structure=False``).

    The coarsest candidates are the encoder's grid.  At each level the
    ``dec_d`` block runs on the candidates, ``struct_d`` and ``udf_d`` on
    every candidate row; the statuses (the logits' argmax, the first
    maximum on a tie as ``jnp.argmax``) are read back to the host, where
    ``core/svh.decoder_step`` prunes and refines at the configuration's
    capacities; the heads read the kept rows and the transposed conv
    ``up_d`` plus the encoder skip feed the next level's candidates.
    ``enc_grids`` the cut splat hierarchy (host), ``enc_tables`` its
    ``nbr`` / ``child`` tables as int64 device tensors.  ``tm`` (an
    accumulating ``PhaseTimer``) adds the device work to "train:
    forward", the status readbacks to "train: structure readback" and
    the host steps with their uploads to "train: structure tables", each
    summed over the levels."""
    if tm is not None and not tm.accumulate:
        raise ValueError("predicted_unet: the level loop's phases recur; "
                         "pass a PhaseTimer(..., accumulate=True)")

    def lap(name):
        if tm is not None:
            tm.lap(name)
    depth = cfg.tree_depth
    cdt = getattr(torch, cfg.conv_dtype)
    dev = xyz.device
    up = net.unet
    stencil = gs.stencil_offsets(3)

    def dev_i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)
    enc_feats = encoder_path(cfg, net, enc_tables.nbr, enc_tables.child,
                             n_vox, xyz, feat, splat_idx, cdt)
    basis, normal = [None] * depth, [None] * depth
    logits, udf = [None] * depth, [None] * depth
    dec_grids, cand_grids = [None] * depth, [None] * depth
    cand = enc_grids[depth - 1]
    nbr = enc_tables.nbr[depth - 1][:n_vox[depth - 1]]
    g = enc_feats[depth - 1]
    for d in range(depth - 1, -1, -1):
        cand_grids[d] = cand
        g = conv_block(getattr(up, f"dec_{d}"), g, nbr, cdt)
        logits[d] = getattr(up, f"struct_{d}")(g)
        udf[d] = getattr(up, f"udf_{d}")(g)
        status = logits[d].detach().argmax(-1)
        lap("train: forward")
        status = status.cpu().numpy()
        lap("train: structure readback")
        step = SVH.decoder_step(cand, status,
                                enc_grids[d - 1] if d else None,
                                caps[d - 1] if d else 0, stencil)
        dec_grids[d] = step.dec
        nc = len(cand.keys)
        dec_rows = dev_i64(checked_rows(step.dec_rows, nc, "dec_rows"))
        if d > 0:
            parent = dev_i64(checked_rows(step.parent, nc, "parent"))
            octant = dev_i64(step.octant)
            skip = dev_i64(checked_rows(step.skip, n_vox[d - 1], "skip"))
            nbr = dev_i64(checked_rows(step.nbr, len(step.nxt.keys),
                                       "nbr"))
        lap("train: structure tables")
        basis[d], normal[d] = heads(up, d, gs.take_rows(g, dec_rows),
                                    len(step.dec.keys), caps[d])
        if d > 0:
            h = up_conv(up, d, g, parent, octant)
            g = h + gs.take_rows(enc_feats[d - 1], skip)
            cand = step.nxt
    lap("train: forward")
    return PredictedUNet(tuple(basis), tuple(normal), tuple(logits),
                         tuple(udf), tuple(dec_grids), tuple(cand_grids))
