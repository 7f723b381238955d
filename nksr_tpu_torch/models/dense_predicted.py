"""The structure-predicting UNet on a dense lattice, in one pass
(counterpart of nksr_tpu/models/dense_predicted.py).

The network itself prunes and refines the decoder hierarchy: at each
level, from the coarsest down, the ``dec_d`` block runs on the level's
candidate cells, the ``struct_d`` head and an argmax give each candidate
a status (0 pruned, 1 kept, 2 refined), and every child of a refined
cell becomes a candidate of the next finer level.  On a dense lattice
that is a change of boolean masks, so the whole forward is dense conv3d
work (cuDNN, as XLA computed it in the JAX package) with data-dependent
masks; the host reads back one int8 status lattice per level.

Each finer lattice must hold every child of every coarser cell, or a
refined boundary voxel's children would fall off it.
``plan_unet_lattice`` therefore builds child-cover dims (``dims[d] =
2 * dims[d+1]``, zero-phase origins), so the dense candidates equal the
per-level engine's grids (``recon/host_predicted.py``) cell for cell.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dense_unet as DU
from .network import NKSRNetwork
from .pipeline import PipelineConfig

# total (dense cells x f_maps) the one-pass forward may hold (the JAX
# package's budget, so the engine is chosen where it chooses it); each
# level keeps an f_maps-wide feature lattice alive for the head reads
DENSE_PRED_CELLMAP_BUDGET = 400_000_000

# a voxel's predicted status: kept and subdivided at the next finer depth
VOXEL_REFINED = 2


def plan_unet_lattice(grids, depth: int, f_maps: int = 32,
                      budget: Optional[int] = None):
    """Child-cover dense lattice over the encoder hierarchy: zero-phase
    origins (``o_d = o0 >> d``, o0 aligned to 2^(depth-1)) and doubling
    dims (``dims[d] = 2 * dims[d+1]``), so parent and child maps are
    ``l >> 1`` / ``2l + o`` and every child of a cell of lattice d lies
    in lattice d-1.  Returns (dims, origins (depth, 3) int64), or None
    when a level is empty or the cells x ``f_maps`` exceed ``budget``
    (default ``DENSE_PRED_CELLMAP_BUDGET``)."""
    lo_t, hi_t = [], []
    for d in range(depth):
        c = grids[d].coords
        if len(c) == 0:
            return None
        lo_t.append(c.min(0).astype(np.int64) - 1)
        hi_t.append(c.max(0).astype(np.int64) + 1)
    algn = 1 << (depth - 1)
    o0 = np.minimum.reduce(
        [(lo_t[d] << d) + (1 << d) - 1 for d in range(depth)])
    o0 = o0 & ~np.int64(algn - 1)
    origins = np.stack([o0 >> d for d in range(depth)])
    # the top level's extent covering every level's bbox when halved up
    need = np.maximum.reduce([
        -((origins[d] - hi_t[d] - 1) // (1 << (depth - 1 - d)))
        for d in range(depth)])
    need = (need + 7) // 8 * 8
    dims, total = [], 0
    for d in range(depth):
        e = need << (depth - 1 - d)
        dims.append((int(e[0]), int(e[1]), int(e[2])))
        total += int(e[0] * e[1] * e[2])
    if budget is None:
        budget = DENSE_PRED_CELLMAP_BUDGET
    if total * f_maps > budget:
        return None
    return tuple(dims), origins


def _upsample2(mask: torch.Tensor, dims_f) -> torch.Tensor:
    """2x nearest upsample of a (1, 1, X, Y, Z) mask onto the finer
    lattice (fine cell l reads coarse cell l >> 1), cropped to it."""
    m = mask
    for ax in (2, 3, 4):
        m = m.repeat_interleave(2, dim=ax)
    xf, yf, zf = dims_f
    return m[:, :, :xf, :yf, :zf]


def struct_status(up, d: int, g: torch.Tensor) -> torch.Tensor:
    """argmax of the ``struct_d`` logits at every cell of the feature
    lattice ``g`` (1, C, X, Y, Z): (X, Y, Z) int64.  The logits are f32
    (the lattice's values widened, as the JAX package's f32 head reads
    bf16 rows); ties go to the lower status, as in ``jnp.argmax``."""
    head = getattr(up, f"struct_{d}")
    c = g.shape[1]
    logits = head.weight @ g.reshape(c, -1).float() + head.bias[:, None]
    return logits.argmax(0).view(g.shape[2:])


@torch.no_grad()
def predicted_forward(cfg: PipelineConfig, net: NKSRNetwork, dims, origins,
                      enc_cell, enc_active, xyz: torch.Tensor, feat,
                      base0: torch.Tensor
                      ) -> Tuple[Tuple[torch.Tensor, ...],
                                 Tuple[torch.Tensor, ...]]:
    """Encoder, encoder path, then the structure-predicting decoder.
    Points in depth-0 cell order with their host-computed base cells
    ``base0``.  Returns (per-depth decoder feature lattices (1, C, X, Y,
    Z) in the conv dtype, per-depth int8 status lattices (X, Y, Z): 0 =
    not a candidate, else status + 1)."""
    depth = cfg.tree_depth
    cdt = getattr(torch, cfg.conv_dtype)
    up = net.unet
    occ = [DU.occupancy(dims[d], enc_cell[d], enc_active[d])
           for d in range(depth)]
    enc_feats = DU.encoder_path(cfg, net, dims, origins, occ, xyz, feat,
                                base0, cdt)
    g = enc_feats[depth - 1]
    cand = occ[depth - 1]
    gs: list = [None] * depth
    sts: list = [None] * depth
    for d in range(depth - 1, -1, -1):
        g = DU._conv_block(getattr(up, f"dec_{d}"), g, cand, cdt)
        status = struct_status(up, d, g)
        sts[d] = torch.where(cand[0, 0], status + 1, 0).to(torch.int8)
        gs[d] = g
        if d > 0:
            refined = cand & (status == VOXEL_REFINED)
            # every child of a refined voxel is a candidate; child-cover
            # dims keep them all on the finer lattice
            cand = _upsample2(refined, dims[d - 1])
            h = DU._up(getattr(up, f"up_{d}"), g, dims[d - 1], cdt)
            g = torch.where(cand, h + enc_feats[d - 1], 0.0)
    return tuple(gs), tuple(sts)


@torch.no_grad()
def predicted_heads(net: NKSRNetwork, gs, dec_cell, dec_active,
                    cand_cell=None, cand_active=None):
    """Basis and normal heads at the decoder voxels, and with
    ``cand_cell`` the UDF head at the candidate voxels: one row gather a
    depth from the retained feature lattices, in the cap-padded voxel-list
    order of the JAX package.  Returns (basis, normal, udf or None)."""
    basis, normal, udf = [], [], []
    for d in range(len(gs)):
        b, n = DU.heads(net.unet, d, gs[d], dec_cell[d], dec_active[d])
        basis.append(b)
        normal.append(n)
        if cand_cell is not None:
            udf.append(DU.udf_head(net.unet, d, gs[d], cand_cell[d],
                                   cand_active[d]))
    return tuple(basis), tuple(normal), \
        tuple(udf) if cand_cell is not None else None


def status_lists(st: np.ndarray, origin, sel: int):
    """Flat ids and world coords of the cells of a (X, Y, Z) status
    lattice with ``st > sel``, in flat (row-major) order, which is the
    grids' packed-key order."""
    _, Y, Z = st.shape
    ids = np.flatnonzero(st.reshape(-1) > sel).astype(np.int64)
    c = np.stack([ids // (Y * Z), (ids // Z) % Y, ids % Z], -1) + origin
    return ids, c
