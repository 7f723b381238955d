"""Dense-lattice UNet inference: the sparse-conv network as conv3d on the
solve lattice (counterpart of nksr_tpu/models/dense_unet.py).

Features live on the per-depth dense lattices as ``(1, C, X, Y, Z)``;
inactive cells are zeroed after every masked GroupNorm, which makes the
dense program equal to the submanifold semantics.  The 27-tap
submanifold conv is ``F.conv3d`` with padding 1 (a cross-correlation in
the same tap order), the stride-2 down/up convs are kernel-2 stride-2
conv3d / transposed conv3d between nested lattices (zero-phase origins
make local parent/child maps ``l >> 1`` / ``2l + o``).  These convs are
cuDNN's, as XLA computed them in the JAX package; no TPU kernel did.

A float32 conv on the card runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; ``Reconstructor`` turns it
off, so f32 here means f32.  With ``conv_dtype="bfloat16"`` the convs
run in bf16 and GroupNorm keeps f32 statistics.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..native import flat_cells
from .network import ConvBlock, NKSRNetwork
from .pipeline import PipelineConfig

_OFFS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                 -1).reshape(8, 3)


class DenseUNetTables(NamedTuple):
    """Per depth: (cap,) dense cell of each voxel (pad rows -> 0) and
    whether the row is a real voxel."""
    enc_cell: Tuple[torch.Tensor, ...]
    enc_active: Tuple[torch.Tensor, ...]


def build_tables(spec, origins, grids, caps, device) -> DenseUNetTables:
    """Map the splat grids' voxel lists to dense lattice cells (host)."""
    cells, act = [], []
    for d in range(spec.depth):
        cap = caps[d]
        n = min(len(grids[d].keys), cap)
        c = np.zeros((cap, 3), np.int64)
        c[:n] = grids[d].coords[:n]
        a = np.zeros(cap, bool)
        a[:n] = True
        cells.append(torch.from_numpy(
            flat_cells(c, 0, origins[d], spec.dims[d]).astype(np.int64)
        ).to(device))
        act.append(torch.from_numpy(a).to(device))
    return DenseUNetTables(tuple(cells), tuple(act))


def _occupancy(spec, tables: DenseUNetTables, d: int) -> torch.Tensor:
    occ = torch.zeros(spec.n_cells(d), dtype=torch.bool,
                      device=tables.enc_cell[d].device)
    occ[tables.enc_cell[d][tables.enc_active[d]]] = True
    return occ.view(spec.dims[d])


def trilinear_splat(dims, origin, base: torch.Tensor, frac: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Trilinear 8-corner splat by ``index_add_``: point i adds
    ``w_c(frac_i) * values[i, c]`` to the cell ``base_i + c - origin`` of
    each corner c (corners off the lattice are dropped).  ``base`` (N, 3)
    integer world cells, ``frac`` (N, 3) offsets in [0, 1), ``values``
    (N, 8, C) or (N, C).  Returns (X*Y*Z, C) and the weights (N, 8)."""
    dev = base.device
    offs = torch.as_tensor(_OFFS, device=dev)
    w = torch.where(offs[None].bool(), frac[:, None, :],
                    1.0 - frac[:, None, :]).prod(-1)              # (N, 8)
    if values.dim() == 2:
        values = values[:, None, :]
    X, Y, Z = dims
    loc = base[:, None, :] + offs - torch.as_tensor(
        np.asarray(origin, np.int64), device=dev)
    ok = ((loc >= 0) & (loc < torch.tensor([X, Y, Z], device=dev))).all(-1)
    flat = (loc[..., 0] * Y + loc[..., 1]) * Z + loc[..., 2]
    rows = values * w[..., None]
    acc = torch.zeros((X * Y * Z, rows.shape[-1]), device=dev)
    acc.index_add_(0, flat[ok], rows[ok])
    return acc, w


def encode_points(cfg: PipelineConfig, net: NKSRNetwork, dims0, origin0,
                  xyz: torch.Tensor, feat, base0: torch.Tensor
                  ) -> torch.Tensor:
    """Point encoder on the depth-0 lattice: trilinear splat of (features,
    corner offsets, weight), then the 2-layer MLP.  ``base0``: the
    host-computed depth-0 cells of the points (world coords), the same
    cells the plan was built from, so a device ``floor`` can never
    disagree with it.  Returns (cells_0, C)."""
    vs = cfg.voxel_size
    offs = torch.as_tensor(_OFFS, device=xyz.device)
    corner = base0[:, None, :] + offs[None]                        # (N, 8, 3)
    offset = (xyz[:, None, :] - corner.float() * vs) / vs
    n = xyz.shape[0]
    pf = feat if feat is not None else xyz.new_zeros((n, 0))
    raw = torch.cat([pf[:, None, :].expand(n, 8, pf.shape[-1]), offset,
                     xyz.new_ones((n, 8, 1))], -1)                 # (N, 8, C+1)
    acc, _ = trilinear_splat(dims0, origin0, base0, xyz / vs - base0.float(),
                             raw)
    vox = acc[:, :-1] / (acc[:, -1:] + 1e-8)
    density = torch.log1p(acc[:, -1:])
    return net.encoder(torch.cat([vox, density], -1))


def _group_norm(x, mask, gn, num_groups: int = 8):
    """Masked GroupNorm: statistics over the active cells only, in f32;
    the normalization itself in the activation dtype."""
    c = x.shape[1]
    g = min(num_groups, c)
    xg = x.reshape(g, c // g, -1)
    m = mask.reshape(1, 1, -1).float()
    n = torch.clamp(m.sum() * (c // g), min=1.0)
    xg32 = xg.float()
    mean = (xg32 * m).sum((1, 2), keepdim=True) / n
    var = (((xg32 - mean) ** 2) * m).sum((1, 2), keepdim=True) / n
    inv = torch.rsqrt(var + 1e-5)
    xn = ((xg - mean.to(x.dtype)) * inv.to(x.dtype)).reshape(x.shape)
    dt = x.dtype
    out = xn * gn.weight.to(dt).view(1, c, 1, 1, 1) \
        + gn.bias.to(dt).view(1, c, 1, 1, 1)
    return torch.where(mask, out, 0.0)


def _conv27(conv, x, cdt):
    return F.conv3d(x.to(cdt), conv.weight.to(cdt), conv.bias.to(cdt),
                    padding=1)


def _conv_block(p: ConvBlock, x, mask, cdt):
    h = F.silu(_group_norm(_conv27(p.SparseConv_0, x, cdt), mask,
                           p.MaskedGroupNorm_0))
    h = F.silu(_group_norm(_conv27(p.SparseConv_1, h, cdt), mask,
                           p.MaskedGroupNorm_1))
    if x.shape[1] == h.shape[1]:
        h = h + x
    return torch.where(mask, h, 0.0)


def _down(conv, x, dims_c, cdt):
    """Stride-2 child-gather conv: out[p] = sum_o x[2p+o] @ w[o] (fine
    lattice zero-padded to twice the coarse extent)."""
    _, _, xf, yf, zf = x.shape
    xc, yc, zc = dims_c
    x = F.pad(x, (0, 2 * zc - zf, 0, 2 * yc - yf, 0, 2 * xc - xf))
    return F.conv3d(x.to(cdt), conv.weight.to(cdt), conv.bias.to(cdt),
                    stride=2)


def _up(conv, x, dims_f, cdt):
    """Transposed stride-2: child l takes parent l >> 1 through the
    octant-(l & 1) weight; cropped to the fine extent."""
    y = F.conv_transpose3d(x.to(cdt), conv.weight.to(cdt), stride=2)
    xf, yf, zf = dims_f
    return y[:, :, :xf, :yf, :zf]


def _head_rows(g, cells, act):
    rows = g.reshape(g.shape[1], -1).index_select(1, cells).T.float()
    return torch.where(act[:, None], rows, 0.0)


@torch.no_grad()
def dense_unet_apply(cfg: PipelineConfig, net: NKSRNetwork, spec, origins,
                     tables: DenseUNetTables, xyz: torch.Tensor, feat,
                     base0: torch.Tensor):
    """Encoder + UNet + heads on the dense lattice, with the decoder
    taught the splat hierarchy.  Returns per-depth (basis_features,
    normal_features) in the voxel-row layout of the JAX package (the
    structure and UDF heads serve routes this package does not run)."""
    depth = spec.depth
    cdt = getattr(torch, cfg.conv_dtype)
    up = net.unet
    occ = [_occupancy(spec, tables, d)[None, None] for d in range(depth)]

    h = encode_points(cfg, net, spec.dims[0], origins[0], xyz, feat, base0)
    X, Y, Z = spec.dims[0]
    f = h.T.reshape(1, -1, X, Y, Z)
    f = torch.where(occ[0], f, 0.0).to(cdt)

    enc_feats = []
    for d in range(depth):
        f = _conv_block(getattr(up, f"enc_{d}"), f, occ[d], cdt)
        enc_feats.append(f)
        if d < depth - 1:
            f = _down(getattr(up, f"down_{d}"), f, spec.dims[d + 1], cdt)
            f = torch.where(occ[d + 1], f, 0.0)

    basis, normal = [None] * depth, [None] * depth
    g = enc_feats[depth - 1]
    for d in range(depth - 1, -1, -1):
        g = _conv_block(getattr(up, f"dec_{d}"), g, occ[d], cdt)
        act = tables.enc_active[d]
        rows = _head_rows(g, tables.enc_cell[d], act)
        basis[d] = getattr(up, f"basis_{d}")(rows)
        normal[d] = torch.where(act[:, None],
                                getattr(up, f"normal_{d}")(rows), 0.0)
        if d > 0:
            hu = _up(getattr(up, f"up_{d}"), g, spec.dims[d - 1], cdt)
            g = torch.where(occ[d - 1], hu + enc_feats[d - 1], 0.0)
    return tuple(basis), tuple(normal)
