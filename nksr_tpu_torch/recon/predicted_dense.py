"""Predicted-structure reconstruction with the one-pass dense engine
(counterpart of nksr_tpu/recon/predicted_dense.py, single device).

The whole structure-predicting forward runs on the child-cover dense
lattice (``models/dense_predicted.py``); the host reads back one int8
status lattice a level and builds the decoder voxel lists from it; the
heads are read from the retained feature lattices; the final solve and
the mesher are the splat path's (dense lattice solve with the dense
normal prior, lattice evaluator, dense dual MC).  A UDF head is read at
the candidate voxels, and its mask lives on the candidate hierarchy.

``reconstruct_predicted_sharded`` runs the same engine with the final
solve in x-slabs over a device mesh.

``reconstruct_predicted_dense`` returns None where this engine does not
apply (the UNet lattice over ``DENSE_PRED_CELLMAP_BUDGET``, an empty
level, a prediction that prunes everything, a solve plan refused); the
caller then runs the per-level engine (``recon/host_predicted.py``),
which owns the empty-prediction warning.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import host_build as HB
from ..fields.lattice import plan_lattice
from ..models import dense_predicted as DP
from ..models import dense_unet as DU
from .host_field import HostField
from .solve_tail import UdfHead, lattice_field


def _next_pow2(n: int) -> int:
    return 1 << max(8, int(math.ceil(math.log2(max(n, 1)))))


class PredictedParts:
    """What the structure-predicting forward gives the final solve: the
    encoder grids and point orders, the decoder and candidate grids and
    their cells in the UNet lattice, and the head features (the UDF
    head's at the candidates, None without one)."""
    __slots__ = ("grids", "orders", "caps", "dec_host", "dec_caps",
                 "cand_host", "cand_caps", "dec_cells", "cand_cells",
                 "basis_f", "normal_f", "udf_f")


def _sorted_grid(coords: np.ndarray, voxel_size: float) -> HB.HostGrid:
    """HostGrid from coords already in packed-key order (no sort)."""
    return HB.HostGrid(coords=coords.astype(np.int32),
                       keys=HB.pack64(coords), voxel_size=voxel_size)


@torch.no_grad()
def predicted_structures(cfg, net, xyz: np.ndarray, xyz_t: torch.Tensor,
                         feat, splat, tm) -> Optional[PredictedParts]:
    """The one-pass forward, the status readback and the heads; None when
    the UNet lattice is over budget or a level is empty, or when the
    prediction keeps no voxel.  ``feat``: the per-point input features
    on the device (or None), in the order of ``xyz``; ``splat``: the
    output of ``build_splat_grids_ex`` on ``xyz`` (the encoder
    hierarchy)."""
    dev = xyz_t.device
    D = cfg.tree_depth
    grids, orders = splat
    caps = tuple(_next_pow2(len(g.keys)) for g in grids)
    planu = DP.plan_unet_lattice(grids, D, f_maps=cfg.f_maps)
    if planu is None:
        return None
    dims, origins = planu
    enc_cell, enc_active = DU.cell_tables(grids, caps, dims, origins, dev)
    # the points in depth-0 cell order, with the host's base cells
    perm = torch.as_tensor(orders[0][1], device=dev)
    base0 = torch.as_tensor(HB.unpack64(orders[0][0]).astype(np.int64),
                            device=dev)
    tm.lap("unet lattice")

    gs, sts = DP.predicted_forward(
        cfg, net, dims, origins, enc_cell, enc_active, xyz_t[perm],
        None if feat is None else feat[perm], base0)
    del enc_cell, enc_active
    tm.lap("dispatch network")

    # one int8 lattice a level comes back; the decoder keeps st > 1
    # (status > 0), the candidates are st > 0, both in flat order
    dec_host, cand_host, dec_ids, cand_ids = [], [], [], []
    for d in range(D):
        st = sts[d].cpu().numpy()
        vs = cfg.voxel_size * (2.0 ** d)
        for sel, grids_out, ids_out in ((1, dec_host, dec_ids),
                                        (0, cand_host, cand_ids)):
            ids, c = DP.status_lists(st, origins[d], sel)
            grids_out.append(_sorted_grid(c, vs))
            ids_out.append(ids)
    del sts
    tm.lap("status readback")

    if all(len(g.keys) == 0 for g in dec_host):
        return None

    dec_caps = tuple(_next_pow2(len(g.keys)) for g in dec_host)
    cand_caps = tuple(_next_pow2(len(g.keys)) for g in cand_host)

    def padded(ids_list, caps_):
        cells, active = [], []
        for d, ids in enumerate(ids_list):
            c = np.zeros(caps_[d], np.int64)
            c[:len(ids)] = ids
            cells.append(torch.as_tensor(c, device=dev))
            active.append(torch.arange(caps_[d], device=dev) < len(ids))
        return cells, active

    dc, da = padded(dec_ids, dec_caps)
    cc, ca = padded(cand_ids, cand_caps) if cfg.udf_enabled else (None, None)
    basis_f, normal_f, udf_f = DP.predicted_heads(net, gs, dc, da, cc, ca)
    del gs
    tm.lap("dispatch heads")

    parts = PredictedParts()
    parts.grids, parts.orders, parts.caps = grids, orders, caps
    parts.dec_host, parts.dec_caps = dec_host, dec_caps
    parts.cand_host, parts.cand_caps = cand_host, cand_caps
    parts.dec_cells, parts.cand_cells = dec_ids, cand_ids
    parts.basis_f, parts.normal_f, parts.udf_f = basis_f, normal_f, udf_f
    return parts


@torch.no_grad()
def reconstruct_predicted_dense(cfg, net, xyz: np.ndarray,
                                xyz_t: torch.Tensor, feat, splat, tm,
                                times: dict) -> Optional[HostField]:
    """The dense engine end to end: the HostField, or None where it does
    not apply (see the module docstring).  Arguments as in
    ``predicted_structures``."""
    parts = predicted_structures(cfg, net, xyz, xyz_t, feat, splat, tm)
    if parts is None:
        return None
    plan = plan_lattice(parts.grids, parts.caps, xyz, parts.orders[0][0],
                        parts.orders[0][1], cfg.voxel_size, cfg.tree_depth,
                        cfg.adaptive_depth, k=cfg.kernel_dim,
                        dec_grids=parts.dec_host, dec_caps=parts.dec_caps)
    if plan is None:
        return None
    tm.lap("lattice plan")
    return lattice_field(cfg, net, plan, parts.dec_host, xyz, xyz_t,
                         _input_normal(cfg, feat), parts.basis_f,
                         parts.normal_f, tm, times, dense_prior=True,
                         label="final solve (lattice)", udf=_udf_head(parts))


def _input_normal(cfg, feat):
    return feat if cfg.feature == "normal" else None


def _udf_head(parts: PredictedParts) -> Optional[UdfHead]:
    """The UDF head at the candidate voxels (None without one)."""
    return None if parts.udf_f is None else UdfHead(
        parts.cand_host, parts.cand_caps, parts.udf_f)


@torch.no_grad()
def reconstruct_predicted_sharded(cfg, net, xyz: np.ndarray,
                                  xyz_t: torch.Tensor, feat, splat, tm,
                                  times: dict, mesh) -> Optional[HostField]:
    """The dense engine with its FINAL SOLVE in x-slabs over ``mesh``
    (``parallel/lattice_shard.py``; the JAX package's
    ``reconstruct_predicted_sharded``): the structure-predicting forward
    runs on every rank, the solve is the slab's.  None where the dense
    engine or the slab-aligned plan does not apply (the caller then runs
    the single-device predicted route on every rank)."""
    from ..parallel.lattice_shard import plan_sharded
    from .solve_tail import sharded_lattice_field
    parts = predicted_structures(cfg, net, xyz, xyz_t, feat, splat, tm)
    if parts is None:
        return None
    out = plan_sharded(parts.grids, parts.caps, xyz, parts.orders[0][0],
                       parts.orders[0][1], cfg.voxel_size, cfg.tree_depth,
                       cfg.adaptive_depth, mesh.size(), k=cfg.kernel_dim,
                       dec_grids=parts.dec_host, dec_caps=parts.dec_caps)
    if out is None:
        return None
    plan, splan = out
    tm.lap("sharded plan")
    return sharded_lattice_field(cfg, net, plan, splan, mesh, parts.dec_host,
                                 xyz_t, _input_normal(cfg, feat),
                                 parts.basis_f, parts.normal_f, tm, times,
                                 udf=_udf_head(parts))
