"""Predicted-structure reconstruction with the per-level engine
(counterpart of nksr_tpu/recon/host_predicted.py).

The structure-predicting UNet changes the hierarchy at every level, so
the forward is cut there and the host does the integer work between the
cuts:

  phase 1 (device)   encoder, encoder path, the bottom decoder block and
                     its structure logits, on the gather-conv pieces of
                     ``models/sparse_unet.py`` over host tables;
  per level (host)   read the statuses back, prune to the decoder grid,
                     expand the children of refined voxels, build their
                     stencil, parent and skip rows (``core/svh.
                     decoder_step``, the training forward's step,
                     without its capacity cut);
  per level (device) the octant-weighted transposed conv ``up_d``, the
                     encoder skip, the ``dec_{d-1}`` block and its logits;
  final (device)     the heads on the pruned grids (a UDF head on every
                     candidate row, its mask on the candidate grids),
                     then the lattice solve (or, for a bounding box
                     ``plan_lattice`` refuses, the support-row solve).

It runs where the one-pass dense engine (``recon/predicted_dense.py``)
does not: a UNet lattice over its budget, or a prediction that prunes
everything.  Phase names are the JAX package's timer labels; the level
loop's status readbacks, host tables and device work are summed as
phases of their own.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..core import host_build as HB
from ..core import svh as SVH
from ..fields.lattice import plan_lattice
from ..models import sparse_unet as SU
from ..ops import gather_scatter as gs
from ..utils.profiling import PhaseTimer
from .host_field import HostField
from .solve_tail import UdfHead, lattice_field, support_row_field


def _next_pow2(n: int) -> int:
    return 1 << max(8, int(math.ceil(math.log2(max(n, 1)))))


def _status(up, d: int, g: torch.Tensor) -> torch.Tensor:
    """argmax of the ``struct_d`` logits a row (f32 rows)."""
    return getattr(up, f"struct_{d}")(g).argmax(-1)


@torch.no_grad()
def reconstruct_predicted_host(cfg, net, xyz: np.ndarray,
                               xyz_t: torch.Tensor, feat, splat, tm,
                               times: dict) -> HostField:
    """The per-level engine end to end.  ``feat``: the per-point input
    features on the device (or None), in the order of ``xyz``;
    ``splat``: the output of ``build_splat_grids_ex`` on ``xyz`` (the
    encoder hierarchy, with exact capacities here)."""
    dev = xyz_t.device
    D = cfg.tree_depth
    cdt = getattr(torch, cfg.conv_dtype)
    up = net.unet
    stencil = gs.stencil_offsets(3)

    def dev_i64(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)

    grids, orders = splat
    caps = tuple(_next_pow2(len(g.keys)) for g in grids)
    n_vox = [len(g.keys) for g in grids]
    tables = HB.build_unet_tables(grids, caps, stencil, decoder=False)
    nbr = tuple(dev_i64(t) for t in tables.nbr)
    child = tuple(dev_i64(t) for t in tables.child)
    del tables
    tm.lap("unet tables")
    splat0 = dev_i64(HB.support_indices(grids[:1], caps[:1], xyz,
                                        presorted=orders[:1])[0])
    tm.lap("splat support")

    enc_feats = SU.encoder_path(cfg, net, nbr, child, n_vox, xyz_t, feat,
                                splat0, cdt)
    g = SU.conv_block(getattr(up, f"dec_{D - 1}"), enc_feats[D - 1],
                      nbr[D - 1][:n_vox[D - 1]], cdt)
    status = _status(up, D - 1, g).cpu().numpy()
    del nbr, child, splat0
    tm.lap("phase1 device")

    # level loop: the host prunes and refines, the device runs the next
    # level's convs; each part summed as a phase of its own
    loop = PhaseTimer(dev, times, accumulate=True)
    cand, cand_cap = grids[D - 1], caps[D - 1]
    g_convs = [None] * D
    g_convs[D - 1] = g
    dec_host = [None] * D
    head_rows = [None] * D
    cand_host, cand_caps = [None] * D, [0] * D
    for d in range(D - 1, -1, -1):
        cand_host[d], cand_caps[d] = cand, cand_cap
        # no cut: a level keeps every child of its refined voxels
        step = SVH.decoder_step(cand, status, grids[d - 1] if d else None,
                                8 * len(cand.keys), stencil)
        dec_host[d], head_rows[d] = step.dec, step.dec_rows
        if d == 0:
            break
        loop.lap("level loop: host tables")
        h = SU.up_conv(up, d, g, dev_i64(step.parent), dev_i64(step.octant))
        g = h + gs.take_rows(enc_feats[d - 1], dev_i64(step.skip))
        g = SU.conv_block(getattr(up, f"dec_{d - 1}"), g, dev_i64(step.nbr),
                          cdt)
        g_convs[d - 1] = g
        st_dev = _status(up, d - 1, g)
        loop.lap("level loop: device")
        status = st_dev.cpu().numpy()
        loop.lap("level loop: status readback")
        cand, cand_cap = step.nxt, _next_pow2(len(step.nxt.keys))
    del enc_feats
    tm.lap("level loop")

    n = xyz.shape[0]
    if n > 0 and all(len(g_.keys) == 0 for g_ in dec_host):
        warnings.warn(
            "predicted structure is empty (no decoder voxels survived "
            "pruning): the network is untrained or unsuited to this "
            "input; pass structure='splat' for a weight-independent "
            "hierarchy", RuntimeWarning)

    # heads on the pruned rows, in the cap-padded voxel-list layout
    dec_caps = tuple(_next_pow2(len(g_.keys)) for g_ in dec_host)
    basis_f, normal_f = [], []
    for d in range(D):
        rows = np.full(dec_caps[d], -1, np.int64)
        rows[:len(head_rows[d])] = head_rows[d]
        gd = gs.take_rows(g_convs[d], dev_i64(rows))
        live = len(head_rows[d])
        b, nf = SU.heads(up, d, gd, live, dec_caps[d])
        basis_f.append(b)
        normal_f.append(nf)
    udf = None
    if cfg.udf_enabled:
        # the UDF head on every candidate row of each level
        udf = UdfHead(cand_host, tuple(cand_caps), tuple(
            SU.udf_head(up, d, g_convs[d], len(cand_host[d].keys),
                        cand_caps[d]) for d in range(D)))
    del g_convs
    tm.lap("dispatch heads")

    plan = None
    if any(len(g_.keys) for g_ in dec_host):
        plan = plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            cfg.voxel_size, D, cfg.adaptive_depth,
                            k=cfg.kernel_dim, dec_grids=dec_host,
                            dec_caps=dec_caps)
        tm.lap("lattice plan (pre)")
    # the points' splat rows into the decoder voxels: the normal prior
    # (adaptive depths) and, without a plan, the value rows (every depth)
    n_sup = D if plan is None else cfg.adaptive_depth
    pt_sup = tuple(dev_i64(t) for t in HB.support_indices(
        dec_host[:n_sup], dec_caps[:n_sup], xyz, presorted=orders[:n_sup]))
    tm.lap("dec support")
    input_normal = feat if cfg.feature == "normal" else None
    if plan is not None:
        return lattice_field(cfg, net, plan, dec_host, xyz, xyz_t,
                             input_normal, basis_f, normal_f, tm, times,
                             dense_prior=False, pt_sup=pt_sup,
                             dec_caps=dec_caps,
                             label="final solve (lattice)", udf=udf)
    return support_row_field(cfg, net, dec_host, dec_caps, xyz_t,
                             input_normal, basis_f, normal_f, pt_sup, tm,
                             times, udf=udf)
