"""Training losses and metrics (counterpart of nksr_tpu/train/losses.py):
the SVH-uniform and surface-band samplers, the soft or hard TSDF
truncation, and the spatial, GT-surface, structure and UDF losses with
the structure-accuracy and occupancy-IoU metrics.

Random draws take an explicit ``torch.Generator`` (a CPU one: the draws
are made on the host, so one generator gives the same samples whatever
device the step runs on).  The two packages cannot draw the same random
numbers, so ``compute_losses`` also takes the samples and surface picks
precomputed (``draw_samples`` makes them): the CPU tests feed it the JAX
package's draws.  GT signed distances come from the GT cloud through
``ops/sdf.py``; the field and the UDF are evaluated at the samples
through host support joins (``core/host_build.support_indices``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import host_build as HB
from ..models.pipeline import (ForwardOutput, PipelineConfig, TrainInputs,
                               level_voxel_size)
from ..ops import knn as K
from ..ops import sdf as SDF


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    type: str = "uniform"       # 'uniform' | 'band'
    n_samples: int = 50000
    expand: int = 1
    expand_top: int = 3
    eps: float = 0.5            # band width, times voxel size


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The fields and defaults of ``nksr_tpu.train.losses.LossConfig``."""
    structure_weight: float = 20.0
    gt_surface_value: float = 200.0
    gt_surface_normal: float = 100.0
    gt_surface_subsample: int = 50000
    spatial_weight: float = 300.0
    reg_sdf_weight: float = 0.0
    spatial_samplers: Tuple[SamplerConfig, ...] = (
        SamplerConfig("uniform", 50000, 1, 3),
        SamplerConfig("band", 50000),
    )
    udf_weight: float = 150.0
    udf_samplers: Tuple[SamplerConfig, ...] = (
        SamplerConfig("uniform", 80000, 1, 5),
        SamplerConfig("band", 20000),
    )
    gt_soft: bool = True
    gt_band: float = 1.0        # truncation, times voxel size
    sdf_knn: int = 8


# ------------------------------------------------------------------ samplers
def _expand_coords(coords: np.ndarray, expand: int) -> np.ndarray:
    """Each voxel and its neighbours within the expand cube (offsets
    ``(-e)//2+1 .. e//2``, duplicates kept, as the JAX package)."""
    if expand < 3:
        return coords
    r = np.arange((-expand) // 2 + 1, expand // 2 + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return (coords[:, None, :] + offs[None]).reshape(-1, 3)


def svh_uniform_samples(gen: torch.Generator, cfg: PipelineConfig, grids,
                        n: int, expand: int = 0, expand_top: int = 0
                        ) -> torch.Tensor:
    """(n, 3) samples uniform over the (expanded) voxels of every level of
    a host hierarchy (the coarsest level expanded by ``expand_top``):
    a voxel drawn uniformly from all rows, then a point uniform in its
    cube.  Drawn on the CPU from ``gen``.  An empty hierarchy draws as
    the JAX package's does: every pick is the first row of its padded
    depth-0 table, whose coords are 0 (expanded by its first offset)."""
    empty = all(len(g.keys) == 0 for g in grids)
    base, scale = [], []
    for d, g in enumerate(grids):
        e = expand if d != len(grids) - 1 else expand_top
        cc = np.zeros((1, 3), np.int64) if empty and d == 0 \
            else np.asarray(g.coords, np.int64)
        cc = _expand_coords(cc, e)
        vs = np.float32(level_voxel_size(cfg, d))
        base.append(cc.astype(np.float32) * vs)
        scale.append(np.full(len(cc), vs, np.float32))
    base = torch.from_numpy(np.concatenate(base, 0))
    scale = torch.from_numpy(np.concatenate(scale, 0))
    total = base.shape[0]
    u = torch.rand(n, generator=gen)
    pick = torch.floor(u * total).long().clamp(0, total - 1)
    if empty:
        pick = torch.zeros_like(pick)
    local = (torch.rand((n, 3), generator=gen) - 0.5) * scale[pick][:, None]
    return base[pick] + local


def band_samples(gen: torch.Generator, ref_xyz: torch.Tensor,
                 ref_normal: torch.Tensor, n: int, eps: float
                 ) -> torch.Tensor:
    """(n, 3) samples in a Gaussian band of width ``eps`` along the
    normals of uniformly picked GT points (CPU tensors)."""
    pick = masked_choice(gen, ref_xyz.shape[0], n)
    offs = torch.randn((n, 1), generator=gen) * eps
    return ref_xyz[pick] + ref_normal[pick] * offs


def masked_choice(gen: torch.Generator, count: int, n: int) -> torch.Tensor:
    """(n,) indices drawn uniformly from ``range(count)`` (the JAX
    package's ``_masked_choice`` over the real rows)."""
    u = torch.rand(n, generator=gen)
    return torch.floor(u * max(count, 1)).long().clamp(0, max(count - 1, 0))


def get_samples(gen: torch.Generator, cfg: PipelineConfig,
                samplers: Sequence[SamplerConfig], grids,
                ref_xyz: torch.Tensor, ref_normal: torch.Tensor
                ) -> torch.Tensor:
    parts = []
    for sc in samplers:
        if sc.type == "uniform":
            parts.append(svh_uniform_samples(gen, cfg, grids, sc.n_samples,
                                             sc.expand, sc.expand_top))
        elif sc.type == "band":
            parts.append(band_samples(gen, ref_xyz, ref_normal, sc.n_samples,
                                      sc.eps * cfg.voxel_size))
        else:
            raise ValueError(sc.type)
    return torch.cat(parts, 0)


def draw_samples(gen: torch.Generator, cfg: PipelineConfig,
                 lcfg: LossConfig, inp: TrainInputs, dec_grids=None
                 ) -> Dict[str, torch.Tensor]:
    """The step's random draws, on the CPU: ``spatial`` and ``udf``
    sample points (over the decoder hierarchy ``dec_grids`` and the GT
    band; JAX: ``field.svh``) and the ``surface`` picks (indices into
    the GT cloud), each where its loss is on.  ``dec_grids`` is the
    forward's (``ForwardOutput.dec_grids``); None reads the GT
    hierarchy, the teacher-forced decoder's, which is known before the
    forward."""
    ref_xyz, ref_normal = inp.gt_xyz.cpu(), inp.gt_normal.cpu()
    grids = inp.gt_grids if dec_grids is None else dec_grids
    out = {}
    if lcfg.spatial_weight > 0:
        out["spatial"] = get_samples(gen, cfg, lcfg.spatial_samplers,
                                     grids, ref_xyz, ref_normal)
    if lcfg.gt_surface_value > 0 or lcfg.gt_surface_normal > 0:
        out["surface"] = masked_choice(gen, ref_xyz.shape[0],
                                       lcfg.gt_surface_subsample)
    if cfg.udf_enabled and lcfg.udf_weight > 0:
        out["udf"] = get_samples(gen, cfg, lcfg.udf_samplers, grids,
                                 ref_xyz, ref_normal)
    return out


# ------------------------------------------------------------- field helpers
def transform_field(cfg: PipelineConfig, lcfg: LossConfig,
                    field_vals: torch.Tensor) -> torch.Tensor:
    """Soft (tanh) or hard (clip) TSDF truncation at ``gt_band`` voxels."""
    ts = lcfg.gt_band * cfg.voxel_size
    if lcfg.gt_soft:
        return torch.tanh(field_vals / ts) * ts
    return field_vals.clamp(-ts, ts)


def gt_tsdf_from_points(cfg: PipelineConfig, lcfg: LossConfig,
                        table: K.BucketTable, query: torch.Tensor,
                        ref_xyz: torch.Tensor, ref_normal: torch.Tensor
                        ) -> torch.Tensor:
    """Minus the IMLS signed distance, truncated (positive inside)."""
    sdf = SDF.sdf_from_points(query, ref_xyz, ref_normal, table=table,
                              nb_points=lcfg.sdf_knn, stdv=0.02)
    return transform_field(cfg, lcfg, -sdf)


def _support(grids, caps, x: torch.Tensor):
    """Support rows of (n, 3) device points in a host hierarchy, on the
    points' device."""
    return tuple(torch.as_tensor(t.astype(np.int64), device=x.device)
                 for t in HB.support_indices(grids, caps,
                                             x.detach().cpu().numpy()))


# ------------------------------------------------------------------- losses
def compute_losses(cfg: PipelineConfig, lcfg: LossConfig,
                   out: ForwardOutput, inp: TrainInputs,
                   samples: Dict[str, torch.Tensor],
                   compute_metric: bool = False):
    """(loss dict, metric dict) in the JAX package's key order; the total
    is ``sum(losses.values())``.  ``samples``: ``draw_samples``' dict (or
    the JAX package's draws), moved to the step's device here."""
    losses: Dict[str, torch.Tensor] = {}
    metrics: Dict[str, torch.Tensor] = {}
    field = out.field
    dev = inp.xyz.device
    caps = tuple(cfg.capacities)
    ref_xyz, ref_normal = inp.gt_xyz, inp.gt_normal
    vs = cfg.voxel_size
    table = K.build_buckets(ref_xyz, 4.0 * vs, 32)

    if lcfg.spatial_weight > 0:
        chi = samples["spatial"].to(dev)
        pd_chi = field.evaluate_f(chi, _support(out.dec_grids, caps,
                                                chi)).value
        with torch.no_grad():
            gt_tsdf = gt_tsdf_from_points(cfg, lcfg, table, chi, ref_xyz,
                                          ref_normal)
        pd_tsdf = transform_field(cfg, lcfg, pd_chi)
        losses["spatial"] = lcfg.spatial_weight * (
            (pd_tsdf - gt_tsdf).abs() / vs).mean()
        if lcfg.reg_sdf_weight > 0:
            eps = 0.5
            losses["msa"] = lcfg.reg_sdf_weight * (
                eps / (pd_chi ** 2 + eps ** 2)).mean()

    if lcfg.gt_surface_value > 0 or lcfg.gt_surface_normal > 0:
        pick = samples["surface"].to(dev)
        sx, sn = ref_xyz[pick], ref_normal[pick]
        want_grad = lcfg.gt_surface_normal > 0
        ev = field.evaluate_f(sx, _support(out.dec_grids, caps, sx),
                              grad=want_grad)
        if want_grad:
            g = ev.gradient
            g = -g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-6)
            losses["gt-surface-normal"] = lcfg.gt_surface_normal * (
                1.0 - (g * sn).sum(-1).mean())
        losses["gt-surface-value"] = lcfg.gt_surface_value * \
            ev.value.abs().mean()

    if lcfg.structure_weight > 0:
        for d, (logits, status) in enumerate(zip(out.structure_logits,
                                                 out.structure_status)):
            logp = F.log_softmax(logits, -1)
            ce = -logp.gather(1, status[:, None])[:, 0]
            denom = max(logits.shape[0], 1)
            losses[f"struct-{d}"] = lcfg.structure_weight * ce.sum() / denom
            if compute_metric:
                metrics[f"struct-acc-{d}"] = \
                    (logits.argmax(-1) == status).sum() / denom

    if cfg.udf_enabled and lcfg.udf_weight > 0:
        chi = samples["udf"].to(dev)
        pd = out.mask_field.evaluate_f(chi, _support(out.cand_grids, caps,
                                                     chi)).value
        with torch.no_grad():
            gt_tudf = gt_tsdf_from_points(cfg, lcfg, table, chi, ref_xyz,
                                          ref_normal).abs()
        pd_tudf = transform_field(cfg, lcfg, pd)
        losses["udf"] = lcfg.udf_weight * ((pd_tudf - gt_tudf).abs()
                                           / vs).mean()

    if compute_metric and inp.onet is not None:
        with torch.no_grad():
            q, occ = inp.onet
            pd_in = evaluate_f_bar(cfg, out, inp, q) > 0
            gt_in = occ > 0
            inter = (pd_in & gt_in).sum()
            union = (pd_in | gt_in).sum()
            metrics["iou"] = inter / (union + 1e-6)
    return losses, metrics


def evaluate_f_bar(cfg: PipelineConfig, out: ForwardOutput,
                   inp: TrainInputs, x: torch.Tensor) -> torch.Tensor:
    """The mask-combined field at (n, 3) points: f where the mask passes
    (the UDF head's on the candidate hierarchy, or without it the union
    of the decoder hierarchy's supports), ``-voxel_size`` elsewhere."""
    caps = tuple(cfg.capacities)
    sup = _support(out.dec_grids, caps, x)
    f = out.field.evaluate_f(x, sup).value
    if out.mask_field is not None:
        m = out.mask_field.evaluate_mask(x, _support(out.cand_grids, caps,
                                                     x))
    else:
        inside = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for s in sup:
            inside |= (s >= 0).any(-1)
        m = torch.where(inside, 1.0, -1.0)
    return torch.where(m > 0, f, -cfg.voxel_size)
