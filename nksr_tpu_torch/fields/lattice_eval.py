"""Lattice-native field evaluation (counterpart of
nksr_tpu/fields/lattice_eval.py): dense tables built once per solved
field, then one AV0 row gather and one corner-feature gather per query.

  * once: the forward cascade kernel expands the solved coefficient
    lattices into AV0; the basis features are scattered onto the dense
    lattices; per-depth corner activity is folded into one depth-0
    trust mask (the union of the depths' supports) and the depth-0 voxel
    occupancy gives the extraction shell.
  * per query: integer cells from ``floor(x / voxel_size)``, then the
    basis MLP, window and (optionally) gradient in f32.

Queries outside the lattice alias to dense cell 0, whose margin is
structurally inactive: value 0, mask False.  Waves are sized by memory
alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import lattice as LAT
from . import lattice_kernels as LK
from ..models.network import Interpolators, mlp_with_tangents

# bytes of temporaries one evaluation wave may hold
_WAVE_BYTES = 1 << 30


class LatticeEvalTables(NamedTuple):
    av0: torch.Tensor                  # (cells_0, depth*8k) in compute dtype
    fdp: Tuple[torch.Tensor, ...]      # per depth padded (cells_d, Cb)
    mask0: torch.Tensor                # (cells_0,) bool: trusted cells
    shell0: torch.Tensor               # (cells_0,) bool: extraction shell


def _upsample_to_0(a: torch.Tensor, spec, d: int) -> torch.Tensor:
    """(cells_d,) -> (cells_0,): depth-0 cell x reads its ancestor x >> d
    (zero-phase nesting)."""
    dev = a.device
    idx = [torch.arange(n, device=dev) >> d for n in spec.dims[0]]
    return a.view(spec.dims[d])[idx[0]][:, idx[1]][:, :, idx[2]].reshape(-1)


def prepare_tables(spec, dense_xs, basis_features, vox_cell, vox_active,
                   compute_dtype) -> LatticeEvalTables:
    """Evaluator tables from the solve's dense coefficient lattices."""
    av0 = LK.av0_cascade(spec, dense_xs, compute_dtype)
    fdp, adp = LAT.scatter_tables(spec, basis_features, vox_cell,
                                   vox_active)
    mask0 = shell0 = None
    for d in range(spec.depth):
        n = spec.n_cells(d)
        cells = torch.arange(n, device=av0.device)
        any_c = (LAT.corner_rows(adp[d], cells, spec, d)[..., 0] > 0).any(-1)
        m = _upsample_to_0(any_c, spec, d)
        mask0 = m if mask0 is None else mask0 | m
        if d < spec.adaptive_depth:
            occ = _upsample_to_0(adp[d][:n, 0] > 0, spec, d)
            shell0 = occ if shell0 is None else shell0 | occ
    return LatticeEvalTables(
        av0=av0, fdp=tuple(t.to(compute_dtype) for t in fdp),
        mask0=mask0, shell0=shell0)


class LatticeEvalContext:
    """Carried by HostField: the plan geometry plus the solved field,
    with the device tables prepared on first query."""

    def __init__(self, spec, origins: np.ndarray, interp: Interpolators,
                 basis_features, vox_cell, vox_active, voxel_size: float,
                 approx_grad: bool, compute_dtype, dense_xs):
        self.spec = spec
        self.origins = np.asarray(origins)
        self.interp = interp
        self.basis_features = basis_features
        self.vox_cell = vox_cell
        self.vox_active = vox_active
        self.voxel_size = float(voxel_size)
        self.approx_grad = bool(approx_grad)
        self.compute_dtype = compute_dtype
        self.dense_xs = dense_xs
        self._tables: Optional[LatticeEvalTables] = None

    def tables(self) -> LatticeEvalTables:
        if self._tables is None:
            self._tables = prepare_tables(
                self.spec, self.dense_xs, self.basis_features,
                self.vox_cell, self.vox_active, self.compute_dtype)
        return self._tables

    def _wave(self, grad: bool) -> int:
        spec = self.spec
        cb = self.basis_features[0].shape[-1]
        width = 3 + cb + 2 * self.interp.level(0).layers()[0].out_features
        per_q = spec.depth * 8 * width * 4 * (4 if grad else 1) \
            + spec.lanes * 6
        return max(1024, _WAVE_BYTES // per_q)

    @torch.no_grad()
    def evaluate(self, x: torch.Tensor, grad: bool = False,
                 max_chunk: Optional[int] = None):
        """values (n,), mask (n,) [, gradients (n, 3)] at (n, 3) f32
        device points."""
        spec, k, vs = self.spec, self.spec.k, self.voxel_size
        tab = self.tables()
        dev = tab.av0.device
        cdt = self.compute_dtype
        offs = torch.as_tensor(LAT.CORNER_OFFS, device=dev)
        origins = torch.as_tensor(self.origins.astype(np.int64), device=dev)
        dims = [torch.tensor(dd, device=dev) for dd in spec.dims]
        want_tan = grad and not self.approx_grad
        n = x.shape[0]
        chunk = self._wave(grad)
        if max_chunk is not None:
            chunk = max(1, min(chunk, int(max_chunk)))
        val = torch.empty(n, device=dev)
        mask = torch.empty(n, dtype=torch.bool, device=dev)
        gout = torch.empty((n, 3), device=dev) if grad else None
        w8 = 8 * k
        for s in range(0, n, chunk):
            xc = x[s:s + chunk]
            c0 = torch.floor(xc / vs).long()
            cells = []
            for d in range(spec.depth):
                _, Y, Z = spec.dims[d]
                loc = (c0 >> d) - origins[d]
                ok = ((loc >= 0) & (loc < dims[d])).all(-1)
                flat = (loc[:, 0] * Y + loc[:, 1]) * Z + loc[:, 2]
                cells.append(torch.where(ok, flat, 0))
            avr = tab.av0.index_select(0, cells[0])
            v = torch.zeros(xc.shape[0], device=dev)
            g = torch.zeros((xc.shape[0], 3), device=dev) if grad else None
            for d in range(spec.depth):
                vs_d = vs * (2.0 ** d)
                z0 = (xc / vs_d)[:, None, :] \
                    - (c0 >> d).float()[:, None, :] - offs
                fc = LAT.corner_rows(tab.fdp[d], cells[d], spec, d)
                xin = torch.cat([z0.to(cdt), fc], -1).float()
                raw, draws = mlp_with_tangents(self.interp.level(d), xin,
                                               3 if want_tan else 0)
                w, dw = LAT.window_grad(z0)
                av_d = avr[:, d * w8:(d + 1) * w8].float().view(-1, 8, k)
                v += (raw * w[..., None] * av_d).sum((1, 2))
                if grad:
                    for a in range(3):
                        db = raw * dw[..., a, None]
                        if want_tan:
                            db = db + draws[a] * w[..., None]
                        g[:, a] += (db * av_d).sum((1, 2)) / vs_d
            val[s:s + chunk] = v
            mask[s:s + chunk] = tab.mask0[cells[0]]
            if grad:
                gout[s:s + chunk] = g
        return (val, mask, gout) if grad else (val, mask)

    def eval_batched(self, x: np.ndarray, grad: bool = False):
        """``evaluate`` on host arrays: numpy in, numpy out."""
        dev = self.tables().av0.device
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return tuple(o.cpu().numpy() for o in self.evaluate(xt, grad=grad))
