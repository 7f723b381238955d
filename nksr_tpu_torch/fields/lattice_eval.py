"""Lattice-native field evaluation (counterpart of
nksr_tpu/fields/lattice_eval.py): dense tables built once per solved
field, then one AV0 row gather and one corner-feature gather per query.

  * once: the forward cascade kernel expands the solved coefficient
    lattices into AV0; the basis features are scattered onto the dense
    lattices; per-depth corner activity is folded into one depth-0
    trust mask (the union of the depths' supports) and the depth-0 voxel
    occupancy gives the extraction shell.
  * per query: integer cells from ``floor(x / voxel_size)``, then the
    basis MLP, window and (optionally) gradient in f32: on the card one
    launch of the fused field kernel a wave
    (``basis_kernels.basis_field``), on the CPU its plain version.

Queries outside the lattice alias to dense cell 0, whose margin is
structurally inactive: value 0, mask False.  Waves are sized by memory
alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import basis_kernels as BK
from . import lattice as LAT
from . import lattice_kernels as LK
from ..models.network import Interpolators

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
    fdp, adp = LAT.scatter_tables(spec, basis_features, vox_cell,
                                   vox_active)
    return tables_from(spec, dense_xs, fdp, adp, compute_dtype)


def tables_from(spec, dense_xs, fdp, adp, compute_dtype
                ) -> LatticeEvalTables:
    """Evaluator tables from the dense coefficient lattices and the
    padded per-depth basis feature and activity tables."""
    av0 = LK.av0_cascade(spec, dense_xs, compute_dtype)
    mask0 = shell0 = None
    for d in range(spec.depth):
        n = spec.n_cells(d)
        cells = torch.arange(n, device=av0.device)
        any_c = (BK.corner_rows(adp[d], cells, spec, d)[..., 0] > 0).any(-1)
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
                 approx_grad: bool, compute_dtype, dense_xs,
                 tables: Optional[LatticeEvalTables] = None):
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
        self._tables = tables
        self._packed: Optional[BK.PackedMLP] = None

    def to(self, device) -> "LatticeEvalContext":
        """Move the solved field, and its tables once built, to
        ``device`` in place (the MLPs stay with the network)."""
        def mv(ts):
            return tuple(t.to(device) for t in ts)
        self.basis_features = mv(self.basis_features)
        self.vox_cell = mv(self.vox_cell)
        self.vox_active = mv(self.vox_active)
        self.dense_xs = mv(self.dense_xs)
        self._packed = None
        if self._tables is not None:
            tab = self._tables
            self._tables = LatticeEvalTables(
                tab.av0.to(device), mv(tab.fdp), tab.mask0.to(device),
                tab.shell0.to(device))
        return self

    def tables(self) -> LatticeEvalTables:
        if self._tables is None:
            self._tables = prepare_tables(
                self.spec, self.dense_xs, self.basis_features,
                self.vox_cell, self.vox_active, self.compute_dtype)
        return self._tables

    def _wave(self, grad: bool, kernel: bool) -> int:
        """Queries a wave: by the plain version's temporaries, or on the
        kernel path by the outputs alone (the kernel holds no
        temporaries), so a mesher's call is one launch or a few."""
        if kernel:
            return max(1024, _WAVE_BYTES // (5 + (12 if grad else 0)))
        spec = self.spec
        cb = self.basis_features[0].shape[-1]
        width = 3 + cb + 2 * self.interp.level(0).layers()[0].out_features
        per_q = spec.depth * 8 * width * 4 * (4 if grad else 1) \
            + spec.lanes * 6
        return max(1024, _WAVE_BYTES // per_q)

    def _mlp_pack(self) -> BK.PackedMLP:
        """The MLPs packed for the field kernel, once per context (``to``
        drops the packing; the next call on the card packs again)."""
        if self._packed is None:
            self._packed = BK.pack_mlps(self.interp, self.spec.depth)
        return self._packed

    @torch.no_grad()
    def evaluate(self, x: torch.Tensor, grad: bool = False,
                 max_chunk: Optional[int] = None):
        """values (n,), mask (n,) [, gradients (n, 3)] at (n, 3) f32
        device points, in waves of ``basis_kernels.basis_field``."""
        tab = self.tables()
        kernel = x.device.type != "cpu"
        packed = self._mlp_pack() if kernel else None
        n = x.shape[0]
        chunk = self._wave(grad, kernel)
        if max_chunk is not None:
            chunk = max(1, min(chunk, int(max_chunk)))

        def wave(xc):
            return BK.basis_field(self.spec, self.interp, tab, self.origins,
                                  xc, self.voxel_size, grad,
                                  self.approx_grad, self.compute_dtype,
                                  packed)
        if n <= chunk:
            return wave(x)
        dev = tab.av0.device
        outs = (torch.empty(n, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev)) + \
            ((torch.empty((n, 3), device=dev),) if grad else ())
        for s in range(0, n, chunk):
            for o, part in zip(outs, wave(x[s:s + chunk])):
                o[s:s + chunk] = part
        return outs

    def eval_batched(self, x: np.ndarray, grad: bool = False):
        """``evaluate`` on host arrays: numpy in, numpy out."""
        dev = self.tables().av0.device
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return tuple(o.cpu().numpy() for o in self.evaluate(xt, grad=grad))
