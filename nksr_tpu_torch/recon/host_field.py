"""The solved field a ``Reconstructor`` returns (counterpart of
nksr_tpu/recon/host_field.py): one class for both engines.

  * the lattice field carries a ``LatticeEvalContext`` (dense tables,
    one AV0 row gather per query);
  * the support-row field carries a ``KernelField``: each query wave
    gets its support rows from a host join over the decoder grids, then
    the device evaluates the basis; the trust mask is the union of the
    queries' supports.

Meshing takes the dense device mesher where there is a lattice and the
fine grid fits ``DENSE_CELL_BUDGET``, else the host mesher.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import host_build as HB
from ..meshing.host_mc import host_extract_dual_mesh
from ..meshing.lattice_mc import TriangleMesh, extract_dual_mesh_dense
from ..utils.profiling import PhaseTimer

# queries per support-row evaluation wave (the gradient wave holds about
# 7 KB of supports and temporaries a query)
_EVAL_BATCH = 1 << 20


def _in_support(sup_idx) -> np.ndarray:
    """True where a query has a support row at any depth."""
    return np.logical_or.reduce([(t >= 0).any(1) for t in sup_idx])


class SolverStats:
    """CG convergence diagnostics: iterations run and final relative
    residual, against the solver's tolerance and iteration cap."""

    def __init__(self, iters: int, rel_res: float, tol: float,
                 max_iters: int):
        self.iters = int(iters)
        self.rel_res = float(rel_res)
        self.tol = float(tol)
        self.max_iters = int(max_iters)

    @property
    def converged(self) -> bool:
        return self.rel_res <= self.tol

    def __repr__(self):
        return (f"SolverStats(iters={self.iters}, "
                f"rel_res={self.rel_res:.3e}, tol={self.tol:.1e}, "
                f"converged={self.converged})")


class FieldEval(NamedTuple):
    value: np.ndarray
    gradient: Optional[np.ndarray] = None


class HostField:
    """Solved kernel field plus the host grids it lives on.
    ``phase_times`` collects seconds per stage of the reconstruction and
    of the last mesh extraction."""

    def __init__(self, cfg, host_grids, alpha: Sequence[torch.Tensor],
                 lattice_ctx, solver_stats: SolverStats,
                 phase_times: Optional[dict] = None, field=None,
                 capacities: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.host_grids = host_grids
        self.alpha = tuple(alpha)
        self.lattice_ctx = lattice_ctx
        self.field = field
        self.capacities = None if capacities is None else tuple(capacities)
        self.solver_stats = solver_stats
        self.phase_times = {} if phase_times is None else phase_times

    @property
    def device(self) -> torch.device:
        return self.alpha[0].device

    def _support_eval(self, x: np.ndarray, grad: bool, tm=None):
        """Support-row field on host points: values, union-of-support
        mask and (with ``grad``) gradients, in waves.  ``tm`` (a
        ``PhaseTimer``) splits the time into host joins and device
        evaluation."""
        n = x.shape[0]
        vals = np.empty(n, np.float32)
        mask = np.empty(n, bool)
        grads = np.empty((n, 3), np.float32) if grad else None
        for s in range(0, n, _EVAL_BATCH):
            xb = x[s:s + _EVAL_BATCH]
            sup = HB.support_indices(self.host_grids, self.capacities, xb)
            inside = _in_support(sup)
            idx = tuple(torch.as_tensor(t.astype(np.int64), device=self.device)
                        for t in sup)
            if tm is not None:
                tm.lap("mc: support joins")
            out = self.field.evaluate_f(
                torch.as_tensor(xb, device=self.device), idx, grad=grad)
            vals[s:s + len(xb)] = out.value.cpu().numpy()
            mask[s:s + len(xb)] = inside
            if grad:
                grads[s:s + len(xb)] = out.gradient.cpu().numpy()
            if tm is not None:
                tm.lap("mc: device eval")
        return vals, mask, grads

    def _eval_batched(self, x: np.ndarray, grad: bool = False, tm=None):
        x = np.asarray(x, np.float32)
        if self.lattice_ctx is not None:
            out = self.lattice_ctx.eval_batched(x, grad=grad)
            return (out[0], out[2]) if grad else out[0]
        v, _, g = self._support_eval(x, grad, tm)
        return (v, g) if grad else v

    def _mask_host(self, x: np.ndarray) -> np.ndarray:
        """Trust mask: the lattice's trusted cells, or the union of the
        queries' supports."""
        x = np.asarray(x, np.float32)
        if self.lattice_ctx is not None:
            return self.lattice_ctx.eval_batched(x)[1]
        return _in_support(HB.support_indices(self.host_grids,
                                              self.capacities, x))

    def eval_fbar_batched(self, x: np.ndarray, tm=None) -> np.ndarray:
        """Field value where trusted, ``-voxel_size`` elsewhere."""
        x = np.asarray(x, np.float32)
        if self.lattice_ctx is not None:
            v, m = self.lattice_ctx.eval_batched(x)
        else:
            v, m, _ = self._support_eval(x, False, tm)
        return np.where(m, v, -self.host_grids[0].voxel_size
                        ).astype(np.float32)

    def evaluate_f(self, x, grad: bool = False) -> FieldEval:
        x = np.asarray(x, np.float32)
        if grad:
            v, g = self._eval_batched(x, grad=True)
            return FieldEval(value=v, gradient=g)
        return FieldEval(value=self._eval_batched(x))

    def extract_dual_mesh(self, mise_iter: int = 0, grid_upsample: int = 1,
                          max_points: Optional[int] = None) -> TriangleMesh:
        """Dual mesh of the zero set; ``max_points`` bounds each
        field-evaluation wave."""
        tm = PhaseTimer(self.device, self.phase_times)
        if self.lattice_ctx is not None:
            self.lattice_ctx.tables()
            tm.lap("evaluator tables")
            mesh = extract_dual_mesh_dense(
                self.lattice_ctx, mise_iter=mise_iter,
                grid_upsample=grid_upsample, max_points=max_points)
            if mesh is not None:
                tm.lap("dual mc")
                return mesh
        mesh = host_extract_dual_mesh(self, mise_iter=mise_iter,
                                      grid_upsample=grid_upsample,
                                      max_points=max_points)
        tm.lap("host dual mc")
        return mesh
