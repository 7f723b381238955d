"""The solved field a ``Reconstructor`` returns: the lattice evaluator and
dense mesher over one solve (counterpart of nksr_tpu/recon/host_field.py,
lattice branches only)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..meshing.lattice_mc import TriangleMesh, extract_dual_mesh_dense
from ..utils.profiling import PhaseTimer


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
    """Solved kernel field on the dense lattice.  ``phase_times``
    collects seconds per stage of the reconstruction and of the last
    mesh extraction."""

    def __init__(self, cfg, host_grids, alpha: Sequence[torch.Tensor],
                 lattice_ctx, solver_stats: SolverStats,
                 phase_times: Optional[dict] = None):
        self.cfg = cfg
        self.host_grids = host_grids
        self.alpha = tuple(alpha)
        self.lattice_ctx = lattice_ctx
        self.solver_stats = solver_stats
        self.phase_times = {} if phase_times is None else phase_times

    def _eval_batched(self, x: np.ndarray, grad: bool = False):
        out = self.lattice_ctx.eval_batched(x, grad=grad)
        return (out[0], out[2]) if grad else out[0]

    def eval_fbar_batched(self, x: np.ndarray) -> np.ndarray:
        """Field value where trusted, ``-voxel_size`` elsewhere."""
        v, m = self.lattice_ctx.eval_batched(x)
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
        tm = PhaseTimer(self.alpha[0].device, self.phase_times)
        self.lattice_ctx.tables()
        tm.lap("evaluator tables")
        mesh = extract_dual_mesh_dense(self.lattice_ctx, mise_iter=mise_iter,
                                       grid_upsample=grid_upsample,
                                       max_points=max_points)
        tm.lap("dual mc")
        return mesh
