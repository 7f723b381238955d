"""The support-row kernel field: learned-kernel coefficients fit by a
sparse SPD solve over host-built support rows (counterpart of
nksr_tpu/fields/kernel_field.py ``KernelField``).

The primal weighted least squares in coefficient space

    min_a  sum_i w_pos f_a(x_i)^2 + sum_j w_n |grad f_a(c_j) - n_j|^2
           + reg |a|^2,        f_a(x) = sum_{v,k} a_{v,k} B_{v,k}(x)

has SPD normal equations, applied matrix-free from per-row supports
(``fields/support.py``: gathers, small contractions, index-add scatters)
and solved by Jacobi PCG (``solver/pcg.py``).  ``solve_non_fused`` keeps
the supports for the whole solve; ``solve_fused`` recomputes them in
every matvec (memory for compute), the reference's ``fused_mode``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.network import MLP
from ..solver.pcg import pcg
from . import support as S


class FieldEval(NamedTuple):
    value: torch.Tensor
    gradient: Optional[torch.Tensor] = None


class KernelField:
    """Per-depth voxel sizes, capacities, basis features (cap_d, Cb) and
    interpolator MLPs; ``alpha`` the flat (cap_d * K,) coefficients once
    solved, ``cg_stats`` (iters, rel_res) of that solve."""

    def __init__(self, voxel_sizes: Sequence[float],
                 capacities: Sequence[int],
                 features: Sequence[torch.Tensor], mlps: Sequence[MLP],
                 kernel_dim: int, approx_kernel_grad: bool = False,
                 alpha: Optional[Tuple[torch.Tensor, ...]] = None,
                 cg_stats: Optional[Tuple[int, float]] = None):
        self.voxel_sizes = tuple(float(v) for v in voxel_sizes)
        self.capacities = tuple(int(c) for c in capacities)
        self.features = tuple(features)
        self.mlps = tuple(mlps)
        self.kernel_dim = int(kernel_dim)
        self.approx_kernel_grad = bool(approx_kernel_grad)
        self.alpha = alpha
        self.cg_stats = cg_stats

    def _shapes(self):
        return tuple((c, self.kernel_dim) for c in self.capacities)

    def _with(self, alpha, stats) -> "KernelField":
        return KernelField(self.voxel_sizes, self.capacities, self.features,
                           self.mlps, self.kernel_dim,
                           self.approx_kernel_grad, tuple(alpha), stats)

    def support(self, x: torch.Tensor, sup_idx, grad: bool = False):
        return S.svh_support(self.voxel_sizes, self.features, self.mlps, x,
                             sup_idx, grad=grad,
                             approx_grad=self.approx_kernel_grad)

    # ------------------------------------------------------------- solving
    @torch.no_grad()
    def normal_equations(self, pos_xyz, pos_w, normal_xyz, normal_w,
                         normal_value, reg_weight: float = 1.0,
                         pos_sup_idx=None, normal_sup_idx=None,
                         fused: bool = False):
        """(matvec, rhs, Jacobi diagonal) of the solve's SPD system.
        ``pos_w`` / ``normal_w`` per-row weights; ``*_sup_idx`` the rows'
        host support tables.  Unfused, the supports are built once and
        held; fused, every matvec rebuilds them, so one row block is alive
        at a time."""
        shapes = self._shapes()
        sg = self.support(normal_xyz, normal_sup_idx, grad=True)
        rhs = S.scatter_rows(sg, shapes, normal_w[:, None] * normal_value,
                             grad=True)
        dg = S.diag_contrib(sg, shapes, normal_w, grad=True)
        sv = self.support(pos_xyz, pos_sup_idx)
        dv = S.diag_contrib(sv, shapes, pos_w)
        diag = tuple(a + b + reg_weight for a, b in zip(dv, dg))
        if fused:
            del sg, sv

        def matvec(a):
            sup_v = self.support(pos_xyz, pos_sup_idx) if fused else sv
            out = S.scatter_rows(sup_v, shapes, pos_w * S.predict(sup_v, a))
            del sup_v
            sup_g = (self.support(normal_xyz, normal_sup_idx, grad=True)
                     if fused else sg)
            _, fg = S.predict(sup_g, a, grad=True)
            out_g = S.scatter_rows(sup_g, shapes, normal_w[:, None] * fg,
                                   grad=True)
            return tuple(v + g + reg_weight * ai
                         for v, g, ai in zip(out, out_g, a))

        return matvec, rhs, diag

    def solve_non_fused(self, *args, solver_tol: float = 1e-5,
                        max_iters: int = 128, **kw) -> "KernelField":
        """Fit the coefficients (arguments of ``normal_equations``) with
        the supports held for the whole solve."""
        return self._pcg(*self.normal_equations(*args, fused=False, **kw),
                         solver_tol, max_iters)

    def solve_fused(self, *args, solver_tol: float = 1e-5,
                    max_iters: int = 128, **kw) -> "KernelField":
        """``solve_non_fused``'s system with the supports recomputed in
        every matvec (memory for compute)."""
        return self._pcg(*self.normal_equations(*args, fused=True, **kw),
                         solver_tol, max_iters)

    @torch.no_grad()
    def _pcg(self, matvec, rhs, diag, tol, max_iters) -> "KernelField":
        alpha, iters, rel = pcg(
            matvec, rhs,
            precond=lambda r: tuple(ri / di for ri, di in zip(r, diag)),
            tol=tol, max_iters=max_iters)
        return self._with(alpha, (iters, rel))

    def solve(self, *args, fused: bool = False, **kw) -> "KernelField":
        return (self.solve_fused if fused else self.solve_non_fused)(
            *args, **kw)

    # ----------------------------------------------------------- evaluation
    @torch.no_grad()
    def evaluate_f(self, x: torch.Tensor, sup_idx, grad: bool = False
                   ) -> FieldEval:
        sup = self.support(x, sup_idx, grad=grad)
        if grad:
            v, g = S.predict(sup, self.alpha, grad=True)
            return FieldEval(value=v, gradient=g)
        return FieldEval(value=S.predict(sup, self.alpha))
