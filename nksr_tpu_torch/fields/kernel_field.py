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

The field follows PyTorch's grad mode.  Under autograd (the training
forward) the unfused solve is ``solve_spd``, the implicitly
differentiated PCG, with the support rows as the operator's inputs, and
``evaluate_f`` differentiates through the supports and the
coefficients.  Inference builds no graph: ``Reconstructor`` freezes its
network and reconstructs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.network import MLP
from ..solver.pcg import solve_spd
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

    def to(self, device) -> "KernelField":
        """Move the basis features and coefficients to ``device`` in place
        (the MLPs stay with the network)."""
        self.features = tuple(f.to(device) for f in self.features)
        if self.alpha is not None:
            self.alpha = tuple(a.to(device) for a in self.alpha)
        return self

    def support(self, x: torch.Tensor, sup_idx, grad: bool = False):
        return S.svh_support(self.voxel_sizes, self.features, self.mlps, x,
                             sup_idx, grad=grad,
                             approx_grad=self.approx_kernel_grad)

    # ------------------------------------------------------------- solving
    def normal_equations(self, *args, **kw):
        """(matvec, rhs, Jacobi diagonal) of the solve's SPD system (the
        arguments of ``_system``), ``matvec(a)`` the operator applied."""
        matvec, op, rhs, diag = self._system(*args, **kw)
        return (lambda a: matvec(a, *op)), rhs, diag

    def _system(self, pos_xyz, pos_w, normal_xyz, normal_w,
                normal_value, reg_weight: float = 1.0,
                pos_sup_idx=None, normal_sup_idx=None,
                fused: bool = False):
        """(matvec, op, rhs, Jacobi diagonal) of the solve's SPD system:
        ``matvec(a, *op)`` is linear in ``a``, and ``op`` the support
        tensors it reads (each depth's value-row basis, then each depth's
        gradient-row dbasis), so ``solver.pcg.solve_spd`` differentiates
        through them.  ``pos_w`` / ``normal_w`` per-row weights;
        ``*_sup_idx`` the rows' host support tables.  Unfused, the
        supports are built once and held; fused, every matvec rebuilds
        them, so one row block is alive at a time (no gradient: the
        rebuilt supports are not inputs of the solve, so it raises where
        the supports carry a graph).  The diagonal is a constant."""
        shapes = self._shapes()
        n = len(shapes)
        sg = self.support(normal_xyz, normal_sup_idx, grad=True)
        if fused and any(s.dbasis.requires_grad for s in sg):
            raise ValueError("fused_mode recomputes the supports in every "
                             "matvec and cannot be differentiated; solve "
                             "unfused under autograd")
        # the scatters' summation orders follow the host support rows
        # only: built once for the whole solve
        og = S.scatter_orders(sg, shapes)
        rhs = S.scatter_rows(sg, shapes, normal_w[:, None] * normal_value,
                             grad=True, orders=og)
        sv = self.support(pos_xyz, pos_sup_idx)
        ov = S.scatter_orders(sv, shapes)
        with torch.no_grad():
            dg = S.diag_contrib(sg, shapes, normal_w, grad=True, orders=og)
            dv = S.diag_contrib(sv, shapes, pos_w, orders=ov)
            diag = tuple(a + b + reg_weight for a, b in zip(dv, dg))
        def apply(a, sup_v, sup_g):
            out = S.scatter_rows(sup_v, shapes, pos_w * S.predict(sup_v, a),
                                 orders=ov)
            _, fg = S.predict(sup_g, a, grad=True)
            out_g = S.scatter_rows(sup_g, shapes, normal_w[:, None] * fg,
                                   grad=True, orders=og)
            return tuple(v + g + reg_weight * ai
                         for v, g, ai in zip(out, out_g, a))

        if fused:
            del sg, sv

            def matvec(a):
                sup_v = self.support(pos_xyz, pos_sup_idx)
                sup_g = self.support(normal_xyz, normal_sup_idx, grad=True)
                return apply(a, sup_v, sup_g)
            return matvec, (), rhs, diag

        k = self.kernel_dim
        idx_v = tuple(s.idx_k for s in sv)
        # the gradient rows' basis enters only their (discarded) values
        fixed_g = tuple((s.idx_k, s.basis.detach()) for s in sg)

        def matvec_op(a, *op):
            return apply(a, tuple(S.DepthSupport(i, b, None, k)
                                  for i, b in zip(idx_v, op[:n])),
                         tuple(S.DepthSupport(i, b, g, k)
                               for (i, b), g in zip(fixed_g, op[n:])))
        op = tuple(s.basis for s in sv) + tuple(s.dbasis for s in sg)
        return matvec_op, op, rhs, diag

    def solve_non_fused(self, *args, solver_tol: float = 1e-5,
                        max_iters: int = 128, **kw) -> "KernelField":
        """Fit the coefficients (arguments of ``normal_equations``) with
        the supports held for the whole solve; differentiable
        (``solve_spd``) under autograd."""
        return self._solve(*self._system(*args, fused=False, **kw),
                           solver_tol, max_iters)

    def solve_fused(self, *args, solver_tol: float = 1e-5,
                    max_iters: int = 128, **kw) -> "KernelField":
        """``solve_non_fused``'s system with the supports recomputed in
        every matvec (memory for compute; no gradient)."""
        return self._solve(*self._system(*args, fused=True, **kw),
                           solver_tol, max_iters)

    def _solve(self, matvec, op, rhs, diag, tol, max_iters) -> "KernelField":
        def precond(r):
            return tuple(ri / di for ri, di in zip(r, diag))
        alpha = solve_spd(matvec, rhs, op, precond=precond, tol=tol,
                          max_iters=max_iters)
        return self._with(alpha, solve_spd.last_stats)

    def solve(self, *args, fused: bool = False, **kw) -> "KernelField":
        return (self.solve_fused if fused else self.solve_non_fused)(
            *args, **kw)

    # ----------------------------------------------------------- evaluation
    def evaluate_f(self, x: torch.Tensor, sup_idx, grad: bool = False
                   ) -> FieldEval:
        sup = self.support(x, sup_idx, grad=grad)
        if grad:
            v, g = S.predict(sup, self.alpha, grad=True)
            return FieldEval(value=v, gradient=g)
        return FieldEval(value=S.predict(sup, self.alpha))
