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

A field that carries its decoder hierarchy's host grids (the forward's,
``host_grids``) joins the supports of arbitrary points itself
(``HostJoinedField``, shared with the neural geometry head of
``fields/neural_field.py``): ``evaluate_at`` and the masked
``evaluate_f_bar`` take world points, ``evaluate_f`` joins them itself
when it is given no support rows, ``svh`` is the hierarchy as a
``core/svh.SparseFeatureHierarchy``, and ``extract_dual_mesh`` meshes
through ``meshing/dual_mc.py``, coloured by ``set_texture_field``'s
texture.  The mask is ``mask_field`` (the UDF head's ``NeuralField``,
or a ``LayerField``) or, without one, the union of the hierarchy's
supports (``fields/neural_field.LayerField``'s mask).

The field follows PyTorch's grad mode.  Under autograd (the training
forward) the unfused solve is ``solve_spd``, the implicitly
differentiated PCG, with the support rows as the operator's inputs, and
``evaluate_f`` differentiates through the supports and the
coefficients.  Inference builds no graph: ``Reconstructor`` freezes its
network and reconstructs under ``torch.no_grad()``.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import host_build as HB
from ..core.grid import host_array
from ..models.network import MLP
from ..solver.pcg import solve_spd
from . import support as S


class FieldEval(NamedTuple):
    value: torch.Tensor
    gradient: Optional[torch.Tensor] = None


class HostJoinedField:
    """What a field that carries its decoder hierarchy's host grids
    (``host_grids``, ``capacities``, ``voxel_sizes``) gives the in-graph
    mesher (``meshing/dual_mc.py``) and its users, over the field's own
    ``_value_and_grad(x, sup_idx, grad)``: ``evaluate_f(x, grad=False,
    sup_idx=None)``, the supports joined on the host where none are
    given, the masked field, the hierarchy (``svh``), the mesh and its
    texture.  The mask is ``mask_field`` (the UDF head's
    ``NeuralField``, or a ``LayerField``) or, without one, the union of
    the hierarchy's supports at every depth (``LayerField``'s mask);
    ``adaptive_depth`` the depths the mesher's lattice spans without a
    UDF mask.  ``texture_field`` (a ``PCNNField`` or None) colours the
    mesh's vertices."""

    texture_field = None
    mask_field = None
    adaptive_depth = 1

    def host_supports(self, x: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Per depth the (n, 8) support rows of world points ``x`` (f32
        numpy) in the field's host grids, on the field's device."""
        if self.host_grids is None:
            raise ValueError(f"this {type(self).__name__} carries no host "
                             "grids: pass the support rows to evaluate_f")
        caps = self.capacities or [len(g.keys) for g in self.host_grids]
        return tuple(torch.as_tensor(t.astype(np.int64), device=self.device)
                     for t in HB.support_indices(self.host_grids, caps, x))

    def evaluate_f(self, x, grad: bool = False, sup_idx=None) -> FieldEval:
        """(n,) values at (n, 3) points (a tensor on the field's device,
        or numpy), with ``grad`` also their (n, 3) x-gradients;
        ``sup_idx`` per depth the (n, 8) support rows, joined on the
        host when None."""
        if sup_idx is None:
            x = host_array(x, np.float32)
            sup_idx = self.host_supports(x)
            x = torch.as_tensor(x, device=self.device)
        return self._value_and_grad(x, sup_idx, grad)

    def evaluate_at(self, x, grad: bool = False) -> FieldEval:
        """``evaluate_f`` at (n, 3) world points (numpy or a tensor),
        their supports joined on the host."""
        return self.evaluate_f(host_array(x, np.float32), grad=grad)

    @property
    def svh(self):
        """The decoder hierarchy as a ``core/svh.SparseFeatureHierarchy``
        on the field's device (``svh.voxel_size`` the finest level's)."""
        from ..core.svh import SparseFeatureHierarchy
        if self.host_grids is None:
            raise ValueError(f"this {type(self).__name__} carries no host "
                             "grids")
        caps = self.capacities or [len(g.keys) for g in self.host_grids]
        return SparseFeatureHierarchy.from_host(self.host_grids, caps,
                                                device=self.device)

    def _trust(self, x: np.ndarray, xt: torch.Tensor, sup) -> torch.Tensor:
        """The mask at host points ``x`` (``xt`` on the field's device)
        whose supports are ``sup``: the mask field's, its supports joined
        on the host where it has host grids, or without one
        ``LayerField``'s union of ``sup``."""
        from .neural_field import LayerField
        if self.mask_field is None:
            return LayerField.union_mask(sup)
        if isinstance(self.mask_field, HostJoinedField):
            return self.mask_field.evaluate_mask(
                xt, sup_idx=self.mask_field.host_supports(x))
        return self.mask_field.evaluate_mask(xt)

    def evaluate_f_bar(self, x) -> torch.Tensor:
        """The masked field at (n, 3) world points: ``f`` where the mask
        passes (is positive), ``-voxel_size`` elsewhere."""
        x = host_array(x, np.float32)
        sup = self.host_supports(x)
        xt = torch.as_tensor(x, device=self.device)
        f = self._value_and_grad(xt, sup, False).value
        return torch.where(self._trust(x, xt, sup) > 0, f,
                           -self.voxel_sizes[0])

    def set_mask_field(self, field) -> "HostJoinedField":
        """A copy of the field masked with ``field`` (a ``NeuralField`` at
        its level set, or a ``LayerField``; None: the union of the
        supports), as the JAX package's ``replace`` gives; the field
        itself keeps its mask."""
        out = copy.copy(self)
        out.mask_field = field
        return out

    @property
    def mesh_adaptive_depth(self) -> int:
        """The depths the mesher's lattice spans: the JAX package reads
        them from the mask (``LayerField.adaptive_depth``); its UDF mask
        has none, so the lattice is depth 0's alone."""
        from .neural_field import LayerField
        if self.mask_field is None:
            return self.adaptive_depth
        return self.mask_field.adaptive_depth \
            if isinstance(self.mask_field, LayerField) else 1

    def set_texture_field(self, field) -> "HostJoinedField":
        """Colour the mesh with ``field`` (a ``PCNNField``; None: no
        colours).  Sets it in place and returns the field."""
        self.texture_field = field
        return self

    def _move_parts(self, device):
        """Move the mask and the texture to ``device`` in place."""
        for part in (self.mask_field, self.texture_field):
            if part is not None:
                part.to(device)
        return self

    def extract_dual_mesh(self, mise_iter: int = 0, grid_upsample: int = 1,
                          max_points: Optional[int] = None,
                          max_quads: Optional[int] = None):
        """Dual-MC mesh (``meshing/dual_mc.py``; ``mise_iter`` Newton
        steps where the field has coefficients), coloured by the
        texture field if one is set."""
        from ..meshing.dual_mc import extract_dual_mesh
        return extract_dual_mesh(self, mise_iter=mise_iter,
                                 grid_upsample=grid_upsample,
                                 max_points=max_points, max_quads=max_quads)


class KernelField(HostJoinedField):
    """Per-depth voxel sizes, capacities, basis features (cap_d, Cb) and
    interpolator MLPs; ``alpha`` the flat (cap_d * K,) coefficients once
    solved, ``cg_stats`` (iters, rel_res) of that solve.  Optionally the
    decoder hierarchy's ``host_grids`` (``core/host_build.HostGrid``s),
    its ``adaptive_depth`` and the UDF ``mask_field``."""

    def __init__(self, voxel_sizes: Sequence[float],
                 capacities: Sequence[int],
                 features: Sequence[torch.Tensor], mlps: Sequence[MLP],
                 kernel_dim: int, approx_kernel_grad: bool = False,
                 alpha: Optional[Tuple[torch.Tensor, ...]] = None,
                 cg_stats: Optional[Tuple[int, float]] = None,
                 host_grids: Optional[Sequence[Any]] = None,
                 adaptive_depth: int = 1, mask_field: Any = None):
        self.voxel_sizes = tuple(float(v) for v in voxel_sizes)
        self.capacities = tuple(int(c) for c in capacities)
        self.features = tuple(features)
        self.mlps = tuple(mlps)
        self.kernel_dim = int(kernel_dim)
        self.approx_kernel_grad = bool(approx_kernel_grad)
        self.alpha = alpha
        self.cg_stats = cg_stats
        self.host_grids = None if host_grids is None else tuple(host_grids)
        self.adaptive_depth = int(adaptive_depth)
        self.mask_field = mask_field

    def _shapes(self):
        return tuple((c, self.kernel_dim) for c in self.capacities)

    def _with(self, alpha, stats) -> "KernelField":
        out = KernelField(self.voxel_sizes, self.capacities, self.features,
                          self.mlps, self.kernel_dim,
                          self.approx_kernel_grad, tuple(alpha), stats,
                          self.host_grids, self.adaptive_depth,
                          self.mask_field)
        return out.set_texture_field(self.texture_field)

    @property
    def device(self) -> torch.device:
        return self.features[0].device

    def to(self, device) -> "KernelField":
        """Move the basis features, coefficients, mask and texture to
        ``device`` in place (the MLPs stay with the network)."""
        self.features = tuple(f.to(device) for f in self.features)
        if self.alpha is not None:
            self.alpha = tuple(a.to(device) for a in self.alpha)
        return self._move_parts(device)

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
    def _value_and_grad(self, x: torch.Tensor, sup_idx, grad: bool
                        ) -> FieldEval:
        sup = self.support(x, sup_idx, grad=grad)
        if grad:
            v, g = S.predict(sup, self.alpha, grad=True)
            return FieldEval(value=v, gradient=g)
        return FieldEval(value=S.predict(sup, self.alpha))

    def evaluate_mask(self, x) -> torch.Tensor:
        """The signed mask at (n, 3) world points, positive where the
        field is trusted: the mask field's, or without one the union of
        the supports (+1 inside, -1 outside).  A mask field of None
        stands for the ``LayerField`` that the JAX package's
        reconstructions attach, whose mask this is; a JAX ``KernelField``
        built with no mask reads ones here instead."""
        x = host_array(x, np.float32)
        return self._trust(x, torch.as_tensor(x, device=self.device),
                           self.host_supports(x)
                           if self.mask_field is None else None)
