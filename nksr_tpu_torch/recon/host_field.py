"""The solved field a ``Reconstructor`` returns (counterpart of
nksr_tpu/recon/host_field.py): one class for both engines.

  * the lattice field carries a ``LatticeEvalContext`` (dense tables,
    one AV0 row gather per query);
  * the support-row field carries a ``KernelField``: each query wave
    gets its support rows from a host join over the decoder grids, then
    the device evaluates the basis; the trust mask is the union of the
    queries' supports.

A model with a UDF head (``cfg.udf_enabled``) carries its mask field
instead (``fields/neural_field.NeuralField`` at level set ``2 *
voxel_size`` over ``udf_host``, the hierarchy its features live on):
then the trust mask is ``level_set - udf(x) > 0`` alone, on either
engine, and the values are the field's own (the lattice's trusted-cell
mask is not read), as in the JAX package.

Meshing takes the dense device mesher where there is a lattice and the
fine grid fits ``DENSE_CELL_BUDGET``, else the host mesher.  With a UDF
mask the two differ as they do in the JAX package: the dense mesher
TRIMS (faces with a dual vertex outside the mask are dropped after the
Newton step), the host mesher SEALS (corners outside the mask read
``-voxel_size`` through ``eval_fbar_batched``, so the surface closes
at the mask's edge).  Either mesher colours the vertices it keeps with
the texture field (``set_texture_field``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import host_build as HB
from ..fields.neural_field import NeuralField
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
                 capacities: Optional[Sequence[int]] = None,
                 udf_host: Optional[List[HB.HostGrid]] = None,
                 udf_caps: Optional[Sequence[int]] = None,
                 mask_field: Optional[NeuralField] = None):
        self.cfg = cfg
        self.host_grids = host_grids
        self.alpha = tuple(alpha)
        self.lattice_ctx = lattice_ctx
        self.field = field
        self.capacities = None if capacities is None else tuple(capacities)
        self.solver_stats = solver_stats
        self.phase_times = {} if phase_times is None else phase_times
        # the UDF mask head's grids, capacities and field (None without
        # one); the last dense extraction's trim, in triangles
        self.udf_host = udf_host
        self.udf_caps = None if udf_caps is None else tuple(udf_caps)
        self.mask_field = mask_field
        self.trim_stats: Optional[dict] = None
        # colours the meshes (``set_texture_field``)
        self.texture_field = None

    @property
    def device(self) -> torch.device:
        return self.alpha[0].device

    @property
    def svh(self):
        """The decoder hierarchy the field lives on, as a ``core/svh.
        SparseFeatureHierarchy`` on the field's device (the JAX
        package's ``HostField`` reaches its field's ``svh``)."""
        from ..core.svh import SparseFeatureHierarchy
        caps = self.capacities or [len(g.keys) for g in self.host_grids]
        return SparseFeatureHierarchy.from_host(self.host_grids, caps,
                                                device=self.device)

    @property
    def has_udf_mask(self) -> bool:
        return self.udf_host is not None and self.mask_field is not None

    def to(self, device) -> "HostField":
        """Move the field to ``device`` in place: the coefficients, the
        lattice evaluator's state, the support-row field, the UDF
        mask's features and the texture.  The MLPs are the
        Reconstructor's network and stay where it lives, so a field
        parked off the network's device
        cannot be evaluated until it is moved back.  Chunked mode parks
        each chunk on the CPU between its solve and the mesh."""
        for part in (self.lattice_ctx, self.field, self.mask_field,
                     self.texture_field):
            if part is not None:
                part.to(device)
        # the support-row field's coefficients are this field's
        self.alpha = self.field.alpha if self.field is not None else \
            tuple(a.to(device) for a in self.alpha)
        return self

    def set_mask_field(self, mf: Optional[NeuralField]) -> "HostField":
        """Replace the mask field (e.g. ``mask_field.set_level_set(v)``);
        None falls back to the union-of-support / trusted-cell mask."""
        self.mask_field = mf
        return self

    def set_texture_field(self, tex) -> "HostField":
        """Colour the meshes with ``tex`` (a ``fields/neural_field.
        PCNNField``; None: no colours), on the dense and the host mesher
        alike.  Sets it in place and returns the field, as the JAX
        package's ``HostField.set_texture_field``."""
        self.texture_field = tex
        return self

    def udf_mask(self, x: np.ndarray, tm=None) -> torch.Tensor:
        """``level_set - udf(x) > 0`` at (n, 3) host points, as a device
        bool tensor: per wave a host join over ``udf_host``, then the
        pool and the decoder on the device.  ``tm`` (a ``PhaseTimer``)
        splits the time into "mc: udf support joins" and "mc: udf
        mask"."""
        x = np.asarray(x, np.float32)
        out = torch.empty(x.shape[0], dtype=torch.bool, device=self.device)
        for s in range(0, x.shape[0], _EVAL_BATCH):
            xb = x[s:s + _EVAL_BATCH]
            sup = tuple(torch.as_tensor(t.astype(np.int64),
                                        device=self.device)
                        for t in HB.support_indices(self.udf_host,
                                                    self.udf_caps, xb))
            if tm is not None:
                tm.lap("mc: udf support joins")
            out[s:s + len(xb)] = self.mask_field.evaluate_mask(
                torch.as_tensor(xb, device=self.device), sup_idx=sup) > 0
            if tm is not None:
                tm.lap("mc: udf mask")
        return out

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
                torch.as_tensor(xb, device=self.device), grad=grad,
                sup_idx=idx)
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

    def _mask_host(self, x: np.ndarray, tm=None) -> np.ndarray:
        """Trust mask: the UDF mask where the model has one (``tm`` splits
        its time as in ``udf_mask``), else the lattice's trusted cells,
        or the union of the queries' supports."""
        x = np.asarray(x, np.float32)
        if self.has_udf_mask:
            return self.udf_mask(x, tm).cpu().numpy()
        if self.lattice_ctx is not None:
            return self.lattice_ctx.eval_batched(x)[1]
        return _in_support(HB.support_indices(self.host_grids,
                                              self.capacities, x))

    def eval_fbar_batched(self, x: np.ndarray, tm=None) -> np.ndarray:
        """Field value where trusted, ``-voxel_size`` elsewhere (the host
        mesher's corner values: with a UDF mask, its seal)."""
        x = np.asarray(x, np.float32)
        if self.has_udf_mask:
            v = self._eval_batched(x, tm=tm)
            if tm is not None:
                tm.lap("mc: field eval")
            m = self.udf_mask(x, tm).cpu().numpy()
        elif self.lattice_ctx is not None:
            v, m = self.lattice_ctx.eval_batched(x)
        else:
            v, m, _ = self._support_eval(x, False, tm)
        return np.where(m, v, -self.host_grids[0].voxel_size
                        ).astype(np.float32)

    def evaluate_f_bar(self, x) -> np.ndarray:
        """``evaluate_f`` where the mask passes, ``-voxel_size``
        elsewhere."""
        x = np.asarray(x, np.float32)
        return np.where(self._mask_host(x), self._eval_batched(x),
                        -self.host_grids[0].voxel_size).astype(np.float32)

    def evaluate_f(self, x, grad: bool = False) -> FieldEval:
        x = np.asarray(x, np.float32)
        if grad:
            v, g = self._eval_batched(x, grad=True)
            return FieldEval(value=v, gradient=g)
        return FieldEval(value=self._eval_batched(x))

    def extract_dual_mesh(self, mise_iter: int = 0, grid_upsample: int = 1,
                          max_points: Optional[int] = None) -> TriangleMesh:
        """Dual mesh of the zero set, coloured by the texture field if one
        is set; ``max_points`` bounds each field-evaluation wave."""
        tm = PhaseTimer(self.device, self.phase_times)
        if self.lattice_ctx is not None:
            self.lattice_ctx.tables()
            tm.lap("evaluator tables")
            trim = {} if self.has_udf_mask else None
            mesh = extract_dual_mesh_dense(
                self.lattice_ctx, mise_iter=mise_iter,
                grid_upsample=grid_upsample, max_points=max_points,
                udf_mask=(lambda v: self.udf_mask(v.cpu().numpy()))
                if trim is not None else None, trim_stats=trim,
                texture=self.texture_field)
            if mesh is not None:
                tm.lap("dual mc")
                if trim is not None:
                    # the trim as a phase of its own, out of "dual mc"
                    self.phase_times["dual mc"] -= trim["seconds"]
                    self.phase_times["dmc: udf mask trim"] = trim["seconds"]
                self.trim_stats = trim
                return mesh
        mesh = host_extract_dual_mesh(self, mise_iter=mise_iter,
                                      grid_upsample=grid_upsample,
                                      max_points=max_points)
        tm.lap("host dual mc")
        return mesh
