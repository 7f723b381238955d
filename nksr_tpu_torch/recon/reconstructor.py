"""Public reconstruction API (counterpart of
nksr_tpu/recon/reconstructor.py):

    recon = Reconstructor()                     # device="cuda"
    field = recon.reconstruct(xyz, normal)      # structure="predicted"
    mesh  = field.extract_dual_mesh(mise_iter=1)   # mesh.v / mesh.f
    field = recon.reconstruct(xyz, sensor=sensor, chunk_size=20.0,
        preprocess_fn=get_estimate_normal_preprocess_fn(64, 85.0))

Three structures, as in the JAX package:

  * "splat" (the point splat) and "adaptive" (the normal-variation
    decoder hierarchy over the splat encoder): host grid build and
    lattice plan (numpy + C++), the UNet, the kernel solve, the field
    evaluator and dual marching cubes.  The route is chosen as the JAX
    package chooses it, by the same budgets in the same order:

      - lattice: the plan exists and its feature lattices fit
        ``DENSE_UNET_CELLMAP_BUDGET``: the dense conv3d UNet, the primal
        lattice CG solve and the lattice evaluator;
      - route A: the plan exists but the feature lattices do not fit:
        the gather-conv UNet over host tables, then the lattice solve;
      - route B (the sparse fallback): ``plan_lattice`` returns None (the
        dense coefficients would exceed its budget): the gather-conv
        UNet, the support-row kernel solve and the host dual MC.

    With "adaptive" the gather-conv UNet of routes A and B keeps the
    splat hierarchy as its decoder's candidates (the JAX package's
    teacher-forced run over host tables) and writes its basis and
    normal heads at the decoder voxels' rows; the solve's rows and the
    field live on the decoder hierarchy, the UDF head on the splat one.
  * "predicted" (the default: the UNet predicts the decoder hierarchy):
    the one-pass dense engine (``recon/predicted_dense.py``) where its
    child-cover lattice fits ``DENSE_PRED_CELLMAP_BUDGET`` and the
    prediction keeps a voxel, else the per-level engine
    (``recon/host_predicted.py``); both end in the lattice solve, or in
    the support-row solve for a bounding box the plan refuses.

"predicted_ingraph" is the JAX package's in-graph route: capacities
estimated from a subsample (``estimate_capacities``), the inference
forward (``models/pipeline.infer``: the gather-conv UNet on its predicted
structure, each level cut at its capacity, and the support-row solve),
and a ``KernelField`` that meshes through ``meshing/dual_mc.py``, where
``mise_iter`` means Newton steps.  It is the one route of
``geometry="neural"`` (a config's ``geometry: neural``): the field is then
the ``NeuralField`` of the SDF decoder over the basis features, with no
solve and no Newton step.  The host routes (splat, adaptive, predicted,
and chunks of them) raise ``ValueError`` for it, where the JAX package
builds a kernel field whatever the geometry.

Every field colours its meshes with a texture field
(``fields/neural_field.PCNNField``, through ``set_texture_field``), on
the dense, host and in-graph meshers and the chunked meshes.

A model with a UDF head (``udf_enabled``, e.g. ``runs/scene_big`` under
its own config.yaml through ``train.driver.pipeline_config_from_yaml``)
runs every route above with the head's mask on its field: the head reads
the encoder's splat hierarchy on the splat and adaptive structures and
the candidate hierarchy on the predicted one, as in the JAX package.

The README's lidar recipe runs too: ``reconstruct(xyz, sensor=...,
chunk_size=..., preprocess_fn=get_estimate_normal_preprocess_fn(64,
85.0))`` estimates normals on the device (``ops/knn.py``), then splits
the scene into chunks, each reconstructed alone by this class and parked
on ``chunk_tmp_device`` (``recon/chunking.py``); the returned
``ChunkedField`` meshes the blend of all chunks with the host mesher.
Without normals and without a preprocess, the points' sensor directions
are the input feature (``feature="sensor"``).

The dense mesher meshes a lattice field whose fine grid fits
``meshing.lattice_mc.DENSE_CELL_BUDGET``, the host mesher any other
field; with a UDF mask the dense mesher trims and the host mesher seals
(``recon/host_field.py``).  ``_last_unet_engine`` records "dense" or "sparse",
``_last_pred_engine`` "dense" or "host-per-level".  Nothing falls back
to another engine or to the CPU.

``mesh=`` (a ``parallel.make_mesh()`` device mesh; every rank calls
``reconstruct`` with the same cloud) runs the JAX package's sharded
routes over ``torch.distributed``: splat and adaptive on the dense UNet's
route and predicted on the one-pass dense engine solve in x-slabs
(``parallel/lattice_shard.py``), each rank ending with the whole field,
whose ``extract_dual_mesh`` is then a collective (``parallel/
mesh_shard.py``); with ``chunk_size`` the chunks are dealt over the
ranks (``parallel/spatial.py``).  Where the slab-aligned plan or the
dense engine does not apply, every rank reconstructs the whole scene
alone, as in the JAX package (an engine demotion on stderr).  The
sharded solve is the primal's: ``solver_formulation="dual"`` with
``mesh=`` raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import host_build as HB
from ..fields.lattice import plan_lattice
from ..models import dense_unet as DU
from ..models import pipeline as P
from ..models import sparse_unet as SU
from ..models.network import NKSRNetwork
from ..ops import knn as K
from ..ops.gather_scatter import stencil_offsets
from ..utils.checkpoint import params_to_torch
from ..utils.profiling import PhaseTimer
from .host_field import HostField
from .host_predicted import reconstruct_predicted_host
from ..utils.profiling import log_engine_demotion
from .predicted_dense import (reconstruct_predicted_dense,
                              reconstruct_predicted_sharded)
from .solve_tail import (UdfHead, lattice_field, resolve_solver_dtype,
                         sharded_lattice_field, support_row_field)

# total dense cells (all depths) x f_maps the conv3d UNet may hold;
# beyond it the gather-conv UNet runs
DENSE_UNET_CELLMAP_BUDGET = 400_000_000


def _next_pow2(n: int) -> int:
    return 1 << max(8, int(math.ceil(math.log2(max(n, 1)))))


def _check_geometry(cfg) -> None:
    """A geometry other than the kernel's runs on the in-graph route
    alone (``models/pipeline.geometry_field`` knows them).  The JAX
    package's host routes build a kernel field whatever the geometry;
    the port refuses them rather than answer with another geometry."""
    if cfg.geometry != "kernel" and \
            cfg.structure_mode != "predicted_ingraph":
        raise ValueError(
            f"geometry={cfg.geometry!r} runs on structure="
            f"'predicted_ingraph' only, not on structure="
            f"{cfg.structure_mode!r} (a host route, which solves a kernel "
            "field)")


def _check_mesh(mesh) -> None:
    """``mesh=`` takes the device mesh ``parallel.make_mesh`` returns."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(
            f"mesh= takes a 1-D DeviceMesh from parallel.make_mesh() "
            f"(multi-GPU reconstruction, ROADMAP item 15a), not "
            f"{type(mesh).__name__}")


def _check_sharded(cfg) -> None:
    """The x-slab solve is the primal's; the JAX package's sharded route
    runs the primal whatever the formulation, the port refuses the dual
    rather than answer with the other formulation."""
    if cfg.solver_formulation != "primal":
        raise ValueError(
            f"solver_formulation={cfg.solver_formulation!r} does not run "
            "with mesh=: the sharded solve (parallel/lattice_shard.py) "
            "solves the primal formulation only")


def _demote_sharded(cfg, why: str) -> None:
    """Every rank reconstructs the whole scene on its own device, as the
    JAX package does where its sharded solve does not apply."""
    log_engine_demotion("sharded-svh-solve", "single-device",
                        f"structure={cfg.structure_mode!r}: {why}")


def _dense_unet_fits(spec, cfg) -> bool:
    """The dense conv3d UNet's feature lattices fit the budget."""
    total = sum(spec.n_cells(d) for d in range(spec.depth))
    return total * cfg.f_maps <= DENSE_UNET_CELLMAP_BUDGET


def _set_matmul_precision() -> None:
    """Full f32 in f32 matmuls and convs on the card: cuDNN would run
    f32 convs in TF32 by default.  bf16 work stays bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Reconstructor:
    """Neural-kernel surface reconstruction on one device.

    ``device`` defaults to ``"cuda"`` and has no fallback: without a GPU
    the constructor raises; the CPU runs only when asked for
    (``device="cpu"``).  ``params``: a flax-layout parameter tree (e.g.
    ``utils.checkpoint.load_tree`` of a JAX checkpoint); None draws
    seeded random weights (``models.pipeline.init_params``)."""

    def __init__(self, device="cuda", config: Optional[P.PipelineConfig] = None,
                 params=None, seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Reconstructor(device='cuda'): no CUDA "
                                   "device is available")
            _set_matmul_precision()
        self.config = config or P.PipelineConfig()
        if params is None:
            params = P.init_params(self.config, seed)
        net = NKSRNetwork(self.config)
        net.load_state_dict(params_to_torch(params), strict=True)
        # frozen: fields evaluated after reconstruct (outside its
        # no_grad) build no graph
        self.network = net.to(self.device).eval().requires_grad_(False)
        # where chunked mode parks each chunk's field between its solve
        # and the mesh (the reference's attribute)
        self.chunk_tmp_device = torch.device("cpu")

    # ------------------------------------------------------------------ api
    @torch.no_grad()
    def reconstruct(self, input_xyz, input_normal=None, *, sensor=None,
                    detail_level: Optional[float] = 0.0,
                    voxel_size: Optional[float] = None,
                    chunk_size: Optional[float] = None,
                    preprocess_fn: Optional[Callable] = None,
                    approx_kernel_grad: bool = False,
                    solver_tol: float = 1e-5,
                    solver_max_iters: Optional[int] = None,
                    fused_mode: bool = False,
                    structure: Optional[str] = None,
                    mesh=None):
        """Reconstruct an implicit field from a point cloud (parameter
        semantics of ``nksr_tpu.Reconstructor.reconstruct``): a
        ``HostField``, or with ``chunk_size`` a ``chunking.ChunkedField``
        whose chunks each took this call with the configuration's
        structure.  ``fused_mode`` selects the support-row solve that
        recomputes its supports in every matvec; the lattice solve is
        matrix-free either way."""
        xyz = np.asarray(input_xyz, np.float32)
        normal = None if input_normal is None else np.asarray(
            input_normal, np.float32)
        sens = None if sensor is None else np.asarray(sensor, np.float32)
        if mesh is not None:
            _check_mesh(mesh)
        if preprocess_fn is not None:
            xyz, normal, sens = preprocess_fn(xyz, normal, sens)
            xyz = np.asarray(xyz, np.float32)
            normal = None if normal is None else np.asarray(normal,
                                                            np.float32)
        if chunk_size is not None:
            if voxel_size is not None or (detail_level or 0.0) != 0.0:
                # the reference's restriction (NKSR-USAGE.md:137)
                raise ValueError(
                    "detail tuning is not supported in chunk mode; "
                    "prescale your cloud instead")
            _check_geometry(self.config)
            if mesh is not None:
                _check_sharded(self.config)
                from ..parallel.spatial import reconstruct_chunks_sharded
                return reconstruct_chunks_sharded(
                    self, xyz, normal, sens, chunk_size, mesh,
                    approx_kernel_grad=approx_kernel_grad,
                    solver_tol=solver_tol)
            from .chunking import reconstruct_chunked
            return reconstruct_chunked(self, xyz, normal, sens, chunk_size,
                                       approx_kernel_grad=approx_kernel_grad,
                                       solver_tol=solver_tol)
        cfg = self._runtime_config(
            self._pick_voxel_size(xyz, detail_level, voxel_size),
            approx_kernel_grad, solver_tol, solver_max_iters,
            feature="normal" if normal is not None else "sensor",
            fused_mode=fused_mode)
        if structure is not None:
            cfg = dataclasses.replace(cfg, structure_mode=structure)
        _check_geometry(cfg)
        if mesh is not None:
            _check_sharded(cfg)
        if cfg.structure_mode == "predicted":
            if mesh is not None:
                hf = self._reconstruct_predicted(cfg, xyz, normal, sens,
                                                 mesh=mesh)
                if hf is not None:
                    return hf
                _demote_sharded(cfg, "the dense engine or its slab-aligned "
                                "plan does not apply")
            return self._reconstruct_predicted(cfg, xyz, normal, sens)
        if cfg.structure_mode == "predicted_ingraph":
            if mesh is not None:
                _demote_sharded(cfg, "no sharded route")
            return self._reconstruct_ingraph(cfg, xyz, normal, sens)
        if cfg.structure_mode not in ("splat", "adaptive"):
            raise ValueError(f"unknown structure {cfg.structure_mode!r}")
        if cfg.structure_mode == "adaptive" and normal is None:
            raise ValueError("adaptive structure needs input normals")
        return self._reconstruct_host(cfg, xyz, normal, sens, mesh=mesh)

    def _inputs(self, cfg, xyz, normal, sens):
        """The points and their input features on the device."""
        dev = self.device
        xyz_t = torch.as_tensor(xyz, device=dev)
        feat = P.point_features(
            cfg, xyz_t,
            normal=None if normal is None else torch.as_tensor(normal,
                                                               device=dev),
            sensor=None if sens is None else torch.as_tensor(sens,
                                                             device=dev))
        return xyz_t, feat

    def _reconstruct_predicted(self, cfg, xyz, normal, sens, mesh=None
                               ) -> Optional[HostField]:
        """The predicted structure: the one-pass dense engine, or the
        per-level engine where it does not apply (the JAX package's
        order).  With ``mesh``: the dense engine with its final solve in
        x-slabs over the mesh, or None where that does not apply."""
        times: dict = {}
        tm = PhaseTimer(self.device, times)
        xyz_t, feat = self._inputs(cfg, xyz, normal, sens)
        # the encoder's splat hierarchy, shared by both engines
        splat = HB.build_splat_grids_ex(xyz, cfg.voxel_size, cfg.tree_depth)
        tm.lap("splat grids")
        if mesh is not None:
            hf = reconstruct_predicted_sharded(cfg, self.network, xyz, xyz_t,
                                               feat, splat, tm, times, mesh)
            if hf is not None:
                self._last_pred_engine = self._last_unet_engine = "dense"
            return hf
        hf = reconstruct_predicted_dense(cfg, self.network, xyz, xyz_t, feat,
                                         splat, tm, times)
        if hf is not None:
            self._last_pred_engine = self._last_unet_engine = "dense"
            return hf
        self._last_pred_engine = "host-per-level"
        self._last_unet_engine = "sparse"
        return reconstruct_predicted_host(cfg, self.network, xyz, xyz_t,
                                          feat, splat, tm, times)

    def _reconstruct_ingraph(self, cfg, xyz, normal, sens):
        """The JAX package's in-graph route: the inference forward
        (``models/pipeline.infer``) at capacities estimated from a
        subsample, each level cut at them; the support-row solve on the
        predicted hierarchy.  Returns its ``KernelField``, which meshes
        through ``meshing/dual_mc.py`` (``mise_iter`` Newton steps).
        ``phase_times``: seconds by stage."""
        times: dict = {}
        tm = PhaseTimer(self.device, times, accumulate=True)
        cfg = dataclasses.replace(
            cfg, capacities=estimate_capacities(xyz, cfg.voxel_size,
                                                cfg.tree_depth))
        _, feat = self._inputs(cfg, xyz, normal, sens)
        tm.lap("infer: upload")
        field = P.infer(cfg, self.network, xyz, feat, tm=tm).field
        field.phase_times = times
        self._last_unet_engine = "sparse"
        return field

    def _reconstruct_host(self, cfg, xyz, normal, sens, mesh=None
                          ) -> HostField:
        """Host-built grids, plan and tables, then the device stages of
        the route the budgets pick (see the module docstring).  With
        ``structure="adaptive"`` the decoder hierarchy (the plan, the
        heads, the solve and the field's mask) is the normal-variation
        one, the encoder's the splat.  With ``mesh`` the plan is the
        slab-aligned one and the solve runs in x-slabs over the mesh
        (the JAX package's ``_reconstruct_sharded``), on the dense
        UNet's route only: where the aligned plan or its feature
        lattices do not fit, the single-device route runs on every
        rank."""
        dev = self.device
        times: dict = {}
        tm = PhaseTimer(dev, times)
        grids, orders = HB.build_splat_grids_ex(xyz, cfg.voxel_size,
                                                cfg.tree_depth)
        caps = tuple(max(_next_pow2(int(len(g.keys) * 1.05)), 512)
                     for g in grids)
        dec_grids, dec_caps = grids, caps
        if cfg.structure_mode == "adaptive":
            dec_grids = HB.build_adaptive_grids(
                xyz, normal, cfg.voxel_size, cfg.tree_depth,
                tau=cfg.adaptive_tau, adaptive_depth=cfg.adaptive_depth,
                splat=(grids, orders))
            dec_caps = tuple(max(_next_pow2(int(len(g.keys) * 1.05)), 512)
                             for g in dec_grids)
        plan_kw = dict(dec_grids=None if dec_grids is grids else dec_grids,
                       dec_caps=None if dec_grids is grids else dec_caps)
        splan = None
        if mesh is not None:
            from ..parallel.lattice_shard import plan_sharded
            out = plan_sharded(grids, caps, xyz, orders[0][0], orders[0][1],
                               cfg.voxel_size, cfg.tree_depth,
                               cfg.adaptive_depth, mesh.size(),
                               k=cfg.kernel_dim, **plan_kw)
            if out is not None and _dense_unet_fits(out[0].spec, cfg):
                plan, splan = out
            else:
                _demote_sharded(cfg, "the slab-aligned lattice or its "
                                "feature lattices exceed the dense budgets")
        if splan is None:
            plan = plan_lattice(grids, caps, xyz, orders[0][0],
                                orders[0][1], cfg.voxel_size, cfg.tree_depth,
                                cfg.adaptive_depth, k=cfg.kernel_dim,
                                **plan_kw)
        dense_unet = plan is not None and _dense_unet_fits(plan.spec, cfg)
        self._last_unet_engine = "dense" if dense_unet else "sparse"

        def up(a, dtype=None):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

        i64 = torch.int64
        xyz_t, feat = self._inputs(cfg, xyz, normal, sens)
        input_normal = feat if cfg.feature == "normal" else None
        tm.lap("host build + plan + upload")

        if dense_unet:
            tables = DU.build_tables(plan.spec, plan.origins, grids, caps,
                                     dev, dec_grids, dec_caps)
            perm = up(orders[0][1], i64)
            base0 = up(HB.unpack64(orders[0][0]), i64)
            basis_f, normal_f, udf_f = DU.dense_unet_apply(
                cfg, self.network, plan.spec, plan.origins, tables,
                xyz_t[perm], None if feat is None else feat[perm], base0)
            tm.lap("dense unet")
            # the UDF head lives on the encoder's splat hierarchy
            udf = None if udf_f is None else UdfHead(grids, caps, udf_f)
            if splan is not None:
                return sharded_lattice_field(
                    cfg, self.network, plan, splan, mesh, dec_grids, xyz_t,
                    input_normal, basis_f, normal_f, tm, times, udf=udf)
            return lattice_field(cfg, self.network, plan, dec_grids, xyz,
                                 xyz_t, input_normal, basis_f, normal_f, tm,
                                 times, dense_prior=True, udf=udf)

        # the points' splat rows into the decoder voxels: the normal
        # prior's (adaptive depths) and route B's value rows (every
        # depth); the encoder's depth-0 table is the first of them unless
        # the decoder is the adaptive one
        n_sup = cfg.tree_depth if plan is None else cfg.adaptive_depth
        pt_sup = tuple(up(t, i64) for t in HB.support_indices(
            dec_grids[:n_sup], dec_caps[:n_sup], xyz,
            presorted=orders[:n_sup]))
        splat0 = pt_sup[0] if dec_grids[0] is grids[0] else up(
            HB.support_indices(grids[:1], caps[:1], xyz,
                               presorted=orders[:1])[0], i64)
        ut = HB.build_unet_tables(grids, caps, stencil_offsets(3))
        ut = HB.UNetTables(*(tuple(up(t, i64) for t in part)
                             for part in ut))
        coords = tuple(up(g.coords, i64) for g in grids)
        dec_rows = tuple(None if r is None else up(r)
                         for r in SU.decoder_rows(grids, dec_grids))
        tm.lap("unet tables")
        basis_f, normal_f, udf_f = SU.sparse_unet_apply(
            cfg, self.network, ut, [len(g.keys) for g in grids], caps,
            coords, xyz_t, feat, splat0, dec_rows, dec_caps)
        del ut, coords, dec_rows, splat0
        tm.lap("sparse unet")
        # the UDF head lives on the encoder's splat hierarchy
        udf = None if udf_f is None else UdfHead(grids, caps, udf_f)
        if plan is None:
            return support_row_field(cfg, self.network, dec_grids, dec_caps,
                                     xyz_t, input_normal, basis_f, normal_f,
                                     pt_sup, tm, times, udf=udf)
        return lattice_field(cfg, self.network, plan, dec_grids, xyz, xyz_t,
                             input_normal, basis_f, normal_f, tm, times,
                             dense_prior=False, pt_sup=pt_sup,
                             dec_caps=dec_caps, udf=udf)

    # -------------------------------------------------------------- helpers
    def _pick_voxel_size(self, xyz: np.ndarray,
                         detail_level: Optional[float],
                         voxel_size: Optional[float]) -> float:
        """``voxel_size`` wins; ``detail_level`` in [0, 1] sweeps coarse ->
        fine around the sampling density; None means the network's
        native scale."""
        if voxel_size is not None:
            return float(voxel_size)
        if detail_level is None:
            return self.config.voxel_size
        sub = xyz[:: max(1, xyz.shape[0] // 5000)]
        from scipy.spatial import cKDTree  # host-side heuristic only
        d, _ = cKDTree(sub).query(sub, k=2)
        spacing = float(np.median(d[:, 1])) + 1e-9
        lo, hi = 1.5 * spacing, 6.0 * spacing
        return float(hi * (1 - detail_level) + lo * detail_level)

    def _runtime_config(self, vs: float, approx_kernel_grad: bool,
                        solver_tol: float, solver_max_iters: Optional[int],
                        feature: str, fused_mode: bool = False
                        ) -> P.PipelineConfig:
        return dataclasses.replace(
            self.config, voxel_size=vs,
            approx_kernel_grad=approx_kernel_grad, solver_tol=solver_tol,
            solver_max_iters=solver_max_iters or self.config.solver_max_iters,
            feature=feature, fused_mode=fused_mode,
            solver_compute_dtype=resolve_solver_dtype(
                self.config.solver_compute_dtype, self.device))


def estimate_capacities(xyz: np.ndarray, voxel_size: float, depth: int
                        ) -> tuple:
    """Per-level capacities estimated as the JAX package's in-graph route
    sizes them (nksr_tpu/recon/reconstructor.py ``_runtime_config``):
    the unique splat corners of every ceil(n / 100,000)-th point, grown
    by step^0.7 (occupied cells grow sublinearly with the points), x1.3,
    the next power of two, at least 512."""
    caps = []
    step = max(1, xyz.shape[0] // 100000)
    sub = xyz[::step]
    offs = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"),
                    -1).reshape(1, 8, 3)
    for d in range(depth):
        base = np.floor(sub / (voxel_size * 2.0 ** d)).astype(np.int64)
        corners = (base[:, None, :] + offs).reshape(-1, 3)
        key = ((corners[:, 0] + (1 << 20)) << 42) \
            + ((corners[:, 1] + (1 << 20)) << 21) \
            + (corners[:, 2] + (1 << 20))
        n_unique = len(np.unique(key))
        scale = min(step, max(1.0, step ** 0.7))
        caps.append(max(_next_pow2(int(n_unique * scale * 1.3)), 512))
    return tuple(caps)


def get_estimate_normal_preprocess_fn(knn: int = 64,
                                      max_angle_deg: float = 85.0,
                                      device="cuda"):
    """The reference's normal-estimation preprocess (NKSR-USAGE.md:109):
    ``fn(xyz, None, sensor)`` returns the kept points, their kNN-PCA
    normals flipped toward the sensor (grazing points beyond
    ``max_angle_deg`` dropped) and None, as numpy arrays.  It computes
    on ``device`` (the card by default; the CPU only when asked for, as
    ``Reconstructor``).  ``fn.phase_times``: the last call's seconds by
    stage ("knn: ...")."""
    device = torch.device(device)
    times: dict = {}

    def fn(xyz, normal, sensor):
        if normal is not None:
            raise ValueError("normals already provided")
        if sensor is None:
            raise ValueError("sensor positions required")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("get_estimate_normal_preprocess_fn(device="
                               "'cuda'): no CUDA device is available")
        times.clear()
        tm = PhaseTimer(device, times)
        xyz = np.asarray(xyz, np.float32)
        xyz_t = torch.as_tensor(xyz, device=device)
        sens_t = torch.as_tensor(np.asarray(sensor, np.float32),
                                 device=device)
        tm.lap("knn: upload")
        nrm, keep = K.estimate_normals(
            xyz_t, knn, K.estimate_cell_size(xyz, knn),
            max_per_cell=max(2 * knn // 9, 8), sensor=sens_t,
            max_angle_deg=max_angle_deg, tm=tm)
        keep_np = keep.cpu().numpy()
        out = xyz[keep_np], nrm.cpu().numpy()[keep_np], None
        tm.lap("knn: readback")
        return out

    fn.phase_times = times
    return fn
