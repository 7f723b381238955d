"""The port's chunked out-of-core reconstruction (nksr_tpu_torch/recon/
chunking.py), the README's lidar recipe through it and the sensor-feature
input against nksr_tpu on the CPU, at small sizes, with the same random
weights, f32 on both sides.

Two scenes go through ``reconstruct(..., chunk_size=)`` in both
packages: the plane of tests/test_recon.py::test_chunked_plane (the
splat structure, given normals) and a small lidar-like terrain through
``get_estimate_normal_preprocess_fn`` with the default predicted
structure and the UDF mask head on (the structure heads boosted as in
tests/test_torch_predicted.py, so the prediction keeps voxels).  Each is
held by its chunk set and point selections (equal), its per-chunk
coefficients after 3 CG iterations and its stitched mesh; the blended
field on the JAX package's own chunk solutions (ROADMAP queue 3: never
field values after an unconverged solve).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu import get_estimate_normal_preprocess_fn as jax_preprocess
from nksr_tpu.meshing.dual_mc import TriangleMesh as JTriangleMesh
from nksr_tpu.models import pipeline as JP
from nksr_tpu.recon import chunking as JCH
from nksr_tpu_torch import Reconstructor, get_estimate_normal_preprocess_fn
from nksr_tpu_torch.examples import recons_by_chunk, recons_waymo
from nksr_tpu_torch.fields.lattice_eval import LatticeEvalContext
from nksr_tpu_torch.meshing.lattice_mc import TriangleMesh
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.recon import chunking as CH
from nksr_tpu_torch.recon.host_field import HostField, SolverStats
from nksr_tpu_torch.utils.checkpoint import params_to_torch
from nksr_tpu_torch.utils.scenes import make_terrain_scene

from test_field import sphere_points
from test_torch_dense_unet import random_params, to_jax
from test_torch_predicted import CFG as PRED_CFG
from test_torch_predicted import boosted_params

torch.set_num_threads(1)

ITERS = dict(solver_max_iters=3)
# the plane of test_chunked_plane: open geometry needs the strong
# gradient weight
PLANE_CFG = dict(tree_depth=2, f_maps=8, basis_dim=8, udf_dim=8,
                 voxel_size=0.1, normal_weight=1e6, structure_mode="splat",
                 **ITERS)
# the predicted default with the UDF head, at tests/test_torch_predicted.py's
# size (voxel 0.12, tree depth 3: a 1.2 m halo)
TERRAIN_CFG = dict(PRED_CFG, udf_enabled=True, **ITERS)
# a whole route's coefficients: the UNet's f32 features (1e-5 apart)
# enter the system (tests/test_torch_predicted.py::test_solve_matches_jax)
SOLVE_RTOL = 1e-3


def _plane():
    rng = np.random.default_rng(24)
    xyz = np.zeros((4000, 3), np.float32)
    xyz[:, :2] = rng.uniform(0, 2.0, (4000, 2)).astype(np.float32)
    nrm = np.tile([0, 0, 1.0], (4000, 1)).astype(np.float32)
    return xyz, nrm


def _record_chunks(rec):
    """Wrap ``rec.reconstruct`` so each chunk's call (the recursion
    without ``chunk_size``) records its points and normals."""
    calls, inner = [], rec.reconstruct

    def reconstruct(xyz, normal=None, **kw):
        if kw.get("chunk_size") is None:
            calls.append((np.array(xyz), None if normal is None
                          else np.array(normal)))
        return inner(xyz, normal, **kw)

    rec.reconstruct = reconstruct
    return calls


class Scene:
    """One scene run through chunk mode in both packages: the chunked
    fields, the chunks' inputs and the stitched meshes."""

    def __init__(self, cfg_kw, params, xyz, normal=None, sensor=None,
                 chunk_size=1.0, knn=None):
        self.cfg = P.PipelineConfig(**cfg_kw)
        self.params, self.xyz = params, xyz
        self.jrec = JReconstructor(config=JP.PipelineConfig(**cfg_kw),
                                   params=to_jax(params))
        self.rec = Reconstructor(device="cpu", config=self.cfg,
                                 params=params)
        self.jcalls, self.calls = (_record_chunks(self.jrec),
                                   _record_chunks(self.rec))
        kw = dict(sensor=sensor, chunk_size=chunk_size, solver_tol=1e-12)
        jpre = pre = None
        if knn is not None:
            jpre = jax_preprocess(knn, 85.0)
            pre = get_estimate_normal_preprocess_fn(knn, 85.0, device="cpu")
        self.jcf = self.jrec.reconstruct(xyz, normal, preprocess_fn=jpre,
                                         **kw)
        self.cf = self.rec.reconstruct(xyz, normal, preprocess_fn=pre, **kw)
        self.jmesh = self.jcf.extract_dual_mesh(mise_iter=1)
        self.mesh = self.cf.extract_dual_mesh(mise_iter=1)


@pytest.fixture(scope="module")
def plane():
    xyz, nrm = _plane()
    return Scene(PLANE_CFG, random_params(P.PipelineConfig(**PLANE_CFG), 0),
                 xyz, nrm)


@pytest.fixture(scope="module")
def terrain():
    """A 2.4 m x 1 m strip of the lidar-like terrain, sensor at (0, 0,
    10): two chunks of 1.5 m (each with its 1.2 m halo)."""
    xyz, sensor = make_terrain_scene(3000, extent=2.4, seed=3)
    strip = np.abs(xyz[:, 1]) < 0.5
    return Scene(TERRAIN_CFG, boosted_params(), xyz[strip],
                 sensor=sensor[strip], chunk_size=1.5, knn=16)


SCENES = ["plane", "terrain"]


@pytest.mark.parametrize("scene", SCENES)
def test_chunk_selection_matches_jax(scene, request):
    """The same chunks (ids, bounds) and each chunk's points equal; the
    terrain's normals, estimated in both packages, to 1e-5 (every point
    kept, none near the 85-degree cut, all eigen-gaps clear)."""
    sc = request.getfixturevalue(scene)
    n_chunks = {"plane": 4, "terrain": 2}[scene]
    assert len(sc.cf.chunks) == len(sc.jcf.chunks) == n_chunks
    assert len(sc.calls) == len(sc.jcalls) == n_chunks
    for ch, jch in zip(sc.cf.chunks, sc.jcf.chunks):
        np.testing.assert_array_equal(ch["cid"], jch["cid"])
        np.testing.assert_array_equal(ch["lo"], jch["lo"])
        np.testing.assert_array_equal(ch["hi"], jch["hi"])
        assert ch["lo"].dtype == jch["lo"].dtype == np.float64
    np.testing.assert_array_equal(sc.cf.origin, sc.jcf.origin)
    for (x, n), (jx, jn) in zip(sc.calls, sc.jcalls):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_allclose(n, jn, atol=1e-5)
    for ch, (x, _) in zip(sc.cf.chunks, sc.calls):
        assert ch["n_points"] == len(x) and ch["seconds"] > 0
    if scene == "terrain":
        assert [ch["engine"] for ch in sc.cf.chunks] == ["dense"] * 2
        assert all(ch["field"].has_udf_mask for ch in sc.cf.chunks)


@pytest.mark.parametrize("scene", SCENES)
def test_chunk_solves_match_jax(scene, request):
    """Each chunk's coefficients after 3 CG iterations to rtol 1e-3 (atol
    1e-3 of the largest), with equal iteration counts."""
    sc = request.getfixturevalue(scene)
    k = sc.cfg.kernel_dim
    for ch, jch in zip(sc.cf.chunks, sc.jcf.chunks):
        hf, jhf = ch["field"], jch["field"]
        assert hf.solver_stats.iters == jhf.solver_stats.iters == 3
        for d in range(sc.cfg.tree_depth):
            n = len(hf.host_grids[d].keys)
            assert n == len(jhf.host_grids[d].keys)
            ref = np.asarray(jhf.field.alpha[d]).reshape(-1, k)[:n]
            got = hf.alpha[d].numpy().reshape(-1, k)[:n]
            assert np.abs(ref).max() > 0
            np.testing.assert_allclose(got, ref, rtol=SOLVE_RTOL,
                                       atol=SOLVE_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("scene", SCENES)
def test_stitched_mesh_matches_jax(scene, request):
    """The global dual MC over the chunks' blend: vertex counts within 2%
    and the symmetric nearest-vertex distance (mean of both directions)
    under 0.05 voxel; the port's mesh spans the scene across the seams,
    its stages timed."""
    sc = request.getfixturevalue(scene)
    jv, tv = np.asarray(sc.jmesh.v), sc.mesh.v
    assert len(tv) > 200 and sc.mesh.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.02 * len(jv)
    d = 0.5 * (cKDTree(jv).query(tv)[0].mean()
               + cKDTree(tv).query(jv)[0].mean())
    assert d < 0.05 * sc.cfg.voxel_size
    assert {"mc: chunks to device", "mc: extraction lattice",
            "mc: field eval", "mc: quads"} <= set(sc.cf.phase_times)
    used = tv[np.unique(sc.mesh.f), :2]
    assert (used.min(0) < sc.xyz[:, :2].min(0) + 0.3).all()
    assert (used.max(0) > sc.xyz[:, :2].max(0) - 0.3).all()


def _port_field(cfg, params, jhf):
    """A port HostField over the JAX package's own lattice solution."""
    jctx = jhf.lattice_ctx
    spec = jctx.spec
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    ctx = LatticeEvalContext(
        spec, jctx.origins, net.interpolators,
        [torch.from_numpy(np.array(b)) for b in jctx.basis_features],
        [torch.from_numpy(np.asarray(v).astype(np.int64))
         for v in jctx.vox_cell],
        [torch.from_numpy(np.array(v)) for v in jctx.vox_active],
        jctx.voxel_size, jctx.approx_grad, torch.float32,
        [torch.from_numpy(np.array(x).reshape(-1, spec.k))
         for x in jctx.dense_xs])
    return HostField(cfg, jhf.host_grids,
                     [torch.from_numpy(np.array(a)) for a in jhf.field.alpha],
                     ctx, SolverStats(3, 0.0, 1e-12, 3))


def test_blended_field_matches_jax(plane):
    """``ChunkedField.evaluate_f_bar`` over the JAX package's chunk
    solutions, at probe points inside the blend ramps (within two voxels
    of the seams at x = 1 and y = 1) and across the chunks: rtol 1e-4,
    atol 1e-4 of the largest magnitude (the evaluator's f32 sums in
    another order, tests/test_torch_slice.py)."""
    jcf = plane.jcf
    chunks = [dict(ch, field=_port_field(plane.cfg, plane.params,
                                         ch["field"]))
              for ch in jcf.chunks]
    cf = CH.ChunkedField(chunks, jcf.chunk_size, jcf.voxel_size,
                         origin=jcf.origin, id_lo=jcf.id_lo,
                         id_hi=jcf.id_hi)
    rng = np.random.default_rng(8)
    p = rng.uniform(0.05, 1.95, (3000, 3))
    p[:1000, 0] = 1.0 + rng.uniform(-0.2, 0.2, 1000)
    p[1000:2000, 1] = 1.0 + rng.uniform(-0.2, 0.2, 1000)
    p[:, 2] = rng.uniform(-0.15, 0.15, 3000)
    p = p.astype(np.float32)
    ref = np.asarray(jcf.evaluate_f_bar(p))
    got = cf.evaluate_f_bar(p)
    inside = ref != -np.float32(jcf.voxel_size)
    assert inside.mean() > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_chunks_park_on_the_cpu_and_mesh_on_the_device(monkeypatch):
    """Each chunk's field is parked on ``chunk_tmp_device`` after its
    solve; ``extract_dual_mesh`` moves every chunk to the Reconstructor's
    device before the first evaluation."""
    events = []
    to, ev = HostField.to, HostField._eval_batched
    monkeypatch.setattr(HostField, "to", lambda self, dev: (
        events.append(("to", id(self), torch.device(dev))), to(self, dev))[1])
    monkeypatch.setattr(HostField, "_eval_batched", lambda self, *a, **k: (
        events.append(("eval", id(self), None)), ev(self, *a, **k))[1])
    xyz, nrm = _plane()
    cfg = P.PipelineConfig(**PLANE_CFG)
    rec = Reconstructor(device="cpu", config=cfg,
                        params=random_params(cfg, 0))
    assert rec.chunk_tmp_device == torch.device("cpu")
    cf = rec.reconstruct(xyz[:1500], nrm[:1500], chunk_size=1.0)
    ids = [id(ch["field"]) for ch in cf.chunks]
    assert events == [("to", i, torch.device("cpu")) for i in ids]
    del events[:]
    cf.extract_dual_mesh()
    first_eval = [e[0] for e in events].index("eval")
    assert events[:first_eval] == [("to", i, rec.device) for i in ids]


def _tensors(obj, seen=None):
    """Every tensor reachable from ``obj``'s attributes (tuples, lists,
    dicts and named tuples included; modules are the network's)."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, torch.nn.Module):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        items = obj
    elif isinstance(obj, dict):
        items = obj.values()
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return []
    return [t for it in items for t in _tensors(it, seen)]


@pytest.mark.parametrize("route", ["lattice", "support_row"])
def test_host_field_to_round_trip(route):
    """``HostField.to``: every tensor of the field moves (the meta device
    shows any left behind), and a field moved back evaluates bit-equal,
    its evaluator tables built before the move included."""
    xyz, nrm = sphere_points(1500, r=0.5, seed=31)
    if route == "support_row":     # a bounding box the plan refuses
        xyz = np.concatenate([xyz, xyz[:700] + 200.0]).astype(np.float32)
        nrm = np.concatenate([nrm, nrm[:700]]).astype(np.float32)
    cfg = P.PipelineConfig(**dict(TERRAIN_CFG, structure_mode="splat"))
    rec = Reconstructor(device="cpu", config=cfg, params=boosted_params())
    hf = rec.reconstruct(xyz, nrm, detail_level=None, voxel_size=0.12)
    assert (hf.lattice_ctx is None) == (route == "support_row")
    assert hf.has_udf_mask
    rng = np.random.default_rng(9)
    probe = (xyz[rng.integers(0, len(xyz), 800)]
             + rng.normal(scale=0.1, size=(800, 3))).astype(np.float32)
    before = hf.evaluate_f(probe, grad=True), hf.evaluate_f_bar(probe)
    hf.to("cpu")
    after = hf.evaluate_f(probe, grad=True), hf.evaluate_f_bar(probe)
    np.testing.assert_array_equal(after[0].value, before[0].value)
    np.testing.assert_array_equal(after[0].gradient, before[0].gradient)
    np.testing.assert_array_equal(after[1], before[1])
    hf.to("meta")
    moved = _tensors(hf)
    assert len(moved) >= 3 * cfg.tree_depth and hf.device.type == "meta"
    assert {t.device.type for t in moved} == {"meta"}


def test_chunk_mode_refuses_detail_tuning():
    """As the JAX package (the reference's restriction): no voxel_size,
    no detail_level in chunk mode."""
    xyz, nrm = sphere_points(500, r=0.5, seed=23)
    rec = Reconstructor(device="cpu", config=P.PipelineConfig(**PLANE_CFG))
    jrec = JReconstructor(config=JP.PipelineConfig(**PLANE_CFG))
    for kw in (dict(voxel_size=0.05), dict(detail_level=0.5)):
        for r in (rec, jrec):
            with pytest.raises(ValueError, match="chunk mode"):
                r.reconstruct(xyz, nrm, chunk_size=1.0, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weld_vertices_matches_jax(seed):
    """Random meshes with near-duplicate vertices: bit-equal to the JAX
    package's weld."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    v = np.concatenate([v, v[:120] + rng.uniform(-1e-7, 1e-7, (120, 3))
                        .astype(np.float32)])
    f = rng.integers(0, len(v), (500, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (len(v), 3)).astype(np.float32) if seed else None
    got = CH.weld_vertices(TriangleMesh(v=v, f=f, c=c), eps=1e-5)
    ref = JCH.weld_vertices(JTriangleMesh(v=v, f=f, c=c), eps=1e-5)
    assert len(got.v) < len(v)
    for a, b in ((got.v, ref.v), (got.f, ref.f), (got.c, ref.c)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.asarray(b).dtype


# ------------------------------------------------ the sensor-feature input
@pytest.mark.parametrize("structure", ["splat", "predicted"])
def test_sensor_feature_solve_matches_jax(structure):
    """``reconstruct(xyz, sensor=sensor)`` with no normals and no
    preprocess: the points' unit view directions are the UNet's input
    (``feature="sensor"``).  Coefficients after 3 CG iterations to rtol
    1e-3 (atol 1e-3 of the largest), equal iteration counts."""
    xyz, _ = sphere_points(1500, r=0.5, seed=31)
    sensor = np.tile(np.float32([0.1, -0.2, 0.05]), (len(xyz), 1))
    cfg_kw = dict(PRED_CFG, structure_mode=structure, **ITERS)
    params = boosted_params()
    kw = dict(detail_level=None, voxel_size=PRED_CFG["voxel_size"],
              solver_tol=1e-12)
    jhf = JReconstructor(config=JP.PipelineConfig(**cfg_kw),
                         params=to_jax(params)).reconstruct(
        xyz, sensor=sensor, **kw)
    rec = Reconstructor(device="cpu", config=P.PipelineConfig(**cfg_kw),
                        params=params)
    hf = rec.reconstruct(xyz, sensor=sensor, **kw)
    assert hf.cfg.feature == jhf.cfg.feature == "sensor"
    assert hf.solver_stats.iters == jhf.solver_stats.iters == 3
    k = hf.cfg.kernel_dim
    for d in range(hf.cfg.tree_depth):
        n = len(hf.host_grids[d].keys)
        assert n == len(jhf.host_grids[d].keys)
        ref = np.asarray(jhf.field.alpha[d]).reshape(-1, k)[:n]
        got = hf.alpha[d].numpy().reshape(-1, k)[:n]
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=SOLVE_RTOL,
                                   atol=SOLVE_RTOL * np.abs(ref).max())


# ------------------------------------------------------------- the examples
@pytest.mark.parametrize("example", ["recons_by_chunk", "recons_waymo"])
def test_examples_run_on_the_cpu(example, tmp_path):
    """Each example end to end at a tiny size on ``device="cpu"`` (a
    small splat configuration: the examples' own untrained default
    predicts no structure), its PLY written with the mesh's counts."""
    cfg = P.PipelineConfig(**dict(PLANE_CFG, normal_weight=1e4))
    rec = Reconstructor(device="cpu", config=cfg,
                        params=random_params(cfg, 1))
    out = tmp_path / "mesh.ply"
    if example == "recons_by_chunk":
        field, mesh = recons_by_chunk.main(n=3000, extent=3.0,
                                           chunk_size=1.5, reconstructor=rec,
                                           out=str(out))
        assert len(field.chunks) == 4
    else:
        field, mesh = recons_waymo.main(n=3000, extent=3.0,
                                        reconstructor=rec, out=str(out))
        assert field.cfg.fused_mode and field.cfg.approx_kernel_grad
    assert len(mesh.v) > 100 and len(mesh.f) > 100
    head = out.read_bytes().split(b"end_header")[0].decode()
    assert re.search(rf"element vertex {len(mesh.v)}\n", head)
    assert re.search(rf"element face {len(mesh.f)}\n", head)


def test_top_level_exports():
    import nksr_tpu_torch
    assert nksr_tpu_torch.get_estimate_normal_preprocess_fn is \
        get_estimate_normal_preprocess_fn
    assert dataclasses.is_dataclass(nksr_tpu_torch.PipelineConfig)


@pytest.mark.parametrize("hi", [3, 2000, 1 << 30])
def test_unique_rows_is_numpys(hi):
    """Chunk ids through packed keys: the rows and order of
    ``np.unique(ids, axis=0)`` (the last case past the keys' range)."""
    rng = np.random.default_rng(hi)
    ids = rng.integers(0, hi, (5000, 3)).astype(np.int64)
    ids[:2500] = ids[2500:]                       # repeated rows
    got, ref = CH.unique_rows(ids), np.unique(ids, axis=0)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
