"""The port's UDF mask head against nksr_tpu on the CPU, at a small size:
tree depth 3, f_maps 8, udf_dim 8, a sphere of 1,500 points at voxel
0.12, every weight random (the structure heads boosted as in
tests/test_torch_predicted.py, so the prediction prunes and refines),
f32 on both sides, ``udf_enabled=True`` in both packages.

Held to the JAX package: the mask field's values on the same support
tables (points with no support included); the UDF features of each
route (dense UNet, gather-conv UNet, both predicted engines); the masked
queries of the lattice and support-row fields after a 3-iteration solve
(the seal's corner values); the dense mesher's trim; every route end to
end by its mesh (ROADMAP queue 3: never field values after an
unconverged 16-iteration solve).  Also the port's YAML reader and
``pipeline_config_from_yaml`` on every run config, and the checkpoint's
UDF weights.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from scipy.spatial import cKDTree

from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu.core import host_build as JHB
from nksr_tpu.fields import DecoderFn
from nksr_tpu.fields import NeuralField as JNeuralField
from nksr_tpu.meshing import lattice_mc as JLMC
from nksr_tpu.models import dense_unet as JDU
from nksr_tpu.models import pipeline as JP
from nksr_tpu.models.network import MLP as JMLP
from nksr_tpu.ops import gather_scatter as JGS
from nksr_tpu.recon import host_predicted as JHP
from nksr_tpu.recon import predicted_dense as JPD
from nksr_tpu.recon import reconstructor as JR
from nksr_tpu.recon.host_field import _udf_mask_fn
from nksr_tpu.recon.reconstructor import _compiled_structure
from nksr_tpu.train import driver as JDRV
from nksr_tpu.utils import config as JCFG
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields.neural_field import NeuralField
from nksr_tpu_torch.meshing import lattice_mc as LMC
from nksr_tpu_torch.models import dense_predicted as DP
from nksr_tpu_torch.models import dense_unet as DU
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models import sparse_unet as SU
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.ops import gather_scatter as GS
from nksr_tpu_torch.recon import host_predicted as HP
from nksr_tpu_torch.recon import predicted_dense as PD
from nksr_tpu_torch.recon import reconstructor as R
from nksr_tpu_torch.train.driver import pipeline_config_from_yaml
from nksr_tpu_torch.utils import checkpoint as CK
from nksr_tpu_torch.utils.config import load_config, parse_yaml

from test_field import sphere_points
from test_torch_dense_unet import to_jax
from test_torch_host_plan import _assert_same
from test_torch_predicted import CFG as PRED_CFG
from test_torch_predicted import Case, boosted_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VS = 0.12
CFG = dict(PRED_CFG, udf_enabled=True)
KW = dict(detail_level=None, voxel_size=VS, solver_tol=1e-4,
          solver_max_iters=16)
LEVEL_SET = np.float32(2.0 * VS)
# features of the same f32 UNet summed in other orders (heads of
# tests/test_torch_predicted.py): rtol 1e-4, atol 1e-5 of the largest
FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-5
# one pool and MLP on the same rows: f32 sums in another order
MASK_RTOL, MASK_ATOL = 1e-5, 1e-6
# a mask value this far from 0 (one per mille of the level set, ten
# times the largest mask difference the features' tolerance allows
# here) decides a point the same way in both packages
MASK_CLEAR = 1e-3 * float(LEVEL_SET)


@pytest.fixture(scope="module")
def params():
    return boosted_params()


def _recons(params, **cfg_kw):
    kw = dict(CFG, **cfg_kw)
    return (JReconstructor(config=JP.PipelineConfig(**kw),
                           params=to_jax(params)),
            Reconstructor(device="cpu", config=P.PipelineConfig(**kw),
                          params=params))


def _sphere():
    return sphere_points(1500, r=0.5, seed=31)


def _port_mask_values(hf, x):
    sup = tuple(torch.from_numpy(t.astype(np.int64)) for t in
                HB.support_indices(hf.udf_host, hf.udf_caps, x))
    return hf.mask_field.evaluate_mask(torch.from_numpy(x), sup).numpy()


def _jax_mask_values(jhf, x):
    sup = JHB.support_indices(jhf.udf_host, jhf.udf_caps, x)
    return np.asarray(_udf_mask_fn(jhf.cfg)(
        jhf.field.mask_field, jnp.asarray(x),
        tuple(jnp.asarray(s) for s in sup)))


def _probe_points(xyz, seed=5, n=600):
    """Points near the cloud, through its bounding box and far outside
    it (no support at any depth)."""
    rng = np.random.default_rng(seed)
    near = xyz[rng.integers(0, len(xyz), n)] \
        + rng.normal(scale=0.1, size=(n, 3))
    lo, hi = xyz.min(0) - 0.4, xyz.max(0) + 0.4
    box = rng.uniform(lo, hi, (n, 3))
    far = xyz.mean(0) + rng.uniform(5.0, 9.0, (40, 3)) \
        * rng.choice([-1.0, 1.0], (40, 3))
    return np.concatenate([near, box, far]).astype(np.float32), 40


# --------------------------------------------------------------- (a) mask
def test_neural_field_mask_matches_jax(params):
    """``NeuralField.evaluate_mask`` against the JAX package's
    ``_udf_mask_fn`` on the same hierarchy, support tables, features and
    decoder: rtol 1e-5, atol 1e-6 of the largest value.  A point with no
    support reads ``level_set - decoder(0)`` in both."""
    xyz, _ = _sphere()
    grids, _ = HB.build_splat_grids_ex(xyz, VS, CFG["tree_depth"])
    caps = tuple(1 << int(np.ceil(np.log2(len(g.keys) + 1))) for g in grids)
    rng = np.random.default_rng(7)
    feats = [rng.normal(size=(c, CFG["udf_dim"])).astype(np.float32)
             for c in caps]
    x, n_far = _probe_points(xyz)
    sup = HB.support_indices(grids, caps, x)
    for a, b in zip(sup, JHB.support_indices(grids, caps, x)):
        _assert_same(a, b, "support rows")
    assert all((s[-n_far:] < 0).all() for s in sup)
    assert 0 < (sup[0] >= 0).any(1).sum() < len(x) - n_far

    jcfg = JP.PipelineConfig(**CFG)
    dec = DecoderFn(params=to_jax({"params": params["params"][
        "udf_decoder"]}), module=JMLP(hidden=(2 * CFG["udf_dim"],) * 2,
                                      out=1))
    jmf = JNeuralField(svh=JHB.to_device_svh(grids, caps, VS),
                       features=tuple(jnp.asarray(f) for f in feats),
                       decoder=dec).set_level_set(2.0 * VS)
    ref = np.asarray(_udf_mask_fn(jcfg)(
        jmf, jnp.asarray(x), tuple(jnp.asarray(s) for s in sup)))

    net = NKSRNetwork(P.PipelineConfig(**CFG))
    net.load_state_dict(CK.params_to_torch(params), strict=True)
    net.requires_grad_(False)   # inference, as Reconstructor's network
    mf = NeuralField([P.level_voxel_size(P.PipelineConfig(**CFG), d)
                      for d in range(CFG["tree_depth"])],
                     [torch.from_numpy(f) for f in feats],
                     net.udf_decoder).set_level_set(2.0 * VS)
    got = mf.evaluate_mask(torch.from_numpy(x), tuple(
        torch.from_numpy(s.astype(np.int64)) for s in sup)).numpy()
    assert mf.level_set == float(LEVEL_SET)
    np.testing.assert_allclose(got, ref, rtol=MASK_RTOL,
                               atol=MASK_ATOL * np.abs(ref).max())
    with torch.no_grad():
        at_zero = LEVEL_SET - net.udf_decoder(
            torch.zeros(1, CFG["udf_dim"]))[0, 0].numpy()
    np.testing.assert_array_equal(got[-n_far:], np.full(n_far, at_zero))
    assert 0 < (got > 0).sum() < len(got)


# ------------------------------------------------------ (b) UDF features
def _dense_unet_udf(params):
    """Dense UNet UDF features at the encoder voxels in both packages."""
    cfg, jcfg = P.PipelineConfig(**CFG), JP.PipelineConfig(**CFG)
    xyz, nrm = _sphere()
    grids, orders = HB.build_splat_grids_ex(xyz, VS, cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    plan = LAT.plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            VS, cfg.tree_depth, cfg.adaptive_depth,
                            k=cfg.kernel_dim)
    jt = JDU.build_tables(plan.spec, plan.origins, grids, caps, grids, caps)
    ref = jax.jit(lambda p, x, f, m: JDU.dense_unet_apply(
        jcfg, p, plan.spec, jnp.asarray(plan.origins), jt, x, f, m))(
        to_jax(params), jnp.asarray(xyz), jnp.asarray(nrm),
        jnp.ones(len(xyz), bool))[3]
    net = NKSRNetwork(cfg)
    net.load_state_dict(CK.params_to_torch(params), strict=True)
    tables = DU.build_tables(plan.spec, plan.origins, grids, caps, "cpu")
    perm = orders[0][1]
    with torch.no_grad():
        got = DU.dense_unet_apply(
            cfg, net, plan.spec, plan.origins, tables,
            torch.from_numpy(xyz[perm]), torch.from_numpy(nrm[perm]),
            torch.from_numpy(HB.unpack64(orders[0][0]).astype(np.int64)))[2]
    return ref, got


def _sparse_unet_udf(params):
    """Gather-conv UNet UDF features at the candidate (= splat) rows."""
    cfg = P.PipelineConfig(**CFG)
    xyz, nrm = _sphere()
    grids, orders = HB.build_splat_grids_ex(xyz, VS, cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    jcfg = dataclasses.replace(JP.PipelineConfig(**CFG), capacities=caps,
                               structure_mode="splat")
    svh = JHB.to_device_svh(grids, caps, VS)
    jt = JHB.build_unet_tables(grids, caps, JGS.stencil_offsets(3))
    splat0 = HB.support_indices(grids[:1], caps[:1], xyz,
                                presorted=orders[:1])[0]
    out, _, _ = _compiled_structure(jcfg)(
        to_jax(params), jnp.asarray(xyz), jnp.ones(len(xyz), bool),
        jnp.asarray(nrm), svh, svh, jt, jnp.asarray(splat0))
    net = NKSRNetwork(cfg)
    net.load_state_dict(CK.params_to_torch(params), strict=True)
    ut = HB.build_unet_tables(grids, caps, GS.stencil_offsets(3))
    ut = HB.UNetTables(*(tuple(torch.from_numpy(t.astype(np.int64))
                               for t in part) for part in ut))
    got = SU.sparse_unet_apply(
        cfg, net, ut, [len(g.keys) for g in grids], caps,
        [torch.from_numpy(g.coords.astype(np.int64)) for g in grids],
        torch.from_numpy(xyz), torch.from_numpy(nrm),
        torch.from_numpy(splat0.astype(np.int64)))[2]
    return out.udf_features, got


def _dense_predicted_udf(params):
    case = Case(params, udf_enabled=True)
    jparts = JPD.predicted_structures(*case.jax_args())
    parts = PD.predicted_structures(*case.port_args()[:-1])
    for d in range(CFG["tree_depth"]):
        _assert_same(jparts.cand_host[d].keys, parts.cand_host[d].keys,
                     f"candidates, depth {d}")
    assert tuple(jparts.cand_caps) == parts.cand_caps
    return jparts.udf_f, parts.udf_f


def _per_level_udf(params, monkeypatch):
    case = Case(params, udf_enabled=True)
    monkeypatch.setenv("NKSR_PRED_DENSE", "0")
    jhf = JHP.reconstruct_predicted_host(*case.jax_args())
    hf = HP.reconstruct_predicted_host(*case.port_args())
    for d in range(CFG["tree_depth"]):
        _assert_same(jhf.udf_host[d].keys, hf.udf_host[d].keys,
                     f"candidates, depth {d}")
    assert tuple(jhf.udf_caps) == hf.udf_caps
    return jhf.field.mask_field.features, hf.mask_field.features


@pytest.mark.parametrize("route", ["dense_unet", "sparse_unet",
                                   "dense_predicted", "per_level"])
def test_udf_features_match_jax(params, route, monkeypatch):
    """The UDF head's rows of each route (the cap-padded candidate rows,
    pad rows included, where both packages write the head's bias):
    rtol 1e-4, atol 1e-5 of the largest value."""
    if route == "dense_unet":
        ref, got = _dense_unet_udf(params)
    elif route == "sparse_unet":
        ref, got = _sparse_unet_udf(params)
    elif route == "dense_predicted":
        ref, got = _dense_predicted_udf(params)
    else:
        ref, got = _per_level_udf(params, monkeypatch)
    assert len(ref) == len(got) == CFG["tree_depth"]
    for d in range(CFG["tree_depth"]):
        r = np.asarray(ref[d])
        assert got[d].shape == r.shape and r.shape[1] == CFG["udf_dim"]
        assert np.abs(r).max() > 0.1
        np.testing.assert_allclose(got[d].numpy(), r, rtol=FEAT_RTOL,
                                   atol=FEAT_ATOL * np.abs(r).max(),
                                   err_msg=f"{route} depth {d}")


# ------------------------------------------------- (c) masked queries
def _two_spheres():
    """Two spheres 200 m apart: a bounding box ``plan_lattice`` refuses
    (route B, the support-row solve and the host mesher)."""
    xyz, nrm = _sphere()
    shift = np.array([200.0, 200.0, 200.0], np.float32)
    return (np.concatenate([xyz, xyz[:700] + shift]).astype(np.float32),
            np.concatenate([nrm, nrm[:700]]).astype(np.float32))


@pytest.mark.parametrize("route", ["lattice", "route_b"])
def test_masked_queries_match_jax(params, route):
    """``eval_fbar_batched`` (the host mesher's corner values: with a UDF
    mask, its seal) and ``evaluate_f_bar`` after a 3-iteration solve:
    the UDF mask decides every point clear of its threshold as the JAX
    package's does; where it passes both read the field (rtol 1e-3,
    atol 1e-3 of the largest value, as the solves after 3 iterations
    agree), elsewhere -voxel_size exactly.  On the lattice the field is
    read where the UDF passes even outside the lattice's trusted cells
    (points far from the cloud included: the cell they alias to)."""
    jrec, rec = _recons(params, structure_mode="splat")
    xyz, nrm = _sphere() if route == "lattice" else _two_spheres()
    kw = dict(KW, solver_max_iters=3, solver_tol=1e-12)
    jhf = jrec.reconstruct(xyz, nrm, **kw)
    hf = rec.reconstruct(xyz, nrm, **kw)
    assert (hf.lattice_ctx is None) == (jhf.lattice_ctx is None) \
        == (route == "route_b")
    assert hf.has_udf_mask and hf.udf_host is not None
    for a, b in zip(jhf.udf_host, hf.udf_host):
        _assert_same(a.keys, b.keys, "UDF grids (the encoder's)")
    x, n_far = _probe_points(xyz[:1500])
    jm, tm = _jax_mask_values(jhf, x), _port_mask_values(hf, x)
    clear = np.abs(jm) > MASK_CLEAR
    assert clear.mean() > 0.95
    jpass, tpass = jhf._mask_host(x), hf._mask_host(x)
    np.testing.assert_array_equal(tpass, tm > 0)
    np.testing.assert_array_equal(tpass[clear], jpass[clear])
    assert 0 < tpass.sum() < len(x)

    vals = hf.evaluate_f(x).value
    neg = -np.float32(VS)
    for name, got, ref in (
            ("eval_fbar_batched", hf.eval_fbar_batched(x),
             np.asarray(jhf.eval_fbar_batched(x))),
            ("evaluate_f_bar", hf.evaluate_f_bar(x),
             np.asarray(jhf.evaluate_f_bar(x)))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.where(tpass, vals, neg), name)
        both = clear & tpass
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-3,
                                   atol=1e-3 * np.abs(ref[both]).max(),
                                   err_msg=name)
        np.testing.assert_array_equal(ref[clear & ~tpass], neg, name)
    if route == "lattice":
        trusted = hf.lattice_ctx.eval_batched(x)[1]
        assert (tpass & ~trusted).any()
        far_pass = tpass[-n_far:]
        np.testing.assert_array_equal(
            hf.eval_fbar_batched(x[-n_far:]),
            np.where(far_pass, vals[-n_far:], neg))


# ------------------------------------------------------ (d) dense trim
@pytest.fixture(scope="module")
def splat_meshes(params):
    """The splat structure with UDF on in both packages, 16 iterations,
    meshed by the dense mesher (mise_iter=1)."""
    jrec, rec = _recons(params, structure_mode="splat")
    xyz, nrm = _sphere()
    jhf = jrec.reconstruct(xyz, nrm, **KW)
    hf = rec.reconstruct(xyz, nrm, **KW)
    return jhf, hf, JLMC.extract_dual_mesh_dense(jhf, mise_iter=1), \
        hf.extract_dual_mesh(mise_iter=1)


def test_dense_mesher_trims_as_jax(splat_meshes):
    """The trim's invariant (every kept face's vertices pass the mask, in
    each package under its own mask); the trim drops part of the faces;
    and the two meshes agree away from the threshold: every vertex whose
    mask value (the port's, at that vertex) is clear of 0 by 5% of the
    level set has the other mesh's nearest vertex within half a voxel,
    and the vertex counts agree within 3%."""
    jhf, hf, jm, tm = splat_meshes
    assert "dmc: udf mask trim" in hf.phase_times
    assert "host dual mc" not in hf.phase_times
    st = hf.trim_stats
    assert 0 < st["dropped"] < st["faces"]
    assert st["faces"] - st["dropped"] == len(tm.f)
    jv, tv = np.asarray(jm.v), tm.v
    assert len(tv) > 100 and tm.f.max() < len(tv)
    assert (_port_mask_values(hf, tv)[np.unique(tm.f)] > 0).all()
    assert (_jax_mask_values(jhf, jv)[np.unique(np.asarray(jm.f))]
            > 0).all()
    assert abs(len(tv) - len(jv)) <= 0.03 * len(jv)
    tau = 0.05 * float(LEVEL_SET)
    t_in = tv[_port_mask_values(hf, tv) > tau]
    j_in = jv[_port_mask_values(hf, jv) > tau]
    assert len(t_in) > 0.5 * len(tv)
    assert cKDTree(jv).query(t_in)[0].max() < 0.5 * VS
    assert cKDTree(tv).query(j_in)[0].max() < 0.5 * VS
    d = 0.5 * (cKDTree(jv).query(tv)[0].mean()
               + cKDTree(tv).query(jv)[0].mean())
    assert d < 0.05 * VS


def test_negative_level_set_trims_everything(splat_meshes):
    """At level set -1 no point passes (a UDF head's output would have
    to be below -1): the dense mesher keeps no face, as the JAX
    package's (tests/test_meshing.py::TestDenseUdfMask)."""
    _, hf, _, _ = splat_meshes
    mf = hf.mask_field
    try:
        hf.set_mask_field(mf.set_level_set(-1.0))
        m = hf.extract_dual_mesh(mise_iter=1)
    finally:
        hf.set_mask_field(mf)
    assert m.f.shape == (0, 3) and m.v.shape == (0, 3)
    assert hf.trim_stats["dropped"] == hf.trim_stats["faces"] > 0


# ------------------------------------------------ (e) every route, meshed
ROUTES = ["predicted_dense", "predicted_per_level", "splat", "adaptive",
          "route_a", "route_b"]


@pytest.mark.parametrize("route", ROUTES)
def test_routes_mesh_like_jax(params, route, monkeypatch):
    """Each route with UDF on, end to end (reconstruct at 16 iterations,
    extract_dual_mesh(mise_iter=1)) in both packages: the same engines,
    the UDF mask on the same grids (the candidates on the predicted
    route, the encoder's splat grids elsewhere), and meshes within 3% in
    vertex count with a symmetric nearest-vertex distance (mean of both
    directions) under 0.05 voxel.  The dense mesher trims, the host
    mesher (routes A and B) seals through the mask's support joins."""
    cfg_kw, xyz_nrm = {}, _sphere()
    if route == "predicted_per_level":
        monkeypatch.setenv("NKSR_PRED_DENSE", "0")
        monkeypatch.setattr(DP, "DENSE_PRED_CELLMAP_BUDGET", 0)
    elif route == "adaptive":
        cfg_kw = dict(structure_mode="adaptive", adaptive_tau=0.05)
    elif route == "route_a":
        cfg_kw = dict(structure_mode="splat")
        for mod in (JR, R):
            monkeypatch.setattr(mod, "DENSE_UNET_CELLMAP_BUDGET", 0)
        for mod in (JLMC, LMC):
            monkeypatch.setattr(mod, "DENSE_CELL_BUDGET", 0)
    elif route == "route_b":
        cfg_kw, xyz_nrm = dict(structure_mode="splat"), _two_spheres()
    elif route == "splat":
        cfg_kw = dict(structure_mode="splat")
    jrec, rec = _recons(params, **cfg_kw)
    jhf = jrec.reconstruct(*xyz_nrm, **KW)
    hf = rec.reconstruct(*xyz_nrm, **KW)
    jm, tm = jhf.extract_dual_mesh(mise_iter=1), \
        hf.extract_dual_mesh(mise_iter=1)
    if route.startswith("predicted"):
        assert rec._last_pred_engine == ("dense" if route.endswith("dense")
                                         else "host-per-level")
    assert (hf.lattice_ctx is None) == (route == "route_b")
    host_mesher = route in ("route_a", "route_b")
    assert ("host dual mc" in hf.phase_times) == host_mesher
    assert ("mc: udf support joins" in hf.phase_times) == host_mesher
    assert ("dmc: udf mask trim" in hf.phase_times) != host_mesher
    assert hf.has_udf_mask and len(hf.udf_host) == CFG["tree_depth"]
    for d, (a, b) in enumerate(zip(jhf.udf_host, hf.udf_host)):
        _assert_same(a.keys, b.keys, f"UDF grids, depth {d}")
    assert tuple(jhf.udf_caps) == hf.udf_caps
    jv, tv = np.asarray(jm.v), tm.v
    assert len(tv) > 100 and len(tm.f) and tm.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.03 * len(jv)
    d = 0.5 * (cKDTree(jv).query(tv)[0].mean()
               + cKDTree(tv).query(jv)[0].mean())
    assert d < 0.05 * VS


# ----------------------------------------------- (f) configs without yaml
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "runs", "*", "config.yaml")))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(os.path.dirname(p))
                              for p in CONFIGS])
def test_yaml_reader_matches_pyyaml(path):
    """Every run config reads as ``yaml.safe_load`` reads it: the same
    keys, values and Python types."""
    text = open(path).read()
    got, ref = parse_yaml(text, path), yaml.safe_load(text)
    assert got == ref and repr(got) == repr(ref)
    assert load_config(path) == JCFG.load_config(path)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(os.path.dirname(p))
                              for p in CONFIGS])
def test_pipeline_config_matches_jax(path):
    """``pipeline_config_from_yaml`` field for field as the JAX
    package's, on each run config."""
    got = dataclasses.asdict(pipeline_config_from_yaml(load_config(path)))
    ref = dataclasses.asdict(JDRV.pipeline_config_from_yaml(
        JCFG.load_config(path)))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k


def test_scene_big_config_enables_the_udf_head():
    cfg = pipeline_config_from_yaml(load_config(
        os.path.join(ROOT, "runs", "scene_big", "config.yaml")))
    assert cfg.udf_enabled and (cfg.f_maps, cfg.tree_depth, cfg.kernel_dim,
                                cfg.udf_dim) == (32, 4, 4, 16)
    assert (cfg.solver_tol, cfg.solver_max_iters) == (1e-4, 16)


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  c: 2.5\n  d:\n  - x\n  - 3\n",
    "a:\n- b: 1\n  c: true\n- b: 2  # a comment\n  c: off\n",
    "# head\na: 1.0e-06\nb: 1e-4\nc: .5\nd: -2\ne: ~\nf: data/x_y\n",
    "a:\n  b:\n  c: 1_000\nd: +1.5\ne: .inf\n",
    "- 1\n- two\n- c: 3\n",
    "a: [1, 2]", "a: {b: 1}", "a: 'x'", 'a: "x"', "a: ${b}",
])
def test_yaml_subset_matches_pyyaml(text):
    assert repr(parse_yaml(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: [1, 2", "a: {b: 1", "a: 'x", 'a: "x', "a: &x 1\nb: *x",
    "a: !!str 1", "a: |\n  text", "a: [1] x", "a: 0755", "a: 0x1f",
    "a: 1\na: 2", "---\na: 1", "a:\n\t- 1", "a:\n- - 1",
])
def test_yaml_reader_refuses_what_it_does_not_parse(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_load_config_refuses_include_chains(tmp_path):
    """An include chain that comes back to a file it started from (the
    JAX package's loader recurses without end on it)."""
    p = tmp_path / "config.yaml"
    p.write_text("include_configs:\n- base.yaml\na: 1\n")
    (tmp_path / "base.yaml").write_text("include_configs: [config.yaml]\n")
    with pytest.raises(ValueError, match="include_configs"):
        load_config(p)


# ------------------------------------------------ (g) the UDF weights
@pytest.mark.parametrize("family", ["udf_0", "udf_1", "udf_2", "udf_3",
                                    "udf_decoder"])
def test_udf_weights_carried_across(family):
    """The scene_big checkpoint's UDF heads and decoder: the port's
    msgpack reader and flax's give the same leaves, and
    ``params_to_torch`` puts each into the port's Linear (weight = the
    flax kernel's transpose) bit for bit."""
    path = os.path.join(ROOT, "runs", "scene_big", "best.ckpt")
    ours = CK.model_params(CK.load_tree(path))
    with open(path, "rb") as f:
        flax_tree = serialization.msgpack_restore(f.read())
    while isinstance(flax_tree.get("params"), dict):
        flax_tree = flax_tree["params"]
    net = NKSRNetwork(P.PipelineConfig())
    net.load_state_dict(CK.params_to_torch(CK.load_tree(path)), strict=True)
    if family == "udf_decoder":
        mine, theirs = ours["udf_decoder"], flax_tree["udf_decoder"]
        mods = {k: getattr(net.udf_decoder, k) for k in mine}
        assert sorted(mine) == ["Dense_0", "Dense_1", "Dense_2"]
    else:
        mine, theirs = ours["unet"][family], flax_tree["unet"][family]
        mods = {None: getattr(net.unet, family)}
        mine, theirs = {None: mine}, {None: theirs}
    for k, lin in mods.items():
        for leaf in ("kernel", "bias"):
            a, b = np.asarray(mine[k][leaf]), np.asarray(theirs[k][leaf])
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(lin.weight.detach().numpy().T,
                                      mine[k]["kernel"])
        np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                      mine[k]["bias"])
    assert mine[next(iter(mine))]["kernel"].shape[-1] in (16, 32, 1)
