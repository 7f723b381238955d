"""The adaptive structure on the sparse routes against nksr_tpu on the
CPU, at tests/test_torch_adaptive.py's size: its sphere, tree depth 3,
f_maps 8, adaptive depth 2, tau 0.02, every weight random, f32 on both
sides.

  * route A: the feature lattices over the dense UNet's budget (set to
    0, with the dense mesher's): the gather-conv UNet with its heads on
    the decoder voxels, the lattice solve on the decoder, the host
    mesher;
  * route B: no lattice plan (the port's ``LATTICE_COEFF_BUDGET`` and
    the JAX package's ``NKSR_LATTICE`` set to 0): the same UNet, the
    support-row solve on the decoder, the host mesher.

The UNet's heads and the host mesher on the adaptive hierarchy are
compared live against the JAX package's (its teacher-forced pass over
host tables, ``_compiled_structure``'s call, and its
``dual_mc_on_lattice`` on one analytic field); the JAX side of the
routes (solves after 1 and 3 CG iterations, meshes, the UDF head's mask
and seal, a chunked run) is ``scripts/adaptive_routes_reference.py``'s,
kept in ``tests/data/adaptive_routes_reference.npz`` (its
reconstructions and meshes take minutes to compile).  Rewrite it after
a change to the inputs below:

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/adaptive_routes_reference.py
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nksr_tpu.core import host_build as JHB
from nksr_tpu.models import pipeline as JP
from nksr_tpu.ops import gather_scatter as JGS
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.meshing import lattice_mc as LMC
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models import sparse_unet as SU
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.ops import gather_scatter as GS
from nksr_tpu_torch.recon import reconstructor as R
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from bench import synthetic_scene
from test_field import sphere_points
from test_torch_adaptive import CFG, KW, TAU, VS, _caps
from test_torch_dense_unet import random_params, to_jax

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "adaptive_routes_reference.npz")
ROUTES = ("A", "B")
# the chunked run: the sphere's upper cap in a strip along x, two chunks
CHUNK_SIZE = 0.6
# a UDF mask value this far from 0 decides a point the same way in both
# packages (tests/test_torch_udf.py's MASK_CLEAR)
MASK_CLEAR = 1e-3 * 2.0 * VS


def sphere():
    return sphere_points(1500, r=0.5, seed=31)


def strip():
    """The sphere's upper cap, |y| < 0.25: normals that vary (depth-0
    decoder voxels) over 1 m in x, two chunks of ``CHUNK_SIZE``."""
    xyz, nrm = sphere_points(3000, r=0.5, seed=31)
    keep = (xyz[:, 2] > 0.0) & (np.abs(xyz[:, 1]) < 0.25)
    return xyz[keep], nrm[keep]


def make_params():
    """tests/test_torch_adaptive.py's weights (normal heads scaled down:
    random residual normals would swamp the splatted input normals)."""
    params = random_params(P.PipelineConfig(**CFG), 5)
    for d in range(3):
        for leaf in params["params"]["unet"][f"normal_{d}"].values():
            leaf *= 0.05
    return params


def probes(xyz):
    """Points near the cloud and through its bounding box."""
    rng = np.random.default_rng(5)
    near = xyz[rng.integers(0, len(xyz), 600)] \
        + rng.normal(scale=0.1, size=(600, 3))
    box = rng.uniform(xyz.min(0) - 0.4, xyz.max(0) + 0.4, (600, 3))
    return np.concatenate([near, box]).astype(np.float32)


def route_budgets(route, mods):
    """The (module, name, value) settings that send a reconstruction to
    ``route``: route A, the dense UNet's and the dense mesher's budgets
    at 0 (``mods``: the reconstructor and ``lattice_mc`` modules of one
    package); route B, the port's lattice plan budget at 0 (the JAX
    package's ``NKSR_LATTICE=0``)."""
    rec, lmc, lat = mods
    if route == "A":
        return [(rec, "DENSE_UNET_CELLMAP_BUDGET", 0),
                (lmc, "DENSE_CELL_BUDGET", 0)]
    return [] if lat is None else [(lat, "LATTICE_COEFF_BUDGET", 0)]


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as z:
        return dict(z)


@pytest.fixture(scope="module")
def params():
    return make_params()


def _port(params, route, monkeypatch, **cfg_kw):
    for mod, name, value in route_budgets(route, (R, LMC, LAT)):
        monkeypatch.setattr(mod, name, value)
    return Reconstructor(device="cpu", config=P.PipelineConfig(
        **dict(CFG, **cfg_kw)), params=params)


def _assert_meshes_agree(ref, key, mesh, count_tol):
    """Vertex counts within ``count_tol`` and the symmetric nearest-vertex
    distance (mean of both directions) under 0.05 voxel."""
    jv, tv = ref[key + "_v"], mesh.v
    assert len(tv) > 100 and len(mesh.f) and mesh.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= count_tol * len(jv)
    d = 0.5 * (cKDTree(jv).query(tv)[0].mean()
               + cKDTree(tv).query(jv)[0].mean())
    assert d < 0.05 * VS


# ------------------------------------------------------------ UNet heads
@pytest.fixture(scope="module")
def hierarchy():
    xyz, nrm = sphere()
    grids, orders = HB.build_splat_grids_ex(xyz, VS, 3)
    dec = HB.build_adaptive_grids(xyz, nrm, VS, 3, tau=TAU,
                                  adaptive_depth=2, splat=(grids, orders))
    return xyz, nrm, grids, orders, dec


def _port_unet(params, hierarchy, dec_rows=None, dec_caps=None, udf=False):
    xyz, nrm, grids, orders, _ = hierarchy
    caps = _caps(grids)
    cfg = P.PipelineConfig(**CFG, udf_enabled=udf)
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    ut = HB.build_unet_tables(grids, caps, GS.stencil_offsets(3))
    ut = HB.UNetTables(*(tuple(torch.from_numpy(t.astype(np.int64))
                               for t in part) for part in ut))
    splat0 = HB.support_indices(grids[:1], caps[:1], xyz,
                                presorted=orders[:1])[0]
    return SU.sparse_unet_apply(
        cfg, net, ut, [len(g.keys) for g in grids], caps,
        [torch.from_numpy(g.coords.astype(np.int64)) for g in grids],
        torch.from_numpy(xyz), torch.from_numpy(nrm),
        torch.from_numpy(splat0.astype(np.int64)), dec_rows, dec_caps)


def test_decoder_rows_are_the_splat_rows(hierarchy):
    """Each adaptive decoder voxel's row holds its coordinates in the
    splat hierarchy; the splat levels take no table; a voxel outside
    the splat hierarchy raises."""
    _, _, grids, _, dec = hierarchy
    rows = SU.decoder_rows(grids, dec)
    assert rows[0] is not None and rows[1] is None and rows[2] is None
    assert 0 < len(rows[0]) == len(dec[0].keys) < len(grids[0].keys)
    np.testing.assert_array_equal(grids[0].coords[rows[0]], dec[0].coords)
    assert SU.decoder_rows(grids, grids) == (None, None, None)
    far = dec[0].coords.astype(np.int64) + 1000
    stray = HB.HostGrid(dec[0].coords + 1000, HB.pack64(far),
                        dec[0].voxel_size)
    with pytest.raises(ValueError, match="not voxels of the splat"):
        SU.decoder_rows(grids[:1], [stray])


def test_sparse_unet_heads_at_the_decoder_match_jax(params, hierarchy):
    """The gather-conv UNet with the decoder table against the JAX
    package's teacher-forced pass over host tables (the encoder's splat
    grids as candidates, the heads at the adaptive decoder): basis and
    normal heads at (dec_caps[d], C), pad rows included, to rtol 1e-4,
    atol 1e-5 of the largest value; the UDF head at the splat rows."""
    xyz, nrm, grids, orders, dec = hierarchy
    caps, dec_caps = _caps(grids), _caps(dec)
    jcfg = dataclasses.replace(JP.PipelineConfig(**CFG), capacities=caps,
                               udf_enabled=True)
    jt = JHB.build_unet_tables(grids, caps, JGS.stencil_offsets(3))
    splat0 = HB.support_indices(grids[:1], caps[:1], xyz,
                                presorted=orders[:1])[0]
    # ``_compiled_structure``'s call, op by op: its jit takes twice as
    # long to compile on one core
    out, _, _ = jcfg.network().apply(
        to_jax(params), jnp.asarray(xyz), jnp.asarray(nrm),
        jnp.ones(len(xyz), bool), JHB.to_device_svh(grids, caps, VS),
        JHB.to_device_svh(dec, dec_caps, VS), True, caps, tables=jt,
        point_splat_idx=jnp.asarray(splat0))
    rows = tuple(None if r is None else torch.from_numpy(r)
                 for r in SU.decoder_rows(grids, dec))
    basis, normal, udf = _port_unet(params, hierarchy, rows, dec_caps,
                                    udf=True)
    for d in range(3):
        assert basis[d].shape == (dec_caps[d], 8)
        assert normal[d].shape == (dec_caps[d], 3)
        for got, want in ((basis[d], out.basis_features[d]),
                          (normal[d], out.normal_features[d])):
            want = np.asarray(want)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())
    # the UDF head on the candidates' rows: the splat hierarchy's
    for d in range(3):
        n, want = len(grids[d].keys), np.asarray(out.udf_features[d])
        assert udf[d].shape == want.shape == (caps[d], 8)
        np.testing.assert_allclose(udf[d][:n].numpy(), want[:n], rtol=1e-4,
                                   atol=1e-5 * np.abs(want[:n]).max())


def test_no_decoder_table_leaves_the_unet_as_it_was(params, hierarchy):
    """Without a decoder table, with an explicit table of Nones, and with
    identity tables on the splat hierarchy, the heads are bit-equal: the
    splat route's output does not move."""
    _, _, grids, _, _ = hierarchy
    caps = _caps(grids)
    base = _port_unet(params, hierarchy)
    nones = _port_unet(params, hierarchy, (None,) * 3, caps)
    ident = _port_unet(params, hierarchy, tuple(
        torch.arange(len(g.keys)) for g in grids), caps)
    for other in (nones, ident):
        for a, b in zip(base[:2], other[:2]):
            for x, y in zip(a, b):
                assert torch.equal(x, y)


# ------------------------------------------------ the host mesher
@pytest.mark.parametrize("seal", [False, True])
def test_host_mesher_on_the_adaptive_hierarchy_matches_jax(hierarchy, seal):
    """The host mesher on a hierarchy of adaptive depth 2: the extraction
    lattice (levels 0 and 1 unioned at the finest resolution, dilated)
    equal to the JAX package's, and one analytic field (the sphere's
    signed distance, its gradient for the Newton step) meshed there by
    both packages' ``dual_mc_on_lattice``: the same faces, vertices to 1e-6
    of a voxel.  ``seal``: corners outside a mask (x < 0.2) read
    -voxel_size, the host mesher's seal at a UDF mask's edge."""
    from nksr_tpu.meshing import host_mc as JMC

    from nksr_tpu_torch.meshing import host_mc as MC
    dec = hierarchy[-1]
    assert len(dec[0].keys) > 0
    vox = MC.extraction_lattice_host(dec, 2)
    np.testing.assert_array_equal(vox, JMC.extraction_lattice_host(dec, 2))

    def fbar(p):
        f = (np.linalg.norm(p, axis=1) - 0.5).astype(np.float32)
        if seal:
            f = np.where(p[:, 0] < 0.2, f, -np.float32(VS))
        return f.astype(np.float32)

    def grad(p):
        g = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)
        return (np.linalg.norm(p, axis=1) - 0.5).astype(np.float32), \
            g.astype(np.float32)

    got = MC.dual_mc_on_lattice(vox, VS, fbar, grad, 1)
    want = JMC.dual_mc_on_lattice(vox, VS, fbar, grad, 1)
    assert len(got.f) > 100
    np.testing.assert_array_equal(got.f, np.asarray(want.f))
    np.testing.assert_allclose(got.v, np.asarray(want.v), rtol=0,
                               atol=1e-6 * VS)


# ------------------------------------------------------- routes A and B
def _solve(params, route, monkeypatch, iters, **cfg_kw):
    rec = _port(params, route, monkeypatch, **cfg_kw)
    hf = rec.reconstruct(*sphere(), **dict(
        KW, solver_max_iters=iters, solver_tol=1e-12 if iters < 16
        else 1e-4))
    assert rec._last_unet_engine == "sparse"
    assert (hf.lattice_ctx is not None) == (route == "A")
    return hf


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("iters", [1, 3])
def test_adaptive_route_solve_matches_jax(params, ref, route, iters,
                                          monkeypatch):
    """Coefficients on the active decoder voxels after 1 and 3 CG
    iterations match the JAX package's to rtol 1e-3 (atol 1e-3 of the
    largest), on route A with equal iteration counts and rel_res to rtol
    1e-3 (the UNet's f32 features, 1e-5 apart above, enter the system),
    and the field lives on the decoder hierarchy."""
    hf = _solve(params, route, monkeypatch, iters)
    key = f"{route}_it{iters}"
    assert hf.solver_stats.iters == iters
    if route == "A":
        # the JAX package's support-row solve keeps no statistics
        assert int(ref[key + "_iters"]) == iters
        np.testing.assert_allclose(hf.solver_stats.rel_res,
                                   float(ref[key + "_rel_res"]), rtol=1e-3)
    for d in range(3):
        n = int(ref[f"dec{d}_n"])
        assert len(hf.host_grids[d].keys) == n
        want = ref[f"{key}_alpha{d}"]
        got = hf.alpha[d].numpy().reshape(-1, 4)[:n]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("route", ROUTES)
def test_adaptive_route_meshes_agree(params, ref, route, monkeypatch):
    """reconstruct(structure="adaptive") at 16 iterations, then
    extract_dual_mesh(mise_iter=1), meshed by the host mesher on a
    hierarchy of adaptive depth 2 (levels 0 and 1 in its extraction
    lattice): vertex counts within 2% of the JAX package's, the
    symmetric nearest-vertex distance under 0.05 voxel, the mesh on the
    sphere."""
    hf = _solve(params, route, monkeypatch, 16)
    mesh = hf.extract_dual_mesh(mise_iter=1)
    assert "host dual mc" in hf.phase_times
    assert "dual mc" not in hf.phase_times
    assert 0 < len(hf.host_grids[0].keys) < len(
        HB.build_splat_grids_ex(sphere()[0], VS, 3)[0][0].keys)
    _assert_meshes_agree(ref, f"{route}_mesh", mesh, 0.02)
    r = np.linalg.norm(mesh.v[np.unique(mesh.f)], axis=1)
    assert np.median(np.abs(r - 0.5)) < 0.5 * VS


@pytest.mark.parametrize("route", ROUTES)
def test_adaptive_route_with_an_empty_depth_0(params, route, monkeypatch):
    """At a tau no normal variation reaches the decoder keeps no depth-0
    voxel (as the terrain at the configuration's tau 0.1, on which the
    JAX package's routes A and B run): the heads of that level are all
    padding, the solve and the mesher run on levels 1 and up, and the
    mesh lies on the sphere."""
    hf = _solve(params, route, monkeypatch, 16, adaptive_tau=10.0)
    assert len(hf.host_grids[0].keys) == 0
    assert len(hf.host_grids[1].keys) > 0
    mesh = hf.extract_dual_mesh(mise_iter=1)
    assert len(mesh.f) > 100 and np.isfinite(mesh.v).all()
    r = np.linalg.norm(mesh.v[np.unique(mesh.f)], axis=1)
    assert np.median(np.abs(r - 0.5)) < VS


@pytest.mark.parametrize("route", ROUTES)
def test_adaptive_route_udf_seal_matches_jax(params, ref, route,
                                             monkeypatch):
    """The UDF head on: its mask on the encoder's splat grids decides
    every probe clear of its threshold as the JAX package's does, and the
    host mesher's seal (a second sheet at the mask's edge) meshes as the
    JAX package's: vertex counts within 3%, the symmetric distance under
    0.05 voxel."""
    hf = _solve(params, route, monkeypatch, 16, udf_enabled=True)
    assert hf.has_udf_mask
    assert [len(g.keys) for g in hf.udf_host] == [
        len(g.keys) for g in HB.build_splat_grids_ex(sphere()[0], VS,
                                                     3)[0]]
    x = probes(sphere()[0])
    sup = tuple(torch.from_numpy(t.astype(np.int64)) for t in
                HB.support_indices(hf.udf_host, hf.udf_caps, x))
    tm = hf.mask_field.evaluate_mask(torch.from_numpy(x), sup).numpy()
    jm, jpass = ref[f"udf_{route}_mask"], ref[f"udf_{route}_pass"]
    clear = np.abs(jm) > MASK_CLEAR
    assert clear.mean() > 0.95
    tpass = hf._mask_host(x)
    np.testing.assert_array_equal(tpass, tm > 0)
    np.testing.assert_array_equal(tpass[clear], jpass[clear])
    assert 0 < tpass.sum() < len(x)
    mesh = hf.extract_dual_mesh(mise_iter=1)
    assert {"mc: udf support joins", "mc: udf mask"} <= set(hf.phase_times)
    _assert_meshes_agree(ref, f"udf_{route}_mesh", mesh, 0.03)


def test_adaptive_route_a_in_chunks(params, ref, monkeypatch):
    """reconstruct(chunk_size=) with structure "adaptive" on route A
    (two chunks of the sphere's cap, each on the gather-conv UNet and the
    lattice solve on its adaptive decoder), then the stitched mesh:
    within 2% of the JAX package's in vertex count, under 0.05 voxel."""
    rec = _port(params, "A", monkeypatch, structure_mode="adaptive",
                solver_max_iters=16)
    cf = rec.reconstruct(*strip(), chunk_size=CHUNK_SIZE, solver_tol=1e-4)
    assert len(cf.chunks) == int(ref["chunk_n"]) == 2
    for c in cf.chunks:
        assert c["engine"] == "sparse"
        f = c["field"]
        assert f.lattice_ctx is not None
        assert 0 < len(f.host_grids[0].keys)
    _assert_meshes_agree(ref, "chunk_mesh", cf.extract_dual_mesh(mise_iter=1),
                         0.02)


# ------------------------------------------------ the plan's budget
def test_lattice_budget_routes_as_jax(monkeypatch):
    """``LATTICE_COEFF_BUDGET`` is the JAX package's dense coefficient
    budget: tests/test_torch_sparse_slice.py's scenes take the same
    routes as there (its one patch a plan, its two patches 200 m apart
    none, in both packages), a plan whose coefficients fill the budget
    exactly is kept and one a coefficient over is refused; at 0 no plan
    is made."""
    from nksr_tpu.fields import lattice as JLAT

    from test_torch_sparse_slice import _two_patches
    assert LAT.LATTICE_COEFF_BUDGET == 160_000_000

    def plans(xyz, lat):
        grids, orders = HB.build_splat_grids_ex(xyz, 0.1, 3)
        caps = _caps(grids)
        return lat.plan_lattice(grids, caps, xyz, orders[0][0],
                                orders[0][1], 0.1, 3, 1, k=4)

    one = synthetic_scene(3000, seed=3, half_extent=2.0)[0]
    two = _two_patches()[0]
    p1 = plans(one, LAT)
    assert p1 is not None and plans(one, JLAT) is not None
    assert plans(two, LAT) is None and plans(two, JLAT) is None
    need = sum(p1.spec.n_cells(d) for d in range(3)) * p1.spec.k
    monkeypatch.setattr(LAT, "LATTICE_COEFF_BUDGET", need)
    assert plans(one, LAT) is not None
    monkeypatch.setattr(LAT, "LATTICE_COEFF_BUDGET", need - 1)
    assert plans(one, LAT) is None
    monkeypatch.setattr(LAT, "LATTICE_COEFF_BUDGET", 0)
    assert plans(one, LAT) is None
