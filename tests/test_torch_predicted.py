"""The port's predicted structure (the default route) against nksr_tpu on
the CPU, at a small size: tree depth 3, f_maps 8, a sphere of 1,500
points at voxel 0.12, every weight random and the structure heads
boosted (kernels x 30, biases (0, 0.5, 3)) so that the prediction prunes
and refines down to depth 0.  f32 on both sides.

Both engines are held to the JAX package's: the one-pass dense engine
(``recon/predicted_dense.py``) and the per-level engine
(``recon/host_predicted.py``).  Grids are compared cell for cell, the
host structures and plans byte for byte; solves after 1 and 3 CG
iterations on the active voxels; the slice by its meshes (ROADMAP queue
3: never field values after an unconverged solve).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu.core import host_build as JHB
from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.models import dense_predicted as JDP
from nksr_tpu.models import pipeline as JP
from nksr_tpu.recon import host_predicted as JHP
from nksr_tpu.recon import predicted_dense as JPD
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.models import dense_predicted as DP
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.recon import host_predicted as HP
from nksr_tpu_torch.recon import predicted_dense as PD
from nksr_tpu_torch.utils.checkpoint import params_to_torch
from nksr_tpu_torch.utils.profiling import PhaseTimer

from bench import synthetic_scene
from test_field import sphere_points
from test_torch_dense_unet import random_params, to_jax
from test_torch_host_plan import _assert_same

torch.set_num_threads(1)

VS = 0.12
CFG = dict(tree_depth=3, f_maps=8, basis_dim=8, udf_dim=8, voxel_size=VS,
           solver_max_iters=16, solver_tol=1e-4)
KW = dict(detail_level=None, voxel_size=VS, solver_tol=1e-4,
          solver_max_iters=16)


def boosted_params(seed=3, bias=(0.0, 0.5, 3.0)):
    """Random weights; struct heads boosted so the prediction varies in
    space and refines, normal heads scaled down (random residual normals
    would swamp the splatted input normals)."""
    params = random_params(P.PipelineConfig(**CFG), seed)
    unet = params["params"]["unet"]
    for d in range(CFG["tree_depth"]):
        unet[f"struct_{d}"]["kernel"] *= 30.0
        unet[f"struct_{d}"]["bias"][:] = bias
        for leaf in unet[f"normal_{d}"].values():
            leaf *= 0.05
    return params


class Case:
    def __init__(self, params, **cfg_kw):
        self.cfg = P.PipelineConfig(**CFG, **cfg_kw)
        self.jcfg = JP.PipelineConfig(**CFG, **cfg_kw)
        self.params = params
        self.jparams = to_jax(params)
        self.net = NKSRNetwork(self.cfg)
        self.net.load_state_dict(params_to_torch(params), strict=True)
        self.xyz, self.nrm = sphere_points(1500, r=0.5, seed=31)
        n, cap = len(self.xyz), 2048
        self.xyz_p = np.pad(self.xyz, ((0, cap - n), (0, 0)))
        self.nrm_p = jnp.asarray(np.pad(self.nrm, ((0, cap - n), (0, 0))))
        self.mask = np.arange(cap) < n

    def jax_args(self):
        return (self.jparams, self.jcfg, self.xyz, self.xyz_p, self.mask,
                self.nrm_p)

    def port_args(self):
        """The port's engine arguments: (cfg, net, xyz, xyz_t, feat,
        splat, tm, times)."""
        times = {}
        splat = HB.build_splat_grids_ex(self.xyz, VS, CFG["tree_depth"])
        return (self.cfg, self.net, self.xyz, torch.from_numpy(self.xyz),
                torch.from_numpy(self.nrm), splat, PhaseTimer("cpu", times),
                times)


@pytest.fixture(scope="module")
def case():
    return Case(boosted_params())


@pytest.fixture(scope="module")
def structures(case):
    """Both packages' one-pass forward, status readback and heads."""
    jparts = JPD.predicted_structures(*case.jax_args())
    parts = PD.predicted_structures(*case.port_args()[:-1])
    return jparts, parts


def _assert_grids_equal(ref, got, what):
    assert len(ref) == len(got)
    for d, (r, g) in enumerate(zip(ref, got)):
        _assert_same(r.keys, g.keys, f"{what} keys, depth {d}")
        _assert_same(r.coords, g.coords, f"{what} coords, depth {d}")
        assert r.voxel_size == g.voxel_size


def test_dense_engine_grids_match_jax(structures):
    """Decoder and candidate grids cell for cell, their cells in the UNet
    lattice equal, the encoder grids and capacities equal; the
    prediction prunes at every depth and reaches depth 0."""
    jparts, parts = structures
    _assert_grids_equal(jparts.grids, parts.grids, "encoder")
    assert jparts.caps == parts.caps
    _assert_grids_equal(jparts.dec_host, parts.dec_host, "decoder")
    _assert_grids_equal(jparts.cand_host, parts.cand_host, "candidates")
    assert jparts.dec_caps == parts.dec_caps
    for d in range(CFG["tree_depth"]):
        np.testing.assert_array_equal(jparts.dec_cells[d],
                                      parts.dec_cells[d])
        np.testing.assert_array_equal(jparts.cand_cells[d],
                                      parts.cand_cells[d])
        assert 0 < len(parts.dec_host[d].keys) < len(parts.cand_host[d].keys)


def test_dense_engine_heads_match_jax(structures):
    """Basis and normal heads at the decoder voxels (cap-padded rows, the
    pad rows included): rtol 1e-4, atol 1e-5 of the largest value (f32
    convs summed in other orders by XLA and PyTorch)."""
    jparts, parts = structures
    for d in range(CFG["tree_depth"]):
        for ref, got in ((jparts.basis_f[d], parts.basis_f[d]),
                         (jparts.normal_f[d], parts.normal_f[d])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max())


def test_plan_unet_lattice_matches_jax(structures):
    """Child-cover dims and zero-phase origins equal to the JAX
    package's on the sphere's splat grids, with each finer dim exactly
    twice the coarser."""
    _, parts = structures
    ref = JDP.plan_unet_lattice(parts.grids, CFG["tree_depth"], f_maps=8)
    got = DP.plan_unet_lattice(parts.grids, CFG["tree_depth"], f_maps=8)
    assert ref[0] == got[0]
    _assert_same(np.asarray(ref[1]), got[1], "origins")
    for d in range(CFG["tree_depth"] - 1):
        assert got[0][d] == tuple(2 * e for e in got[0][d + 1])


@pytest.mark.parametrize("n,half_extent,depth", [
    (3000, 2.0, 3), (3000, 2.0, 4), (800, 6.0, 4)])
def test_unet_lattice_budget_matches_jax(n, half_extent, depth):
    """The budget is the JAX package's 400M cells x maps, and at f_maps
    just either side of each scene's cell count both packages make the
    same choice: None over the budget, the same lattice under it."""
    assert DP.DENSE_PRED_CELLMAP_BUDGET == JDP.DENSE_PRED_CELLMAP_BUDGET \
        == 400_000_000
    xyz, _ = synthetic_scene(n, seed=4, half_extent=half_extent)
    grids, _ = HB.build_splat_grids_ex(xyz, 0.1, depth)
    dims, _ = DP.plan_unet_lattice(grids, depth, f_maps=1)
    cells = sum(int(np.prod(e)) for e in dims)
    for f_maps in (DP.DENSE_PRED_CELLMAP_BUDGET // cells,
                   DP.DENSE_PRED_CELLMAP_BUDGET // cells + 1):
        ref = JDP.plan_unet_lattice(grids, depth, f_maps=f_maps)
        got = DP.plan_unet_lattice(grids, depth, f_maps=f_maps)
        assert (ref is None) == (got is None) == (f_maps * cells
                                                  > 400_000_000)
        if got is not None:
            assert ref[0] == got[0]
            _assert_same(np.asarray(ref[1]), got[1], "origins")


@pytest.mark.parametrize("pick", ["none", "one", "every_third", "all"])
def test_prune_and_children_of_match_jax(pick):
    """``prune`` and ``children_of`` on a depth-1 splat grid: grid,
    parent rows and octants byte-identical to the JAX package's."""
    xyz, _ = synthetic_scene(2000, seed=6, half_extent=2.0)
    grid = HB.build_splat_grids_ex(xyz, 0.1, 2)[0][1]
    n = len(grid.keys)
    rows = {"none": np.zeros(0, np.int64), "one": np.array([n // 2]),
            "every_third": np.arange(0, n, 3), "all": np.arange(n)}[pick]
    keep = np.zeros(n, bool)
    keep[rows] = True
    _assert_same(tuple(JHB.prune(grid, keep)), tuple(HB.prune(grid, keep)),
                 "prune")
    _assert_same(JHB.children_of(grid, rows)[1:], HB.children_of(grid,
                                                                 rows)[1:],
                 "parents, octants")
    _assert_same(tuple(JHB.children_of(grid, rows)[0]),
                 tuple(HB.children_of(grid, rows)[0]), "children")


@pytest.mark.parametrize("adaptive_depth", [1, 2])
def test_plan_on_the_predicted_decoder_is_byte_identical(case, structures,
                                                         adaptive_depth):
    """``plan_lattice(dec_grids=...)`` on the predicted decoder grids:
    every array of the plan byte-identical to the JAX package's."""
    _, parts = structures
    kw = dict(k=4, dec_grids=parts.dec_host, dec_caps=parts.dec_caps)
    pos = (parts.grids, parts.caps, case.xyz, parts.orders[0][0],
           parts.orders[0][1], VS, CFG["tree_depth"], adaptive_depth)
    ref = JLAT.plan_lattice(*pos, **kw)
    got = LAT.plan_lattice(*pos, **kw)
    assert dataclasses.asdict(ref.spec) == dataclasses.asdict(got.spec)
    for name in ref._fields[1:]:
        _assert_same(getattr(ref, name), getattr(got, name), name)


def test_host_engine_grids_match_jax(case, structures, monkeypatch):
    """The per-level engine's decoder grids equal the JAX per-level
    engine's (``NKSR_PRED_DENSE=0``) cell for cell, and the dense
    engine's; its heads equal the dense engine's at every decoder voxel
    to rtol 1e-4, atol 1e-5 of the largest value."""
    monkeypatch.setenv("NKSR_PRED_DENSE", "0")
    jhf = JHP.reconstruct_predicted_host(*case.jax_args())
    assert jhf.lattice_ctx is not None
    captured = {}
    real = HP.lattice_field

    def spy(cfg, net, plan, dec_grids, xyz, xyz_t, inorm, basis_f,
            normal_f, *a, **k):
        captured.update(basis=basis_f, normal=normal_f)
        return real(cfg, net, plan, dec_grids, xyz, xyz_t, inorm, basis_f,
                    normal_f, *a, **k)

    monkeypatch.setattr(HP, "lattice_field", spy)
    hf = HP.reconstruct_predicted_host(*case.port_args())
    assert hf.lattice_ctx is not None
    _assert_grids_equal(jhf.host_grids, hf.host_grids, "decoder")
    _, parts = structures
    _assert_grids_equal(parts.dec_host, hf.host_grids, "engines")
    for d in range(CFG["tree_depth"]):
        n = len(hf.host_grids[d].keys)
        for name, ref in (("basis", parts.basis_f[d]),
                          ("normal", parts.normal_f[d])):
            ref = ref[:n].numpy()
            np.testing.assert_allclose(captured[name][d][:n].numpy(), ref,
                                       rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max())
    assert {"phase1 device", "level loop", "level loop: status readback",
            "level loop: host tables", "level loop: device",
            "dispatch heads", "final solve (lattice)"} <= set(hf.phase_times)


@pytest.mark.parametrize("engine", ["dense", "host-per-level"])
@pytest.mark.parametrize("max_iters", [1, 3])
def test_solve_matches_jax(case, engine, max_iters, monkeypatch):
    """Coefficients on the active voxels after 1 and 3 CG iterations of
    each engine's final lattice solve match the JAX package's same
    engine to rtol 1e-3 (atol 1e-3 of the largest coefficient), with
    equal iteration counts and rel_res to rtol 1e-3: the UNet's f32
    features (1e-5 apart, above) enter the system; the splat test holds
    the solve alone to 1e-4 (tests/test_torch_slice.py)."""
    kw = dict(solver_max_iters=max_iters, solver_tol=1e-12)
    jcfg = dataclasses.replace(case.jcfg, **kw)
    cfg = dataclasses.replace(case.cfg, **kw)
    args = case.port_args()
    if engine == "dense":
        jhf = JPD.reconstruct_predicted_dense(
            case.jparams, jcfg, *case.jax_args()[2:])
        hf = PD.reconstruct_predicted_dense(cfg, *args[1:])
    else:
        monkeypatch.setenv("NKSR_PRED_DENSE", "0")
        jhf = JHP.reconstruct_predicted_host(
            case.jparams, jcfg, *case.jax_args()[2:])
        hf = HP.reconstruct_predicted_host(cfg, *args[1:])
    assert hf.solver_stats.iters == jhf.solver_stats.iters == max_iters
    np.testing.assert_allclose(hf.solver_stats.rel_res,
                               jhf.solver_stats.rel_res, rtol=1e-3)
    k = CFG.get("kernel_dim", 4)
    for d in range(CFG["tree_depth"]):
        n = len(hf.host_grids[d].keys)
        ref = np.asarray(jhf.field.alpha[d]).reshape(-1, k)[:n]
        got = hf.alpha[d].numpy().reshape(-1, k)[:n]
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=1e-3 * np.abs(ref).max())


@pytest.fixture(scope="module")
def meshes(case):
    """The default route end to end in both packages: reconstruct
    (structure left at its default) and extract_dual_mesh(mise_iter=1)."""
    jrec = JReconstructor(config=case.jcfg, params=case.jparams)
    jm = jrec.reconstruct(case.xyz, case.nrm, **KW).extract_dual_mesh(
        mise_iter=1)
    rec = Reconstructor(device="cpu", config=case.cfg, params=case.params)
    hf = rec.reconstruct(case.xyz, case.nrm, **KW)
    return rec, hf, np.asarray(jm.v), hf.extract_dual_mesh(mise_iter=1)


def test_default_route_is_the_dense_engine(meshes):
    rec, hf, _, _ = meshes
    assert rec.config.structure_mode == "predicted"
    assert rec._last_pred_engine == "dense"
    assert hf.lattice_ctx is not None and "dual mc" in hf.phase_times
    assert {"dispatch network", "status readback", "dispatch heads",
            "final solve (lattice)"} <= set(hf.phase_times)


def test_default_route_meshes_agree(meshes):
    """Vertex counts within 2% and the symmetric nearest-vertex distance
    (mean of both directions) under 0.05 voxel; the port's mesh has a
    sheet on the sphere."""
    _, _, jv, tm = meshes
    tv = tm.v
    assert len(tv) > 100 and tm.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.02 * len(jv)
    d_tj = cKDTree(jv).query(tv)[0]
    d_jt = cKDTree(tv).query(jv)[0]
    assert 0.5 * (d_tj.mean() + d_jt.mean()) < 0.05 * VS
    r = np.linalg.norm(tv, axis=1)
    assert (np.abs(r - 0.5) < 0.15).sum() > 100


def test_fully_pruned_prediction(case):
    """Struct heads that prune everything: the dense engine returns None
    in both packages; the port's Reconstructor then takes the per-level
    engine, which warns, as the JAX package's does."""
    params = boosted_params(bias=(100.0, 0.0, 0.0))
    for d in range(CFG["tree_depth"]):
        params["params"]["unet"][f"struct_{d}"]["kernel"][:] = 0.0
    crushed = Case(params)
    assert JPD.reconstruct_predicted_dense(*crushed.jax_args()) is None
    assert PD.reconstruct_predicted_dense(*crushed.port_args()) is None
    rec = Reconstructor(device="cpu", config=crushed.cfg, params=params)
    with pytest.warns(RuntimeWarning, match="predicted structure is empty"):
        hf = rec.reconstruct(crushed.xyz, crushed.nrm, **KW)
    assert rec._last_pred_engine == "host-per-level"
    assert all(len(g.keys) == 0 for g in hf.host_grids)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mesh = hf.extract_dual_mesh()
    assert mesh.v.shape[1] == 3 and len(mesh.f) == 0


def test_budget_routes_to_the_per_level_engine(case, structures,
                                               monkeypatch):
    """With the UNet lattice over the budget the port takes the per-level
    engine, whose grids are the dense engine's."""
    monkeypatch.setattr(DP, "DENSE_PRED_CELLMAP_BUDGET", 0)
    rec = Reconstructor(device="cpu", config=case.cfg, params=case.params)
    hf = rec.reconstruct(case.xyz, case.nrm, **KW)
    assert rec._last_pred_engine == "host-per-level"
    assert hf.lattice_ctx is not None and "level loop" in hf.phase_times
    _assert_grids_equal(structures[1].dec_host, hf.host_grids, "decoder")
