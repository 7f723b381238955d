"""The port's adaptive structure against nksr_tpu on the CPU, at a small
size: tree depth 3, f_maps 8, every weight random, adaptive depth 2.
The decoder hierarchy is the normal-variation one (a depth-0 voxel only
under a parent whose points' normals vary by more than tau), the encoder
hierarchy the splat one.  f32 on both sides.

Host structures and plans are compared byte for byte, the dense UNet's
heads at the decoder voxels, solves after 1 and 3 CG iterations on the
active voxels, the slice by its meshes (ROADMAP queue 3: never field
values after an unconverged solve).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from bench import synthetic_scene
from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu.core import host_build as JHB
from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.models import dense_unet as JDU
from nksr_tpu.models import pipeline as JP
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.models import dense_unet as DU
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from test_field import sphere_points
from test_torch_dense_unet import random_params, to_jax
from test_torch_host_plan import _assert_same

torch.set_num_threads(1)

VS = 0.12
TAU = 0.02
CFG = dict(tree_depth=3, f_maps=8, basis_dim=8, udf_dim=8, voxel_size=VS,
           adaptive_depth=2, adaptive_tau=TAU)
KW = dict(detail_level=None, voxel_size=VS, solver_tol=1e-4,
          solver_max_iters=16, structure="adaptive")


def _caps(grids):
    return tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)


@pytest.fixture(scope="module")
def case():
    """The sphere, its splat and adaptive hierarchies and plan, and one
    set of random weights (normal heads scaled down: random residual
    normals would swamp the splatted input normals)."""
    xyz, nrm = sphere_points(1500, r=0.5, seed=31)
    grids, orders = HB.build_splat_grids_ex(xyz, VS, 3)
    dec = HB.build_adaptive_grids(xyz, nrm, VS, 3, tau=TAU,
                                  adaptive_depth=2, splat=(grids, orders))
    caps, dec_caps = _caps(grids), _caps(dec)
    plan = LAT.plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1], VS,
                            3, 2, k=4, dec_grids=dec, dec_caps=dec_caps)
    params = random_params(P.PipelineConfig(**CFG), 5)
    for d in range(3):
        for leaf in params["params"]["unet"][f"normal_{d}"].values():
            leaf *= 0.05
    return dict(xyz=xyz, nrm=nrm, grids=grids, orders=orders, dec=dec,
                caps=caps, dec_caps=dec_caps, plan=plan, params=params)


@pytest.mark.parametrize("scene,adaptive_depth,tau", [
    (scene, ad, tau) for scene in ("terrain", "sphere")
    for ad in (1, 2, 3) for tau in (0.1, 0.02, 0.001)
    # terrain at depth 3 above tau 0.001: an empty parent level, below
    if not (scene == "terrain" and ad == 3 and tau > 0.001)])
def test_build_adaptive_grids_matches_jax(scene, adaptive_depth, tau):
    """Every level's keys, coords and voxel size byte-identical to the
    JAX package's, with and without the splat build passed in; with
    adaptive depth 1 the hierarchy is the splat one."""
    if scene == "terrain":
        xyz, nrm = synthetic_scene(3000, seed=3, half_extent=2.0)
        vs = 0.1
    else:
        xyz, nrm = sphere_points(1500, r=0.5, seed=31)
        vs = VS
    splat = HB.build_splat_grids_ex(xyz, vs, 3)
    got = HB.build_adaptive_grids(xyz, nrm, vs, 3, tau=tau,
                                  adaptive_depth=adaptive_depth, splat=splat)
    ref = JHB.build_adaptive_grids(xyz, nrm, vs, 3, tau=tau,
                                   adaptive_depth=adaptive_depth)
    again = HB.build_adaptive_grids(xyz, nrm, vs, 3, tau=tau,
                                    adaptive_depth=adaptive_depth)
    for d in range(3):
        for other in (ref[d], again[d]):
            _assert_same(tuple(other), tuple(got[d]), f"depth {d}")
    if adaptive_depth == 1:
        for d in range(3):
            _assert_same(tuple(splat[0][d]), tuple(got[d]), f"depth {d}")


@pytest.mark.parametrize("tau", [0.1, 0.02])
def test_empty_parent_level_refines_nothing(tau):
    """Terrain at adaptive depth 3: no depth-2 voxel varies by tau, so
    depth 1 is empty and so is depth 0 under it.  The port returns the
    empty levels; the JAX package's copy raises IndexError there (a take
    from an empty array), a fault the port does not copy."""
    xyz, nrm = synthetic_scene(3000, seed=3, half_extent=2.0)
    splat = HB.build_splat_grids_ex(xyz, 0.1, 3)
    got = HB.build_adaptive_grids(xyz, nrm, 0.1, 3, tau=tau,
                                  adaptive_depth=3, splat=splat)
    assert [len(g.keys) for g in got[:2]] == [0, 0]
    assert [g.voxel_size for g in got] == [0.1, 0.2, 0.4]
    assert got[2] is splat[0][2]
    ref = JHB.build_adaptive_grids(xyz, nrm, 0.1, 3, tau=tau,
                                   adaptive_depth=2)
    assert len(ref[0].keys) == 0
    with pytest.raises(IndexError):
        JHB.build_adaptive_grids(xyz, nrm, 0.1, 3, tau=tau,
                                 adaptive_depth=3)


def test_adaptive_decoder_prunes_depth_0(case):
    """The fixture's decoder is smaller than the splat hierarchy at depth
    0 and not empty there; coarser levels are the splat ones."""
    n0, s0 = len(case["dec"][0].keys), len(case["grids"][0].keys)
    assert 0 < n0 < s0
    for d in (1, 2):
        assert case["dec"][d] is case["grids"][d]


def test_plan_on_the_adaptive_decoder_is_byte_identical(case):
    """``plan_lattice(dec_grids=...)`` on the adaptive decoder: every
    array of the plan byte-identical to the JAX package's."""
    ref = JLAT.plan_lattice(case["grids"], case["caps"], case["xyz"],
                            case["orders"][0][0], case["orders"][0][1], VS,
                            3, 2, k=4, dec_grids=case["dec"],
                            dec_caps=case["dec_caps"])
    got = case["plan"]
    assert dataclasses.asdict(ref.spec) == dataclasses.asdict(got.spec)
    for name in ref._fields[1:]:
        _assert_same(getattr(ref, name), getattr(got, name), name)


def test_dense_unet_heads_at_the_decoder_match_jax(case):
    """The dense UNet with the decoder tables: basis and normal heads at
    the decoder voxels (cap-padded rows, pad rows included) to rtol
    1e-4, atol 1e-5 of the largest value (f32 convs summed in other
    orders by XLA and PyTorch); the tables' decoder cells are the plan's
    voxel cells."""
    plan, cfg = case["plan"], P.PipelineConfig(**CFG)
    jt = JDU.build_tables(plan.spec, plan.origins, case["grids"],
                          case["caps"], case["dec"], case["dec_caps"])
    jbasis, jnormal, _, _ = jax.jit(
        lambda p, x, f, m: JDU.dense_unet_apply(
            JP.PipelineConfig(**CFG), p, plan.spec,
            jnp.asarray(plan.origins), jt, x, f, m))(
        to_jax(case["params"]), jnp.asarray(case["xyz"]),
        jnp.asarray(case["nrm"]), jnp.ones(len(case["xyz"]), bool))
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(case["params"]), strict=True)
    tables = DU.build_tables(plan.spec, plan.origins, case["grids"],
                             case["caps"], "cpu", case["dec"],
                             case["dec_caps"])
    for d in range(3):
        np.testing.assert_array_equal(tables.dec_cell[d].numpy(),
                                      plan.vox_cell[d])
        np.testing.assert_array_equal(tables.dec_active[d].numpy(),
                                      plan.vox_active[d])
    perm = case["orders"][0][1]
    with torch.no_grad():
        basis, normal, _ = DU.dense_unet_apply(
            cfg, net, plan.spec, plan.origins, tables,
            torch.from_numpy(case["xyz"][perm]),
            torch.from_numpy(case["nrm"][perm]),
            torch.from_numpy(HB.unpack64(case["orders"][0][0])
                             .astype(np.int64)))
    for d in range(3):
        assert basis[d].shape[0] == case["dec_caps"][d]
        for ref, got in ((jbasis[d], basis[d]), (jnormal[d], normal[d])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max())


def _reconstruct_both(case, **kw):
    kw = dict(KW, **kw)
    jf = JReconstructor(config=JP.PipelineConfig(**CFG),
                        params=to_jax(case["params"])).reconstruct(
        case["xyz"], case["nrm"], **kw)
    rec = Reconstructor(device="cpu", config=P.PipelineConfig(**CFG),
                        params=case["params"])
    return jf, rec, rec.reconstruct(case["xyz"], case["nrm"], **kw)


@pytest.mark.parametrize("max_iters", [1, 3])
def test_adaptive_solve_matches_jax(case, max_iters):
    """Coefficients on the active decoder voxels after 1 and 3 CG
    iterations match the JAX package's to rtol 1e-3 (atol 1e-3 of the
    largest coefficient), equal iteration counts, rel_res to rtol 1e-3:
    the UNet's f32 features (1e-5 apart, above) enter the system; the
    splat test holds the solve alone to 1e-4
    (tests/test_torch_slice.py)."""
    jf, rec, tf = _reconstruct_both(case, solver_max_iters=max_iters,
                                    solver_tol=1e-12)
    assert rec._last_unet_engine == "dense" and tf.lattice_ctx is not None
    assert tf.solver_stats.iters == jf.solver_stats.iters == max_iters
    np.testing.assert_allclose(tf.solver_stats.rel_res,
                               jf.solver_stats.rel_res, rtol=1e-3)
    for d in range(3):
        n = len(case["dec"][d].keys)
        ref = np.asarray(jf.field.alpha[d]).reshape(-1, 4)[:n]
        got = tf.alpha[d].numpy().reshape(-1, 4)[:n]
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=1e-3 * np.abs(ref).max())


def test_adaptive_meshes_agree(case):
    """reconstruct(structure="adaptive") -> extract_dual_mesh(mise_iter=1)
    in both packages: the field lives on the decoder grids; vertex counts
    within 2% and the symmetric nearest-vertex distance (mean of both
    directions) under 0.05 voxel; the mesh lies on the sphere."""
    jf, _, tf = _reconstruct_both(case)
    for d in range(3):
        _assert_same(tuple(case["dec"][d]), tuple(tf.host_grids[d]),
                     f"decoder {d}")
        assert int(tf.lattice_ctx.vox_active[d].sum()) == \
            len(case["dec"][d].keys)
    jv = np.asarray(jf.extract_dual_mesh(mise_iter=1).v)
    tm = tf.extract_dual_mesh(mise_iter=1)
    tv = tm.v
    assert len(tv) > 100 and tm.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.02 * len(jv)
    d_tj = cKDTree(jv).query(tv)[0]
    d_jt = cKDTree(tv).query(jv)[0]
    assert 0.5 * (d_tj.mean() + d_jt.mean()) < 0.05 * VS
    r = np.linalg.norm(tv[np.unique(tm.f)], axis=1)
    assert np.median(np.abs(r - 0.5)) < 0.5 * VS
