"""The port's solve, evaluator and whole splat slice against nksr_tpu on
the CPU, at a small size (tree depth 3, f_maps 8, a few thousand
bench-terrain points), with the same weights.

The JAX package runs its default XLA cascade here; the port's cascade
has the Pallas kernels' edge semantics.  The two agree on every cell a
solve reaches (tests/test_torch_lattice_kernels.py), so solves are
compared on the active voxels.  Field values are never compared after
an unconverged 16-iteration solve: the solve is compared after 1 and 3
iterations, the evaluator on the JAX solution, and the slice by its
meshes.
"""

import types

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from bench import synthetic_scene
from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.models import pipeline as JP
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields.lattice_eval import LatticeEvalContext
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from test_torch_dense_unet import SMALL, random_params, to_jax

torch.set_num_threads(1)

VS = 0.1
KW = dict(detail_level=None, voxel_size=VS, solver_tol=1e-4,
          solver_max_iters=16, structure="splat")


def _scene(n=3000, seed=3):
    return synthetic_scene(n, seed=seed, half_extent=2.0)


def _height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def _net(cfg, params):
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    return net


@pytest.fixture(scope="module")
def solved():
    """One JAX reconstruction and one port reconstruction of the same
    cloud with the same random weights (f32 on both sides)."""
    cfg, jcfg = P.PipelineConfig(**SMALL), JP.PipelineConfig(**SMALL)
    params = random_params(cfg, 1)
    # keep the normal heads small: random residual normals would swamp
    # the splatted input normals the gradient rows fit
    for d in range(cfg.tree_depth):
        for leaf in params["params"]["unet"][f"normal_{d}"].values():
            leaf *= 0.05
    xyz, nrm = _scene()
    jf = JReconstructor(config=jcfg, params=to_jax(params)).reconstruct(
        xyz, nrm, **KW)
    tf = Reconstructor(device="cpu", config=cfg, params=params).reconstruct(
        xyz, nrm, **KW)
    return cfg, params, jf, tf


def _solve_inputs(cfg, seed):
    xyz, _ = _scene(2500, seed)
    grids, orders = HB.build_splat_grids_ex(xyz, cfg.voxel_size,
                                            cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    plan = LAT.plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            cfg.voxel_size, cfg.tree_depth,
                            cfg.adaptive_depth, k=cfg.kernel_dim)
    rng = np.random.default_rng(seed)
    basis = [rng.normal(size=(c, cfg.basis_dim)).astype(np.float32)
             for c in caps]
    tgt = rng.normal(size=(plan.spec.s_gr, 3)).astype(np.float32)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    return xyz, plan, basis, tgt


@pytest.mark.parametrize("max_iters", [1, 3])
def test_solve_matches_jax(max_iters):
    """Coefficients on the active voxels after 1 and 3 CG iterations
    match nksr_tpu's XLA engine to rtol 1e-4 (f32 sums in other orders;
    atol 1e-4 of the largest coefficient for the near-zero ones), with
    equal iteration counts."""
    cfg = P.PipelineConfig(**SMALL)
    params = random_params(cfg, 2)
    xyz, plan, basis, tgt = _solve_inputs(cfg, 7)
    spec, n = plan.spec, len(xyz)
    w = dict(voxel_size=cfg.voxel_size, pos_weight=cfg.pos_weight,
             normal_weight=cfg.normal_weight, reg_weight=cfg.reg_weight,
             tol=1e-12, max_iters=max_iters, approx_grad=False)

    ncap = spec.n_pts_cap
    xs_p = np.zeros((ncap, 3), np.float32)
    xs_p[:n] = xyz[plan.pt_perm]
    c0_p = np.zeros((ncap, 3), np.int32)
    c0_p[:n] = plan.pt_cell0
    dest_p = np.full(ncap, spec.p_rows * spec.s_pt, np.int32)
    dest_p[:n] = plan.pt_dest
    interp = types.SimpleNamespace(
        params={"params": to_jax(params["params"]["interpolators"])})
    j_alphas, _, (j_iters, j_res) = JLAT.lattice_solve(
        spec, interp, tuple(jnp.asarray(b) for b in basis),
        jnp.asarray(xs_p), jnp.arange(ncap) < n, jnp.asarray(c0_p),
        jnp.asarray(dest_p), jnp.asarray(plan.slot_cell_pt),
        jnp.asarray(plan.slot_cell_gr), jnp.asarray(plan.gr_coords),
        jnp.asarray(plan.gr_depth), jnp.asarray(plan.gr_active),
        jnp.asarray(tgt), tuple(jnp.asarray(v) for v in plan.vox_cell),
        tuple(jnp.asarray(v) for v in plan.vox_active), **w,
        slot_cell0_pt=jnp.asarray(plan.slot_cell0_pt),
        slot_cell0_gr=jnp.asarray(plan.slot_cell0_gr),
        gr_perm=jnp.asarray(plan.gr_perm), cascade_engine="xla",
        return_dense=True, return_stats=True)

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                                else a)

    alphas, _, (iters, res) = LAT.lattice_solve(
        spec, _net(cfg, params).interpolators,
        [torch.from_numpy(b) for b in basis], torch.from_numpy(xyz[plan.pt_perm]),
        t(plan.pt_cell0), t(plan.pt_dest), t(plan.slot_cell_pt),
        t(plan.slot_cell_gr), t(plan.gr_coords), t(plan.gr_depth),
        t(plan.gr_active), torch.from_numpy(tgt),
        [t(v) for v in plan.vox_cell], [t(v) for v in plan.vox_active],
        **w, slot_cell0_pt=t(plan.slot_cell0_pt),
        slot_cell0_gr=t(plan.slot_cell0_gr), gr_perm=t(plan.gr_perm))
    assert iters == int(j_iters) == max_iters
    np.testing.assert_allclose(res, float(j_res), rtol=1e-4)
    for d in range(spec.depth):
        ref = np.asarray(j_alphas[d])
        np.testing.assert_allclose(alphas[d].numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_solver_stats_match(solved):
    _, _, jf, tf = solved
    assert tf.solver_stats.iters == jf.solver_stats.iters == 16
    np.testing.assert_allclose(tf.solver_stats.rel_res,
                               jf.solver_stats.rel_res, rtol=1e-3)


def test_evaluator_matches_jax(solved):
    """JAX's solved dense lattices through both evaluators: values and
    gradients to rtol 1e-4 (atol 1e-4 of the largest magnitude, for the
    values near the zero set), trust masks equal."""
    cfg, params, jf, _ = solved
    jctx = jf.lattice_ctx
    spec = jctx.spec
    ctx = LatticeEvalContext(
        spec, jctx.origins, _net(cfg, params).interpolators,
        [torch.from_numpy(np.array(b)) for b in jctx.basis_features],
        [torch.from_numpy(np.asarray(v).astype(np.int64))
         for v in jctx.vox_cell],
        [torch.from_numpy(np.array(v)) for v in jctx.vox_active],
        jctx.voxel_size, jctx.approx_grad, torch.float32,
        [torch.from_numpy(np.array(x).reshape(-1, spec.k))
         for x in jctx.dense_xs])
    rng = np.random.default_rng(4)
    xy = rng.uniform(-1.9, 1.9, (2000, 2))
    z = _height(xy[:, 0], xy[:, 1]) + rng.uniform(-0.3, 0.3, 2000)
    probe = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    rv, rm, rg = jctx.eval_batched(probe, grad=True)
    v, m, g = ctx.eval_batched(probe, grad=True)
    assert (m == rm).all() and rm.mean() > 0.5
    np.testing.assert_allclose(v, rv, rtol=1e-4, atol=1e-4 * np.abs(rv).max())
    np.testing.assert_allclose(g, rg, rtol=1e-4, atol=1e-4 * np.abs(rg).max())


def test_slice_meshes_agree(solved):
    """reconstruct -> extract_dual_mesh(mise_iter=1) in both packages:
    vertex counts within 2%, and the symmetric nearest-vertex distance
    (mean of both directions) under 0.05 voxel; the port's mesh lies on
    the terrain."""
    _, _, jf, tf = solved
    jm = jf.extract_dual_mesh(mise_iter=1)
    tm = tf.extract_dual_mesh(mise_iter=1)
    jv, tv = np.asarray(jm.v), tm.v
    assert len(tv) > 1000 and tm.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.02 * len(jv)
    d_tj = cKDTree(jv).query(tv)[0]
    d_jt = cKDTree(tv).query(jv)[0]
    assert 0.5 * (d_tj.mean() + d_jt.mean()) < 0.05 * VS
    used = tv[np.unique(tm.f)]
    inner = (np.abs(used[:, 0]) < 1.8) & (np.abs(used[:, 1]) < 1.8)
    err = np.abs(used[inner, 2] - _height(used[inner, 0], used[inner, 1]))
    assert err.mean() < 0.2 * VS


def test_host_field_queries(solved):
    """evaluate_f / eval_fbar_batched are the lattice evaluator's values,
    with -voxel_size outside the trusted cells."""
    _, _, _, tf = solved
    rng = np.random.default_rng(5)
    probe = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    v, m, g = tf.lattice_ctx.eval_batched(probe, grad=True)
    ev = tf.evaluate_f(probe, grad=True)
    np.testing.assert_array_equal(ev.value, v)
    np.testing.assert_array_equal(ev.gradient, g)
    assert tf.evaluate_f(probe).gradient is None
    fb = tf.eval_fbar_batched(probe)
    assert 0 < m.sum() < len(m)
    np.testing.assert_array_equal(fb, np.where(m, v, -np.float32(VS)))


@pytest.mark.parametrize("cfg_kw,call_kw", [
    ({}, dict(structure="adaptive")),
    ({}, dict(structure="predicted")),
    ({}, dict(structure="splat", chunk_size=1.0, voxel_size=None)),
    ({}, dict(structure="splat", mesh=object())),
    (dict(udf_enabled=True), dict(structure="splat")),
    (dict(solver_formulation="dual"), dict(structure="splat")),
    (dict(geometry="neural"), dict(structure="splat")),
])
def test_unported_routes_raise(cfg_kw, call_kw):
    xyz, nrm = _scene(200)
    recon = Reconstructor(device="cpu",
                          config=P.PipelineConfig(**SMALL, **cfg_kw))
    kw = dict(KW, **call_kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        recon.reconstruct(xyz, nrm, **kw)


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Reconstructor()
