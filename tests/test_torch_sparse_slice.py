"""Both routes of the sparse fallback end to end against nksr_tpu on the
CPU, at a small size (tree depth 3, f_maps 8, bench-terrain patches),
with the same random weights:

  * route B: two terrain patches 200 m apart, so that ``plan_lattice``
    returns None in both packages with no switch: gather-conv UNet,
    support-row solve, host dual MC;
  * route A: one patch, with ``DENSE_UNET_CELLMAP_BUDGET`` and
    ``DENSE_CELL_BUDGET`` monkeypatched to 0 in both packages:
    gather-conv UNet, lattice solve, host dual MC over the lattice
    evaluator.

Field values are never compared after an unconverged 16-iteration
solve: the support-row solve is compared after 1 and 3 iterations and
converged, the routes by their meshes.
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
from nksr_tpu.meshing import lattice_mc as JLMC
from nksr_tpu.models import pipeline as JP
from nksr_tpu.recon import reconstructor as JR
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields.kernel_field import KernelField
from nksr_tpu_torch.meshing import lattice_mc as LMC
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.recon import reconstructor as R
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from test_torch_dense_unet import SMALL, random_params, to_jax

torch.set_num_threads(1)

VS = 0.1
KW = dict(detail_level=None, voxel_size=VS, solver_tol=1e-4,
          solver_max_iters=16, structure="splat")


def _height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def _two_patches(n=1000, half_extent=1.25):
    """Two terrain patches whose bounding box (200 m) is far over the
    dense lattice budget."""
    a, na = synthetic_scene(n, seed=3, half_extent=half_extent)
    b, nb = synthetic_scene(n, seed=4, half_extent=half_extent)
    shift = np.array([200.0, 200.0, 0.0], np.float32)
    return (np.concatenate([a, b + shift]).astype(np.float32),
            np.concatenate([na, nb]).astype(np.float32))


def _params(cfg):
    params = random_params(cfg, 1)
    # keep the normal heads small: random residual normals would swamp
    # the splatted input normals the gradient rows fit
    for d in range(cfg.tree_depth):
        for leaf in params["params"]["unet"][f"normal_{d}"].values():
            leaf *= 0.05
    return params


def _reconstruct_both(xyz, nrm):
    cfg = P.PipelineConfig(**SMALL)
    params = _params(cfg)
    jrec = JReconstructor(config=JP.PipelineConfig(**SMALL),
                          params=to_jax(params))
    trec = Reconstructor(device="cpu", config=cfg, params=params)
    jf = jrec.reconstruct(xyz, nrm, **KW)
    tf = trec.reconstruct(xyz, nrm, **KW)
    return jrec, trec, jf, tf, jf.extract_dual_mesh(mise_iter=1), \
        tf.extract_dual_mesh(mise_iter=1)


def _assert_meshes_agree(jm, tm):
    """Vertex counts within 2%; every vertex of each mesh within half a
    voxel of the other mesh's vertices (the nearest vertex bounds the
    distance to the other surface from above)."""
    jv, tv = np.asarray(jm.v), tm.v
    assert len(tv) > 1000 and len(tm.f) and tm.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.02 * len(jv)
    assert cKDTree(jv).query(tv)[0].max() < 0.5 * VS
    assert cKDTree(tv).query(jv)[0].max() < 0.5 * VS


@pytest.fixture(scope="module")
def route_b():
    return _reconstruct_both(*_two_patches())


def test_route_b_taken_in_both(route_b):
    jrec, trec, jf, tf, _, _ = route_b
    assert jrec._last_unet_engine == trec._last_unet_engine == "sparse"
    assert jf.lattice_ctx is None and tf.lattice_ctx is None
    assert tf.field is not None
    assert {"unet tables", "sparse unet", "support tables",
            "support-row solve", "host dual mc"} <= set(tf.phase_times)
    assert tf.solver_stats.iters == 16


def test_route_b_meshes_agree(route_b):
    *_, jm, tm = route_b
    _assert_meshes_agree(jm, tm)
    used = tm.v[np.unique(tm.f)]
    patch = used[np.linalg.norm(used[:, :2], axis=1) < 100]
    inner = (np.abs(patch[:, 0]) < 1.1) & (np.abs(patch[:, 1]) < 1.1)
    err = np.abs(patch[inner, 2] - _height(patch[inner, 0], patch[inner, 1]))
    assert err.mean() < 0.2 * VS


def test_route_b_fused_mode_selects_solve_fused(route_b, monkeypatch):
    """``reconstruct(fused_mode=True)`` takes ``KernelField.solve_fused``,
    which runs the same operations: the same coefficients (rtol 1e-6)."""
    _, trec, _, tf, _, _ = route_b
    calls = []
    orig = KernelField.solve_fused

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(KernelField, "solve_fused", spy)
    ff = trec.reconstruct(*_two_patches(), fused_mode=True, **KW)
    assert calls == [1]
    for a, b in zip(ff.alpha, tf.alpha):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def test_route_b_queries(route_b):
    """evaluate_f and eval_fbar_batched on the support-row field: the
    trust mask is the union of the queries' supports, values read
    -voxel_size outside it, and values and gradients are finite."""
    *_, tf, _, _ = route_b
    rng = np.random.default_rng(5)
    probe = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    ev = tf.evaluate_f(probe, grad=True)
    assert np.isfinite(ev.value).all() and np.isfinite(ev.gradient).all()
    m = tf._mask_host(probe)
    assert 0 < m.sum() < len(m)
    fb = tf.eval_fbar_batched(probe)
    np.testing.assert_array_equal(fb, np.where(m, ev.value, -np.float32(VS)))


def test_route_a_meshes_agree(monkeypatch):
    for mod in (JR, R):
        monkeypatch.setattr(mod, "DENSE_UNET_CELLMAP_BUDGET", 0)
    for mod in (JLMC, LMC):
        monkeypatch.setattr(mod, "DENSE_CELL_BUDGET", 0)
    xyz, nrm = synthetic_scene(3000, seed=3, half_extent=2.0)
    jrec, trec, jf, tf, jm, tm = _reconstruct_both(xyz, nrm)
    assert jrec._last_unet_engine == trec._last_unet_engine == "sparse"
    assert jf.lattice_ctx is not None and tf.lattice_ctx is not None
    assert "host dual mc" in tf.phase_times
    assert "dual mc" not in tf.phase_times
    _assert_meshes_agree(jm, tm)


def _solve_pair(max_iters, tol):
    """The support-row solve of both packages on route B's hierarchy with
    the same random basis and normal features."""
    xyz, nrm = _two_patches(600, 1.0)
    cfg = dataclasses.replace(P.PipelineConfig(**SMALL), voxel_size=VS,
                              solver_max_iters=max_iters, solver_tol=tol)
    params = _params(cfg)
    grids, orders = HB.build_splat_grids_ex(xyz, VS, cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    rng = np.random.default_rng(6)
    basis = [rng.normal(size=(c, cfg.basis_dim)).astype(np.float32)
             for c in caps]
    normal = []
    for g, c in zip(grids, caps):
        nf = np.zeros((c, 3), np.float32)
        nf[:len(g.keys)] = 0.05 * rng.normal(size=(len(g.keys), 3))
        normal.append(nf)
    pos_sup = HB.support_indices(grids, caps, xyz, presorted=orders)
    ad = cfg.adaptive_depth

    # the JAX package's rows: gradient rows padded to capacity (weight 0)
    centers = []
    for d in range(ad):
        c = np.zeros((caps[d], 3), np.float32)
        c[:len(grids[d].keys)] = grids[d].coords * grids[d].voxel_size
        centers.append(c)
    jgrad_sup = JHB.support_indices(grids, caps, np.concatenate(centers))
    jcfg = dataclasses.replace(JP.PipelineConfig(**SMALL), capacities=caps,
                               voxel_size=VS, solver_max_iters=max_iters,
                               solver_tol=tol)
    svh = JHB.to_device_svh(grids, caps, VS)
    jfield = jax.jit(lambda p, svh, b, n, ps, gs: JP.solve_kernel_field(
        jcfg, p, jnp.asarray(xyz), jnp.ones(len(xyz), bool),
        jnp.asarray(nrm), svh, b, n, pos_sup_idx=ps, grad_sup_idx=gs,
        prior_splat_idx=ps[:ad]))(
        to_jax(params), svh, tuple(map(jnp.asarray, basis)),
        tuple(map(jnp.asarray, normal)), tuple(map(jnp.asarray, pos_sup)),
        tuple(map(jnp.asarray, jgrad_sup)))

    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    net.requires_grad_(False)   # inference, as Reconstructor's network

    def t64(a):
        return torch.from_numpy(a.astype(np.int64))

    grad_sup = HB.support_indices(grids, caps, P.grad_row_centers(cfg, grids))
    field = P.solve_kernel_field(
        cfg, net, grids, caps, torch.from_numpy(xyz), torch.from_numpy(nrm),
        [torch.from_numpy(b) for b in basis],
        [torch.from_numpy(n) for n in normal],
        [t64(s) for s in pos_sup], [t64(s) for s in grad_sup])
    return jfield, field


@pytest.mark.parametrize("max_iters,tol", [(1, 1e-12), (3, 1e-12),
                                           (1000, 1e-8)])
def test_support_row_solve_matches_jax(max_iters, tol):
    """Coefficients after 1 and 3 CG iterations and converged (relative
    residual 1e-8) to rtol 1e-4 / atol 1e-4 of the largest coefficient:
    f32 on both sides, scatter sums in other orders.  The JAX package's
    zero-weight padding rows, which the port trims, change nothing."""
    jfield, field = _solve_pair(max_iters, tol)
    iters, rel = field.cg_stats
    if max_iters < 1000:
        assert iters == max_iters
    else:
        assert rel <= tol and iters < max_iters
    for a, ref in zip(field.alpha, jfield.alpha):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
