"""The port's support-row field (nksr_tpu_torch/ops/window_basis.py,
nksr_tpu_torch/fields/support.py, nksr_tpu_torch/fields/kernel_field.py)
against nksr_tpu's on the CPU, at tree depth 3 on a bench-terrain cloud,
with the same random weights, features and coefficients.  Both sides
compute in f32; sums run in other orders (XLA's scatter-add against
``index_add_``), hence the f32 tolerances stated per test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench import synthetic_scene
from nksr_tpu.core import host_build as JHB
from nksr_tpu.fields import support as JS
from nksr_tpu.models.network import Interpolators
from nksr_tpu.ops.pallas import window_and_grad_fused as j_window_fused
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import support as S
from nksr_tpu_torch.fields.kernel_field import KernelField
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.ops import window_basis as WB
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from test_torch_dense_unet import SMALL, random_params, to_jax

torch.set_num_threads(1)

VS = 0.1
RTOL = 1e-5


def _close(got, ref, rtol=RTOL):
    """rtol with an atol of rtol times the largest reference magnitude
    (f32 sums in another order; near-zero entries cancel)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    cfg = P.PipelineConfig(**SMALL)
    params = random_params(cfg, 3)
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    xyz, _ = synthetic_scene(2000, seed=9, half_extent=1.5)
    grids, _ = HB.build_splat_grids_ex(xyz, VS, cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(c, cfg.basis_dim)).astype(np.float32)
             for c in caps]
    centers = (grids[0].coords * grids[0].voxel_size).astype(np.float32)
    jinterp = JS.InterpolatorFn(
        params={"params": to_jax(params["params"]["interpolators"])},
        module=Interpolators(depth=cfg.tree_depth, kernel_dim=cfg.kernel_dim,
                             n_hidden=cfg.interp_layers,
                             hidden_dim=cfg.interp_hidden))
    field = KernelField([P.level_voxel_size(cfg, d)
                         for d in range(cfg.tree_depth)], caps,
                        [torch.from_numpy(f) for f in feats],
                        [net.interpolators.level(d)
                         for d in range(cfg.tree_depth)], cfg.kernel_dim)
    return dict(cfg=cfg, grids=grids, caps=caps, feats=feats, xyz=xyz,
                centers=centers, jinterp=jinterp, field=field,
                svh=JHB.to_device_svh(grids, caps, VS), rng=rng)


def _idx(t):
    return torch.from_numpy(np.asarray(t).astype(np.int64))


def test_window_versions_agree():
    """The plain window, the plain window_and_grad and the wrapper's CPU
    version equal JAX's window_and_grad and its Pallas kernel's CPU path
    to rtol 1e-5 / atol 1e-6, the bound of tests/test_pallas.py."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.4, 1.4, (500, 8, 3)).astype(np.float32)
    jw, jdw = JS.window_and_grad(jnp.asarray(x))
    pw, pdw = j_window_fused(jnp.asarray(x))
    xt = torch.from_numpy(x)
    w, dw = S.window_and_grad(xt)
    fw, fdw = WB.window_and_grad_fused(xt)
    for got in (w, fw, S.window(xt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(np.asarray(pw), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    for got in (dw, fdw):
        np.testing.assert_allclose(got.numpy(), np.asarray(jdw), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(pdw), rtol=1e-5,
                                   atol=1e-6)
    assert WB.window_and_grad_fused.launches == 0


def _supports(s, x, grad, approx):
    cfg, grids, caps = s["cfg"], s["grids"], s["caps"]
    sup_idx = HB.support_indices(grids, caps, x)
    jsup = tuple(
        JS.depth_support(s["svh"].grids[d], jnp.asarray(s["feats"][d]),
                         s["jinterp"], d, jnp.asarray(x), grad=grad,
                         approx_grad=approx, idx=jnp.asarray(sup_idx[d]))
        for d in range(cfg.tree_depth))
    field = s["field"]
    field.approx_kernel_grad = approx
    sup = field.support(torch.from_numpy(x), [_idx(t) for t in sup_idx],
                        grad=grad)
    field.approx_kernel_grad = False
    return jsup, sup


@pytest.mark.parametrize("grad,approx", [(False, False), (True, False),
                                         (True, True)])
def test_depth_support_matches(setup, grad, approx):
    """Basis and (exact or approximate) basis gradients at the points
    and the voxel centers, per depth, to f32 tolerance; identical DoF
    indices."""
    x = np.concatenate([setup["xyz"], setup["centers"]])
    jsup, sup = _supports(setup, x, grad, approx)
    for js, s in zip(jsup, sup):
        np.testing.assert_array_equal(s.idx_k.numpy(), np.asarray(js.idx_k))
        _close(s.basis, js.basis)
        if grad:
            _close(s.dbasis, js.dbasis)
        assert (s.dbasis is None) == (not grad)


def test_predict_scatter_diag_match(setup):
    """predict (values and gradients), scatter_rows (value and gradient
    rows) and diag_contrib on the same supports and random coefficients."""
    rng = setup["rng"]
    cfg, caps = setup["cfg"], setup["caps"]
    x = setup["centers"]
    jsup, sup = _supports(setup, x, True, False)
    shapes = tuple((c, cfg.kernel_dim) for c in caps)
    alpha = [rng.normal(size=c * cfg.kernel_dim).astype(np.float32)
             for c in caps]
    jv, jg = JS.predict(jsup, tuple(jnp.asarray(a) for a in alpha), grad=True)
    v, g = S.predict(sup, [torch.from_numpy(a) for a in alpha], grad=True)
    _close(v, jv)
    _close(g, jg)
    r1 = rng.normal(size=len(x)).astype(np.float32)
    r3 = rng.normal(size=(len(x), 3)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, len(x)).astype(np.float32)
    pairs = [
        (JS.scatter_rows(jsup, shapes, jnp.asarray(r1)),
         S.scatter_rows(sup, shapes, torch.from_numpy(r1))),
        (JS.scatter_rows(jsup, shapes, jnp.asarray(r3), grad=True),
         S.scatter_rows(sup, shapes, torch.from_numpy(r3), grad=True)),
        (JS.diag_contrib(jsup, shapes, jnp.asarray(w)),
         S.diag_contrib(sup, shapes, torch.from_numpy(w))),
        (JS.diag_contrib(jsup, shapes, jnp.asarray(w), grad=True),
         S.diag_contrib(sup, shapes, torch.from_numpy(w), grad=True)),
    ]
    for ref, got in pairs:
        for r, t in zip(ref, got):
            _close(t, r)


def _system_inputs(s):
    rng = np.random.default_rng(11)
    xyz, centers = s["xyz"], s["centers"]
    nv = rng.normal(size=(len(centers), 3)).astype(np.float32)
    pos_w = np.full(len(xyz), 0.5 / len(xyz), np.float32)
    nrm_w = np.full(len(centers), 2.0 / len(centers) * VS ** 2, np.float32)
    sup_p = HB.support_indices(s["grids"], s["caps"], xyz)
    sup_c = HB.support_indices(s["grids"], s["caps"], centers)
    return xyz, centers, nv, pos_w, nrm_w, sup_p, sup_c


def test_matvec_matches_jax(setup):
    """One application of the solve's operator, its right-hand side and
    its Jacobi diagonal on the same random coefficients: the JAX package's
    matvec (KernelField.solve_non_fused) composed from its support
    functions against the port's normal_equations."""
    cfg, caps = setup["cfg"], setup["caps"]
    xyz, centers, nv, pos_w, nrm_w, sup_p, sup_c = _system_inputs(setup)
    reg = cfg.reg_weight
    shapes = tuple((c, cfg.kernel_dim) for c in caps)
    rng = np.random.default_rng(12)
    a = [rng.normal(size=c * cfg.kernel_dim).astype(np.float32) for c in caps]

    svh, feats, interp = setup["svh"], setup["feats"], setup["jinterp"]
    jf = tuple(jnp.asarray(f) for f in feats)
    jv = JS.svh_support(svh, jf, interp, jnp.asarray(xyz),
                        sup_idx=tuple(jnp.asarray(t) for t in sup_p))
    jg = JS.svh_support(svh, jf, interp, jnp.asarray(centers), grad=True,
                        sup_idx=tuple(jnp.asarray(t) for t in sup_c))
    ja = tuple(jnp.asarray(x) for x in a)
    _, fg = JS.predict(jg, ja, grad=True)
    ref = [v + g + reg * ai for v, g, ai in zip(
        JS.scatter_rows(jv, shapes, jnp.asarray(pos_w) * JS.predict(jv, ja)),
        JS.scatter_rows(jg, shapes, jnp.asarray(nrm_w)[:, None] * fg,
                        grad=True), ja)]
    ref_rhs = JS.scatter_rows(jg, shapes, jnp.asarray(nrm_w)[:, None]
                              * jnp.asarray(-nv), grad=True)
    ref_diag = [x + y + reg for x, y in zip(
        JS.diag_contrib(jv, shapes, jnp.asarray(pos_w)),
        JS.diag_contrib(jg, shapes, jnp.asarray(nrm_w), grad=True))]

    matvec, rhs, diag = setup["field"].normal_equations(
        torch.from_numpy(xyz), torch.from_numpy(pos_w),
        torch.from_numpy(centers), torch.from_numpy(nrm_w),
        torch.from_numpy(-nv), reg_weight=reg,
        pos_sup_idx=[_idx(t) for t in sup_p],
        normal_sup_idx=[_idx(t) for t in sup_c])
    got = matvec(tuple(torch.from_numpy(x) for x in a))
    for group_ref, group in ((ref, got), (ref_rhs, rhs), (ref_diag, diag)):
        for r, t in zip(group_ref, group):
            _close(t, r)


@pytest.mark.parametrize("approx", [False, True])
def test_solve_fused_equals_non_fused(setup, approx):
    """The recompute-in-every-matvec solve runs the same operations as
    the held-support solve: equal coefficients and statistics after 5
    iterations (rtol 1e-6; both run on one CPU in one order)."""
    xyz, centers, nv, pos_w, nrm_w, sup_p, sup_c = _system_inputs(setup)
    field = setup["field"]
    field.approx_kernel_grad = approx
    args = (torch.from_numpy(xyz), torch.from_numpy(pos_w),
            torch.from_numpy(centers), torch.from_numpy(nrm_w),
            torch.from_numpy(-nv))
    kw = dict(reg_weight=1.0, solver_tol=1e-12, max_iters=5,
              pos_sup_idx=[_idx(t) for t in sup_p],
              normal_sup_idx=[_idx(t) for t in sup_c])
    a = field.solve(*args, fused=False, **kw)
    b = field.solve(*args, fused=True, **kw)
    field.approx_kernel_grad = False
    assert a.cg_stats[0] == b.cg_stats[0] == 5
    np.testing.assert_allclose(a.cg_stats[1], b.cg_stats[1], rtol=1e-6)
    for x, y in zip(a.alpha, b.alpha):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(x.abs().max()))
