"""The port's dual (row-space) lattice solve, ``solver_formulation=
"dual"``, against nksr_tpu on the CPU, at small sizes, with the same
weights, f32 on both sides.

The dual is the reference NKSR's own formulation and the one whose CG
reaches 1e-4 in f32 (DESIGN.md #17), so it carries the port's converged
parity check: a sphere solved to tol 1e-4 in both packages, both
``converged``, field values compared at probes
(tests/test_pipeline.py::test_dense_unet_reconstruct_parity's bound).
Below that: the matvec's middle ``C C^T`` against the JAX package's
``_gram_middle``, the solve after 1 and 3 iterations, and every lattice
route after 3 iterations (route A, adaptive, both predicted engines, a
chunked call).  Route B's support-row solve has no dual in either
package and solves the primal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from bench import synthetic_scene
from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.models import pipeline as JP
from nksr_tpu.recon import host_predicted as JHP
from nksr_tpu.recon import predicted_dense as JPD
from nksr_tpu.recon import reconstructor as JR
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields import lattice_kernels as LK
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.ops import segment_sum as SEG
from nksr_tpu_torch.recon import host_predicted as HP
from nksr_tpu_torch.recon import predicted_dense as PD
from nksr_tpu_torch.recon import reconstructor as R

from test_field import sphere_points
from test_torch_adaptive import CFG as ADAPTIVE_CFG
from test_torch_adaptive import KW as ADAPTIVE_KW
from test_torch_chunked import PLANE_CFG, _plane
from test_torch_dense_unet import SMALL, random_params, to_jax
from test_torch_predicted import Case, boosted_params
from test_torch_slice import _check_solve_against_jax, _net, _solve_inputs
from test_torch_sparse_slice import _params as route_params
from test_torch_sparse_slice import _two_patches

torch.set_num_threads(1)

DUAL = dict(solver_formulation="dual")
# tests/test_pipeline.py::test_dense_unet_reconstruct_parity: its
# configuration, scene, probes and bound
CONVERGED_CFG = dict(voxel_size=0.1, tree_depth=3, adaptive_depth=1,
                     f_maps=16, basis_dim=8, udf_dim=8, **DUAL)
CONVERGED_KW = dict(detail_level=None, voxel_size=0.1, structure="splat",
                    solver_tol=1e-4, solver_max_iters=500)
FIELD_BOUND = 5e-3
# a whole route's coefficients after 3 iterations: the UNets' f32
# features (1e-5 apart) enter the system, as in the primal's route tests
ROUTE_RTOL = 1e-3


def _real_slot_rows(plan, rng):
    """Random f32 slot rows (point slots, then gradient slots) at the
    plan's slot cells, zero at the pad and inactive slots, and those
    slots' cells set to -1 (dropped), as the solve builds its tables."""
    spec = plan.spec
    cells = np.concatenate([plan.slot_cell0_pt, plan.slot_cell0_gr])
    n_real = int((plan.pt_dest % spec.s_pt).max()) + 1
    real = np.concatenate([np.arange(spec.s_pt) < n_real, plan.gr_active])
    y = rng.normal(size=(len(cells), spec.lanes)).astype(np.float32)
    y[~real] = 0.0
    return cells, np.where(real, cells, -1), y


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gram_middle_matches_jax(cdt):
    """``lattice.gram_middle`` (slot-row adjoint in f32, then AV0's slot
    rows) against the JAX package's ``_gram_middle`` on the dense f32
    buffer ``np.add.at`` builds from the same slot rows, read at the slot
    cells: rtol 1e-5 in f32 (f32 sums in other orders); rounded to bf16,
    within one bf16 ulp (2^-7 of the value; a sum 1e-6 apart may round
    either way) and atol 1e-5 of the largest."""
    cfg = P.PipelineConfig(**SMALL)
    _, plan, _, _ = _solve_inputs(cfg, 7)
    spec = plan.spec
    cells, kept, y = _real_slot_rows(plan, np.random.default_rng(11))
    z0 = np.zeros((spec.n_cells(0), spec.lanes), np.float32)
    np.add.at(z0, cells, y)
    phase0 = tuple((0, 0, 0) for _ in range(spec.depth))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[cdt]
    ref = np.asarray(JLAT._gram_middle(spec, jnp.asarray(z0), phase0, jdt)
                     .astype(jnp.float32))[cells]
    tab = LK.adjoint_rows_tables(spec, torch.from_numpy(kept))
    got = LAT.gram_middle(spec, tab, torch.from_numpy(y),
                          torch.from_numpy(cells.astype(np.int32)), cdt)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(ref).max() > 0
    atol = 1e-5 * np.abs(ref).max()
    if cdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                      got.numpy())
        err = np.abs(got.numpy() - ref)
        assert (err <= 2.0 ** -7 * np.abs(ref) + atol).all(), err.max()


@pytest.mark.parametrize("max_iters", [1, 3])
def test_dual_solve_matches_jax(max_iters):
    """The dual solve on the same plan, rows and weights after 1 and 3
    CG iterations: coefficients on the active voxels to rtol 1e-4 (atol
    1e-4 of the largest), equal iteration counts and the row-space
    rel_res to rtol 1e-4, as the primal's
    (tests/test_torch_slice.py::test_solve_matches_jax)."""
    _check_solve_against_jax(max_iters, formulation="dual")


def test_unknown_formulation_raises():
    cfg = P.PipelineConfig(**SMALL, solver_formulation="gram")
    xyz, nrm = synthetic_scene(300, seed=3, half_extent=1.0)
    with pytest.raises(ValueError, match="formulation 'gram'"):
        Reconstructor(device="cpu", config=cfg).reconstruct(
            xyz, nrm, detail_level=None, voxel_size=0.1, structure="splat")


@pytest.fixture(scope="module")
def converged():
    """The sphere of the JAX package's pin through both packages with
    the dual to tol 1e-4 (the port's seeded weights in both), and each
    field's values at the pin's probes."""
    cfg = P.PipelineConfig(**CONVERGED_CFG)
    params = P.init_params(cfg, 0)
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    probe = sphere_points(150, r=0.45, seed=4)[0]
    jf = JReconstructor(config=JP.PipelineConfig(**CONVERGED_CFG),
                        params=to_jax(params)).reconstruct(
        xyz, nrm, **CONVERGED_KW)
    tf = Reconstructor(device="cpu", config=cfg, params=params).reconstruct(
        xyz, nrm, **CONVERGED_KW)
    return (jf, tf, np.asarray(jf.evaluate_f(probe).value),
            tf.evaluate_f(probe).value)


def test_converged_dual_field_matches_jax(converged):
    """Both solves reach tol 1e-4 (``solver_stats.converged``) in
    iteration counts 5% apart, and the port's field values at the probes
    are within 5e-3 of the largest |f| of the JAX package's."""
    jf, tf, jv, tv = converged
    assert jf.solver_stats.converged, jf.solver_stats
    assert tf.solver_stats.converged, tf.solver_stats
    assert tf.lattice_ctx is not None
    assert abs(tf.solver_stats.iters - jf.solver_stats.iters) <= \
        0.05 * jf.solver_stats.iters
    scale = np.abs(jv).max()
    assert scale > 0
    assert np.abs(tv - jv).max() / scale < FIELD_BOUND, \
        np.abs(tv - jv).max() / scale


def test_converged_dual_meshes_agree(converged):
    """Meshes of the converged fields: vertex counts within 1% and every
    vertex within 0.05 voxel of the other mesh's vertices; the mesh lies
    on the sphere."""
    jf, tf, _, _ = converged
    jv = np.asarray(jf.extract_dual_mesh(mise_iter=1).v)
    tm = tf.extract_dual_mesh(mise_iter=1)
    tv = tm.v
    assert len(tv) > 100 and tm.f.max() < len(tv)
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert cKDTree(jv).query(tv)[0].max() < 0.05 * 0.1
    assert cKDTree(tv).query(jv)[0].max() < 0.05 * 0.1
    r = np.linalg.norm(tv[np.unique(tm.f)], axis=1)
    assert np.median(np.abs(r - 0.5)) < 0.05


def _assert_alphas_close(hf, jhf, grids, k=4):
    assert hf.solver_stats.iters == jhf.solver_stats.iters == 3
    np.testing.assert_allclose(hf.solver_stats.rel_res,
                               jhf.solver_stats.rel_res, rtol=ROUTE_RTOL)
    for d, g in enumerate(grids):
        n = len(g.keys)
        ref = np.asarray(jhf.field.alpha[d]).reshape(-1, k)[:n]
        got = hf.alpha[d].numpy().reshape(-1, k)[:n]
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=ROUTE_RTOL,
                                   atol=ROUTE_RTOL * np.abs(ref).max())


ITERS3 = dict(solver_max_iters=3, solver_tol=1e-12)


def test_route_a_dual_matches_jax(monkeypatch):
    """Route A (the gather-conv UNet, the lattice solve): the dual's
    coefficients after 3 iterations on the active voxels to rtol 1e-3."""
    for mod in (JR, R):
        monkeypatch.setattr(mod, "DENSE_UNET_CELLMAP_BUDGET", 0)
    xyz, nrm = synthetic_scene(3000, seed=3, half_extent=2.0)
    cfg_kw = dict(SMALL, **DUAL)
    params = route_params(P.PipelineConfig(**cfg_kw))
    kw = dict(detail_level=None, voxel_size=0.1, structure="splat", **ITERS3)
    jrec = JReconstructor(config=JP.PipelineConfig(**cfg_kw),
                          params=to_jax(params))
    rec = Reconstructor(device="cpu", config=P.PipelineConfig(**cfg_kw),
                        params=params)
    jf, tf = jrec.reconstruct(xyz, nrm, **kw), rec.reconstruct(xyz, nrm, **kw)
    assert jrec._last_unet_engine == rec._last_unet_engine == "sparse"
    assert tf.lattice_ctx is not None
    _assert_alphas_close(tf, jf, tf.host_grids)


def test_adaptive_dual_matches_jax():
    """The adaptive structure (adaptive depth 2, the dense UNet): the
    dual's coefficients after 3 iterations on the decoder voxels."""
    cfg_kw = dict(ADAPTIVE_CFG, **DUAL)
    params = random_params(P.PipelineConfig(**cfg_kw), 5)
    for d in range(3):
        for leaf in params["params"]["unet"][f"normal_{d}"].values():
            leaf *= 0.05
    xyz, nrm = sphere_points(1500, r=0.5, seed=31)
    kw = dict(ADAPTIVE_KW, **ITERS3)
    jf = JReconstructor(config=JP.PipelineConfig(**cfg_kw),
                        params=to_jax(params)).reconstruct(xyz, nrm, **kw)
    rec = Reconstructor(device="cpu", config=P.PipelineConfig(**cfg_kw),
                        params=params)
    tf = rec.reconstruct(xyz, nrm, **kw)
    assert rec._last_unet_engine == "dense" and tf.lattice_ctx is not None
    _assert_alphas_close(tf, jf, tf.host_grids)


@pytest.mark.parametrize("engine", ["dense", "host-per-level"])
def test_predicted_dual_matches_jax(engine, monkeypatch):
    """Both predicted engines' final solves in the dual: coefficients
    after 3 iterations on the decoder voxels."""
    case = Case(boosted_params(), **DUAL)
    jcfg = dataclasses.replace(case.jcfg, **ITERS3)
    cfg = dataclasses.replace(case.cfg, **ITERS3)
    args = case.port_args()
    if engine == "dense":
        jhf = JPD.reconstruct_predicted_dense(case.jparams, jcfg,
                                              *case.jax_args()[2:])
        hf = PD.reconstruct_predicted_dense(cfg, *args[1:])
    else:
        monkeypatch.setenv("NKSR_PRED_DENSE", "0")
        jhf = JHP.reconstruct_predicted_host(case.jparams, jcfg,
                                             *case.jax_args()[2:])
        hf = HP.reconstruct_predicted_host(cfg, *args[1:])
    assert hf.lattice_ctx is not None
    _assert_alphas_close(hf, jhf, hf.host_grids)


def test_chunked_dual_matches_jax():
    """One chunked call (the plane of tests/test_torch_chunked.py in four
    chunks): each chunk's dual coefficients after 3 iterations."""
    cfg_kw = dict(PLANE_CFG, **DUAL)
    params = random_params(P.PipelineConfig(**cfg_kw), 0)
    xyz, nrm = _plane()
    kw = dict(chunk_size=1.0, solver_tol=1e-12)
    jcf = JReconstructor(config=JP.PipelineConfig(**cfg_kw),
                         params=to_jax(params)).reconstruct(xyz, nrm, **kw)
    cf = Reconstructor(device="cpu", config=P.PipelineConfig(**cfg_kw),
                       params=params).reconstruct(xyz, nrm, **kw)
    assert len(cf.chunks) == len(jcf.chunks) == 4
    for ch, jch in zip(cf.chunks, jcf.chunks):
        _assert_alphas_close(ch["field"], jch["field"],
                             ch["field"].host_grids)


def test_route_b_solves_the_primal():
    """Route B (no lattice plan) takes no formulation, as in the JAX
    package: the dual configuration gives the primal's field bit for
    bit."""
    xyz, nrm = _two_patches(600, 1.0)
    cfg = P.PipelineConfig(**SMALL)
    params = route_params(cfg)
    kw = dict(detail_level=None, voxel_size=0.1, structure="splat", **ITERS3)
    fields = [Reconstructor(device="cpu", config=c, params=params)
              .reconstruct(xyz, nrm, **kw)
              for c in (cfg, dataclasses.replace(cfg, **DUAL))]
    assert all(f.lattice_ctx is None for f in fields)
    for a, b in zip(fields[0].alpha, fields[1].alpha):
        assert torch.equal(a, b)
    assert fields[0].solver_stats.rel_res == fields[1].solver_stats.rel_res


def test_dual_calls_and_launches(monkeypatch):
    """On CPU tensors every launch count stays 0.  A dual solve of 3
    iterations with bf16 row values calls the slot-row adjoint once a
    matvec with ``torch.float32`` (the middle) and once with bf16 (the
    back-substitution), the slot rows once a matvec in bf16, and nothing
    else: no dense forward, no dense adjoint, no segment sum."""
    calls = []
    counted = (LK.av0_adjoint_rows, LK.av0_rows, LK.av0_cascade,
               LK.av0_adjoint_cascade, SEG.segment_sum)
    real_adj, real_rows = counted[:2]

    def adj_spy(spec, tables, y, compute_dtype):
        calls.append(("adj_rows", compute_dtype))
        return real_adj(spec, tables, y, compute_dtype)

    def rows_spy(spec, xs, cells0, dtype):
        calls.append(("rows", dtype))
        return real_rows(spec, xs, cells0, dtype)

    def fail(*a, **k):
        raise AssertionError("the dual solve called a dense kernel")

    monkeypatch.setattr(LK, "av0_adjoint_rows", adj_spy)
    monkeypatch.setattr(LK, "av0_rows", rows_spy)
    monkeypatch.setattr(LK, "av0_cascade", fail)
    monkeypatch.setattr(LK, "av0_adjoint_cascade", fail)
    cfg = P.PipelineConfig(**SMALL)
    xyz, plan, basis, tgt = _solve_inputs(cfg, 7)

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                                else a)

    out = LAT.lattice_solve(
        plan.spec, _net(cfg, random_params(cfg, 2)).interpolators,
        [torch.from_numpy(b) for b in basis],
        torch.from_numpy(xyz[plan.pt_perm]), t(plan.pt_cell0),
        t(plan.pt_dest), t(plan.slot_cell_pt), t(plan.slot_cell_gr),
        t(plan.gr_coords), t(plan.gr_depth), t(plan.gr_active),
        torch.from_numpy(tgt), [t(v) for v in plan.vox_cell],
        [t(v) for v in plan.vox_active], voxel_size=cfg.voxel_size,
        pos_weight=cfg.pos_weight, normal_weight=cfg.normal_weight,
        reg_weight=cfg.reg_weight, tol=1e-12, max_iters=3,
        approx_grad=False, slot_cell0_pt=t(plan.slot_cell0_pt),
        slot_cell0_gr=t(plan.slot_cell0_gr), gr_perm=t(plan.gr_perm),
        compute_dtype=torch.bfloat16, formulation="dual")
    assert out[2][0] == 3
    bf, f32 = torch.bfloat16, torch.float32
    assert calls == [("adj_rows", f32), ("rows", bf)] * 3 + \
        [("adj_rows", bf)]
    assert all(np.isfinite(a.numpy()).all() for a in out[0])
    assert [fn.launches for fn in counted] == [0] * len(counted)
