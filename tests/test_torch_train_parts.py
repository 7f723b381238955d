"""The training slice's parts against the JAX package on the CPU: the
implicitly differentiated solve, the optimizer chain, the GT hierarchies
and their statuses, the IMLS targets, the data loader, the fixed-order
backwards of the gathers and the segment sum, the train-state checkpoint
both ways, and the loop's entry points (``fit``, resume, a port-trained
checkpoint meshed by ``Reconstructor``)."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nksr_tpu.core.svh import SparseFeatureHierarchy
from nksr_tpu.data import DatasetSpec as JDS
from nksr_tpu.data import ShapeNetDataset as JShapeNet
from nksr_tpu.data import to_device_batch as j_to_device_batch
from nksr_tpu.ops import knn as JK
from nksr_tpu.ops import sdf as JSDF
from nksr_tpu.solver.pcg import solve_spd as j_solve_spd
from nksr_tpu.train import loop as JT
from nksr_tpu.utils import checkpoint as JCKPT

from test_field import sphere_points

from nksr_tpu_torch.core import svh as SVH
from nksr_tpu_torch.data import DatasetSpec as DS
from nksr_tpu_torch.data import ShapeNetDataset, to_device_batch
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.ops import gather_scatter as gs
from nksr_tpu_torch.ops import knn as K
from nksr_tpu_torch.ops import sdf as SDF
from nksr_tpu_torch.ops import segment_sum as SEG
from nksr_tpu_torch.ops.window_basis import window_and_grad_fused
from nksr_tpu_torch.solver.pcg import solve_spd
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.train import loop as T
from nksr_tpu_torch.utils import checkpoint as CKPT

REPO = Path(__file__).resolve().parents[1]
TINY = dict(voxel_size=0.1, tree_depth=2, adaptive_depth=1, f_maps=8,
            basis_dim=8, udf_dim=8, capacities=(512, 256))


# ------------------------------------------------------- the implicit solve
def _spd_system(dtype, seed=0, n=12, m=30):
    """A = C^T diag(w) C + I with C fixed: matvec(a, w) linear in a, w an
    input of the operator; b the right-hand side."""
    g = np.random.default_rng(seed)
    c = g.normal(size=(m, n))
    w = g.uniform(0.5, 2.0, size=m)
    b = g.normal(size=n)
    return c, w, b


def _torch_solve(c, w, b, tol, iters):
    ct = torch.as_tensor(c)

    def matvec(a, wt):
        return ((ct.T @ (wt * (ct @ a[0]))) + a[0],)
    return solve_spd(matvec, (b,), (w,), tol=tol, max_iters=iters)[0]


def test_solve_spd_gradcheck_f64():
    """``torch.autograd.gradcheck`` of x(b, w) in f64, both inputs: the
    backward PCG and the operator's cotangent -lam^T d(A x)/dw."""
    c, w, b = _spd_system(torch.float64)
    bt = torch.tensor(b, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda bb, ww: _torch_solve(c, ww, bb, 1e-14, 200), (bt, wt),
        eps=1e-6, atol=1e-6)


def test_solve_spd_grads_match_custom_linear_solve():
    """Gradients of sum(x * r) wrt b and w against the JAX package's
    ``solve_spd`` (``lax.custom_linear_solve``, symmetric) on the same
    f64 system, both converged: within 1e-9 relative."""
    c, w, b = _spd_system(torch.float64, seed=3)
    r = np.random.default_rng(4).normal(size=b.shape)
    jax.config.update("jax_enable_x64", True)
    try:
        cj = jnp.asarray(c)

        def jloss(bb, ww):
            x = j_solve_spd(lambda a: cj.T @ (ww * (cj @ a)) + a, bb,
                            tol=1e-14, max_iters=200)
            return jnp.sum(x * jnp.asarray(r))
        jgb, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(b),
                                                   jnp.asarray(w))
        jgb, jgw = np.asarray(jgb), np.asarray(jgw)
    finally:
        jax.config.update("jax_enable_x64", False)
    bt = torch.tensor(b, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    (_torch_solve(c, wt, bt, 1e-14, 200) * torch.as_tensor(r)).sum() \
        .backward()
    np.testing.assert_allclose(bt.grad.numpy(), jgb, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(wt.grad.numpy(), jgw, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------- optimizer
def test_optimizer_matches_optax_chain():
    """Five updates of random gradients, the third holding a NaN, through
    the port's chain and optax's (``make_optimizer``: value clip 0.5,
    AMSGrad on the bias-corrected nu_hat, decayed weights, staircase
    learning rate floored at ``lr_clip``, NaN steps skipped): parameters
    and optimizer state within 1e-6 of each leaf's largest magnitude at
    every step (f32 both sides; XLA may fuse a multiply-add)."""
    tc = T.TrainConfig(lr_init=2e-3, lr_decay_mult=0.5, lr_decay_step=2,
                       lr_clip=6e-4, weight_decay=0.01, grad_clip=0.5)
    jtc = JT.TrainConfig(**dataclasses.asdict(tc))
    cfg = P.PipelineConfig(**TINY)
    state = T.init_state(cfg, tc, seed=1, device="cpu")
    net = state.net
    # copies: torch_to_params returns views of the parameters, which the
    # port's update changes in place
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.array(a)),
        {"params": CKPT.torch_to_params(net.state_dict())})
    opt = JT.make_optimizer(jtc)
    jstate = opt.init(jparams)
    g = torch.Generator().manual_seed(7)
    opt_state = state.opt_state
    for step in range(5):
        grads = {n: torch.randn(p.shape, generator=g) * 0.7
                 for n, p in net.named_parameters()}
        if step == 2:
            next(iter(grads.values()))[0] = float("nan")
        for n, p in net.named_parameters():
            p.grad = grads[n].clone()
        opt_state = T.apply_optimizer(tc, net, opt_state)
        jg = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.array(a)),
            {"params": CKPT.torch_to_params(grads)})
        upd, jstate = opt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        got = CKPT.torch_to_params(net.state_dict())
        for (path, ref), (_, val) in zip(
                _leaves(jax.tree_util.tree_map(np.asarray, jparams)),
                _leaves({"params": got})):
            np.testing.assert_allclose(
                val, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                err_msg=f"step {step} {path}")
        assert bool(opt_state["last_finite"]) == (step != 2)
        assert int(opt_state["total_notfinite"]) == int(
            jstate.total_notfinite)
        assert int(opt_state["inner_state"]["1"]["count"]) == int(
            jstate.inner_state[1].count)
        tree = CKPT._opt_to_tree(opt_state)
        for key in ("mu", "nu", "nu_max"):
            ref = getattr(jstate.inner_state[1], key)
            for (path, r), (_, v) in zip(
                    _leaves(jax.tree_util.tree_map(np.asarray, ref)),
                    _leaves(tree["inner_state"]["1"][key])):
                np.testing.assert_allclose(
                    v, r, rtol=1e-6, atol=1e-6 * np.abs(r).max(),
                    err_msg=f"{key} {path}")


def test_lr_schedule_and_structure_prob_match_jax():
    tc = T.TrainConfig(lr_init=1e-3, lr_decay_mult=0.7, lr_decay_step=3,
                       lr_clip=3e-4, structure_start_step=5,
                       structure_end_step=9)
    jtc = JT.TrainConfig(**dataclasses.asdict(tc))
    for step in range(0, 14):
        assert float(T.lr_schedule(tc, step)) == float(
            JT.lr_schedule(jtc)(jnp.int32(step)))
        assert T.pd_structure_prob(tc, step) == JT.pd_structure_prob(
            jtc, step)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


# -------------------------------------------------------------- hierarchies
def _jax_levels(svh):
    return [np.asarray(g.coords)[:int(g.num_voxels)] for g in svh.grids]


@pytest.mark.parametrize("adaptive_depth,caps,tau", [
    (1, (2048, 1024, 512), 0.1),
    (1, (700, 200, 512), 0.1),      # levels 0 and 1 over capacity
    (2, (2048, 1024, 512), 0.02),
    (2, (300, 200, 512), 0.02),     # the adaptive level and its parent cut
])
def test_gt_hierarchy_and_status_match_jax(adaptive_depth, caps, tau):
    """The GT hierarchy (``build_adaptive_normal_variation``) equal to the
    JAX in-graph build voxel for voxel at each level, including full
    levels (the same voxels dropped), and ``evaluate_voxel_status`` equal
    on every voxel of the input's splat hierarchy."""
    xyz, nrm = sphere_points(800, r=0.5, seed=5)
    xyz = xyz + np.float32([0.013, -0.021, 0.007])
    jsvh = jax.jit(lambda x, n: SparseFeatureHierarchy
                   .build_adaptive_normal_variation(
                       x, n, jnp.ones(len(x), bool), 0.1, 3, caps,
                       tau=tau, adaptive_depth=adaptive_depth))(
        jnp.asarray(xyz), jnp.asarray(nrm))
    grids = SVH.build_adaptive_normal_variation(
        xyz, nrm, 0.1, 3, caps, tau=tau, adaptive_depth=adaptive_depth)
    for d, ref in enumerate(_jax_levels(jsvh)):
        np.testing.assert_array_equal(grids[d].coords, ref, err_msg=str(d))
    assert len(grids[0].keys) > 0
    for d in range(2):      # a level under its capacity is a full level
        if caps[d] < 1000:
            assert len(grids[d].keys) == caps[d], d
    enc, _ = SVH.build_point_splatting(xyz * 1.1, 0.1, 3, (4096,) * 3)
    for d in range(3):
        want = np.asarray(jax.jit(
            lambda c, dd=d: jsvh.evaluate_voxel_status(c, dd))(
                jnp.asarray(enc[d].coords, jnp.int32)))
        got = SVH.evaluate_voxel_status(grids, enc[d].coords, d)
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- IMLS targets
@pytest.mark.parametrize("imls", [True, False])
def test_sdf_from_points_matches_jax(imls):
    """The GT distance of 600 queries around a sphere (IMLS with the
    adaptive bandwidth, and the vote with the self-kNN radius) against
    the JAX package's over the same bucket table: within 1e-5."""
    ref, nrm = sphere_points(2000, r=0.5, seed=2)
    q = np.random.default_rng(3).uniform(-0.8, 0.8, (600, 3)).astype(
        np.float32)
    n = len(ref)
    jt = JK.build_buckets(jnp.asarray(ref), jnp.ones(n, bool), 0.4, 2048, 32)
    want = np.asarray(JSDF.sdf_from_points(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(nrm), None, table=jt,
        nb_points=8, stdv=0.02, imls=imls))
    table = K.build_buckets(torch.from_numpy(ref), 0.4, 32)
    got = SDF.sdf_from_points(torch.from_numpy(q), torch.from_numpy(ref),
                              torch.from_numpy(nrm), table=table,
                              nb_points=8, stdv=0.02, imls=imls).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- data
def test_to_device_batch_matches_jax(tmp_path):
    """One ``scripts/make_synth_scenes.py`` item through the port's
    ShapeNet reader and loader against the JAX package's: the same
    arrays (seeded input draw, padding, masks, occupancy samples)."""
    spec = importlib.util.spec_from_file_location(
        "make_synth_scenes", REPO / "scripts" / "make_synth_scenes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path), 8, 3000)
    keys = ["SHAPE_NAME", "INPUT_PC", "TARGET_NORMAL", "GT_DENSE_PC",
            "GT_DENSE_NORMAL", "GT_ONET_SAMPLE"]
    jds = JShapeNet(str(tmp_path), [getattr(JDS, k) for k in keys],
                    split="train", num_input_points=1000, seed=3)
    ds = ShapeNetDataset(str(tmp_path), [getattr(DS, k) for k in keys],
                         split="train", num_input_points=1000, seed=3)
    assert len(ds) == len(jds) == 6
    want = j_to_device_batch(jds[1], 2048, 4096)
    got = to_device_batch(ds[1], 2048, 4096)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ------------------------------------------------ fixed-order backwards
def test_gather_rows_backward_equals_index_select():
    """``gather_rows`` and ``take_rows`` (and the conv's gather) backward
    through the fixed-order segment sum: equal to autograd's CPU
    ``index_select`` backward (``index_add_``) bit for bit, repeated and
    absent rows included."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn((50, 6), generator=g)
    idx = torch.randint(-1, 50, (400, 3), generator=g)
    cot = torch.randn((400, 3, 6), generator=g)
    a = src.clone().requires_grad_()
    (gs.take_rows(a, idx) * cot).sum().backward()
    b = src.clone().requires_grad_()
    ref = b.index_select(0, idx.clamp(min=0).reshape(-1)).reshape(400, 3, 6)
    (torch.where((idx >= 0)[..., None], ref, 0.0) * cot).sum().backward()
    assert torch.equal(a.grad, b.grad)
    w = torch.randn((3, 6, 4), generator=g)
    c = src.clone().requires_grad_()
    out = gs.gather_conv(c, idx, w)
    out.backward(torch.ones_like(out))
    d = src.clone().requires_grad_()
    fp = torch.cat([d, d.new_zeros((1, 6))], 0)
    gi = fp.index_select(0, torch.where(idx >= 0, idx, 50).reshape(-1))
    ref = gi.reshape(-1, 18) @ w.reshape(18, 4)
    ref.backward(torch.ones_like(ref))
    assert torch.allclose(c.grad, d.grad, rtol=1e-6, atol=1e-6)


def test_gather_backward_sorts_each_table_once(monkeypatch):
    """Gathers reading one index table (whole or through the same slice,
    as the convs of a level do) sort it once for their backwards; a
    write to the table sorts it anew; every backward stays equal to
    autograd's CPU ``index_select`` backward bit for bit."""
    built = []
    real = SEG.segment_order
    monkeypatch.setattr(SEG, "segment_order",
                        lambda i, n, *a: built.append(n) or real(i, n, *a))
    g = torch.Generator().manual_seed(2)
    table = torch.randint(-1, 30, (200, 4), generator=g)
    src = torch.randn((30, 5), generator=g)

    def grads(idx):
        cot = torch.randn((*idx.shape, 5), generator=g)
        a = src.clone().requires_grad_()
        (gs.take_rows(a, idx) * cot).sum().backward()
        b = src.clone().requires_grad_()
        ref = b.index_select(0, idx.clamp(min=0).reshape(-1)).reshape(
            *idx.shape, 5)
        (torch.where((idx >= 0)[..., None], ref, 0.0) * cot).sum().backward()
        assert torch.equal(a.grad, b.grad)

    for _ in range(3):
        grads(table)
        grads(table[:150])
    assert len(built) == 2
    table[0, 0] = (int(table[0, 0]) + 1) % 30
    grads(table)
    assert len(built) == 3


@pytest.mark.parametrize("compact", [False, True])
def test_segment_sum_backward_equals_index_add(compact):
    """The segment sum's backward (a gather of the cotangent rows, zero
    for dropped entries) against autograd of CPU ``index_add_``."""
    g = torch.Generator().manual_seed(1)
    idx = torch.randint(-1, 40, (300,), generator=g)
    vals = torch.randn((300, 5), generator=g)
    order = SEG.segment_order(idx, 40)
    a = vals.clone().requires_grad_()
    out = SEG.segment_sum(a, order, compact=compact)
    cot = torch.randn(out.shape, generator=g)
    (out * cot).sum().backward()
    b = vals.clone().requires_grad_()
    keep = idx >= 0
    dense = b.new_zeros((40, 5)).index_add(0, idx[keep], b[keep])
    ref = dense[order.targets] if compact else dense
    (ref * cot).sum().backward()
    assert torch.equal(a.grad, b.grad)


def test_window_kernel_refuses_grad_inputs():
    z = torch.zeros((4, 8, 3), requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        window_and_grad_fused(z)


# --------------------------------------------------------------- checkpoint
def _jax_cfg():
    from nksr_tpu.models import pipeline as JP
    return JP.PipelineConfig(**TINY)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port-written train state (after two updates) read back by the
    JAX package's ``load_params`` into ``init_state``'s template: the
    params, moments, counts and step as the port holds them."""
    cfg, tc = P.PipelineConfig(**TINY), T.TrainConfig()
    state = T.init_state(cfg, tc, seed=2, device="cpu")
    g = torch.Generator().manual_seed(3)
    opt_state = state.opt_state
    for _ in range(2):
        for p in state.net.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt_state = T.apply_optimizer(tc, state.net, opt_state)
    path = tmp_path / "port.ckpt"
    CKPT.save_train_state(path, state.net, opt_state, 2)
    template = JT.init_state(_jax_cfg(), JT.TrainConfig(),
                             jax.random.PRNGKey(0))
    js = JCKPT.load_params(path, template)
    assert int(js.step) == 2
    want = {"params": CKPT.torch_to_params(state.net.state_dict())}
    for (p1, a), (p2, b) in zip(_leaves(jax.tree_util.tree_map(
            np.asarray, js.params)), _leaves(want)):
        assert p1 == p2
        np.testing.assert_array_equal(a, b)
    ams = js.opt_state.inner_state[1]
    assert int(ams.count) == 2 and int(js.opt_state.inner_state[3].count) \
        == 2
    tree = CKPT._opt_to_tree(opt_state)["inner_state"]["1"]
    for (_, a), (_, b) in zip(_leaves(jax.tree_util.tree_map(
            np.asarray, ams.nu_max)), _leaves(tree["nu_max"])):
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX ``init_state`` checkpoint (``save_params``) resumed by the
    port: its params in the network, its zero state and step."""
    js = JT.init_state(_jax_cfg(), JT.TrainConfig(), jax.random.PRNGKey(5))
    path = tmp_path / "jax.ckpt"
    JCKPT.save_params(path, js)
    net = NKSRNetwork(P.PipelineConfig(**TINY))
    opt_state, step = CKPT.load_train_state(path, net, "cpu")
    assert step == 0
    for (_, a), (_, b) in zip(
            _leaves(jax.tree_util.tree_map(np.asarray, js.params)),
            _leaves({"params": CKPT.torch_to_params(net.state_dict())})):
        np.testing.assert_array_equal(a, b)
    assert int(opt_state["inner_state"]["1"]["count"]) == 0
    assert all(float(v.abs().max()) == 0 for v in
               opt_state["inner_state"]["1"]["nu_max"].values())


# --------------------------------------------------------------- the loop
def _sphere_batch(n=300, cap=512, seed=0):
    xyz, nrm = sphere_points(n, r=0.5, seed=seed)
    pad = lambda a: torch.from_numpy(np.pad(a, ((0, cap - n), (0, 0))))
    m = torch.from_numpy(np.arange(cap) < n)
    return {"xyz": pad(xyz), "normal": pad(nrm), "mask": m,
            "gt_xyz": pad(xyz), "gt_normal": pad(nrm), "gt_mask": m}


FIT_CFG = {
    "voxel_size": 0.1, "tree_depth": 2, "adaptive_depth": 1,
    "capacities": [1024, 512], "unet": {"f_maps": 8}, "udf": {"enabled": True},
    "solver_max_iters": 8, "solver_tol": 1e-3,
    "supervision": {
        "spatial": {"samplers": [
            {"type": "uniform", "n_samples": 256, "expand": 1,
             "expand_top": 3}, {"type": "band", "n_samples": 256}]},
        "udf": {"samplers": [{"type": "uniform", "n_samples": 128,
                              "expand": 1, "expand_top": 3}]},
        "gt_surface": {"subsample": 256}},
    "structure_schedule": {"start_step": 100, "end_step": 200},
}


def test_fit_checkpoints_resume_and_reconstruct(tmp_path):
    """``fit`` on the CPU: two steps with one validation write best.ckpt,
    last.ckpt and the CSV/JSON logs; a resumed fit continues at step 2;
    two fits from one seed end bit-equal; ``Reconstructor`` loads the
    port-trained best.ckpt and meshes the cloud."""
    loader = [_sphere_batch(seed=i) for i in range(3)]
    val = [_sphere_batch(seed=9)]
    s1 = driver.fit(FIT_CFG, loader, val, tmp_path / "a", max_steps=2,
                    val_every=2, seed=0, device="cpu")
    assert s1.step == 2
    for f in ("best.ckpt", "last.ckpt", "metrics.csv", "metrics.jsonl"):
        assert (tmp_path / "a" / f).exists(), f
    s2 = driver.fit(FIT_CFG, loader, val, tmp_path / "b", max_steps=2,
                    val_every=2, seed=0, device="cpu")
    for p, q in zip(s1.net.parameters(), s2.net.parameters()):
        assert torch.equal(p, q)
    s3 = driver.fit(FIT_CFG, loader, None, tmp_path / "a", max_steps=3,
                    seed=0, resume=True, device="cpu")
    assert s3.step == 3
    from nksr_tpu_torch import Reconstructor
    from nksr_tpu_torch.utils.checkpoint import load_tree
    pcfg = driver.pipeline_config_from_yaml(FIT_CFG)
    recon = Reconstructor(device="cpu", config=pcfg,
                          params=load_tree(tmp_path / "a" / "best.ckpt"))
    xyz, nrm = sphere_points(300, r=0.5, seed=0)
    mesh = recon.reconstruct(xyz, nrm, detail_level=None, voxel_size=0.1,
                             structure="splat").extract_dual_mesh()
    assert len(mesh.f) > 0 and np.isfinite(mesh.v).all()


@pytest.mark.parametrize("udf,approx", [(False, False), (True, True)])
def test_fused_train_step_matches_unfused(udf, approx, monkeypatch):
    """The ``TINY`` ``train_step`` with ``fused_mode`` (the solve that
    rebuilds its supports in every matvec, differentiated against the
    basis features and the interpolators; tests/test_torch_fused_train.py
    holds it against the JAX package) from the seeded init on the same
    draws as the unfused step: the same CG iterations forward and
    backward, the loss terms within 1e-5 relative, the gradient that
    reaches the optimizer within 1e-5 relative L2 whole and 1e-4 per
    leaf (``check_fused_grads``; UDF head and approximate basis
    gradients off, then on)."""
    cfg = P.PipelineConfig(**TINY, udf_enabled=udf, approx_kernel_grad=approx)
    tc = T.TrainConfig()
    lcfg = driver.loss_config_from_yaml(FIT_CFG)
    grads, real = [], T.apply_optimizer

    def recording(tc, net, opt_state):
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()
                      if p.grad is not None})
        return real(tc, net, opt_state)
    monkeypatch.setattr(T, "apply_optimizer", recording)
    runs = []
    for fused in (False, True):
        state = T.init_state(cfg, tc, device="cpu")
        _, losses, _ = T.train_step(
            dataclasses.replace(cfg, fused_mode=fused), tc, lcfg, state,
            _sphere_batch(), torch.Generator().manual_seed(0))
        runs.append((losses, solve_spd.last_stats[0],
                     solve_spd.last_backward_stats[0]))
    (ul, *uit), (fl, *fit) = runs
    assert uit == fit and set(ul) == set(fl) and ("udf" in ul) == udf
    for k in ul:
        np.testing.assert_allclose(fl[k], ul[k], rtol=1e-5, err_msg=k)
    check_fused_grads(*grads)


# a conv bias that feeds a group norm has a gradient of zero up to
# rounding: such a leaf (norm under ZERO_FLOOR of the whole gradient's)
# is held within that floor (tests/test_torch_dp_train.py's rule)
ZERO_FLOOR = 1e-6


def check_fused_grads(ref, got, whole_rtol=1e-5, leaf_rtol=1e-4):
    """Fused against unfused gradients by name: within ``whole_rtol``
    relative L2 whole and ``leaf_rtol`` per leaf, a leaf of rounding
    size within ``ZERO_FLOOR`` of the whole."""
    assert set(ref) == set(got)
    keys = sorted(ref)
    whole = float(torch.cat([ref[k].flatten() for k in keys]).norm())
    err = float(torch.cat([(got[k] - ref[k]).flatten() for k in keys]
                          ).norm())
    assert err <= whole_rtol * whole, err / whole
    for k in keys:
        d, e = float(ref[k].norm()), float((got[k] - ref[k]).norm())
        if d < ZERO_FLOOR * whole:
            assert e < ZERO_FLOOR * whole, k
        else:
            assert e <= leaf_rtol * d, (k, e / d)


def test_train_and_overfit_scripts_on_the_cpu(tmp_path, capsys):
    """The entry points end to end with ``--device cpu`` on a small
    ``make_synth_scenes`` corpus under runs/scene_big's config at f_maps
    8 (``--exec`` overrides): train writes best.ckpt / last.ckpt, overfit
    its loss.csv and a mesh."""
    from nksr_tpu_torch.scripts import overfit as OV
    from nksr_tpu_torch.scripts import train as TR
    spec = importlib.util.spec_from_file_location(
        "make_synth_scenes", REPO / "scripts" / "make_synth_scenes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path / "data"), 8, 3000, 2.0)
    execs = ["unet.f_maps=8", f"train_dataset.args.root={tmp_path}/data",
             f"val_dataset.args.root={tmp_path}/data",
             "train_dataset.args.num_input_points=1000",
             "val_dataset.args.num_input_points=1000",
             "point_bucket=1024", "gt_bucket=4096", "solver_max_iters=4"]
    cfg_path = str(REPO / "runs" / "scene_big" / "config.yaml")
    state = TR.main([cfg_path, "--run_dir", str(tmp_path / "run"),
                     "--max_steps", "2", "--val_every", "2",
                     "--device", "cpu", "--exec", *execs])
    assert state.step == 2
    assert (tmp_path / "run" / "best.ckpt").exists()
    assert (tmp_path / "run" / "last.ckpt").exists()
    hist = OV.main([cfg_path, "--steps", "2", "--interval", "2",
                    "--run_dir", str(tmp_path / "overfit"), "--device",
                    "cpu", "--exec", *execs])
    assert len(hist) == 2 and all(np.isfinite(h["sum"]) for h in hist)
    assert (tmp_path / "overfit" / "loss.csv").exists()
    assert (tmp_path / "overfit" / "mesh_2.ply").exists()
