"""The port's data-parallel training (``parallel.dp_train_step``,
``train.driver.fit(batch_size=B)``) against the JAX package's
``dp_train_step``, on CPU tensors in gloo worlds; and the rest of the
training driver: ``RunLogger``'s backends, mesh renders, the profiler
trace.

The JAX side is ``tests/test_parallel.py``'s (its ``CFG``, ``LCFG`` and
``make_clouds(2)``, the solve raised to convergence as in
``tests/test_torch_train.py``), run unsharded as that file runs it: the
mean losses and updated params of one ``dp_train_step``, the mean of the
two clouds' ``value_and_grad``, and each cloud's draws, kept in
``tests/data/dp_train_reference.npz`` (its compile takes a minute or
two).  Rewrite it after a change to ``tests/torch_dp_cases.py``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/dp_train_reference.py

The port's side runs in one spawn (``tests/torch_dp_worker.py`` a rank,
one thread each, a ``FileStore`` under ``tmp_path``, killed past
``WORLD_TIMEOUT`` seconds) of a world of two, one cloud a rank, and a
world of one with both clouds.  Gates: loss terms within 1e-3, each
gradient leaf and the whole gradient within 1e-2 relative L2 of JAX's
(the sphere-size gates of tests/test_torch_train.py); the first update
within 1e-6 of JAX's where |g| exceeds 1e-2 of its leaf's largest (the
first AMSGrad step moves each such parameter by about lr), within 2 lr
elsewhere; the two worlds bit-equal and the ranks bit-equal.
"""

import dataclasses
import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dp_cases as C
from nksr_tpu.models import pipeline as JP
from nksr_tpu.train import losses as JL
from nksr_tpu.train import loop as JT

from test_torch_parallel import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dp_worker.py")
WORLD_TIMEOUT = 180
LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-2
UPDATE_ATOL = 1e-6
SMALL_G = 1e-2
ZERO_FLOOR = 1e-6


# ---------------------------------------------------------------- JAX side
def jax_reference() -> dict:
    """JAX ``dp_train_step`` on test_parallel's clouds, unsharded, with
    the solve converged; the mean of per-cloud ``value_and_grad``; the
    draws (``fold_in`` of each cloud's key, as run_parity takes them)
    and every PCG solve's (iterations, relative residual)."""
    from nksr_tpu import parallel as JPP
    import test_parallel as TP
    jpcg = importlib.import_module("nksr_tpu.solver.pcg")
    cfg = dataclasses.replace(TP.CFG, solver_max_iters=C.PARITY_ITERS,
                              solver_tol=C.PARITY_TOL)
    assert cfg == JP.PipelineConfig(**C.CFG_KW)
    assert TP.LCFG == C.loss_config(JL)
    tc = JT.TrainConfig()
    state = JT.init_state(cfg, tc, jax.random.PRNGKey(0))
    xyz, nrm, mask = TP.make_clouds(C.N_CLOUDS)
    batch = {"xyz": xyz, "normal": nrm, "mask": mask,
             "gt_xyz": xyz, "gt_normal": nrm, "gt_mask": mask}
    rngs = jax.random.split(jax.random.PRNGKey(1), C.N_CLOUDS)

    stats = []
    real_pcg = jpcg.pcg

    def recording_pcg(*a, **kw):
        x, i, rel = real_pcg(*a, **kw)
        jax.debug.callback(lambda i, r: stats.append((int(i), float(r))),
                           i, rel)
        return x, i, rel
    mp = pytest.MonkeyPatch()
    mp.setattr(jpcg, "pcg", recording_pcg)
    try:
        new_state, losses = JPP.dp_train_step(cfg, tc, LCFG_J(), state,
                                              batch, rngs,
                                              use_gt_structure=True)
        jax.effects_barrier()
        grads, per_losses, draws = [], [], []
        for i in range(C.N_CLOUDS):
            b = {k: v[i] for k, v in batch.items()}
            gt_svh = JP.build_gt_svh(cfg, b["gt_xyz"], b["gt_mask"],
                                     b["gt_normal"])
            feat = JP.point_features(cfg, b["xyz"], normal=b["normal"])

            def loss_fn(p):
                out = JP.forward(cfg, p, b["xyz"], b["mask"], feat,
                                 gt_svh=gt_svh, use_gt_structure=True)
                lb = dict(b, gt_svh=gt_svh)
                ls, _ = JL.compute_losses(rngs[i], cfg, LCFG_J(), out, lb)
                return sum(ls.values()), ls
            (_, ls), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                state.params)
            jax.effects_barrier()
            grads.append(g)
            per_losses.append({k: float(v) for k, v in ls.items()})
            draws.append({
                "spatial": np.asarray(JL.get_samples(
                    jax.random.fold_in(rngs[i], 1), cfg,
                    LCFG_J().spatial_samplers, gt_svh, b["gt_xyz"],
                    b["gt_normal"], b["gt_mask"])),
                "surface": np.asarray(JL._masked_choice(
                    jax.random.fold_in(rngs[i], 2), b["gt_mask"],
                    LCFG_J().gt_surface_subsample))})
    finally:
        mp.undo()
    mean_grad = jax.tree_util.tree_map(lambda *g: sum(g) / len(g), *grads)
    return dict(
        params=dict(C.flatten(jax.tree_util.tree_map(np.asarray,
                                                     state.params))),
        new_params=dict(C.flatten(jax.tree_util.tree_map(
            np.asarray, new_state.params))),
        grad=dict(C.flatten(jax.tree_util.tree_map(np.asarray, mean_grad))),
        losses={k: float(v) for k, v in losses.items()},
        per_losses=per_losses, draws=draws, stats=stats,
        xyz=np.asarray(xyz), normal=np.asarray(nrm), mask=np.asarray(mask))


def LCFG_J():
    return C.loss_config(JL)


def save_reference(path, r) -> None:
    out = {"xyz": r["xyz"], "normal": r["normal"], "mask": r["mask"],
           "loss_names": np.array(list(r["losses"])),
           "loss_values": np.array(list(r["losses"].values()), np.float64),
           "stats": np.array(r["stats"], np.float64)}
    for name, key in (("params", "p"), ("new_params", "np"), ("grad", "g")):
        out.update({f"{key}/{k}": v for k, v in r[name].items()})
    for i, d in enumerate(r["draws"]):
        out[f"spatial_{i}"] = d["spatial"]
        out[f"surface_{i}"] = d["surface"]
    np.savez_compressed(path, **out)


def load_reference(path=C.REF) -> dict:
    z = np.load(path)
    pick = lambda key: {k[len(key) + 1:]: z[k] for k in z.files
                        if k.startswith(key + "/")}
    return dict(params=pick("p"), new_params=pick("np"), grad=pick("g"),
                losses={str(k): float(v) for k, v in
                        zip(z["loss_names"], z["loss_values"])},
                stats=[(int(i), float(r)) for i, r in z["stats"]])


# --------------------------------------------------------------- port side
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank numbers: {1: [rank 0], 2: [rank 0, rank 1]},
    and the world of two's directory."""
    from nksr_tpu_torch import native
    native._load()          # build the host library once, not in each rank
    tmps = {n: tmp_path_factory.mktemp(f"dp_world{n}") for n in (1, 2)}
    spawn([(lambda r, n=n: [sys.executable, WORKER, str(r), str(n),
                            str(tmps[n] / "store"), str(tmps[n])], n, tmps[n])
           for n in (1, 2)], timeout=WORLD_TIMEOUT)
    out = {n: [dict(np.load(tmps[n] / f"rank{r}.npz")) for r in range(n)]
           for n in (1, 2)}
    out["dir"] = tmps[2]
    return out


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _step(rec, s, what):
    return {k[len(f"s{s}/{what}/"):]: v for k, v in rec.items()
            if k.startswith(f"s{s}/{what}/")}


def _losses(rec, s):
    return {str(k): float(v) for k, v in zip(rec[f"s{s}/loss_names"],
                                             rec[f"s{s}/loss_values"])}


def test_reference_solves_converged(ref):
    """Every JAX solve of the reference (the DP step's and each cloud's,
    forward and backward) converged before the iteration cap."""
    assert len(ref["stats"]) >= 4 * C.N_CLOUDS
    for i, rel in ref["stats"]:
        assert rel < C.PARITY_TOL and i < C.PARITY_ITERS, ref["stats"]


def test_ranks_start_replicated(worlds):
    for n in (1, 2):
        for rec in worlds[n]:
            assert bool(rec["replicated"])
    assert [int(r["local_clouds"][0]) for r in worlds[2]] == [1, 1]
    assert int(worlds[1][0]["local_clouds"][0]) == 2


def test_dp_losses_match_jax(worlds, ref):
    got = _losses(worlds[2][0], 0)
    assert set(got) == set(ref["losses"])
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_dp_gradient_matches_jax(worlds, ref):
    """The reduced gradient, whole and leaf by leaf, against the mean of
    JAX's per-cloud gradients.  A conv bias that feeds a group norm has
    a gradient of zero up to rounding (the norm takes out each channel's
    mean), and the two packages' residues differ: a leaf whose JAX norm
    is under ZERO_FLOOR of the whole gradient's is held within that
    floor instead (the largest such residue here is 3e-8 of it)."""
    got = _step(worlds[2][0], 0, "grad")
    assert set(got) == set(ref["grad"])
    whole = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in ref["grad"].values()))
    err = np.sqrt(sum(np.linalg.norm(got[k] - w) ** 2
                      for k, w in ref["grad"].items()))
    assert err / whole < GRAD_RTOL
    for k, want in ref["grad"].items():
        g = got[k]
        assert g.shape == want.shape, k
        d = np.linalg.norm(want)
        if d == 0:        # a leaf no loss reaches: zero in both
            assert np.abs(g).max() == 0, k
        elif d < ZERO_FLOOR * whole:
            assert np.linalg.norm(g - want) < ZERO_FLOOR * whole, k
        else:
            assert np.linalg.norm(g - want) / d < GRAD_RTOL, k


def test_dp_update_matches_jax(worlds, ref):
    """The first update (new params minus the JAX init) against JAX's:
    within UPDATE_ATOL where the mean gradient is above SMALL_G of its
    leaf's largest, within 2 lr (and rounding) elsewhere and on the
    leaves whose gradient is zero up to rounding
    (``test_dp_gradient_matches_jax``:
    AMSGrad's first step moves each entry by about lr whatever its
    gradient's size, so a rounding residue moves it either way)."""
    got = _step(worlds[2][0], 0, "param")
    whole = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in ref["grad"].values()))
    for k, p0 in ref["params"].items():
        du, dj = got[k] - p0, ref["new_params"][k] - p0
        g = np.abs(ref["grad"][k])
        big = g > SMALL_G * g.max()
        if np.linalg.norm(g) < ZERO_FLOOR * whole:
            big[...] = False
        np.testing.assert_array_less(np.abs(du - dj)[big], UPDATE_ATOL,
                                     err_msg=k)
        # 2 lr: an entry that moved the other way; plus the f32 rounding
        # of p0 + lr and p0 - lr
        bound = 2 * C.LR + 4 * np.finfo(np.float32).eps * np.abs(p0)
        assert (np.abs(du - dj) <= bound)[~big].all(), k


@pytest.mark.parametrize("what", ["grad", "param", "loss"])
def test_world_of_two_bit_equal_to_world_of_one(worlds, what):
    """Every step, a world of two (one cloud a rank) against a world of
    one with both clouds: the same draws, the same sums."""
    for s in range(C.STEPS):
        a, b = worlds[2][0], worlds[1][0]
        if what == "loss":
            assert _losses(a, s) == _losses(b, s), s
            continue
        x, y = _step(a, s, what), _step(b, s, what)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{s} {k}")


def test_ranks_bit_equal(worlds):
    """Params, gradients and losses the same on both ranks after every
    step."""
    a, b = worlds[2]
    for k in a:
        if k.startswith("s"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fit_data_parallel_writes_on_rank0_only(worlds):
    """``fit(batch_size=2)`` in the world of two: 3 steps, one
    validation, its logs, mesh artifact and checkpoints in rank 0's run
    directory only; both ranks end with one model."""
    a, b = worlds[2]
    assert int(a["fit_step"][0]) == int(b["fit_step"][0]) == 3
    for k in a:
        if k.startswith("fit/param/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    run0, run1 = worlds["dir"] / "fit_rank0", worlds["dir"] / "fit_rank1"
    for name in ("metrics.csv", "metrics.jsonl", "best.ckpt", "last.ckpt",
                 "artifacts/val_mesh_3.ply"):
        assert (run0 / name).exists(), name
    assert "val/sum" in (run0 / "metrics.csv").read_text()
    assert not run1.exists()


def test_fit_batch_not_a_multiple_of_the_world_raises(worlds):
    for rec in worlds[2]:
        assert "multiple of the world size" in str(rec["bad_batch_raised"])


# ------------------------------------------------ logger, renders, trace
CUBE_V = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                   for z in (0, 1)], np.float32)
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7],
                   [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                   [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)


def test_run_logger_tb_scalars_and_mesh_artifacts(tmp_path):
    """tests/test_train.py's logger test on the port: csv and jsonl
    rows, tensorboard events (``auto``, which imports here), the mesh's
    .ply and a render that draws something."""
    from nksr_tpu_torch.train.driver import RunLogger, render_mesh
    lg = RunLogger(tmp_path, backend="auto")
    lg.log(10, {"sum": 1.5, "lr": 1e-4}, "train/")
    lg.log_mesh(10, "val/mesh", CUBE_V, CUBE_F)
    lg.close()
    assert lg.backend == "tensorboard"
    assert (tmp_path / "metrics.csv").exists()
    assert '"train/sum": 1.5' in (tmp_path / "metrics.jsonl").read_text()
    assert any((tmp_path / "tb").iterdir())     # tensorboard events
    assert (tmp_path / "artifacts" / "val_mesh_10.ply").exists()
    assert (tmp_path / "artifacts" / "val_mesh_10.png").exists()
    img = render_mesh(CUBE_V, CUBE_F)
    assert img is not None and img.ndim == 3 and img.shape[-1] == 3
    assert img.dtype == np.uint8 and img.std() > 1.0
    assert render_mesh(CUBE_V, CUBE_F[:0]) is None


@pytest.mark.parametrize("backend,error", [
    ("csv", None), ("tensorboard", None), ("wandb", ImportError),
    ("neptune", ValueError)])
def test_run_logger_backends(tmp_path, backend, error):
    """The JAX package's four backends: csv adds nothing, tensorboard
    writes ``tb/``, wandb needs ``wandb`` (not installed here: it
    raises, as the JAX package's does); another name raises."""
    from nksr_tpu_torch.train.driver import RunLogger
    if error is not None:
        with pytest.raises(error):
            RunLogger(tmp_path, backend=backend)
        return
    lg = RunLogger(tmp_path, backend=backend)
    lg.log(1, {"sum": 2.0})
    lg.close()
    assert lg.backend == backend
    assert (tmp_path / "tb").exists() == (backend == "tensorboard")


def test_render_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib does not import (the card's machine), no render
    and no PNG; the .ply is still written."""
    from nksr_tpu_torch.train import driver
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert driver.render_mesh(CUBE_V, CUBE_F) is None
    lg = driver.RunLogger(tmp_path, backend="csv")
    lg.log_mesh(3, "val/mesh", CUBE_V, CUBE_F)
    lg.close()
    assert (tmp_path / "artifacts" / "val_mesh_3.ply").exists()
    assert not list((tmp_path / "artifacts").glob("*.png"))


@pytest.mark.parametrize("on", [True, False])
def test_trace_run(tmp_path, monkeypatch, on):
    """A Chrome trace of the body, with its ``phase`` ranges, under
    NKSR_PROFILE=1; nothing without it."""
    from nksr_tpu_torch.utils import profiling as PROF
    if on:
        monkeypatch.setenv("NKSR_PROFILE", "1")
    else:
        monkeypatch.delenv("NKSR_PROFILE", raising=False)
    with PROF.trace_run(str(tmp_path / "trace")) as d:
        with PROF.phase("dp: test range"):
            torch.ones(64).sum()
    assert (d is not None) == on
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() == on
    if on:
        assert "dp: test range" in trace.read_text()
    assert PROF.device_memory_snapshot() == {}      # no card here
    t = PROF.StepTimer(warmup=1)
    assert t.tick() is None and t.tick() > 0
