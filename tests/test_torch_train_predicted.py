"""The port's predicted-structure training step (``use_gt_structure=
False``) against the JAX package's on the CPU, and its entry points.

(a) ``jax.value_and_grad`` of the JAX step's loss with the decoder on
its own prediction against the port's ``loss_and_grads(use_gt_structure=
False)``, from a trained checkpoint (runs/synth_r3c/best.ckpt under its
config.yaml, f_maps 16, tree depth 3) at voxel 0.1 and capacities
2048/1024/512, on ``tests/test_train.py``'s 800-point sphere, with the
JAX package's draws (taken from its *decoder* hierarchy, as its losses
take them).  Gates: the candidate and decoder hierarchies voxel for
voxel (1,360 / 408 / 81 candidates and 817 / 251 / 81 kept), with every
candidate's top-2 logit margin above ``MARGIN_FRAC`` of the largest
|logit| (so no argmax is a near-tie); the structure logits within 1e-4
of their largest magnitude; every loss term within 1e-3 relative; the
whole gradient within 1e-2 relative L2 and each leaf within
``LEAF_RTOL``.

This checkpoint's solve is far worse conditioned than the seeded init's
of ``tests/test_torch_train.py``.  At tol 1e-4 neither package's solve
converges in 600 iterations (the port's forward stops at relative
residual 6.9e-4); converged to 1e-4 (some 970 and 1,300 iterations), the
two stop at different points along slow modes and the normal loss term
differs by 1.5e-3, one leaf by 4.9e-2.  So the solve runs to tol
``PRED_TOL`` (some 1,900 and 2,200 iterations, under ``PRED_ITERS``),
where the loss terms agree within 4e-5 and the whole gradient within
1.5e-3 (measured on this CPU).  One leaf stays near 1e-2 at any tol
(interp_2's last kernel: 1.02e-2 at tol 1e-5, 1.00e-2 at 1e-6), and
that is f32's floor here: the port against itself with every weight
moved by one ulp differs by 1.4e-2 on that leaf, and the teacher-forced
step on the same checkpoint differs from JAX's by 1.4e-2 on interp_0's.
``LEAF_RTOL`` is twice that; a leaf whose gradient is lost or wrong
reads about 1.  (a)'s JAX side (``jax_reference``) takes about two
minutes to compile here, so its numbers are kept in
``tests/data/train_predicted_reference.npz``; rewrite it after a change
to its inputs with

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/train_predicted_reference.py

(b) The seeded JAX init predicts an empty hierarchy (its stride-2 convs
start at zero, so the coarsest decoder features and logits are exactly
0 and the argmax takes class 0): the port's losses on the JAX draws
match JAX's within 1e-3, with no NaN, and the port draws an empty
hierarchy's samples as the JAX package does.

(c) The predicted forward's decoder grids equal the per-level inference
engine's (``recon/host_predicted.py``) on the same weights and input,
where no capacity cuts.

(d) ``train_step`` and ``val_step`` with ``use_gt_structure=False``, and
``fit`` past the schedule's start, on the CPU.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nksr_tpu.models import pipeline as JP
from nksr_tpu.train import losses as JL

from test_train import CFG as JCFG, LCFG as JLCFG, make_batch
from test_torch_train import _flat, check_loss_terms, port_configs

from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.recon.host_predicted import reconstruct_predicted_host
from nksr_tpu_torch.solver.pcg import solve_spd
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.train import loop as T
from nksr_tpu_torch.train import losses as L
from nksr_tpu_torch.utils.checkpoint import (load_tree, model_params,
                                             params_to_torch,
                                             torch_to_params)
from nksr_tpu_torch.utils.config import load_config
from nksr_tpu_torch.utils.profiling import PhaseTimer

JPCG = importlib.import_module("nksr_tpu.solver.pcg")
REPO = Path(__file__).resolve().parents[1]
RUN = REPO / "runs" / "synth_r3c"
# the JAX side of ``parity`` (``jax_reference``; its compile takes about
# two minutes on the CPU), written by scripts/train_predicted_reference.py
REF = Path(__file__).resolve().parent / "data" / \
    "train_predicted_reference.npz"
PRED_TOL = 1e-5
PRED_ITERS = 4000
MARGIN_FRAC = 1e-4
LEAF_RTOL = 3e-2
WHOLE_RTOL = 1e-2
EXPECTED_CAND = [1360, 408, 81]
EXPECTED_DEC = [817, 251, 81]


def r3c_config():
    """runs/synth_r3c's configuration at the parity test's size."""
    cfg = driver.pipeline_config_from_yaml(load_config(RUN / "config.yaml"))
    return dataclasses.replace(cfg, voxel_size=0.1,
                               capacities=(2048, 1024, 512),
                               solver_tol=PRED_TOL,
                               solver_max_iters=PRED_ITERS)


def jax_config(cfg):
    return JP.PipelineConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(JP.PipelineConfig)})


def np_batch():
    return {k: np.asarray(v) for k, v in make_batch().items()}


def jax_predicted_step(jcfg, params, grad: bool):
    """The JAX package's predicted-structure step loss (and its gradient
    when ``grad``) with its draws taken from its decoder hierarchy, as
    its ``compute_losses`` takes them."""
    batch = make_batch()
    rng = jax.random.PRNGKey(1)
    gt_svh = JP.build_gt_svh(jcfg, batch["gt_xyz"], batch["gt_mask"],
                             batch["gt_normal"])
    feat = JP.point_features(jcfg, batch["xyz"], normal=batch["normal"])

    def loss_fn(p):
        out = JP.forward(jcfg, p, batch["xyz"], batch["mask"], feat,
                         gt_svh=gt_svh, use_gt_structure=False)
        b = dict(batch)
        b["gt_svh"] = gt_svh
        losses, _ = JL.compute_losses(rng, jcfg, JLCFG, out, b)
        return sum(losses.values()), (losses, out.structure_features,
                                      out.udf_svh, out.dec_svh)
    if grad:
        (_, aux), jg = jax.jit(jax.value_and_grad(loss_fn,
                                                  has_aux=True))(params)
    else:
        _, aux = jax.jit(loss_fn)(params)
        jg = None
    jax.effects_barrier()
    jl, jlogits, cand_svh, dec_svh = aux

    def draws(key, samplers):
        return JL.get_samples(key, jcfg, samplers, dec_svh, batch["gt_xyz"],
                              batch["gt_normal"], batch["gt_mask"])
    samples = {
        "spatial": draws(jax.random.fold_in(rng, 1), JLCFG.spatial_samplers),
        "surface": JL._masked_choice(jax.random.fold_in(rng, 2),
                                     batch["gt_mask"],
                                     JLCFG.gt_surface_subsample)}
    samples = {k: torch.tensor(np.asarray(v)) for k, v in samples.items()}
    samples["surface"] = samples["surface"].long()

    def grids(svh):
        return [np.asarray(g.coords)[:int(g.num_voxels)] for g in svh.grids]
    cand = grids(cand_svh)
    return dict(
        jax_losses={k: float(v) for k, v in jl.items()},
        jax_grads=None if jg is None else dict(
            _flat(jax.tree_util.tree_map(np.asarray, jg))),
        jax_logits=[np.asarray(x)[:len(c)] for x, c in zip(jlogits, cand)],
        jax_cand=cand, jax_dec=grids(dec_svh), samples=samples)


def port_predicted_step(cfg, lcfg, params, samples):
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    inp = P.prepare_inputs(cfg, np_batch(), "cpu", use_gt_structure=False)
    losses, _, out = T.loss_and_grads(cfg, lcfg, net, inp, samples,
                                      use_gt_structure=False)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in net.named_parameters()}
    return dict(
        net=net, inp=inp, out=out,
        losses={k: float(v.detach()) for k, v in losses.items()},
        grads=dict(_flat({"params": torch_to_params(grads)})),
        logits=[x.detach().numpy() for x in out.structure_logits],
        cand=[g.coords for g in out.cand_grids],
        dec=[g.coords for g in out.dec_grids],
        stats=(out.field.cg_stats, solve_spd.last_backward_stats))


def min_margin(logits: np.ndarray) -> float:
    """The smallest gap between a row's two largest logits."""
    if len(logits) == 0:
        return np.inf
    s = np.sort(logits, -1)
    return float((s[:, -1] - s[:, -2]).min())


def r3c_params():
    return {"params": model_params(load_tree(RUN / "best.ckpt"))}


def jax_reference():
    """The JAX side of ``parity``: the predicted step's value and
    gradient from the trained checkpoint, its draws, and the (iterations,
    relative residual) of each of its PCG solves."""
    jstats = []
    real_pcg = JPCG.pcg

    def recording_pcg(*a, **kw):
        x, i, rel = real_pcg(*a, **kw)
        jax.debug.callback(lambda i, r: jstats.append((int(i), float(r))),
                           i, rel)
        return x, i, rel
    mp = pytest.MonkeyPatch()
    mp.setattr(JPCG, "pcg", recording_pcg)
    try:
        r = jax_predicted_step(
            jax_config(r3c_config()),
            jax.tree_util.tree_map(jax.numpy.asarray, r3c_params()), True)
    finally:
        mp.undo()
    r["jax_stats"] = jstats
    return r


def save_reference(path, r) -> None:
    """``jax_reference()``'s numbers as an npz (lists by position, names
    in their order)."""
    out = {"loss_names": np.array(list(r["jax_losses"])),
           "loss_values": np.array(list(r["jax_losses"].values()),
                                   np.float64),
           "grad_names": np.array(list(r["jax_grads"])),
           "stats": np.array(r["jax_stats"], np.float64),
           "spatial": r["samples"]["spatial"].numpy(),
           "surface": r["samples"]["surface"].numpy()}
    out.update({f"grad_{i}": v for i, v in enumerate(r["jax_grads"].values())})
    for name in ("jax_logits", "jax_cand", "jax_dec"):
        out.update({f"{name}_{d}": v for d, v in enumerate(r[name])})
    np.savez_compressed(path, **out)


def load_reference(path=REF):
    """Inverse of ``save_reference``."""
    with np.load(path) as z:
        depth = sum(k.startswith("jax_cand_") for k in z.files)
        r = {name: [z[f"{name}_{d}"] for d in range(depth)]
             for name in ("jax_logits", "jax_cand", "jax_dec")}
        r["jax_losses"] = {str(k): float(v) for k, v in
                           zip(z["loss_names"], z["loss_values"])}
        r["jax_grads"] = {str(k): z[f"grad_{i}"]
                          for i, k in enumerate(z["grad_names"])}
        r["jax_stats"] = [(int(i), float(rel)) for i, rel in z["stats"]]
        r["samples"] = {"spatial": torch.tensor(z["spatial"]),
                        "surface": torch.tensor(z["surface"]).long()}
    return r


@pytest.fixture(scope="module")
def parity():
    cfg = r3c_config()
    params = r3c_params()
    r = load_reference()
    _, lcfg = port_configs(jax_config(cfg), JLCFG)
    r.update(port_predicted_step(cfg, lcfg, params, r["samples"]))
    r.update(tol=cfg.solver_tol, cfg=cfg, params=params)
    return r


def test_predicted_hierarchy_matches_jax(parity):
    """Candidates and decoder voxels level by level, no argmax near a
    tie."""
    assert [len(c) for c in parity["jax_cand"]] == EXPECTED_CAND
    assert [len(c) for c in parity["jax_dec"]] == EXPECTED_DEC
    for d in range(3):
        np.testing.assert_array_equal(parity["cand"][d],
                                      parity["jax_cand"][d])
        np.testing.assert_array_equal(parity["dec"][d], parity["jax_dec"][d])
        for lg in (parity["jax_logits"][d], parity["logits"][d]):
            assert min_margin(lg) > MARGIN_FRAC * np.abs(lg).max(), d


def test_predicted_logits_match_jax(parity):
    for got, ref in zip(parity["logits"], parity["jax_logits"]):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_predicted_solves_converged(parity):
    """Both packages' forward and backward solves reached tol before the
    cap."""
    assert len(parity["jax_stats"]) == 2, parity["jax_stats"]
    for i, rel in parity["jax_stats"] + list(parity["stats"]):
        assert rel < parity["tol"] and i < PRED_ITERS, (parity["jax_stats"],
                                                        parity["stats"])


def test_predicted_loss_terms_match_jax(parity):
    check_loss_terms(parity)


def test_predicted_grads_match_jax(parity):
    ref, got = parity["jax_grads"], parity["grads"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        den = np.linalg.norm(r)
        if den == 0:      # a leaf no loss reaches (e.g. the SDF decoder)
            assert np.abs(got[k]).max() == 0, k
            continue
        rel = np.linalg.norm(got[k] - r) / den
        assert rel < LEAF_RTOL, (k, rel)
    whole = np.sqrt(sum(((got[k] - r) ** 2).sum() for k, r in ref.items())
                    / sum((r ** 2).sum() for r in ref.values()))
    assert whole < WHOLE_RTOL, whole


def test_predicted_grids_equal_the_per_level_engine(parity):
    """The training forward's decoder grids against the per-level
    inference engine's on the same weights and points (no level cut:
    every encoder and candidate level under its capacity)."""
    cfg, inp = parity["cfg"], parity["inp"]
    caps = cfg.capacities
    assert all(n < c for n, c in zip(inp.n_vox, caps))
    assert all(len(c) < cap for c, cap in zip(parity["cand"], caps))
    net = parity["net"]
    xyz = inp.host_xyz
    times = {}
    with torch.no_grad():
        hf = reconstruct_predicted_host(
            dataclasses.replace(cfg, solver_max_iters=4), net, xyz, inp.xyz,
            inp.feat, HB.build_splat_grids_ex(xyz, cfg.voxel_size,
                                              cfg.tree_depth),
            PhaseTimer(torch.device("cpu"), times), times)
    for d, g in enumerate(parity["out"].dec_grids):
        np.testing.assert_array_equal(hf.host_grids[d].keys, g.keys)


def test_empty_prediction_matches_jax():
    """The seeded init: every level empty in both packages; the port's
    losses on the JAX draws within 1e-3 of JAX's, finite; the port's own
    draws of an empty hierarchy in the JAX draws' cube, the generator
    consumed as by a non-empty draw."""
    params = JP.init_params(JCFG, jax.random.PRNGKey(0))
    r = jax_predicted_step(JCFG, params, False)
    assert [len(c) for c in r["jax_dec"]] == [0, 0, 0]
    cfg, lcfg = port_configs(JCFG, JLCFG)
    r.update(port_predicted_step(cfg, lcfg, params, r["samples"]))
    assert [len(c) for c in r["dec"]] == [0, 0, 0]
    assert [len(c) for c in r["cand"]] == [len(c) for c in r["jax_cand"]]
    assert all(np.isfinite(v) for v in r["losses"].values())
    check_loss_terms(r)

    gen, twin = torch.Generator().manual_seed(5), \
        torch.Generator().manual_seed(5)
    n = lcfg.spatial_samplers[0].n_samples
    s = L.svh_uniform_samples(gen, cfg, r["out"].dec_grids, n, 1, 3)
    L.svh_uniform_samples(twin, cfg, r["inp"].gt_grids, n, 1, 3)
    assert torch.equal(gen.get_state(), twin.get_state())
    # expand 1 at depth 0: every uniform sample lies in the cube of
    # voxel (0, 0, 0), in both packages
    half = np.float32(cfg.voxel_size) / 2
    assert torch.all(s.abs() <= half)
    assert torch.all(r["samples"]["spatial"][:n].abs() <= half)


# ------------------------------------------------------- the entry points
def test_train_and_val_steps_on_the_predicted_structure(parity):
    """From the trained checkpoint at 16 iterations: a predicted train
    step changes the parameters, a predicted val step reports finite
    losses with the structure accuracies."""
    cfg = dataclasses.replace(parity["cfg"], solver_max_iters=16)
    _, lcfg = port_configs(jax_config(cfg), JLCFG)
    state = T.init_state(cfg, T.TrainConfig(), params=parity["params"],
                         device="cpu")
    before = [p.detach().clone() for p in state.net.parameters()]
    state, losses, _ = T.train_step(cfg, T.TrainConfig(), lcfg, state,
                                    np_batch(), torch.Generator()
                                    .manual_seed(0), use_gt_structure=False)
    assert state.step == 1 and all(np.isfinite(v) for v in losses.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, state.net.parameters()))
    lv, mv = T.val_step(cfg, lcfg, state.net, np_batch(),
                        torch.Generator().manual_seed(0),
                        use_gt_structure=False)
    assert all(np.isfinite(v) for v in lv.values())
    assert {"struct-acc-0", "struct-acc-1", "struct-acc-2"} <= set(mv)


def test_fit_runs_predicted_steps_past_the_schedule_start(tmp_path,
                                                          monkeypatch):
    """A schedule from step 0 to 1: step 0's probability of the predicted
    structure is 0, every later step's 1, so of 3 steps the last 2 run
    predicted (from the seeded init, on an empty hierarchy), and so does
    a step resumed from the run's last.ckpt."""
    from test_torch_train_parts import FIT_CFG, _sphere_batch
    cfg = dict(FIT_CFG, structure_schedule={"start_step": 0,
                                            "end_step": 1})
    modes = []
    real = T.train_step

    def recording(*a, use_gt_structure=True, **kw):
        modes.append(use_gt_structure)
        return real(*a, use_gt_structure=use_gt_structure, **kw)
    monkeypatch.setattr(T, "train_step", recording)
    state = driver.fit(cfg, [_sphere_batch(seed=i) for i in range(3)],
                       [_sphere_batch(seed=9)], tmp_path, max_steps=3,
                       val_every=3, seed=0, device="cpu")
    assert state.step == 3 and modes == [True, False, False]
    rows = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert rows and all("NaN" not in r for r in rows)
    # a resume from last.ckpt past the start draws the predicted structure
    state = driver.fit(cfg, [_sphere_batch(seed=3)], None, tmp_path,
                       max_steps=4, seed=0, resume=True, device="cpu")
    assert state.step == 4 and modes == [True, False, False, False]
