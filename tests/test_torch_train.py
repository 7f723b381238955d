"""The port's teacher-forced training step against the JAX package's
``train_step`` loss on the CPU (UDF head off; ``test_torch_train_udf.py``
runs it with the head on).

At ``tests/test_train.py``'s configuration (tree depth 3, f_maps 16,
capacities 2048/1024/512, the 800-point sphere of ``make_batch``), with
the solve raised from 40 to at most ``PARITY_ITERS`` iterations so that
both packages report it converged (relative residual under tol 1e-4,
forward and backward): ``jax.value_and_grad`` of the step's loss against
the port's ``loss_and_grads`` from the same parameters
(``params_to_torch``) on the same samples (the JAX package's draws,
reproduced from its keys: ``fold_in(rng, 1 | 2 | 3)``, ``get_samples``,
``_masked_choice``).  Tolerances (f32 on both sides, sums in other
orders, CG stopped at tol 1e-4): every loss term within 1e-3 relative,
every gradient leaf within 1e-2 relative L2 (measured on this CPU: 2e-4
and 5e-3), the structure logits within 1e-4 of their largest magnitude,
and the teacher-forced candidate hierarchy voxel for voxel.

The JAX side (``jax_parity``: about a minute of compile here) is kept in
``tests/data/fused_train_reference.npz`` beside the fused step's of
``tests/test_torch_fused_train.py``; rewrite it after a change to its
inputs with

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/fused_train_reference.py
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

from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.solver.pcg import solve_spd
from nksr_tpu_torch.train import loop as T
from nksr_tpu_torch.train import losses as L
from nksr_tpu_torch.utils.checkpoint import params_to_torch, torch_to_params

# the module, not the function that nksr_tpu.solver exports by that name
JPCG = importlib.import_module("nksr_tpu.solver.pcg")
# the JAX side of ``parity`` (``jax_parity``, about a minute of compile
# on the CPU) under keys UNFUSED, and of test_torch_fused_train.py's
# fused step under FUSED: written by scripts/fused_train_reference.py
REF = Path(__file__).resolve().parent / "data" / \
    "fused_train_reference.npz"
UNFUSED, FUSED = "unfused_", "fused_"
PARITY_ITERS = 600
LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-2


def port_configs(jcfg, jlcfg):
    """The JAX configurations as the port's dataclasses."""
    cfg = P.PipelineConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(P.PipelineConfig)})

    def samplers(ss):
        return tuple(L.SamplerConfig(**dataclasses.asdict(s)) for s in ss)
    lcfg = L.LossConfig(**{
        **{f.name: getattr(jlcfg, f.name)
           for f in dataclasses.fields(L.LossConfig)},
        "spatial_samplers": samplers(jlcfg.spatial_samplers),
        "udf_samplers": samplers(jlcfg.udf_samplers)})
    return cfg, lcfg


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def jax_parity(udf: bool, monkeypatch_module, fused: bool = False):
    """JAX's value-and-grad of one teacher-forced step (``fused``: with
    ``fused_mode``), with its draws and the (iterations, relative
    residual) of its forward and backward PCG solves."""
    jcfg = dataclasses.replace(JCFG, udf_enabled=udf, fused_mode=fused,
                               solver_max_iters=PARITY_ITERS)
    batch = make_batch()
    params = JP.init_params(jcfg, jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(1)
    gt_svh = JP.build_gt_svh(jcfg, batch["gt_xyz"], batch["gt_mask"],
                             batch["gt_normal"])
    feat = JP.point_features(jcfg, batch["xyz"], normal=batch["normal"])

    # the JAX solves' (iterations, relative residual), forward then
    # backward, from its own pcg
    jstats = []
    real_pcg = JPCG.pcg

    def recording_pcg(*a, **kw):
        x, i, rel = real_pcg(*a, **kw)
        jax.debug.callback(lambda i, r: jstats.append((int(i), float(r))),
                           i, rel)
        return x, i, rel
    monkeypatch_module.setattr(JPCG, "pcg", recording_pcg)

    def loss_fn(p):
        out = JP.forward(jcfg, p, batch["xyz"], batch["mask"], feat,
                         gt_svh=gt_svh, use_gt_structure=True)
        b = dict(batch)
        b["gt_svh"] = gt_svh
        losses, _ = JL.compute_losses(rng, jcfg, JLCFG, out, b)
        cand = [(g.coords, g.num_voxels) for g in out.udf_svh.grids]
        return sum(losses.values()), (losses, out.structure_features, cand)

    (_, (jl, jlogits, jcand)), jg = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    jax.effects_barrier()

    def draws(key, samplers):
        return JL.get_samples(key, jcfg, samplers, gt_svh, batch["gt_xyz"],
                              batch["gt_normal"], batch["gt_mask"])
    samples = {
        "spatial": draws(jax.random.fold_in(rng, 1), JLCFG.spatial_samplers),
        "surface": JL._masked_choice(jax.random.fold_in(rng, 2),
                                     batch["gt_mask"],
                                     JLCFG.gt_surface_subsample)}
    if udf:
        samples["udf"] = draws(jax.random.fold_in(rng, 3),
                               JLCFG.udf_samplers)
    samples = {k: torch.tensor(np.asarray(v)) for k, v in samples.items()}
    samples["surface"] = samples["surface"].long()
    return dict(
        params=dict(_flat(jax.tree_util.tree_map(np.asarray, params))),
        jax_losses={k: float(v) for k, v in jl.items()},
        jax_grads=dict(_flat(jax.tree_util.tree_map(np.asarray, jg))),
        jax_stats=jstats,
        jax_logits=[np.asarray(x) for x in jlogits],
        jax_cand=[np.asarray(c)[:int(n)] for c, n in jcand],
        samples=samples)


def port_parity(udf: bool, samples, fused: bool = False, params=None):
    """The port's loss and gradients of the same step from the same
    parameters (``params_to_torch`` of the seeded JAX init, or of
    ``params``, its flax tree) on ``samples``."""
    jcfg = dataclasses.replace(JCFG, udf_enabled=udf, fused_mode=fused,
                               solver_max_iters=PARITY_ITERS)
    if params is None:
        params = JP.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, lcfg = port_configs(jcfg, JLCFG)
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    batch = {k: np.asarray(v) for k, v in make_batch().items()}
    inp = P.prepare_inputs(cfg, batch, "cpu")
    losses, _, out = T.loss_and_grads(cfg, lcfg, net, inp, samples)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in net.named_parameters()}
    return dict(
        losses={k: float(v.detach()) for k, v in losses.items()},
        grads=dict(_flat({"params": torch_to_params(grads)})),
        stats=(out.field.cg_stats, solve_spd.last_backward_stats),
        logits=[x.detach().numpy() for x in out.structure_logits],
        cand=[lv.cand.coords for lv in inp.levels],
        tol=cfg.solver_tol)


def run_parity(udf: bool, monkeypatch_module):
    """JAX's value-and-grad and the port's loss and gradients of one
    teacher-forced step; returns a dict of both sides' numbers."""
    r = jax_parity(udf, monkeypatch_module)
    r.update(port_parity(udf, r["samples"]))
    return r


def save_reference(out: dict, prefix: str, r) -> None:
    """``jax_parity``'s numbers into the dict ``out`` of npz arrays, keys
    under ``prefix`` (lists by position, names in their order); the
    parameters, the same for every prefix, once."""
    out.update({"param_names": np.array(list(r["params"]))})
    out.update({f"param_{i}": v for i, v in enumerate(r["params"].values())})
    out.update({
        f"{prefix}loss_names": np.array(list(r["jax_losses"])),
        f"{prefix}loss_values": np.array(list(r["jax_losses"].values()),
                                         np.float64),
        f"{prefix}grad_names": np.array(list(r["jax_grads"])),
        f"{prefix}stats": np.array(r["jax_stats"], np.float64)})
    out.update({f"{prefix}grad_{i}": v
                for i, v in enumerate(r["jax_grads"].values())})
    out.update({f"{prefix}sample_{k}": v.numpy()
                for k, v in r["samples"].items()})
    for name in ("jax_logits", "jax_cand"):
        out.update({f"{prefix}{name}_{d}": v for d, v in enumerate(r[name])})


def load_reference(prefix: str, path=REF) -> dict:
    """Inverse of ``save_reference``."""
    with np.load(path) as z:
        depth = sum(k.startswith(f"{prefix}jax_cand_") for k in z.files)
        r = {name: [z[f"{prefix}{name}_{d}"] for d in range(depth)]
             for name in ("jax_logits", "jax_cand")}
        r["jax_losses"] = {str(k): float(v) for k, v in
                           zip(z[f"{prefix}loss_names"],
                               z[f"{prefix}loss_values"])}
        r["jax_grads"] = {str(k): z[f"{prefix}grad_{i}"]
                          for i, k in enumerate(z[f"{prefix}grad_names"])}
        r["jax_stats"] = [(int(i), float(rel))
                          for i, rel in z[f"{prefix}stats"]]
        samples = {k[len(f"{prefix}sample_"):]: torch.tensor(z[k])
                   for k in z.files if k.startswith(f"{prefix}sample_")}
        params = {}
        for i, name in enumerate(z["param_names"]):
            node = params
            *path, leaf = str(name).split("/")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = z[f"param_{i}"]
    r["params"] = params
    samples["surface"] = samples["surface"].long()
    r["samples"] = samples
    return r


@pytest.fixture(scope="module")
def parity():
    r = load_reference(UNFUSED)
    r.update(port_parity(False, r["samples"], params=r["params"]))
    return r


def check_solves_converged(r):
    """Both packages' forward and backward solves converged (relative
    residual under tol) before the iteration cap."""
    assert len(r["jax_stats"]) == 2, r["jax_stats"]
    (fi, fr), (bi, br) = r["stats"]
    for i, rel in r["jax_stats"] + [(fi, fr), (bi, br)]:
        assert rel < r["tol"] and i < PARITY_ITERS, (r["jax_stats"],
                                                     r["stats"])


def check_loss_terms(r):
    assert set(r["losses"]) - {"sum"} == set(r["jax_losses"])
    for k, ref in r["jax_losses"].items():
        np.testing.assert_allclose(r["losses"][k], ref, rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["losses"]["sum"],
                               sum(r["jax_losses"].values()),
                               rtol=LOSS_RTOL)


def check_grads(r):
    assert set(r["grads"]) == set(r["jax_grads"])
    for k, ref in r["jax_grads"].items():
        got = r["grads"][k]
        assert got.shape == ref.shape, k
        den = np.linalg.norm(ref)
        if den == 0:      # a leaf no loss reaches (e.g. the SDF decoder)
            assert np.abs(got).max() == 0, k
            continue
        rel = np.linalg.norm(got - ref) / den
        assert rel < GRAD_RTOL, (k, rel)


def check_unet(r):
    for got, ref, cand, jcand in zip(r["logits"], r["jax_logits"],
                                     r["cand"], r["jax_cand"]):
        np.testing.assert_array_equal(cand, jcand)
        ref = ref[:len(cand)]
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_solves_converged(parity):
    check_solves_converged(parity)


def test_loss_terms_match_jax(parity):
    check_loss_terms(parity)


def test_grads_match_jax(parity):
    check_grads(parity)


def test_unet_outputs_match_jax(parity):
    check_unet(parity)
