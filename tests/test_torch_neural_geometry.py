"""The port's ``geometry="neural"`` head (``fields/neural_field.
NeuralField`` under the network's SDF decoder) against the JAX package's
on the CPU: the training forward, one step's losses and gradients, and
the in-graph route with its mesh.

The JAX side is ``scripts/neural_geometry_reference.py``'s, kept in
``tests/data/neural_geometry_reference.npz`` (its jitted step takes
about 40 s to compile, too long for this tier).  The weights and inputs
are seeded numpy, so this file rebuilds them:

  * at ``tests/test_train.py``'s configuration (tree depth 3, f_maps 16,
    capacities 2048/1024/512, its 800-point sphere), UDF head off and
    on, random weights (every leaf, the SDF decoder's too, drawn by
    ``test_torch_dense_unet.random_params`` and carried by
    ``params_to_torch``): the teacher-forced field's values and
    x-gradients at 2,000 probes within 1e-5 of their largest magnitude,
    the mask (union of supports, or the UDF's) equal; one step on the
    JAX package's draws: every loss term within ``LOSS_RTOL`` relative
    (the normal loss among them, the second-order path: its gradient
    runs through the x-gradient) and every gradient leaf within
    ``GRAD_RTOL`` relative L2;
  * ``Reconstructor(structure="predicted_ingraph")`` from
    runs/synth_r3c/best.ckpt (a kernel model: its SDF decoder is its
    init's, its last bias offset so that the zero set runs through the
    shell) on a 1,200-point sphere: the capacities and hierarchy voxel
    for voxel, the fields at probes as above, and the mesh of
    ``dual_mc.py`` (no Newton step: no coefficients) against the JAX
    ``NeuralField.extract_dual_mesh``: faces equal, vertices within
    1e-4 voxel.

``train_step``, ``val_step`` and ``fit`` run the head on the CPU; the
host routes refuse it (``tests/test_torch_slice.py``).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.fields.neural_field import NeuralField
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.train import loop as T
from nksr_tpu_torch.utils.checkpoint import (load_tree, model_params,
                                             params_to_torch,
                                             torch_to_params)
from nksr_tpu_torch.utils.config import load_config

from test_field import sphere_points
from test_torch_dense_unet import random_params
from test_torch_train import _flat, port_configs
from test_train import CFG as JCFG, LCFG as JLCFG, make_batch

torch.set_num_threads(1)

JNCFG = dataclasses.replace(JCFG, geometry="neural")
FIELD_TOL = 1e-5          # of the largest |f| and |grad f| at the probes
# measured on the CPU: 1.2e-7 and 5.4e-6 (the kernel head's, after a CG
# solve: 1.9e-4 and 4.9e-3, tests/test_torch_train.py)
LOSS_RTOL = 1e-6
GRAD_RTOL = 5e-5
RUN = Path(__file__).resolve().parents[1] / "runs" / "synth_r3c"
# the JAX package's forward and step (scripts/neural_geometry_reference.py)
REF = Path(__file__).resolve().parent / "data" / \
    "neural_geometry_reference.npz"
REF_SEED = 6


def _probes(n=2000, seed=4):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 3)).astype(
        np.float32)


def _close(got, ref, tol=FIELD_TOL):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _check_fields(field, probes, value, gradient, fbar):
    """Values, x-gradients and the masked field at the probes against
    the JAX package's (the port's under ``no_grad``: its gradient takes
    a local ``enable_grad``)."""
    with torch.no_grad():
        ev = field.evaluate_at(probes, grad=True)
        fb = field.evaluate_f_bar(probes).numpy()
    assert not ev.gradient.requires_grad
    _close(ev.value.numpy(), value)
    _close(ev.gradient.numpy(), gradient)
    out = fb == -np.float32(JNCFG.voxel_size)
    np.testing.assert_array_equal(out, fbar == -np.float32(JNCFG.voxel_size))
    assert 0 < out.sum() < len(out)
    _close(fb, fbar)


# ------------------------------------------- the forward and one step
@pytest.fixture(scope="module", params=[False, True], ids=["udf0", "udf1"])
def step(request):
    """The port's teacher-forced forward and step from the reference's
    weights on its draws, beside the JAX package's numbers."""
    udf = request.param
    ref = np.load(REF)
    tag = f"udf{int(udf)}/"
    ref = {k[len(tag):]: ref[k] for k in ref.files if k.startswith(tag)}
    cfg, lcfg = port_configs(dataclasses.replace(JNCFG, udf_enabled=udf),
                             JLCFG)
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(random_params(cfg, REF_SEED)),
                        strict=True)
    inp = P.prepare_inputs(cfg, {k: np.asarray(v)
                                 for k, v in make_batch().items()}, "cpu")
    samples = {k: torch.from_numpy(ref[k]) for k in ("spatial", "udf")
               if k in ref}
    samples["surface"] = torch.from_numpy(ref["surface"]).long()
    losses, _, out = T.loss_and_grads(cfg, lcfg, net, inp, samples)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in net.named_parameters()}
    return dict(udf=udf, ref=ref, net=net, inp=inp, out=out,
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads=dict(_flat({"params": torch_to_params(grads)})))


def test_forward_field_matches_jax(step):
    """The teacher-forced field (random weights: the SDF decoder's
    leaves carried by ``params_to_torch``) at the probes."""
    field, ref = step["out"].field, step["ref"]
    assert isinstance(field, NeuralField) and field.alpha is None
    assert field.decoder is step["net"].sdf_decoder
    assert step["inp"].pt_sup is None
    assert (field.mask_field is not None) == step["udf"]
    _check_fields(field, _probes(), ref["value"], ref["gradient"],
                  ref["fbar"])


def test_step_losses_match_jax(step):
    ref = {k[len("loss/"):]: float(v) for k, v in step["ref"].items()
           if k.startswith("loss/")}
    losses = step["losses"]
    assert set(losses) - {"sum"} == set(ref)
    assert "gt-surface-normal" in ref and ("udf" in ref) == step["udf"]
    for k, v in ref.items():
        np.testing.assert_allclose(losses[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_step_grads_match_jax(step):
    """Every leaf; the SDF decoder's and the UNet's are reached (the
    normal loss's second-order path among them), the interpolators'
    are zero in both packages."""
    ref = {k[len("grad/"):]: v for k, v in step["ref"].items()
           if k.startswith("grad/")}
    assert set(step["grads"]) == set(ref)
    reached = set()
    for k, v in ref.items():
        got = step["grads"][k]
        assert got.shape == v.shape, k
        den = np.linalg.norm(v)
        if den == 0:
            assert np.abs(got).max() == 0, k
            continue
        reached.add(k.split("/")[1])
        rel = np.linalg.norm(got - v) / den
        assert rel < GRAD_RTOL, (k, rel)
    assert {"sdf_decoder", "unet"} <= reached
    assert "interpolators" not in reached
    assert ("udf_decoder" in reached) == step["udf"]


def test_train_val_steps_and_fit_run_the_neural_head(tmp_path):
    """A teacher-forced and a predicted ``train_step`` change the
    parameters, ``val_step`` reports finite losses with the normal loss,
    and ``fit`` runs a config with ``geometry: neural`` past the
    structure schedule's start."""
    from test_torch_train_parts import FIT_CFG, _sphere_batch
    cfg, lcfg = port_configs(JNCFG, JLCFG)
    state = T.init_state(cfg, T.TrainConfig(), device="cpu")
    batch = {k: np.asarray(v) for k, v in make_batch().items()}
    for use_gt in (True, False):
        before = [p.detach().clone() for p in state.net.parameters()]
        state, losses, _ = T.train_step(
            cfg, T.TrainConfig(), lcfg, state, batch,
            torch.Generator().manual_seed(0), use_gt_structure=use_gt)
        assert all(np.isfinite(v) for v in losses.values())
        assert any(not torch.equal(a, b)
                   for a, b in zip(before, state.net.parameters()))
    lv, _ = T.val_step(cfg, lcfg, state.net, batch,
                       torch.Generator().manual_seed(0))
    assert "gt-surface-normal" in lv and all(np.isfinite(v)
                                             for v in lv.values())
    fcfg = dict(FIT_CFG, geometry="neural",
                structure_schedule={"start_step": 0, "end_step": 1})
    state = driver.fit(fcfg, [_sphere_batch(seed=i) for i in range(2)],
                       [_sphere_batch(seed=9)], tmp_path, max_steps=2,
                       val_every=2, seed=0, device="cpu")
    assert state.step == 2 and (tmp_path / "best.ckpt").exists()


# ------------------------------------------------------ the in-graph route
@pytest.fixture(scope="module")
def ingraph():
    """The port's in-graph route with the reference's SDF bias, beside
    the JAX package's numbers."""
    ref = np.load(REF)
    ref = {k[len("ingraph/"):]: ref[k] for k in ref.files
           if k.startswith("ingraph/")}
    cfg = driver.pipeline_config_from_yaml(
        dict(load_config(RUN / "config.yaml"), geometry="neural"))
    params = {"params": model_params(load_tree(RUN / "best.ckpt"))}
    params["params"]["sdf_decoder"]["Dense_2"]["bias"] = ref["bias"]
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    field = Reconstructor(device="cpu", config=cfg, params=params
                          ).reconstruct(xyz, nrm, detail_level=None,
                                        voxel_size=0.1,
                                        structure="predicted_ingraph")
    return dict(ref=ref, field=field,
                mesh=field.extract_dual_mesh(mise_iter=1))


def test_ingraph_neural_field_matches_jax(ingraph):
    ref, field = ingraph["ref"], ingraph["field"]
    assert isinstance(field, NeuralField) and field.mask_field is None
    assert "infer: field" in field.phase_times
    assert field.capacities == tuple(ref["capacities"])
    for d, g in enumerate(field.host_grids):
        np.testing.assert_array_equal(g.coords, ref[f"coords{d}"])
    _check_fields(field, _probes(seed=5), ref["value"], ref["gradient"],
                  ref["fbar"])


def test_ingraph_neural_mesh_matches_jax(ingraph):
    """``dual_mc.py`` on the neural field (no Newton step) against the
    JAX ``NeuralField.extract_dual_mesh``."""
    got, ref = ingraph["mesh"], ingraph["ref"]
    assert len(ref["mesh_f"]) > 500 and got.c is None
    assert got.v.shape == ref["mesh_v"].shape
    np.testing.assert_array_equal(got.f, ref["mesh_f"])
    np.testing.assert_allclose(got.v, ref["mesh_v"], rtol=0,
                               atol=1e-4 * 0.1)
