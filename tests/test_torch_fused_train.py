"""The port's fused-mode training (``PipelineConfig(fused_mode=True)``:
the support-row solve that rebuilds its supports in every matvec,
differentiated against the basis features and the interpolator MLPs) on
the CPU.

(a) At ``tests/test_torch_support.py``'s setup (tree depth 3, a 2,000
point terrain, random weights and features), approx gradients off and
on: the gradient of a scalar of the fused solve's coefficients against
the basis features, every interpolator parameter and the normal targets
equals the unfused solve's within 1e-5 relative L2 per tensor (measured
on this CPU: 4.9e-7; both solves stop after the same 8 iterations at
relative residual 1.6e-13), and each
parameter's ``.grad`` after ``backward`` equals ``autograd.grad`` of
the same scalar, so no part of it is counted twice.

(b) At ``tests/test_train.py``'s configuration, UDF off, the solve
raised to ``PARITY_ITERS``: the port's fused ``loss_and_grads`` against
the JAX package's ``value_and_grad`` with ``fused_mode=True`` (from
``tests/data/fused_train_reference.npz``, written by
``scripts/fused_train_reference.py``) under ``test_torch_train.py``'s
gates: both solves converged, every loss term within 1e-3 relative,
every gradient leaf within 1e-2 relative L2 (measured: 2e-4 and 4.9e-3),
the structure logits and candidates.

(c) The predicted step (``use_gt_structure=False``) from
runs/synth_r3c/best.ckpt, fused against unfused on the port: the same
hierarchies, loss terms within 1e-5 relative, the whole gradient within
1e-5 and each leaf within 1e-4 relative L2 (``test_torch_train_parts.
check_fused_grads``; measured: equal losses, 7.3e-7 and 1.6e-6), the
same CG iterations.

(d) ``fit`` on the CPU for 2 steps with ``fused_mode`` and the UDF head
(the YAML has no such key in either package, so the test sets it on the
configuration ``fit`` reads): the fused solve runs with a graph in both
steps, and the parameters and the logged losses stay finite.
(``tests/test_torch_train_parts.py`` holds a fused ``train_step``
against the unfused one.)
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_support import _idx, _system_inputs, setup  # noqa: F401
from test_torch_train import (FUSED, check_grads, check_loss_terms,
                              check_solves_converged, check_unet,
                              load_reference, port_parity)
from test_torch_train_parts import FIT_CFG, _sphere_batch, check_fused_grads
from test_torch_train_predicted import (JLCFG, jax_config, np_batch,
                                        port_configs, r3c_config,
                                        r3c_params)

from nksr_tpu_torch.fields.kernel_field import KernelField
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.solver.pcg import solve_spd
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.train import loop as T
from nksr_tpu_torch.utils.checkpoint import params_to_torch

torch.set_num_threads(1)

GRAD_RTOL = 1e-5
LEAF_RTOL = 1e-4


def _rel(got, ref) -> float:
    den = float(ref.norm())
    return float((got - ref).norm()) / den if den else float(got.norm())


def _field_grads(s, interp, approx: bool, fused: bool):
    """The coefficients' scalar ``sum_d r_d . alpha_d`` and its gradient
    against the features, the interpolators' parameters and the normal
    targets, by ``backward`` (``.grad``) and by ``autograd.grad``."""
    xyz, centers, nv, pos_w, nrm_w, sup_p, sup_c = _system_inputs(s)
    cfg, caps = s["cfg"], s["caps"]
    feats = [torch.from_numpy(f).requires_grad_(True) for f in s["feats"]]
    target = torch.from_numpy(-nv).requires_grad_(True)
    for m in interp:
        m.zero_grad(set_to_none=True)
    field = KernelField(s["field"].voxel_sizes, caps, feats, interp,
                        cfg.kernel_dim, approx)
    out = field.solve(
        torch.from_numpy(xyz), torch.from_numpy(pos_w),
        torch.from_numpy(centers), torch.from_numpy(nrm_w), target,
        reg_weight=1.0, solver_tol=1e-12, max_iters=12,
        pos_sup_idx=[_idx(t) for t in sup_p],
        normal_sup_idx=[_idx(t) for t in sup_c], fused=fused)
    rng = np.random.default_rng(5)
    loss = sum((a * torch.from_numpy(rng.normal(size=a.shape[0]).astype(
        np.float32))).sum() for a in out.alpha)
    leaves = feats + [p for m in interp for p in m.parameters()] + [target]
    by_grad = torch.autograd.grad(loss, leaves, retain_graph=True)
    loss.backward()
    return [t.grad for t in leaves], by_grad, out.cg_stats


@pytest.mark.parametrize("approx", [False, True])
def test_fused_solve_gradients_equal_unfused(setup, approx):  # noqa: F811
    interp = copy.deepcopy(setup["field"].mlps)
    for m in interp:
        m.requires_grad_(True)
    got, got_ag, fstats = _field_grads(setup, interp, approx, fused=True)
    ref, _, ustats = _field_grads(setup, interp, approx, fused=False)
    assert fstats[0] == ustats[0]
    for g, a in zip(got, got_ag):      # .grad is autograd's, once
        assert torch.equal(g, a)
    for g, r in zip(got, ref):
        assert float(r.norm()) > 0
        assert _rel(g, r) < GRAD_RTOL


@pytest.fixture(scope="module")
def fused_parity():
    r = load_reference(FUSED)
    r.update(port_parity(False, r["samples"], fused=True,
                         params=r["params"]))
    return r


def test_fused_step_matches_jax(fused_parity):
    check_solves_converged(fused_parity)
    check_loss_terms(fused_parity)
    check_grads(fused_parity)
    check_unet(fused_parity)


def _predicted_step(cfg, lcfg, params):
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    inp = P.prepare_inputs(cfg, np_batch(), "cpu", use_gt_structure=False)
    losses, _, out = T.loss_and_grads(cfg, lcfg, net, inp, None,
                                      use_gt_structure=False,
                                      gen=torch.Generator().manual_seed(0))
    return (losses, {n: p.grad for n, p in net.named_parameters()
                     if p.grad is not None},
            [g.coords for g in out.dec_grids],
            (out.field.cg_stats[0], solve_spd.last_backward_stats[0]))


def test_fused_predicted_step_matches_unfused():
    cfg = dataclasses.replace(r3c_config(), solver_tol=1e-12,
                              solver_max_iters=8)
    _, lcfg = port_configs(jax_config(cfg), JLCFG)
    params = r3c_params()
    ul, ug, udec, uit = _predicted_step(cfg, lcfg, params)
    fl, fg, fdec, fit = _predicted_step(
        dataclasses.replace(cfg, fused_mode=True), lcfg, params)
    assert uit == fit == (8, 8)
    for a, b in zip(udec, fdec):
        np.testing.assert_array_equal(a, b)
    assert set(fl) == set(ul)
    for k in ul:
        np.testing.assert_allclose(fl[k].item(), ul[k].item(), rtol=1e-5,
                                   err_msg=k)
    check_fused_grads(ug, fg, GRAD_RTOL, LEAF_RTOL)


def test_fit_with_fused_mode(tmp_path, monkeypatch):
    calls = []
    real = KernelField.solve_fused

    def spy(self, *a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(self, *a, **kw)
    monkeypatch.setattr(KernelField, "solve_fused", spy)
    read = driver.pipeline_config_from_yaml
    monkeypatch.setattr(driver, "pipeline_config_from_yaml", lambda c:
                        dataclasses.replace(read(c), fused_mode=True))
    # the CSV logger: importing tensorboard takes seconds here
    state = driver.fit(dict(FIT_CFG, logger="csv"),
                       [_sphere_batch(seed=i) for i in range(2)], None,
                       tmp_path, max_steps=2, seed=0, device="cpu")
    assert state.step == 2 and calls == [True, True]
    assert (tmp_path / "last.ckpt").exists()
    assert all(torch.isfinite(p).all() for p in state.net.parameters())
    row = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(row["train/udf"]) and np.isfinite(row["train/sum"])
