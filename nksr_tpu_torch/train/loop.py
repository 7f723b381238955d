"""Training loop: optimizer, schedules, the train and val steps,
teacher-forced or on the predicted structure (counterpart of
nksr_tpu/train/loop.py).

The optimizer is the JAX package's optax chain (``make_optimizer``),
written out as plain functions on tensors, because PyTorch's
``Adam(amsgrad=True)`` is another update:

  1. ``optax.clip(grad_clip)``: each gradient *value* clipped to
     [-grad_clip, grad_clip] (not the norm);
  2. ``scale_by_amsgrad()``: mu, nu moments (b1 0.9, b2 0.999), both
     bias-corrected, and the running maximum of the *bias-corrected*
     nu_hat (PyTorch maxes the raw nu and divides by the current
     correction); update mu_hat / (sqrt(nu_max) + 1e-8);
  3. ``add_decayed_weights(weight_decay)``, after the scaling;
  4. ``scale_by_learning_rate(lr_schedule)``: minus the staircase rate
     ``lr_init * decay_mult ** (count // decay_step)`` floored at
     ``lr_clip``, with its own count;
  5. ``apply_if_finite(max_consecutive_errors=100)``: a step whose
     gradients hold NaN or inf changes neither the parameters nor the
     inner state (it counts the miss), unless more than 100 in a row.

A parameter the losses do not reach (the SDF decoder of a kernel-geometry
model, the interpolators of a neural one) gets a zero gradient, as in
JAX.  ``accumulate_grad_batches`` reaches ``TrainConfig``
but, as in the JAX package, nothing reads it.

The state mirrors optax's tree (``opt_state``: ``notfinite_count``,
``last_finite``, ``total_notfinite``, ``inner_state`` {"1": amsgrad
count, mu, nu, nu_max; "3": schedule count}), with each moment held per
parameter in torch layout; ``utils/checkpoint.save_train_state`` writes
it in flax's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from ..models import pipeline as P
from ..models.network import NKSRNetwork
from ..utils.checkpoint import params_to_torch
from . import losses as L

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields and defaults of ``nksr_tpu.train.loop.TrainConfig``."""
    lr_init: float = 1e-4
    lr_decay_mult: float = 0.7
    lr_decay_step: int = 50000
    lr_clip: float = 1e-6
    weight_decay: float = 0.0
    grad_clip: float = 0.5
    structure_start_step: int = 2500
    structure_end_step: int = 10000
    accumulate_grad_batches: int = 1


def lr_schedule(tc: TrainConfig, step: int) -> torch.Tensor:
    """The staircase learning rate at ``step`` (f32, as optax computes
    it): ``lr_init * decay_mult ** (step // decay_step)``, at least
    ``lr_clip``."""
    f32 = torch.float32
    e = torch.tensor(step // tc.lr_decay_step, dtype=torch.int32)
    lr = torch.tensor(tc.lr_init, dtype=f32) * \
        torch.tensor(tc.lr_decay_mult, dtype=f32) ** e.to(f32)
    return torch.maximum(lr, torch.tensor(tc.lr_clip, dtype=f32))


def pd_structure_prob(tc: TrainConfig, step: int) -> float:
    """Teacher-forcing schedule: the probability of relying on the
    *predicted* structure, ramping 0 -> 1 between the start and end
    steps."""
    denom = max(tc.structure_end_step - tc.structure_start_step, 1)
    return min(max((step - tc.structure_start_step) / denom, 0.0), 1.0)


class TrainState(NamedTuple):
    """The network (its parameters are the params), the optimizer state
    (``init_opt_state``) and the step count."""
    net: NKSRNetwork
    opt_state: Dict
    step: int


def init_opt_state(net: NKSRNetwork) -> Dict:
    """optax's initial state of the chain: zero moments, zero counts."""
    def zeros():
        return {n: torch.zeros_like(p) for n, p in net.named_parameters()}
    i32 = torch.int32
    return {"notfinite_count": torch.zeros((), dtype=i32),
            "last_finite": torch.ones((), dtype=torch.bool),
            "total_notfinite": torch.zeros((), dtype=i32),
            "inner_state": {"0": {},
                            "1": {"count": torch.zeros((), dtype=i32),
                                  "mu": zeros(), "nu": zeros(),
                                  "nu_max": zeros()},
                            "2": {},
                            "3": {"count": torch.zeros((), dtype=i32)}}}


def init_state(cfg: P.PipelineConfig, tc: TrainConfig, seed: int = 0,
               params=None, device="cuda") -> TrainState:
    """A fresh train state on ``device``: the flax-layout ``params`` (a
    checkpoint's) or the port's seeded init (``models.pipeline.
    init_params``; other numbers than JAX's from the same seed)."""
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(
        params if params is not None else P.init_params(cfg, seed)),
        strict=True)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_state(device='cuda'): no CUDA device "
                               "is available")
        # full f32 matmuls, as the JAX package trains (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    net = net.to(device)
    state = init_opt_state(net)
    return TrainState(net, _to(state, device), 0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def apply_optimizer(tc: TrainConfig, net: NKSRNetwork, opt_state: Dict
                    ) -> Dict:
    """One update of the chain from the parameters' ``.grad`` (None reads
    as zeros), in place on the parameters; returns the new state."""
    params = dict(net.named_parameters())
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    finite = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()
    nf = opt_state["notfinite_count"]
    nf = torch.where(finite, torch.zeros_like(nf), nf + 1)
    total_nf = opt_state["total_notfinite"]
    total_nf = torch.where(finite, total_nf, total_nf + 1)
    inner = opt_state["inner_state"]
    if bool(finite) or int(nf) > MAX_CONSECUTIVE_ERRORS:
        ams, sched = inner["1"], inner["3"]
        count = ams["count"] + 1
        f32 = torch.float32
        c = count.to(dev, f32)
        bc1 = 1 - torch.tensor(B1, dtype=f32, device=dev) ** c
        bc2 = 1 - torch.tensor(B2, dtype=f32, device=dev) ** c
        lr = -lr_schedule(tc, int(sched["count"])).to(dev)
        mu, nu, nu_max = {}, {}, {}
        for n, p in params.items():
            g = grads[n].clamp(-tc.grad_clip, tc.grad_clip)
            mu[n] = (1 - B1) * g + B1 * ams["mu"][n]
            nu[n] = (1 - B2) * (g * g) + B2 * ams["nu"][n]
            nu_max[n] = torch.maximum(ams["nu_max"][n], nu[n] / bc2)
            u = (mu[n] / bc1) / (torch.sqrt(nu_max[n]) + EPS)
            u = u + tc.weight_decay * p
            p.add_(lr * u)
        inner = {"0": {}, "1": {"count": count, "mu": mu, "nu": nu,
                                "nu_max": nu_max},
                 "2": {}, "3": {"count": sched["count"] + 1}}
    return {"notfinite_count": nf, "last_finite": finite.to(nf.device),
            "total_notfinite": total_nf, "inner_state": inner}


def loss_and_grads(cfg: P.PipelineConfig, lcfg: L.LossConfig,
                   net: NKSRNetwork, inp: P.TrainInputs,
                   samples: Optional[Dict[str, torch.Tensor]],
                   compute_metric: bool = False, tm=None,
                   use_gt_structure: bool = True,
                   gen: Optional[torch.Generator] = None):
    """The forward (teacher-forced, or on the predicted structure), the
    losses and their backward: leaves the gradients in the parameters'
    ``.grad``.  ``samples`` the draws, or None to draw them from ``gen``
    on the forward's decoder hierarchy.  Returns (losses with "sum",
    metrics, forward output), the losses as tensors.  ``tm`` (a
    ``utils.profiling.PhaseTimer`` that accumulates, fresh for the step:
    the predicted forward's level phases recur) splits the time
    into "train: forward", "train: samples", "train: losses" and "train:
    backward" (of which the implicit solve's PCG is
    ``solve_spd.last_backward_seconds``), and in predicted mode "train:
    structure readback" and "train: structure tables"."""
    def lap(name):
        if tm is not None:
            tm.lap(name)
    net.zero_grad(set_to_none=True)
    out = P.forward(cfg, net, inp, use_gt_structure=use_gt_structure, tm=tm)
    lap("train: forward")
    if samples is None:
        samples = L.draw_samples(gen, cfg, lcfg, inp, out.dec_grids)
        lap("train: samples")
    losses, metrics = L.compute_losses(cfg, lcfg, out, inp, samples,
                                       compute_metric=compute_metric)
    total = sum(losses.values())
    lap("train: losses")
    total.backward()
    lap("train: backward")
    losses = dict(losses)
    losses["sum"] = total
    return losses, metrics, out


def train_step(cfg: P.PipelineConfig, tc: TrainConfig, lcfg: L.LossConfig,
               state: TrainState, batch: Dict, gen: torch.Generator,
               use_gt_structure: bool = True, compute_metric: bool = False,
               samples: Optional[Dict[str, torch.Tensor]] = None, tm=None):
    """One optimization step on one padded batch (``data.loader.
    to_device_batch``'s keys), teacher-forced or on the predicted
    structure.  The random draws come from ``gen`` (a CPU generator),
    on the forward's decoder hierarchy, unless ``samples`` are given.
    Returns (new state, losses as floats with "sum", metrics as floats).
    ``tm`` (a ``PhaseTimer``) adds "train: host build" and "train:
    optimizer" to ``loss_and_grads``' phases."""
    dev = next(state.net.parameters()).device
    inp = P.prepare_inputs(cfg, batch, dev, use_gt_structure)
    if tm is not None:
        tm.lap("train: host build")
    state.net.train()
    losses, metrics, _ = loss_and_grads(
        cfg, lcfg, state.net, inp, samples, compute_metric, tm=tm,
        use_gt_structure=use_gt_structure, gen=gen)
    opt_state = apply_optimizer(tc, state.net, state.opt_state)
    if tm is not None:
        tm.lap("train: optimizer")
    state.net.zero_grad(set_to_none=True)
    return (TrainState(state.net, opt_state, state.step + 1),
            {k: float(v.detach()) for k, v in losses.items()},
            {k: float(v) for k, v in metrics.items()})


def val_step(cfg: P.PipelineConfig, lcfg: L.LossConfig, net: NKSRNetwork,
             batch: Dict, gen: torch.Generator,
             use_gt_structure: bool = True):
    """Losses and metrics without a step; a NaN total reads 0."""
    dev = next(net.parameters()).device
    inp = P.prepare_inputs(cfg, batch, dev, use_gt_structure)
    with torch.no_grad():
        out = P.forward(cfg, net, inp, use_gt_structure=use_gt_structure)
        samples = L.draw_samples(gen, cfg, lcfg, inp, out.dec_grids)
        losses, metrics = L.compute_losses(cfg, lcfg, out, inp, samples,
                                           compute_metric=True)
        total = sum(losses.values())
        total = torch.where(torch.isnan(total), 0.0, total)
    losses = {k: float(v) for k, v in losses.items()}
    losses["sum"] = float(total)
    return losses, {k: float(v) for k, v in metrics.items()}
