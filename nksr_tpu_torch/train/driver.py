"""Run drivers (counterpart of nksr_tpu/train/driver.py): the maps of a
run config onto ``PipelineConfig``, ``LossConfig`` and ``TrainConfig``,
the CSV/JSON run logger, and ``fit``, the training loop (the
teacher-forcing coin a step) with periodic validation, best/last
checkpoints and resume.

    cfg = pipeline_config_from_yaml(load_config("runs/scene_big/config.yaml"))

Entry points: ``nksr_tpu_torch/scripts/train.py`` and ``overfit.py``.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..models import pipeline as P
from ..utils import checkpoint as CKPT
from . import loop as T
from . import losses as L


def pipeline_config_from_yaml(cfg: dict) -> P.PipelineConfig:
    """Map reference-style YAML keys (configs/default/train.yaml) onto
    PipelineConfig, key for key as the JAX package does."""
    solver = cfg.get("solver", {})
    caps = cfg.get("capacities",
                   [65536 >> d for d in range(cfg.get("tree_depth", 4))])
    return P.PipelineConfig(
        voxel_size=cfg.get("voxel_size", 0.1),
        tree_depth=cfg.get("tree_depth", 4),
        adaptive_depth=cfg.get("adaptive_depth", 1),
        kernel_dim=cfg.get("kernel_dim", 4),
        f_maps=cfg.get("unet", {}).get("f_maps", 32),
        interp_hidden=cfg.get("interpolator", {}).get("hidden_dim", 16),
        interp_layers=cfg.get("interpolator", {}).get("n_hidden", 2),
        feature=cfg.get("feature", "normal"),
        geometry=cfg.get("geometry", "kernel"),
        udf_enabled=cfg.get("udf", {}).get("enabled", False),
        pos_weight=solver.get("pos_weight", 1e4),
        normal_weight=solver.get("normal_weight", 1e4),
        capacities=tuple(caps),
        adaptive_tau=cfg.get("adaptive_policy", {}).get("tau", 0.1),
        solver_tol=cfg.get("solver_tol", 1e-5),
        solver_max_iters=cfg.get("solver_max_iters", 128),
    )


def loss_config_from_yaml(cfg: dict) -> L.LossConfig:
    """The ``supervision`` block onto LossConfig, as the JAX package
    maps it."""
    sup = cfg.get("supervision", {})

    def samplers(lst):
        return tuple(L.SamplerConfig(
            type=s.get("type", "uniform"), n_samples=s.get("n_samples", 0),
            expand=s.get("expand", 0), expand_top=s.get("expand_top", 0),
            eps=s.get("eps", 0.5)) for s in lst)
    sp = sup.get("spatial", {})
    udf = sup.get("udf", {})
    gs = sup.get("gt_surface", {})
    return L.LossConfig(
        structure_weight=sup.get("structure_weight", 20.0),
        gt_surface_value=gs.get("value", 200.0),
        gt_surface_normal=gs.get("normal", 100.0),
        gt_surface_subsample=gs.get("subsample", 50000),
        spatial_weight=sp.get("weight", 300.0),
        reg_sdf_weight=sp.get("reg_sdf_weight", 0.0),
        spatial_samplers=samplers(sp.get("samplers", [])) or
        L.LossConfig.spatial_samplers,
        udf_weight=udf.get("weight", 150.0),
        udf_samplers=samplers(udf.get("samplers", [])) or
        L.LossConfig.udf_samplers,
        gt_soft=sp.get("gt_soft", True),
        gt_band=sp.get("gt_band", 1.0),
    )


def train_config_from_yaml(cfg: dict) -> T.TrainConfig:
    lr = cfg.get("learning_rate", {})
    ss = cfg.get("structure_schedule", {})
    return T.TrainConfig(
        lr_init=lr.get("init", 1e-4),
        lr_decay_mult=lr.get("decay_mult", 0.7),
        lr_decay_step=lr.get("decay_step", 50000),
        lr_clip=lr.get("clip", 1e-6),
        weight_decay=cfg.get("weight_decay", 0.0),
        grad_clip=cfg.get("grad_clip", 0.5),
        structure_start_step=ss.get("start_step", 2500),
        structure_end_step=ss.get("end_step", 10000),
        accumulate_grad_batches=cfg.get("accumulate_grad_batches", 1),
    )


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to nksr_tpu_torch yet (ROADMAP.md queue 1, "
        f"{item})")


class RunLogger:
    """Metric logging to ``metrics.csv`` (a header whenever the keys
    change) and ``metrics.jsonl`` (one object a row).  The JAX package's
    tensorboard and wandb backends are not ported: ``backend`` "auto"
    and "csv" log to these files, any other raises."""

    def __init__(self, run_dir: Path, backend: str = "auto"):
        if backend not in ("auto", "csv"):
            raise _not_ported(f"the {backend!r} logger backend", "item 14")
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.run_dir / "metrics.csv"
        self.json_path = self.run_dir / "metrics.jsonl"
        self._keys = None
        self._fh = None
        self._jh = None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        row = {"step": step}
        row.update({f"{prefix}{k}": float(v) for k, v in metrics.items()})
        if self._fh is None:
            self._fh = open(self.csv_path, "a", newline="")
            self._jh = open(self.json_path, "a")
        w = csv.DictWriter(self._fh, fieldnames=sorted(row))
        if self._keys != sorted(row):
            w.writeheader()
            self._keys = sorted(row)
        w.writerow(row)
        self._fh.flush()
        self._jh.write(json.dumps(row) + "\n")
        self._jh.flush()

    def close(self):
        for fh in (self._fh, self._jh):
            if fh:
                fh.close()


def _log_val_mesh(run: Path, step: int, pcfg: P.PipelineConfig, net,
                  val_loader, device) -> None:
    """Reconstruct the first val cloud with the current params (splat
    structure; the in-graph route for the neural geometry head, which
    runs there alone) and write its mesh as
    ``artifacts/val_mesh_<step>.ply``."""
    from ..data.io import write_ply
    from ..recon.reconstructor import Reconstructor
    from ..utils.checkpoint import torch_to_params
    batch = next(iter(val_loader), None)
    if batch is None:
        return
    m = batch["mask"].numpy()
    recon = Reconstructor(device=device, config=pcfg, params={
        "params": torch_to_params(net.state_dict())})
    hf = recon.reconstruct(batch["xyz"].numpy()[m],
                           batch["normal"].numpy()[m], detail_level=None,
                           voxel_size=pcfg.voxel_size,
                           structure="splat" if pcfg.geometry == "kernel"
                           else "predicted_ingraph",
                           solver_max_iters=min(pcfg.solver_max_iters, 48))
    mesh = hf.extract_dual_mesh()
    write_ply(run / "artifacts" / f"val_mesh_{step}.ply", mesh.v, mesh.f)


def fit(cfg: dict, train_loader: Iterable, val_loader: Optional[Iterable],
        run_dir: str, max_steps: int = 10 ** 9, val_every: int = 1000,
        ckpt_every: int = 1000, seed: int = 0, resume: bool = False,
        batch_size: Optional[int] = None, device="cuda",
        params=None) -> T.TrainState:
    """The fit loop: the teacher-forcing coin (``pd_structure_prob``),
    one ``torch.Generator`` a step seeded ``seed * 1000003 + step``,
    window-mean train logs (every 50 steps and the first), validation
    every ``val_every`` steps with ``best.ckpt`` on a better val sum,
    ``last.ckpt`` every ``ckpt_every`` steps and at the end, and resume
    from ``last.ckpt`` (of either package).  ``params``: a flax-layout
    tree to start from (default the port's seeded init).  Runs on
    ``device`` (the card unless asked for the CPU).  A step the coin
    sends to the predicted structure runs the decoder on its own
    prediction; validation is teacher-forced, as in the JAX package.
    ``batch_size`` > 1 (data parallel) raises (item 15)."""
    if batch_size is not None and batch_size > 1:
        raise _not_ported("data-parallel training (batch_size > 1)",
                          "item 15")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda'): no CUDA device is "
                           "available")
    pcfg = pipeline_config_from_yaml(cfg)
    lcfg = loss_config_from_yaml(cfg)
    tcfg = train_config_from_yaml(cfg)
    run = Path(run_dir)
    logger = RunLogger(run, backend=cfg.get("logger", "auto"))
    log_mesh = bool(cfg.get("log_mesh_artifacts", False))
    rng = np.random.default_rng(seed)

    state = T.init_state(pcfg, tcfg, seed, params=params, device=device)
    start_step = 0
    last_ckpt = run / "last.ckpt"
    if resume and last_ckpt.exists():
        opt_state, start_step = CKPT.load_train_state(last_ckpt, state.net,
                                                      device)
        state = T.TrainState(state.net, opt_state, start_step)
        print(f"[resume] from {last_ckpt} at step {start_step}")

    best_val = float("inf")
    step = start_step
    window = []
    t0 = time.time()
    for batch in train_loader:
        if step >= max_steps:
            break
        use_gt = rng.random() >= T.pd_structure_prob(tcfg, step)
        gen = torch.Generator().manual_seed(seed * 1000003 + step)
        state, losses, _ = T.train_step(pcfg, tcfg, lcfg, state, batch, gen,
                                        use_gt_structure=use_gt)
        step = state.step
        window.append(losses)
        if step % 50 == 0 or step == start_step + 1:
            ls = {k: float(np.mean([w[k] for w in window]))
                  for k in window[-1]}
            window = []
            ls["lr"] = float(T.lr_schedule(tcfg, step))
            ls["pd_struct_prob"] = T.pd_structure_prob(tcfg, step)
            dt = time.time() - t0
            print(f"[train {step}] sum={ls['sum']:.4f} "
                  f"({dt / max(step - start_step, 1):.2f}s/it)", flush=True)
            logger.log(step, ls, "train/")
        if val_loader is not None and step % val_every == 0:
            state.net.eval()
            vals = []
            for vb in val_loader:
                lv, mv = T.val_step(pcfg, lcfg, state.net, vb,
                                    torch.Generator().manual_seed(step))
                vals.append({**lv, **mv})
            mean = {k: float(np.mean([v[k] for v in vals if k in v]))
                    for k in vals[0]} if vals else {}
            logger.log(step, mean, "val/")
            print(f"[val {step}] {json.dumps(mean)[:200]}", flush=True)
            if log_mesh:
                try:
                    _log_val_mesh(run, step, pcfg, state.net, val_loader,
                                  device)
                except Exception as e:   # artifacts must never kill a run
                    print(f"[val {step}] mesh artifact failed: {e}",
                          flush=True)
            if mean.get("sum", float("inf")) < best_val:
                best_val = mean["sum"]
                CKPT.save_train_state(run / "best.ckpt", state.net,
                                      state.opt_state, step)
        if step % ckpt_every == 0:
            CKPT.save_train_state(last_ckpt, state.net, state.opt_state, step)
    CKPT.save_train_state(last_ckpt, state.net, state.opt_state, step)
    logger.close()
    return state
