"""Run drivers (counterpart of nksr_tpu/train/driver.py): the maps of a
run config onto ``PipelineConfig``, ``LossConfig`` and ``TrainConfig``,
the run logger (CSV and JSON rows, tensorboard or wandb, mesh renders),
and ``fit``, the training loop (the teacher-forcing coin a step) on one
device or data-parallel, with periodic validation, best/last
checkpoints, resume and an opt-in profiler trace.

    cfg = pipeline_config_from_yaml(load_config("runs/scene_big/config.yaml"))

Entry points: ``nksr_tpu_torch/scripts/train.py`` and ``overfit.py``.
"""

from __future__ import annotations

import contextlib
import csv
import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..models import pipeline as P
from ..utils import checkpoint as CKPT
from ..utils import profiling as PROF
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


class RunLogger:
    """Metric and artifact logging (the JAX package's ``RunLogger``):
    ``metrics.csv`` (a header whenever the keys change) and
    ``metrics.jsonl`` (one object a row) always, plus a backend:
    ``"auto"`` adds tensorboard scalars and images under ``tb/`` where
    ``torch.utils.tensorboard`` imports; ``"tensorboard"`` raises where
    it does not; ``"wandb"`` needs ``wandb`` (it raises without it);
    ``"csv"`` adds nothing."""

    def __init__(self, run_dir: Path, backend: str = "auto"):
        if backend not in ("auto", "csv", "tensorboard", "wandb"):
            raise ValueError(f"unknown logger backend {backend!r}")
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.run_dir / "metrics.csv"
        self.json_path = self.run_dir / "metrics.jsonl"
        self._keys = None
        self._fh = None
        self._jh = None
        self._tb = None
        self._wandb = None
        if backend in ("auto", "tensorboard"):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                if backend == "tensorboard":
                    raise
            else:
                self._tb = SummaryWriter(log_dir=str(self.run_dir / "tb"))
        elif backend == "wandb":
            import wandb  # a hard requirement when asked for
            self._wandb = wandb.init(project=f"nkfw-{self.run_dir.name}",
                                     dir=str(self.run_dir), resume="allow")
        self.backend = ("tensorboard" if self._tb is not None else
                        "wandb" if self._wandb is not None else "csv")

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
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def log_image(self, step: int, tag: str, image: np.ndarray):
        """An (H, W, 3) uint8 image: a PNG under ``artifacts/`` where
        matplotlib imports, and to the backend."""
        art = self.run_dir / "artifacts"
        art.mkdir(exist_ok=True)
        plt = _pyplot()
        if plt is not None:
            plt.imsave(art / f"{tag.replace('/', '_')}_{step}.png", image)
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Image(image)}, step=step)

    def log_mesh(self, step: int, tag: str, verts: np.ndarray,
                 faces: np.ndarray, max_tris: int = 30000):
        """A ``.ply`` under ``artifacts/`` and, where matplotlib imports,
        its render (``render_mesh``) through ``log_image``."""
        from ..data.io import write_ply
        name = tag.replace("/", "_")
        write_ply(self.run_dir / "artifacts" / f"{name}_{step}.ply",
                  np.asarray(verts, np.float32), np.asarray(faces))
        img = render_mesh(verts, faces, max_tris=max_tris)
        if img is not None:
            self.log_image(step, tag, img)

    def close(self):
        for fh in (self._fh, self._jh):
            if fh:
                fh.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it does not
    import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def render_mesh(verts: np.ndarray, faces: np.ndarray,
                max_tris: int = 30000) -> Optional[np.ndarray]:
    """A flat-shaded render of the mesh as (H, W, 3) uint8, by
    matplotlib's software rasteriser (at most ``max_tris`` triangles,
    evenly picked); None for an empty mesh or where matplotlib does not
    import."""
    if len(faces) == 0 or len(verts) == 0:
        return None
    plt = _pyplot()
    if plt is None:
        return None
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    verts = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    if len(f) > max_tris:
        f = f[np.linspace(0, len(f) - 1, max_tris).astype(int)]
    tris = verts[f]                                    # (T, 3, 3)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
    shade = 0.25 + 0.75 * np.clip(n @ np.array([0.4, 0.3, 0.85]), 0, 1)
    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(projection="3d")
    coll = Poly3DCollection(tris, linewidths=0)
    coll.set_facecolor(np.stack([0.55 * shade, 0.65 * shade,
                                 0.85 * shade, np.ones_like(shade)], 1))
    ax.add_collection3d(coll)
    lo, hi = verts.min(0), verts.max(0)
    c, r = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-6
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def _log_val_mesh(logger: Optional[RunLogger], step: int,
                  pcfg: P.PipelineConfig, net, val_loader, device) -> None:
    """Reconstruct the first val cloud with the current params (splat
    structure; the in-graph route for the neural geometry head, which
    runs there alone) and log its mesh (``RunLogger.log_mesh``: the
    ``artifacts/val_mesh_<step>.ply`` and its render); with no
    ``logger`` (a rank that does not write) only reconstruct it."""
    from ..recon.reconstructor import Reconstructor
    from ..utils.checkpoint import torch_to_params
    batch = next(iter(val_loader), None)
    if batch is None:
        return
    m = np.asarray(batch["mask"])
    recon = Reconstructor(device=device, config=pcfg, params={
        "params": torch_to_params(net.state_dict())})
    hf = recon.reconstruct(np.asarray(batch["xyz"])[m],
                           np.asarray(batch["normal"])[m],
                           detail_level=None, voxel_size=pcfg.voxel_size,
                           structure="splat" if pcfg.geometry == "kernel"
                           else "predicted_ingraph",
                           solver_max_iters=min(pcfg.solver_max_iters, 48))
    mesh = hf.extract_dual_mesh()
    if logger is not None:
        logger.log_mesh(step, "val/mesh", np.asarray(mesh.v),
                        np.asarray(mesh.f))


def fit(cfg: dict, train_loader: Iterable, val_loader: Optional[Iterable],
        run_dir: str, max_steps: int = 10 ** 9, val_every: int = 1000,
        ckpt_every: int = 1000, seed: int = 0, resume: bool = False,
        batch_size: Optional[int] = None, device="cuda",
        params=None) -> T.TrainState:
    """The fit loop: the teacher-forcing coin (``pd_structure_prob``),
    one ``torch.Generator`` a cloud and step (``parallel.data_parallel.
    sample_seed``: ``seed * 1000003 + step`` at one cloud a step),
    window-mean train logs (every 50 steps and the first), validation
    every ``val_every`` steps with ``best.ckpt`` on a better val sum,
    ``last.ckpt`` every ``ckpt_every`` steps and at the end, and resume
    from ``last.ckpt`` (of either package).  ``params``: a flax-layout
    tree to start from (default the port's seeded init).  Runs on
    ``device`` (the card unless asked for the CPU).  A step the coin
    sends to the predicted structure runs the decoder on its own
    prediction; validation is teacher-forced, as in the JAX package.
    The whole loop runs under ``utils.profiling.trace_run(run_dir /
    "trace")`` (a trace when NKSR_PROFILE=1).

    ``batch_size`` > 1 trains data-parallel over ``torch.distributed``
    (``parallel.dp_train_step``; the process group of ``parallel.
    init_distributed``, or a world of one): ``batch_size`` must be a
    multiple of the world size, each rank takes ``batch_size // world``
    clouds a step from its own ``train_loader`` (their shapes must
    match: set the config's point and GT buckets), every rank starts
    from rank 0's state (after resume) and runs the same validation,
    and only rank 0 writes logs, artifacts and checkpoints."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda'): no CUDA device is "
                           "available")
    dp = batch_size is not None and batch_size > 1
    mesh, writer, n_local = None, True, 1
    if dp:
        from ..parallel import data_parallel as DP
        from ..parallel import spatial as SP
        mesh = DP.make_mesh(device.type)
        device = DP.mesh_device(mesh)
        if batch_size % SP.size(mesh):
            raise ValueError(f"batch_size {batch_size} must be a multiple "
                             f"of the world size {SP.size(mesh)}")
        n_local = batch_size // SP.size(mesh)
        writer = SP.rank(mesh) == 0
    pcfg = pipeline_config_from_yaml(cfg)
    lcfg = loss_config_from_yaml(cfg)
    tcfg = train_config_from_yaml(cfg)
    run = Path(run_dir)
    logger = None
    if writer:
        logger = RunLogger(run, backend=cfg.get("logger", "auto"))
        print(f"[fit] logger backend: {logger.backend}", flush=True)
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
    if dp:
        state = DP.replicate(mesh, state)

    def batches():
        """This rank's clouds of each step: one padded batch, or a
        stack of ``n_local`` on the device."""
        it = iter(train_loader)
        while True:
            got = []
            for b in it:
                got.append(b)
                if len(got) == n_local:
                    break
            if len(got) < n_local:
                return
            yield DP.to_device(DP.stack_samples(got), device) if dp \
                else got[0]

    def save(path):
        if writer:
            CKPT.save_train_state(path, state.net, state.opt_state, step)

    best_val = float("inf")
    step = start_step
    window = []
    t0 = time.time()
    with PROF.trace_run(str(run / "trace")) if writer \
            else contextlib.nullcontext():
        for batch in batches():
            if step >= max_steps:
                break
            use_gt = rng.random() >= T.pd_structure_prob(tcfg, step)
            if dp:
                first = SP.rank(mesh) * n_local
                gens = [torch.Generator().manual_seed(DP.sample_seed(
                    seed, step, first + i, batch_size))
                    for i in range(n_local)]
                state, losses = DP.dp_train_step(
                    pcfg, tcfg, lcfg, state, batch, gens, mesh,
                    use_gt_structure=use_gt)
            else:
                gen = torch.Generator().manual_seed(seed * 1000003 + step)
                state, losses, _ = T.train_step(pcfg, tcfg, lcfg, state,
                                                batch, gen,
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
                if writer:
                    print(f"[train {step}] sum={ls['sum']:.4f} "
                          f"({dt / max(step - start_step, 1):.2f}s/it)",
                          flush=True)
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
                if writer:
                    logger.log(step, mean, "val/")
                    print(f"[val {step}] {json.dumps(mean)[:200]}",
                          flush=True)
                if log_mesh:
                    try:
                        _log_val_mesh(logger, step, pcfg, state.net,
                                      val_loader, device)
                    except Exception as e:   # artifacts never kill a run
                        print(f"[val {step}] mesh artifact failed: {e}",
                              flush=True)
                if mean.get("sum", float("inf")) < best_val:
                    best_val = mean["sum"]
                    save(run / "best.ckpt")
            if step % ckpt_every == 0:
                save(last_ckpt)
    save(last_ckpt)
    if logger is not None:
        logger.close()
    return state
