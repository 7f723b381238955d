"""Run drivers (counterpart of nksr_tpu/train/driver.py).  For now only
the mapping of a run config onto ``PipelineConfig``, so a checkpoint runs
under the configuration it was trained in:

    cfg = pipeline_config_from_yaml(load_config("runs/scene_big/config.yaml"))
"""

from __future__ import annotations

from ..models import pipeline as P


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
