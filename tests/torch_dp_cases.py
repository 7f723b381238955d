"""What ``tests/test_torch_dp_train.py``, its rank worker
(``tests/torch_dp_worker.py``) and ``scripts/dp_train_reference.py``
share: ``tests/test_parallel.py``'s configuration (``CFG``, ``LCFG``)
with the solve raised to convergence, and the reference file's layout.
Imports neither JAX nor the port, so both sides can read it.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "data", "dp_train_reference.npz")

# tests/test_torch_train.py's bound and tolerance: both packages report
# the forward and backward solves converged (an unconverged CG pins
# nothing: its stopping point differs between the packages)
PARITY_ITERS = 600
PARITY_TOL = 1e-4
# tests/test_parallel.py's CFG, its solve raised as above
CFG_KW = dict(voxel_size=0.1, tree_depth=2, adaptive_depth=1, f_maps=8,
              basis_dim=8, udf_dim=8, capacities=(512, 256),
              solver_max_iters=PARITY_ITERS, solver_tol=PARITY_TOL)
# tests/test_parallel.py's LCFG: (type, n_samples, expand, expand_top)
SPATIAL = (("uniform", 128, 0, 0), ("band", 128, None, None))
UDF = (("uniform", 64, 0, 0),)
SUBSAMPLE = 128
N_CLOUDS = 2
STEPS = 3
LR = 1e-4                # optax's default in TrainConfig, lr_init


def loss_config(L):
    """tests/test_parallel.py's LCFG in the losses module ``L`` (either
    package's)."""
    def samplers(ss):
        return tuple(L.SamplerConfig(t, n) if e is None
                     else L.SamplerConfig(t, n, e, et)
                     for t, n, e, et in ss)
    return L.LossConfig(spatial_samplers=samplers(SPATIAL),
                        udf_samplers=samplers(UDF),
                        gt_surface_subsample=SUBSAMPLE)


def flatten(tree, prefix=()):
    """A nested dict's leaves by "/"-joined path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def unflatten(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def batch(ref, i: int) -> dict:
    """Cloud ``i`` of the reference file as one padded train batch (its
    GT the input, as tests/test_parallel.py feeds it)."""
    xyz, nrm, mask = ref["xyz"][i], ref["normal"][i], ref["mask"][i]
    return {"xyz": xyz, "normal": nrm, "mask": mask, "gt_xyz": xyz,
            "gt_normal": nrm, "gt_mask": mask}


def fit_config() -> dict:
    """A run config at CFG's widths for ``fit``: csv logs, mesh
    artifacts on, a short solve."""
    return {"voxel_size": 0.1, "tree_depth": 2, "unet": {"f_maps": 8},
            "capacities": [512, 256], "solver_max_iters": 20,
            "solver_tol": 1e-3, "logger": "csv", "log_mesh_artifacts": True,
            "supervision": {
                "gt_surface": {"subsample": SUBSAMPLE},
                "spatial": {"samplers": [
                    {"type": "uniform", "n_samples": 128},
                    {"type": "band", "n_samples": 128}]}}}
