"""Scenes, configurations and weights of the sharded-reconstruction tests
(``tests/test_torch_parallel*.py``), shared by their gloo worlds
(``tests/torch_parallel_worker.py``) and by the JAX package's side of
them (``scripts/parallel_reference.py``).  numpy and the port only: the
worlds' processes never import JAX.

The scenes are ``tests/test_parallel.py``'s, at its iteration counts but
three: the x-elongated wavy sheets of its sharded-lattice (with the UDF
mask head on), sharded-mesh and adaptive tests (at 120 iterations where
it runs 80), the sphere of its predicted test (stretched along x, and at
60 iterations where it runs 200) and the flat 2 m square of its
sharded-chunk test (at 16 iterations: its check here is bit-equality).
The weights are random from a numpy seed (every leaf; the normal heads
scaled down, the predicted scene's structure heads boosted so that the
prediction refines to depth 0), the same in both packages.
"""

import numpy as np

WORLDS = (2, 4)
BASE = dict(tree_depth=3, f_maps=8, basis_dim=8, udf_dim=8)
# tests/test_parallel.py's solver settings, scene by scene
SPLAT_CFG = dict(BASE, solver_max_iters=60, solver_tol=1e-7,
                 udf_enabled=True)
MESH_CFG = dict(BASE, solver_max_iters=80, solver_tol=1e-7)
ADAPTIVE_CFG = dict(MESH_CFG, solver_max_iters=120)
PRED_CFG = dict(BASE, solver_max_iters=60, solver_tol=1e-7)
CHUNK_CFG = dict(BASE, tree_depth=2, voxel_size=0.1, normal_weight=1e6,
                 solver_max_iters=16, solver_tol=1e-5,
                 structure_mode="splat")
SPLAT_KW = dict(voxel_size=0.1, detail_level=None, structure="splat")
ADAPTIVE_KW = dict(voxel_size=0.1, detail_level=None, structure="adaptive")
PRED_KW = dict(voxel_size=0.12, detail_level=None, structure="predicted")
CHUNK_SIZE = 1.0
N_PROBES = 512


def sheet(seed, n, length, amp, fx, fy, flat_from=None):
    """An x-elongated wavy sheet ``z = amp sin(fx x) cos(fy y)`` over
    ``[0, length] x [0, 1]`` with its analytic normals; flat for ``x >=
    flat_from``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    x = xy[:, 0] * length
    z = amp * np.sin(fx * x) * np.cos(fy * xy[:, 1])
    dx = amp * fx * np.cos(fx * x) * np.cos(fy * xy[:, 1])
    dy = -amp * fy * np.sin(fx * x) * np.sin(fy * xy[:, 1])
    if flat_from is not None:
        wavy = x < flat_from
        z, dx, dy = (np.where(wavy, a, 0.0) for a in (z, dx, dy))
    xyz = np.stack([x, xy[:, 1], z], 1).astype(np.float32)
    nrm = np.stack([-dx, -dy, np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, nrm.astype(np.float32)


def splat_scene():
    """TestShardedLattice's reconstruct scene."""
    return sheet(5, 1200, 4.0, 0.25, 2.0, 3.0)


def mesh_scene():
    """TestShardedMesh's extraction scene."""
    return sheet(11, 1500, 5.0, 0.3, 1.7, 2.5)


def adaptive_scene():
    """TestShardedMesh's adaptive scene: flat for x >= 2, so the
    normal-variation builder prunes there."""
    return sheet(13, 1500, 4.0, 0.3, 2.2, 2.0, flat_from=2.0)


def sphere():
    """The predicted test's sphere (tests/test_field.py sphere_points),
    stretched 3x along x so that every slab holds some of it."""
    rng = np.random.default_rng(31)
    v = rng.normal(size=(1500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = 0.5 * v * np.array([3.0, 1.0, 1.0])
    nrm = v * np.array([1.0 / 3.0, 1.0, 1.0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz.astype(np.float32), nrm.astype(np.float32)


def chunk_scene():
    """TestShardedChunks' flat 2 m square: four 1 m chunks."""
    rng = np.random.default_rng(24)
    xyz = np.zeros((4000, 3), np.float32)
    xyz[:, :2] = rng.uniform(0, 2.0, (4000, 2)).astype(np.float32)
    nrm = np.tile([0, 0, 1.0], (4000, 1)).astype(np.float32)
    return xyz, nrm


def probes(xyz, seed=7):
    """Points near the cloud."""
    rng = np.random.default_rng(seed)
    return (xyz[rng.integers(0, len(xyz), N_PROBES)]
            + rng.normal(0, 0.05, (N_PROBES, 3))).astype(np.float32)


def chunk_probes():
    rng = np.random.default_rng(25)
    p = np.zeros((256, 3), np.float32)
    p[:, :2] = rng.uniform(0.1, 1.9, (256, 2))
    return p


def random_params(cfg_kw, seed):
    """Every leaf random (tests/test_torch_dense_unet.py's recipe:
    kernels N(0, 1/fan_in), biases N(0, 0.1^2), GroupNorm scales 1 +
    N(0, 0.1^2)), the normal heads scaled by 0.05 (random residual
    normals would swamp the splatted input normals), as a flax-layout
    numpy tree."""
    from nksr_tpu_torch.models import pipeline as P
    from nksr_tpu_torch.models.network import NKSRNetwork
    from nksr_tpu_torch.utils.checkpoint import torch_to_params
    rng = np.random.default_rng(seed)

    def fill(node, name):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        shape = node.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if len(shape) == 1:
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    cfg = P.PipelineConfig(**{k: v for k, v in cfg_kw.items()
                              if k != "structure_mode"})
    params = {"params": fill(torch_to_params(NKSRNetwork(cfg).state_dict()),
                             "")}
    unet = params["params"]["unet"]
    for d in range(cfg.tree_depth):
        for leaf in unet[f"normal_{d}"].values():
            leaf *= 0.05
    return params


def predicted_params():
    """Random weights with the structure heads boosted (kernels x 30,
    biases (0, 0.5, 3): refine-heavy), tests/test_torch_predicted.py's
    recipe, so the prediction keeps a decoder hierarchy down to depth 0."""
    params = random_params(PRED_CFG, 3)
    unet = params["params"]["unet"]
    for d in range(PRED_CFG["tree_depth"]):
        unet[f"struct_{d}"]["kernel"] *= 30.0
        unet[f"struct_{d}"]["bias"][:] = (0.0, 0.5, 3.0)
    return params


SCENES = {
    # name: (scene, config, reconstruct keywords, weights seed)
    "splat": (splat_scene, SPLAT_CFG, SPLAT_KW, 0),
    "mesh": (mesh_scene, MESH_CFG, SPLAT_KW, 1),
    "adaptive": (adaptive_scene, ADAPTIVE_CFG, ADAPTIVE_KW, 2),
}


def scene_params(name):
    if name == "predicted":
        return predicted_params()
    if name == "chunks":
        return random_params(CHUNK_CFG, 4)
    _, cfg, _, seed = SCENES[name]
    return random_params(cfg, seed)
