"""The host mesher's seal at the UDF mask, in both packages, on the CPU:
route A (the gather-conv UNet, the lattice solve and the host dual MC,
forced by setting the dense UNet's and the dense mesher's budgets to 0)
on a small terrain tile at the density of route A's 60 m tile (1M
points over 3600 m^2), the ``runs/scene_big`` checkpoint under its own
config.yaml with f32 convs, voxel 0.1, 16 CG iterations, mise_iter=1;
once with the UDF head off and once on.

    env -u PYTHONPATH JAX_PLATFORMS=cpu python scripts/seal_check_udf.py [--half-extent 5]

Prints, per setting, the interior terrain vertex error (1 m inside the
tile) and the vertex count of the JAX package's mesh and of the port's:
with the UDF head on, corners outside the mask read -voxel_size, which
closes the surface with a second sheet at the mask's edge.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--half-extent", type=float, default=5.0)
    h = ap.parse_args().half_extent
    from flax.serialization import msgpack_restore

    from bench import synthetic_scene
    from nksr_tpu import Reconstructor as JReconstructor
    from nksr_tpu.meshing import lattice_mc as JLMC
    from nksr_tpu.recon import reconstructor as JR
    from nksr_tpu.train.driver import pipeline_config_from_yaml as jpcfg
    from nksr_tpu.utils.config import load_config as jload
    from nksr_tpu_torch import Reconstructor
    from nksr_tpu_torch.meshing import lattice_mc as LMC
    from nksr_tpu_torch.recon import reconstructor as R
    from nksr_tpu_torch.train.driver import pipeline_config_from_yaml
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.config import load_config

    root = Path(__file__).resolve().parent.parent
    config = root / "runs/scene_big/config.yaml"
    ckpt = root / "runs/scene_big/best.ckpt"
    n = int(1e6 / 3600 * (2 * h) ** 2)
    xyz, nrm = synthetic_scene(n, half_extent=h)
    for mod in (JR, R):
        mod.DENSE_UNET_CELLMAP_BUDGET = 0
    for mod in (JLMC, LMC):
        mod.DENSE_CELL_BUDGET = 0
    kw = dict(detail_level=None, voxel_size=0.1, solver_tol=1e-4,
              solver_max_iters=16, structure="splat")
    tree = msgpack_restore(ckpt.read_bytes())
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]

    def error(mesh):
        v = np.asarray(mesh.v)[np.unique(np.asarray(mesh.f))]
        v = v[(np.abs(v[:, 0]) < h - 1) & (np.abs(v[:, 1]) < h - 1)]
        d = np.abs(v[:, 2] - height(v[:, 0], v[:, 1]))
        return (f"error mean {d.mean():.5f} q90 {np.quantile(d, 0.9):.5f} "
                f"max {d.max():.5f}, {len(mesh.v)} vertices")

    for udf in (False, True):
        jcfg = dataclasses.replace(jpcfg(jload(config)), udf_enabled=udf)
        cfg = dataclasses.replace(pipeline_config_from_yaml(
            load_config(config)), udf_enabled=udf)
        t0 = time.time()
        jm = JReconstructor(config=jcfg, params={"params": tree}).reconstruct(
            xyz, nrm, **kw).extract_dual_mesh(mise_iter=1)
        t1 = time.time()
        tm = Reconstructor(device="cpu", config=cfg,
                           params=load_tree(ckpt)).reconstruct(
            xyz, nrm, **kw).extract_dual_mesh(mise_iter=1)
        print(f"UDF {'on' if udf else 'off'}, {n} points on a "
              f"{2 * h:g} m tile: JAX {error(jm)} ({t1 - t0:.1f} s); port "
              f"{error(tm)} ({time.time() - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
