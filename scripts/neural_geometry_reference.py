"""The JAX package's ``geometry="neural"`` teacher-forced forward and one
training step at ``tests/test_train.py``'s configuration (tree depth 3,
f_maps 16, capacities 2048/1024/512, its 800-point sphere), UDF head off
and on, and its in-graph route with the mesh (``ingraph``), on the CPU:
the reference that ``tests/test_torch_neural_geometry.py`` holds the
port against.  The step's jitted ``value_and_grad`` takes about 38 s to
compile here and the in-graph route with its mesh about 20 s, too long
for a Tier-1 test, so their numbers are kept in ``tests/data/
neural_geometry_reference.npz`` (about 0.9 MB):

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        python scripts/neural_geometry_reference.py [--out PATH]

The weights are ``tests/test_torch_dense_unet.random_params(cfg, 6)``
(numpy, every leaf random: the SDF decoder's too), the draws the JAX
package's from ``PRNGKey(1)`` (``fold_in`` 1, 2, 3 as its
``compute_losses`` takes them).  Per case (``udf0``, ``udf1``) the file
holds the draws (``spatial``, ``surface``, ``udf``), the loss terms, every
gradient leaf by its flax path, and at 2,000 seeded probes (uniform in
[-1.5, 1.5]^3) the field's values, x-gradients (``jax.vjp``) and masked
values (``evaluate_f_bar``).
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
OUT = ROOT / "tests" / "data" / "neural_geometry_reference.npz"
PROBE_SEED = 4
N_PROBES = 2000
PARAM_SEED = 6


def probes() -> np.ndarray:
    return np.random.default_rng(PROBE_SEED).uniform(
        -1.5, 1.5, (N_PROBES, 3)).astype(np.float32)


def case(udf: bool) -> dict:
    import jax
    import jax.numpy as jnp

    from nksr_tpu.models import pipeline as JP
    from nksr_tpu.train import losses as JL
    from nksr_tpu_torch.models import pipeline as P
    from test_torch_dense_unet import random_params, to_jax
    from test_train import CFG, LCFG, make_batch

    jcfg = dataclasses.replace(CFG, geometry="neural", udf_enabled=udf)
    cfg = P.PipelineConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(P.PipelineConfig)})
    params = to_jax(random_params(cfg, PARAM_SEED))
    batch = make_batch()
    rng = jax.random.PRNGKey(1)
    gt_svh = JP.build_gt_svh(jcfg, batch["gt_xyz"], batch["gt_mask"],
                             batch["gt_normal"])
    feat = JP.point_features(jcfg, batch["xyz"], normal=batch["normal"])
    q = jnp.asarray(probes())

    def loss_fn(p):
        out = JP.forward(jcfg, p, batch["xyz"], batch["mask"], feat,
                         gt_svh=gt_svh, use_gt_structure=True)
        losses, _ = JL.compute_losses(rng, jcfg, LCFG, out,
                                      dict(batch, gt_svh=gt_svh))
        ev = out.field.evaluate_f(q, grad=True)
        return sum(losses.values()), (losses, ev.value, ev.gradient,
                                      out.field.evaluate_f_bar(q))

    t0 = time.perf_counter()
    (_, (losses, val, grad, fbar)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    jax.block_until_ready(grads)
    print(f"udf={udf}: value_and_grad {time.perf_counter() - t0:.1f} s",
          flush=True)

    def draws(key, samplers):
        return JL.get_samples(key, jcfg, samplers, gt_svh, batch["gt_xyz"],
                              batch["gt_normal"], batch["gt_mask"])
    out = {"spatial": draws(jax.random.fold_in(rng, 1),
                            LCFG.spatial_samplers),
           "surface": JL._masked_choice(jax.random.fold_in(rng, 2),
                                        batch["gt_mask"],
                                        LCFG.gt_surface_subsample),
           "value": val, "gradient": grad, "fbar": fbar}
    if udf:
        out["udf"] = draws(jax.random.fold_in(rng, 3), LCFG.udf_samplers)
    out.update({f"loss/{k}": v for k, v in losses.items()})

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, prefix + (k,))
        else:
            yield "grad/" + "/".join(prefix), tree
    out.update(flat(grads, ()))
    return {k: np.asarray(v) for k, v in out.items()}


def ingraph() -> dict:
    """The in-graph route (``structure="predicted_ingraph"``) of
    runs/synth_r3c under ``geometry: neural`` from its best.ckpt, the
    SDF decoder's last bias offset by minus the median of the field at
    the points (so that the zero set runs through the shell), on a
    1,200-point sphere at voxel 0.1: the bias, the capacities and
    hierarchy, the field at 2,000 probes (seed 5) and the mesh of
    ``extract_dual_mesh(mise_iter=1)``."""
    import functools

    import jax
    import jax.numpy as jnp

    from nksr_tpu import Reconstructor
    from nksr_tpu.meshing import dual_mc as DMC
    from nksr_tpu.models import pipeline as JP
    from nksr_tpu_torch.train import driver
    from nksr_tpu_torch.utils.checkpoint import load_tree, model_params
    from nksr_tpu_torch.utils.config import load_config
    from test_field import sphere_points

    run = ROOT / "runs" / "synth_r3c"
    cfg = driver.pipeline_config_from_yaml(
        dict(load_config(run / "config.yaml"), geometry="neural"))
    jcfg = JP.PipelineConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(
                                    JP.PipelineConfig)})
    params = {"params": model_params(load_tree(run / "best.ckpt"))}
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    kw = dict(detail_level=None, voxel_size=0.1,
              structure="predicted_ingraph")

    def reconstruct():
        return Reconstructor(config=jcfg, params=jax.tree_util.tree_map(
            jnp.asarray, params)).reconstruct(xyz, nrm, **kw)
    med = np.median(np.asarray(reconstruct().evaluate_f(
        jnp.asarray(xyz)).value))
    bias = params["params"]["sdf_decoder"]["Dense_2"]["bias"]
    params["params"]["sdf_decoder"]["Dense_2"]["bias"] = \
        (bias - np.float32(med)).astype(np.float32)
    t0 = time.perf_counter()
    jf = reconstruct()
    q = jnp.asarray(np.random.default_rng(5).uniform(
        -1.5, 1.5, (N_PROBES, 3)).astype(np.float32))
    ev = jax.jit(lambda f, x: f.evaluate_f(x, grad=True))(jf, q)
    fbar = jax.jit(lambda f, x: f.evaluate_f_bar(x))(jf, q)
    mesh = jax.jit(functools.partial(DMC.extract_dual_mesh, trim=False,
                                     mise_iter=1))(jf).trim()
    print(f"in-graph: {time.perf_counter() - t0:.1f} s, "
          f"{len(mesh.v)} vertices, {len(mesh.f)} faces", flush=True)
    out = {"bias": params["params"]["sdf_decoder"]["Dense_2"]["bias"],
           "capacities": np.array([g.capacity for g in jf.svh.grids]),
           "value": ev.value, "gradient": ev.gradient, "fbar": fbar,
           "mesh_v": mesh.v, "mesh_f": mesh.f}
    for d, g in enumerate(jf.svh.grids):
        out[f"coords{d}"] = np.asarray(g.coords)[:int(g.num_voxels)]
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    arrays = {}
    for udf in (False, True):
        arrays.update({f"udf{int(udf)}/{k}": v
                       for k, v in case(udf).items()})
    arrays.update({f"ingraph/{k}": v for k, v in ingraph().items()})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {len(arrays)} arrays, "
          f"{Path(args.out).stat().st_size} bytes")


if __name__ == "__main__":
    main()
