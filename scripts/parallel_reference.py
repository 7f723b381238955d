"""The JAX package's sharded reconstruction at
``tests/test_torch_parallel*.py``'s size, on the CPU's virtual 8-device
mesh at ``make_mesh(2)`` and ``make_mesh(4)``: the reference those tests
hold the port against.  ``tests/test_parallel.py`` spends minutes of
compiles on these routes, too long for a Tier-1 test, so their numbers
are kept in ``tests/data/parallel_reference.npz``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python scripts/parallel_reference.py [--out PATH]

The scenes, configurations and weights are ``tests/torch_parallel_cases.py``'s.
The file holds, per scene (``splat``, ``mesh``, ``adaptive``,
``predicted``) and world ``n``: the single-device and sharded fields at
the probes (``{scene}_single_f``, ``{scene}_n{n}_f``) and their distance
(``{scene}_n{n}_q95``, ``_max``, beside ``{scene}_scale``, max |f| of the
single-device field); the sharded coefficients on the active decoder
voxels (``{scene}_n{n}_alpha{d}``); for the ``mesh`` scene the per-slab
solve coefficients (``mesh_n{n}_xs{d}``, (n, slab cells * k)), the basis
features (``mesh_n{n}_basis{d}``) and ``extract_dual_mesh_sharded``'s mesh
at ``mise_iter=1`` (``mesh_n{n}_v``, ``_f``); the chunk scene's serial and
sharded chunked fields at its probes (``chunks_serial_f``,
``chunks_n{n}_f``).
"""

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
OUT = ROOT / "tests" / "data" / "parallel_reference.npz"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--scenes", default="splat,mesh,adaptive,predicted,"
                    "chunks", help="the scenes to run; the keys of the "
                    "others are kept from an existing --out")
    args = ap.parse_args()
    only = args.scenes.split(",")
    import jax
    import jax.numpy as jnp

    from nksr_tpu import Reconstructor
    from nksr_tpu import parallel as PP
    from nksr_tpu.models import pipeline as JP
    from nksr_tpu.parallel.mesh_shard import extract_dual_mesh_sharded
    import torch_parallel_cases as C

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= max(C.WORLDS), jax.devices()

    def to_jax(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    out = {}
    if os.path.exists(args.out):
        old = np.load(args.out)
        out = {k: old[k] for k in old.files
               if k.split("_")[0] not in only}
    scenes = dict(C.SCENES)
    scenes["predicted"] = (C.sphere, C.PRED_CFG, C.PRED_KW, None)
    for name, (scene, cfg, kw, _) in scenes.items():
        if name not in only:
            continue
        t0 = time.perf_counter()
        xyz, nrm = scene()
        rec = Reconstructor(config=JP.PipelineConfig(**cfg),
                            params=to_jax(C.scene_params(name)))
        probes = C.probes(xyz)
        v1 = np.asarray(rec.reconstruct(xyz, nrm, **kw).evaluate_f(
            probes).value)
        scale = max(float(np.abs(v1).max()), 1e-9)
        out[f"{name}_single_f"] = v1
        out[f"{name}_scale"] = np.float64(scale)
        for n in C.WORLDS:
            mesh = PP.make_mesh(n)
            hf = rec.reconstruct(xyz, nrm, mesh=mesh, **kw)
            vn = np.asarray(hf.evaluate_f(probes).value)
            err = np.abs(vn - v1)
            key = f"{name}_n{n}"
            out[key + "_f"] = vn
            out[key + "_q95"] = np.float64(np.quantile(err, 0.95))
            out[key + "_max"] = np.float64(err.max())
            for d in range(cfg["tree_depth"]):
                m = len(hf.host_grids[d].keys)
                out[f"{key}_alpha{d}"] = np.asarray(
                    hf.field.alpha[d]).reshape(-1, 4)[:m]
            line = (f"{key}: q95 {out[key + '_q95']:.6f} max "
                    f"{out[key + '_max']:.6f} (scale {scale:.6f})")
            if name == "mesh":
                sm = hf.sharded_mesh
                with sm["mesh"]:
                    m = extract_dual_mesh_sharded(
                        sm["mesh"], sm["plan"], sm["splan"],
                        sm["interp_params"], sm["basis"], sm["xs_parts"],
                        sm["voxel_size"], sm["compute_dtype"],
                        sm["approx_grad"], mise_iter=1)
                for d in range(cfg["tree_depth"]):
                    out[f"{key}_xs{d}"] = np.asarray(sm["xs_parts"][d])
                    out[f"{key}_basis{d}"] = np.asarray(sm["basis"][d])
                out[key + "_v"] = np.asarray(m.v)
                out[key + "_f_mesh"] = np.asarray(m.f)
                line += f"; sharded mesh {len(m.v)} v {len(m.f)} f"
            print(line, flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)

    if "chunks" in only:
        t0 = time.perf_counter()
        xyz, nrm = C.chunk_scene()
        rec = Reconstructor(config=JP.PipelineConfig(**C.CHUNK_CFG),
                            params=to_jax(C.scene_params("chunks")))
        cp = C.chunk_probes()
        out["chunks_serial_f"] = np.asarray(rec.reconstruct(
            xyz, nrm, chunk_size=C.CHUNK_SIZE, detail_level=None)
            .evaluate_f_bar(cp))
        for n in C.WORLDS:
            cf = rec.reconstruct(xyz, nrm, chunk_size=C.CHUNK_SIZE,
                                 detail_level=None, mesh=PP.make_mesh(n))
            out[f"chunks_n{n}_f"] = np.asarray(cf.evaluate_f_bar(cp))
        print(f"chunks: {time.perf_counter() - t0:.1f} s", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
