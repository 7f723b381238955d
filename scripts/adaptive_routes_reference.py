"""The JAX package's adaptive structure on the sparse routes at
``tests/test_torch_adaptive_routes.py``'s size, on the CPU: the reference
that test holds the port against.  Its reconstructions and meshes take
minutes to compile here, too long for a Tier-1 test, so their numbers are
kept in ``tests/data/adaptive_routes_reference.npz``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        python scripts/adaptive_routes_reference.py [--out PATH]

The inputs (the sphere, the cap strip, the weights, the probes, the
configuration) are the test module's.  Route A: the dense UNet's and the
dense mesher's budgets at 0; route B: ``NKSR_LATTICE=0``.  The file
holds, per route, the coefficients on the active decoder voxels after 1
and 3 CG iterations (``{route}_it{n}_alpha{d}``; route A's with
``_iters`` and ``_rel_res``: the JAX package's support-row solve keeps
none) and the mesh at 16 iterations (``{route}_mesh_v``,
``_f``); with the UDF head on, the mask values and verdicts at the
test's probes and the sealed mesh (``udf_{route}_*``); the cap strip in
chunks on route A (``chunk_n``, ``chunk_mesh_*``); and the decoder's
voxels per depth (``dec{d}_n``).
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
OUT = ROOT / "tests" / "data" / "adaptive_routes_reference.npz"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    import jax.numpy as jnp

    from nksr_tpu import Reconstructor
    from nksr_tpu.core import host_build as JHB
    from nksr_tpu.meshing import lattice_mc as JLMC
    from nksr_tpu.models import pipeline as JP
    from nksr_tpu.recon import reconstructor as JR
    from nksr_tpu.recon.host_field import _udf_mask_fn
    import test_torch_adaptive_routes as T
    from test_torch_dense_unet import to_jax

    params = to_jax(T.make_params())
    out = {}

    def run(route, fn):
        """``fn()`` with the settings that send the JAX package to
        ``route``, restored after."""
        saved = [(m, n, getattr(m, n))
                 for m, n, _ in T.route_budgets(route, (JR, JLMC, None))]
        for m, n, v in T.route_budgets(route, (JR, JLMC, None)):
            setattr(m, n, v)
        if route == "B":
            os.environ["NKSR_LATTICE"] = "0"
        try:
            return fn()
        finally:
            os.environ.pop("NKSR_LATTICE", None)
            for m, n, v in saved:
                setattr(m, n, v)

    def recon(**cfg_kw):
        return Reconstructor(config=JP.PipelineConfig(**dict(T.CFG, **cfg_kw)),
                             params=params)

    xyz, nrm = T.sphere()
    for route in T.ROUTES:
        for iters in (1, 3):
            t0 = time.perf_counter()
            rec = recon()
            hf = run(route, lambda: rec.reconstruct(xyz, nrm, **dict(
                T.KW, solver_max_iters=iters, solver_tol=1e-12)))
            assert rec._last_unet_engine == "sparse"
            assert (hf.lattice_ctx is not None) == (route == "A")
            key = f"{route}_it{iters}"
            if hf.solver_stats is not None:
                # the support-row solve (route B) keeps no statistics
                out[key + "_iters"] = np.int64(hf.solver_stats.iters)
                out[key + "_rel_res"] = np.float64(hf.solver_stats.rel_res)
            for d in range(3):
                n = len(hf.host_grids[d].keys)
                out[f"dec{d}_n"] = np.int64(n)
                out[f"{key}_alpha{d}"] = np.asarray(
                    hf.field.alpha[d]).reshape(-1, 4)[:n]
            print(f"{key}: decoder {[len(g.keys) for g in hf.host_grids]}, "
                  f"{hf.solver_stats} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        for udf in (False, True):
            t0 = time.perf_counter()
            rec = recon(udf_enabled=udf)
            key = f"udf_{route}" if udf else route

            def lap():
                hf = rec.reconstruct(xyz, nrm, **T.KW)
                return hf, hf.extract_dual_mesh(mise_iter=1)

            hf, mesh = run(route, lap)
            out[key + "_mesh_v"] = np.asarray(mesh.v)
            out[key + "_mesh_f"] = np.asarray(mesh.f)
            if udf:
                x = T.probes(xyz)
                sup = JHB.support_indices(hf.udf_host, hf.udf_caps, x)
                out[key + "_mask"] = np.asarray(_udf_mask_fn(hf.cfg)(
                    hf.field.mask_field, jnp.asarray(x),
                    tuple(jnp.asarray(s) for s in sup)))
                out[key + "_pass"] = np.asarray(hf._mask_host(x))
            print(f"{key} mesh: {len(mesh.v)} vertices, {len(mesh.f)} faces "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rec = recon(structure_mode="adaptive", solver_max_iters=16)

    def chunked():
        cf = rec.reconstruct(*T.strip(), chunk_size=T.CHUNK_SIZE,
                             solver_tol=1e-4)
        return cf, cf.extract_dual_mesh(mise_iter=1)

    cf, mesh = run("A", chunked)
    out["chunk_n"] = np.int64(len(cf.chunks))
    out["chunk_mesh_v"] = np.asarray(mesh.v)
    out["chunk_mesh_f"] = np.asarray(mesh.f)
    print(f"chunked, route A: {len(cf.chunks)} chunks, {len(mesh.v)} "
          f"vertices in {time.perf_counter() - t0:.1f} s", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
