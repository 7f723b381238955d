"""Primal against dual lattice solve at equal iteration budgets
(counterpart of scripts/compare_formulations.py), on the card unless
asked for the CPU.

    python -m nksr_tpu_torch.scripts.compare_formulations [--device cpu]

The JAX study's scene: a 20,000-point analytic terrain on 5 m x 5 m
(seed 7), voxel 0.1, ``structure="splat"``, the default
``PipelineConfig`` with seeded random weights (``models.pipeline.
init_params``, seed 0: the JAX study's rule, other numbers).  Each
formulation runs each budget (8 to 128 iterations) to its end (tol
1e-12), then ``extract_dual_mesh()``.  A row holds, beside CG's
iterations and relative residual (the dual's is its row-space residual)
and the reconstruct seconds:

  * ``vert_err``, ``vert_q90``: the mesh's used vertices 2.2 m inside,
    ``|v_z - h(v_x, v_y)|`` against the analytic height field (the JAX
    study's figure);
  * ``probe_dist``: the mean of ``|f| / |grad f|`` at 2,000 probes on
    the analytic surface, the distance to the zero set it estimates;
  * ``vs_ref``: the largest difference of the field values at the probes
    from those of a deep-converged dual (tol 1e-7, up to 3,000
    iterations, the same compute dtype), over its largest ``|f|``.

Prints one line a row and returns the rows.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

BUDGETS = (8, 16, 32, 64, 128)
REF_TOL, REF_ITERS = 1e-7, 3000


def _height(x, y):
    return np.sin(1.2 * x) * np.cos(y) + 0.2 * np.sin(4 * x)


def scene():
    """The terrain (points, normals) and the probes on its surface, as the
    JAX study draws them from seed 7."""
    rng = np.random.default_rng(7)
    n = 20000
    xy = rng.uniform(-2.5, 2.5, (n, 2)).astype(np.float32)
    xyz = np.concatenate([xy, _height(xy[:, 0], xy[:, 1])[:, None]],
                         1).astype(np.float32)
    dx = 1.2 * np.cos(1.2 * xy[:, 0]) * np.cos(xy[:, 1]) \
        + 0.8 * np.cos(4 * xy[:, 0])
    dy = -np.sin(1.2 * xy[:, 0]) * np.sin(xy[:, 1])
    nrm = np.stack([-dx, -dy, np.ones(n)], 1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    probes = np.zeros((2000, 3), np.float32)
    probes[:, :2] = rng.uniform(-2.2, 2.2, (2000, 2))
    probes[:, 2] = _height(probes[:, 0], probes[:, 1])
    return xyz, nrm, probes


def run(device: str = "cuda", budgets=BUDGETS, log=print):
    from .. import Reconstructor
    from ..models.pipeline import PipelineConfig

    xyz, nrm, probes = scene()

    def solve(formulation, iters, tol=1e-12):
        recon = Reconstructor(device=device, config=PipelineConfig(
            solver_formulation=formulation))
        t0 = time.perf_counter()
        field = recon.reconstruct(xyz, nrm, voxel_size=0.1,
                                  structure="splat", solver_tol=tol,
                                  solver_max_iters=iters)
        if device != "cpu":
            torch.cuda.synchronize()
        return field, time.perf_counter() - t0

    ref, ref_s = solve("dual", REF_ITERS, REF_TOL)
    ref_v = ref.evaluate_f(probes).value
    scale = float(np.abs(ref_v).max())
    log(f"reference: dual {ref.solver_stats} in {ref_s:.3f} s")
    rows = []
    for form in ("dual", "primal"):
        for iters in budgets:
            field, sec = solve(form, iters)
            v = field.evaluate_f(probes, grad=True)
            mesh = field.extract_dual_mesh()
            verts = mesh.v[np.unique(mesh.f)]
            verts = verts[(np.abs(verts[:, 0]) < 2.2)
                          & (np.abs(verts[:, 1]) < 2.2)]
            d = np.abs(verts[:, 2] - _height(verts[:, 0], verts[:, 1]))
            gn = np.linalg.norm(v.gradient, axis=1)
            row = {"formulation": form, "budget": iters,
                   "iters": field.solver_stats.iters,
                   "rel_res": field.solver_stats.rel_res,
                   "reconstruct_s": sec, "verts": len(verts),
                   "vert_err": float(d.mean()),
                   "vert_q90": float(np.quantile(d, 0.9)),
                   "probe_dist": float(np.mean(np.abs(v.value)
                                               / np.maximum(gn, 1e-12))),
                   "vs_ref": float(np.abs(v.value - ref_v).max() / scale)}
            log(f"  {form:7s} iters {iters:4d}: vert err mean "
                f"{row['vert_err']:.4f} q90 {row['vert_q90']:.4f} "
                f"({row['verts']} verts); probe |f|/|grad f| "
                f"{row['probe_dist']:.4f}; vs converged dual "
                f"{row['vs_ref']:.3e}; rel_res {row['rel_res']:.3e}; "
                f"{sec:.3f} s")
            rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    rows = run(ap.parse_args().device)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
