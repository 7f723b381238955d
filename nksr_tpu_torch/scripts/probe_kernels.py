"""Run every kernel probe and print one ok/FAIL line each.

    python -m nksr_tpu_torch.scripts.probe_kernels [--device cpu]

Counterpart of scripts/probe_mosaic.py and scripts/probe_mosaic_cascade.py.
Each of the 17 probes of ``ops/probes.py`` runs on the TPU script's own
input (``arange``, or ones in the bisect) and on a random one, and its
result is held against its plain version on CPU copies of the inputs.  Then, as the bisect's probes
6-8, the cascade kernels run at its depth-2 and depth-3 specs against their
plain versions.  Exits 1 if any probe fails.

Runs on the card unless given ``--device cpu``; there every wrapper takes
its plain version, so the run rehearses the loop and checks nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from ..fields import lattice as LAT
from ..fields import lattice_kernels as LK
from ..ops import probes as P

# the bisect's cascade specs (scripts/probe_mosaic_cascade.py:132, :141)
CASCADE_DIMS = (((16, 16, 8), (8, 8, 8)),
                ((24, 24, 16), (16, 16, 8), (8, 8, 8)))


def cascade_spec(dims) -> LAT.LatticeSpec:
    return LAT.LatticeSpec(dims=dims, k=4, depth=len(dims), adaptive_depth=1,
                           s_pt=8, p_rows=4, s_gr=8, n_pts_cap=8)


def _probe(p: P.Probe, device: str, rng: np.random.Generator) -> Dict:
    """The probe on ``device`` against its plain version on CPU copies of
    the same inputs."""
    ok, err = True, 0.0
    for kind in ("script", "random"):
        ins = [torch.from_numpy(x) for x in p.inputs(kind, rng)]
        got = p(*[t.to(device) for t in ins])
        good, e = P.agree(got.cpu().numpy(), p.plain(*ins).numpy(), p.exact)
        ok, err = ok and good, max(err, e)
    return {"name": p.name, "ok": ok, "max_abs_err": err}


def _cascade(dims, device: str, rng: np.random.Generator) -> List[Dict]:
    """Forward (exact) and, at depth 2 as in the bisect, the adjoint
    (rtol 1e-5, atol 1e-5 of the largest output) against their plain
    versions, on ones and on random inputs."""
    spec = cascade_spec(dims)
    tag = f"depth-{spec.depth} {'x'.join(map(str, dims[0]))}"
    fwd_ok, fwd_err, adj_ok, adj_err = True, 0.0, True, 0.0
    for kind in ("ones", "random"):
        def make(shape):
            a = (np.ones(shape, np.float32) if kind == "ones" else
                 rng.standard_normal(shape).astype(np.float32))
            return torch.from_numpy(a).to(device)
        xs = [make((spec.n_cells(d), spec.k)) for d in range(spec.depth)]
        got = LK.av0_cascade(spec, xs, torch.float32)
        good, e = P.agree(got.cpu().numpy(), LK.av0_cascade_plain(
            spec, xs, torch.float32).cpu().numpy(), True)
        fwd_ok, fwd_err = fwd_ok and good, max(fwd_err, e)
        if spec.depth == 2:
            z = make((spec.n_cells(0), spec.lanes))
            got = LK.av0_adjoint_cascade(spec, z, torch.float32)
            ref = LK.av0_adjoint_cascade_plain(spec, z, torch.float32)
            for g, r in zip(got, ref):
                good, e = P.agree(g.cpu().numpy(), r.cpu().numpy(), False)
                adj_ok, adj_err = adj_ok and good, max(adj_err, e)
    out = [{"name": f"av0_cascade {tag}", "ok": fwd_ok,
            "max_abs_err": fwd_err}]
    if spec.depth == 2:
        out.append({"name": f"av0_adjoint_cascade {tag}", "ok": adj_ok,
                    "max_abs_err": adj_err})
    return out


def run_probes(device: str, seed: int = 0, log=print) -> List[Dict]:
    """Every probe, then the cascade specs; one record and one printed
    line each.  A probe whose kernel fails to build or launch is a FAIL
    with the error's message."""
    rng = np.random.default_rng(seed)
    results = []
    jobs = [(p.name, lambda p=p: [_probe(p, device, rng)]) for p in P.PROBES]
    jobs += [(f"av0 cascade {d[0]}", lambda d=d: _cascade(d, device, rng))
             for d in CASCADE_DIMS]
    for name, job in jobs:
        try:
            recs = job()
        except (RuntimeError, ValueError) as e:
            recs = [{"name": name, "ok": False, "max_abs_err": float("inf"),
                     "error": f"{type(e).__name__}: {str(e)[:160]}"}]
        for r in recs:
            verdict = ("ok" if r["ok"] else
                       "FAIL" + (f": {r['error']}" if "error" in r else
                                 f" (max abs err {r['max_abs_err']:.3e})"))
            log(f"{r['name']:48s} {verdict}")
        results.extend(recs)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_kernels: no CUDA device (use --device cpu to rehearse)",
              file=sys.stderr)
        return 2
    print(f"== kernel probes on {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})"
             if args.device == "cuda" else ""), flush=True)
    results = run_probes(args.device)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
