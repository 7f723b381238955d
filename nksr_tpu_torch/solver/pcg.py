"""Preconditioned conjugate gradients over tuples of tensors
(counterpart of ``nksr_tpu.solver.pcg.pcg``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def _dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]
         ) -> torch.Tensor:
    return sum((x.float() * y.float()).sum() for x, y in zip(a, b))


def pcg(matvec: Callable, b: Tuple[torch.Tensor, ...],
        precond: Optional[Callable] = None, tol: float = 1e-5,
        max_iters: int = 100):
    """Solve M x = b for an SPD ``matvec`` with Jacobi (or no)
    preconditioning; stops early once the relative residual is at most
    ``tol``.  The stopping rule is checked on the host each iteration.
    Returns (x, iters, rel_residual) with python numbers for the last
    two."""
    if precond is None:
        def precond(r):
            return r
    b_norm = torch.sqrt(_dot(b, b)) + 1e-30
    x = tuple(torch.zeros_like(bi) for bi in b)
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    rel = float(torch.sqrt(_dot(r, r)) / b_norm)
    iters = 0
    while iters < max_iters and rel > tol:
        mp = matvec(p)
        alpha = rz / (_dot(p, mp) + 1e-30)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * mi for ri, mi in zip(r, mp))
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / (rz + 1e-30)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        rel = float(torch.sqrt(_dot(r, r)) / b_norm)
        iters += 1
    return x, iters, rel
