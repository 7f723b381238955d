"""Preconditioned conjugate gradients over tuples of tensors
(counterpart of nksr_tpu/solver/pcg.py): ``pcg`` and the implicitly
differentiated ``solve_spd``."""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import torch


def _dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]
         ) -> torch.Tensor:
    return sum((x.float() * y.float()).sum() for x, y in zip(a, b))


def pcg(matvec: Callable, b: Tuple[torch.Tensor, ...],
        precond: Optional[Callable] = None, tol: float = 1e-5,
        max_iters: int = 100, dot: Callable = _dot):
    """Solve M x = b for an SPD ``matvec`` with Jacobi (or no)
    preconditioning; stops early once the relative residual is at most
    ``tol``.  The stopping rule is checked on the host each iteration.
    ``dot``: the inner product of two tuples (the sharded solve sums its
    slabs' with an ``all_reduce``, so every rank stops at one iteration).
    Returns (x, iters, rel_residual) with python numbers for the last
    two."""
    if precond is None:
        def precond(r):
            return r
    b_norm = torch.sqrt(dot(b, b)) + 1e-30
    x = tuple(torch.zeros_like(bi) for bi in b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    rel = float(torch.sqrt(dot(r, r)) / b_norm)
    iters = 0
    while iters < max_iters and rel > tol:
        mp = matvec(p)
        alpha = rz / (dot(p, mp) + 1e-30)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * mi for ri, mi in zip(r, mp))
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / (rz + 1e-30)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        rel = float(torch.sqrt(dot(r, r)) / b_norm)
        iters += 1
    return x, iters, rel


class _SolveSPD(torch.autograd.Function):
    """x = A^-1 b by PCG, differentiated implicitly: the backward solves
    A lam = x_bar by one more PCG (same preconditioner, tol and
    iteration cap; A is symmetric), then b_bar = lam and the operator's
    tensors get -lam^T d(A x)/d(theta), the matvec differentiated at the
    detached solution, or the sum of ``parts``' gradients, one part's
    graph at a time.  The preconditioner is a constant."""

    @staticmethod
    def forward(ctx, matvec, precond, tol, max_iters, parts, n_rhs,
                *tensors):
        rhs, op = tensors[:n_rhs], tensors[n_rhs:]
        t0 = time.perf_counter()
        with torch.no_grad():
            x, iters, rel = pcg(lambda a: matvec(a, *op), tuple(rhs),
                                precond=precond, tol=tol,
                                max_iters=max_iters)
        solve_spd.last_seconds = time.perf_counter() - t0
        ctx.matvec, ctx.precond, ctx.parts = matvec, precond, parts
        ctx.tol, ctx.max_iters, ctx.n = tol, max_iters, len(x)
        ctx.stats = [(iters, rel)]
        ctx.save_for_backward(*x, *op)
        solve_spd.last_stats = (iters, rel)
        return tuple(x)

    @staticmethod
    def backward(ctx, *x_bar):
        saved = ctx.saved_tensors
        x, op = saved[:ctx.n], saved[ctx.n:]
        t0 = time.perf_counter()
        with torch.no_grad():
            lam, iters, rel = pcg(lambda a: ctx.matvec(a, *op), tuple(x_bar),
                                  precond=ctx.precond, tol=ctx.tol,
                                  max_iters=ctx.max_iters)
        solve_spd.last_backward_seconds = time.perf_counter() - t0
        solve_spd.last_backward_stats = (iters, rel)
        first = 6 + ctx.n       # the operator's first input
        need = [i for i in range(len(op)) if ctx.needs_input_grad[first + i]]
        op_bar = [None] * len(op)
        if need:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(i in need)
                          for i, t in enumerate(op)]
                wrt = [leaves[i] for i in need]
                xd = tuple(xi.detach() for xi in x)
                if ctx.parts is None:
                    grads = torch.autograd.grad(
                        ctx.matvec(xd, *leaves), wrt, grad_outputs=lam,
                        allow_unused=True)
                else:
                    grads = [None] * len(need)
                    for s in ctx.parts(xd, lam, *leaves):
                        if not s.requires_grad:   # no needed input in it
                            continue
                        for j, g in enumerate(torch.autograd.grad(
                                s, wrt, allow_unused=True)):
                            if g is not None:
                                grads[j] = g if grads[j] is None \
                                    else grads[j] + g
            for i, g in zip(need, grads):
                op_bar[i] = None if g is None else -g
        return (None,) * 6 + tuple(lam) + tuple(op_bar)


def solve_spd(matvec: Callable, b: Tuple[torch.Tensor, ...],
              op: Sequence[torch.Tensor] = (),
              precond: Optional[Callable] = None, tol: float = 1e-5,
              max_iters: int = 100, parts: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, ...]:
    """Differentiable SPD solve (``nksr_tpu.solver.pcg.solve_spd``, i.e.
    ``lax.custom_linear_solve(..., symmetric=True)``): forward PCG,
    backward one more PCG on the cotangent.  ``matvec(a, *op)`` must be
    linear in ``a``; the tensors ``op`` it reads are the operator's
    differentiable inputs (e.g. the support rows, or the tensors they
    are built from), so their gradients flow on to whatever built them
    (or into the ``.grad`` of those that are leaves).  ``parts(x, lam,
    *op)``, if given, yields scalars that sum to lam^T A(op) x, each
    built from a part of the operator: the backward differentiates them
    one by one instead of the whole matvec, so only one part's graph is
    alive at a time.  ``solve_spd.last_stats`` holds the
    forward's (iters, rel_residual), ``last_backward_stats`` the
    backward's; ``last_seconds`` and ``last_backward_seconds`` the two
    PCGs' host seconds (each reads its residual on the host every
    iteration, so the device is drained when it returns)."""
    return _SolveSPD.apply(matvec, precond, tol, max_iters, parts, len(b),
                           *b, *op)


solve_spd.last_stats = None
solve_spd.last_backward_stats = None
solve_spd.last_seconds = None
solve_spd.last_backward_seconds = None
