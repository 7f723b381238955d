"""The C1 compact-support window and its gradient: a CUDA kernel for
Hopper beside its plain PyTorch version.

``window_and_grad_fused`` replaces the Pallas kernel of the same name
(nksr_tpu/ops/pallas/window_basis.py).  Its CUDA source is
``csrc/window_basis.cu``; the header there says what bounds it (bytes:
224 B a query) and how the design answers that.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback between the two.  The
wrapper counts its kernel launches in ``.launches``.  The kernel is
built at first use (``cuda_build.py``); nothing is compiled when this
module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build as CB

SOURCE = CB.CSRC / "window_basis.cu"


def window_and_grad_plain(x_loc: torch.Tensor):
    """Window ``prod_a (max(0, 1 - t_a^2))^2`` and its gradient wrt
    ``x_loc``: (..., 3) -> (...), (..., 3).  Products in the kernel's
    order, so the two agree bit for bit."""
    u = torch.clamp(1.0 - x_loc * x_loc, min=0.0)
    s = u * u
    du = -4.0 * x_loc * u
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    w = s0 * s1 * s2
    dw = torch.stack([du[..., 0] * s1 * s2, du[..., 1] * s0 * s2,
                      du[..., 2] * s0 * s1], -1)
    return w, dw


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = CB.library("window_basis")
    lib.window_and_grad.restype = ctypes.c_int
    lib.window_and_grad.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p]
    return lib


def window_and_grad_fused(x_loc: torch.Tensor):
    """x_loc (Q, 8, 3) f32 -> (w (Q, 8), dw (Q, 8, 3)).  The kernel has no
    backward: ``x_loc`` is data (offsets of points inside their voxels),
    and an input that requires grad raises rather than lose its
    gradient."""
    if x_loc.requires_grad:
        raise ValueError("window_and_grad_fused: x_loc requires grad, and "
                         "the window kernel has no backward")
    if x_loc.device.type == "cpu":
        return window_and_grad_plain(x_loc)
    q = x_loc.shape[0]
    CB.check_cuda(x_loc, (q, 8, 3), torch.float32, "window_and_grad x_loc",
                  align=4)
    w = torch.empty((q, 8), dtype=torch.float32, device=x_loc.device)
    dw = torch.empty((q, 8, 3), dtype=torch.float32, device=x_loc.device)
    if q == 0:
        return w, dw
    rc = _lib().window_and_grad(
        x_loc.data_ptr(), w.data_ptr(), dw.data_ptr(), q * 8,
        torch.cuda.current_stream(x_loc.device).cuda_stream)
    CB.raise_on(rc, "window_and_grad launch")
    window_and_grad_fused.launches += 1
    return w, dw


window_and_grad_fused.launches = 0
