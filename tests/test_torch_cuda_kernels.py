"""The CUDA kernels (the AV0 cascade pair and the window) against their
plain PyTorch versions on the card (marker ``cuda``; skipped where there
is no CUDA device).  Run on a machine with the card, where JAX need not
be installed (``--noconftest`` skips the JAX set-up of conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields import lattice_kernels as LK

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _spec(depth):
    dims = ((24, 24, 16), (16, 16, 8), (8, 8, 8), (8, 8, 8))[:depth]
    return LAT.LatticeSpec(dims=dims, k=4, depth=depth, adaptive_depth=1,
                           s_pt=64, p_rows=4, s_gr=32, n_pts_cap=256)


@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(gen, depth, dtype):
    """Forward: exactly equal (pure selection).  Adjoint: rtol 1e-5 and
    atol 1e-5 of the largest output (f32 sums in another order), both
    reading z in ``dtype``.  The launch counters count these launches."""
    spec = _spec(depth)
    xs = [torch.randn((spec.n_cells(d), spec.k), device="cuda",
                      generator=gen) for d in range(depth)]
    z = torch.randn((spec.n_cells(0), spec.lanes), device="cuda",
                    generator=gen).to(dtype)
    before = (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches)
    assert torch.equal(LK.av0_cascade(spec, xs, dtype),
                       LK.av0_cascade_plain(spec, xs, dtype))
    got = LK.av0_adjoint_cascade(spec, z, dtype)
    ref = LK.av0_adjoint_cascade_plain(spec, z, dtype)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))
    assert (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches) == \
        (before[0] + 1, before[1] + 1)


def test_adjoint_pair(gen):
    """<fwd(x), z> == <x, adj(z)> to 1e-5 relative (f64 dot products)."""
    spec = _spec(3)
    xs = [torch.randn((spec.n_cells(d), spec.k), device="cuda",
                      generator=gen) for d in range(spec.depth)]
    z = torch.randn((spec.n_cells(0), spec.lanes), device="cuda",
                    generator=gen)
    lhs = float((LK.av0_cascade(spec, xs, torch.float32).double()
                 * z.double()).sum())
    adj = LK.av0_adjoint_cascade(spec, z, torch.float32)
    rhs = float(sum((a.double() * x.double()).sum()
                    for a, x in zip(adj, xs)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("q", [1, 1000, 1 << 20])
def test_window_kernel_matches_plain(gen, q):
    """The window kernel against its plain version on local offsets that
    reach past the support (|t| up to 2.5): rtol 1e-5 / atol 1e-6, the
    bound of the JAX package's own window test (FMA contraction may move
    an ulp).  The counter counts the launch."""
    from nksr_tpu_torch.ops import window_basis as WB
    x = (torch.rand((q, 8, 3), device="cuda", generator=gen) * 5.0 - 2.5)
    before = WB.window_and_grad_fused.launches
    w, dw = WB.window_and_grad_fused(x)
    torch.cuda.synchronize()
    rw, rdw = WB.window_and_grad_plain(x)
    assert w.shape == (q, 8) and dw.shape == (q, 8, 3)
    torch.testing.assert_close(w, rw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-6)
    assert WB.window_and_grad_fused.launches == before + 1


def test_window_kernel_rejects_bad_input(gen):
    """A CUDA tensor of another shape or type raises instead of falling
    back to the plain version."""
    from nksr_tpu_torch.ops import window_basis as WB
    with pytest.raises(ValueError):
        WB.window_and_grad_fused(torch.zeros((4, 8, 3), device="cuda",
                                             dtype=torch.float64))
    with pytest.raises(ValueError):
        WB.window_and_grad_fused(torch.zeros((4, 3, 8), device="cuda"))
