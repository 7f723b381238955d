"""The CUDA kernels (the AV0 cascade pair and slot rows, the window, the
sorted scatters and the probes) against their plain PyTorch versions on
the card (marker ``cuda``; skipped where there is no CUDA device).  Run on a
machine with the card, where JAX need not be installed (``--noconftest``
skips the JAX set-up of conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields import lattice_kernels as LK
from nksr_tpu_torch.ops import probes as P
from nksr_tpu_torch.ops import sorted_scatter as SS

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


def _ragged_spec(depth, k):
    """Depth-0 dims that are no multiple of the adjoint's 8^3 brick, each
    coarser lattice one cell past its last ancestor."""
    dims = tuple(tuple(((n + (1 << d) - 1) >> d) + (d > 0) for n in
                       (20, 12, 10)) for d in range(depth))
    return LAT.LatticeSpec(dims=dims, k=k, depth=depth, adaptive_depth=1,
                           s_pt=8, p_rows=4, s_gr=8, n_pts_cap=8)


# (buffer dtype, compute dtype): the solve's matvec and right-hand side,
# the kernel table's bf16 buffer, the Jacobi diagonal
FORMS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.float32)]
FORM_IDS = ["f32-read-bf16", "bf16", "f32"]


def _check_adjoint(spec, z, cdt):
    """Adjoint kernel against its plain version: rtol 1e-5 and atol 1e-5
    of the largest output (f32 sums in another order); a second call is
    bit-equal to the first (no atomics, a fixed summation order)."""
    got = LK.av0_adjoint_cascade(spec, z, cdt)
    ref = LK.av0_adjoint_cascade_plain(spec, z, cdt)
    assert len(got) == spec.depth
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))
    again = LK.av0_adjoint_cascade(spec, z, cdt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_kernels_match_plain(gen, depth, form):
    """Forward: exactly equal (pure selection), in the compute dtype.
    Adjoint: rtol 1e-5 and atol 1e-5 of the largest output (f32 sums in
    another order), reading the buffer in the compute dtype, and bit-equal
    from call to call.  The launch counters count these launches."""
    zdt, cdt = form
    spec = _spec(depth)
    xs = [torch.randn((spec.n_cells(d), spec.k), device="cuda",
                      generator=gen) for d in range(depth)]
    z = torch.randn((spec.n_cells(0), spec.lanes), device="cuda",
                    generator=gen).to(zdt)
    before = (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches)
    assert torch.equal(LK.av0_cascade(spec, xs, cdt),
                       LK.av0_cascade_plain(spec, xs, cdt))
    _check_adjoint(spec, z, cdt)
    assert (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches) == \
        (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_adjoint_ragged_specs(gen, depth, k):
    """Every depth the wrapper accepts up to 5 (depth 5 takes the brick
    partials' loop) and every kernel dim, on depth-0 dims (20, 12, 10)
    that no brick divides: the three input forms against the plain
    version, as in ``_check_adjoint`` (rtol 1e-5, atol 1e-5 of the
    largest output; bit-equal from call to call)."""
    spec = _ragged_spec(depth, k)
    z = torch.randn((spec.n_cells(0), spec.lanes), device="cuda",
                    generator=gen)
    for zdt, cdt in FORMS:
        _check_adjoint(spec, z.to(zdt), cdt)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", [_spec(3), _ragged_spec(5, 2)],
                         ids=["depth3", "ragged-depth5"])
def test_adjoint_pair(gen, spec, cdt):
    """<fwd(x), z> == <x, adj(z)> to 1e-5 relative (f64 dot products).
    With a bf16 compute dtype the adjoint reads the f32 buffer rounded to
    bf16, so the pair holds for that rounded z."""
    xs = [torch.randn((spec.n_cells(d), spec.k), device="cuda",
                      generator=gen) for d in range(spec.depth)]
    z = torch.randn((spec.n_cells(0), spec.lanes), device="cuda",
                    generator=gen)
    lhs = float((LK.av0_cascade(spec, xs, torch.float32).double()
                 * z.to(cdt).double()).sum())
    adj = LK.av0_adjoint_cascade(spec, z, cdt)
    rhs = float(sum((a.double() * x.double()).sum()
                    for a, x in zip(adj, xs)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_adjoint_rejects_bad_input(gen):
    """A CUDA buffer of another dtype or shape raises instead of falling
    back to the plain version."""
    spec = _spec(3)
    z = torch.zeros((spec.n_cells(0), spec.lanes), device="cuda")
    with pytest.raises(ValueError):
        LK.av0_adjoint_cascade(spec, z.half(), torch.float32)
    with pytest.raises(ValueError):
        LK.av0_adjoint_cascade(spec, z[:, :-4], torch.bfloat16)


def _row_cells(spec, gen):
    """Random depth-0 cells, every cell on the last x, y and z planes and
    repeats of them, in a random (unsorted) order, as int32 on the card."""
    x0, y0, z0 = spec.dims[0]
    grid = torch.arange(spec.n_cells(0), device="cuda").view(x0, y0, z0)
    cells = torch.cat([
        torch.randint(0, spec.n_cells(0), (500,), device="cuda",
                      generator=gen),
        grid[-1].reshape(-1), grid[:, -1].reshape(-1),
        grid[:, :, -1].reshape(-1)])
    cells = torch.cat([cells, cells[:64]])
    perm = torch.randperm(len(cells), device="cuda", generator=gen)
    return cells[perm].to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_rows_kernel_matches_plain(gen, depth, k, dtype):
    """The slot-row kernel is bit-equal to its plain version (pure
    selection and one rounding) on the ragged depth-0 dims (20, 12, 10):
    random cells, edge planes, duplicates, an unsorted order, R = 0, and
    cells outside the lattice (zero rows).  Only launches count."""
    spec = _ragged_spec(depth, k)
    xs = [torch.randn((spec.n_cells(d), spec.k), device="cuda",
                      generator=gen) for d in range(depth)]
    cells = _row_cells(spec, gen)
    before = LK.av0_rows.launches
    got = LK.av0_rows(spec, xs, cells, dtype)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, LK.av0_rows_plain(spec, xs, cells, dtype))
    assert torch.equal(got, LK.av0_cascade_plain(spec, xs, dtype)[
        cells.long()].float())
    empty = LK.av0_rows(spec, xs, cells[:0], dtype)
    assert empty.shape == (0, spec.lanes)
    bad = torch.tensor([-1, spec.n_cells(0), 0], dtype=torch.int32,
                       device="cuda")
    out = LK.av0_rows(spec, xs, bad, dtype)
    assert torch.equal(out, LK.av0_rows_plain(spec, xs, bad, dtype))
    assert not out[:2].any()
    assert LK.av0_rows.launches == before + 2


def test_rows_kernel_rejects_bad_input(gen):
    """int64 or non-contiguous cells, a coefficient lattice of the wrong
    shape or on the CPU, and an unsupported dtype raise instead of
    falling back to the plain version."""
    spec = _spec(3)
    xs = [torch.zeros((spec.n_cells(d), spec.k), device="cuda")
          for d in range(spec.depth)]
    cells = torch.arange(64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        LK.av0_rows(spec, xs, cells.long(), torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_rows(spec, xs, cells[::2], torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_rows(spec, xs[:-1] + [xs[-1][:-1]], cells, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_rows(spec, xs, cells.cpu(), torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_rows(spec, xs, cells, torch.float16)


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


@pytest.mark.parametrize("dup", [False, True], ids=["unique", "dup"])
@pytest.mark.parametrize("w", [32, 128])
def test_scatter_kernels_match_plain(gen, w, dup):
    """The three sorted-scatter kernels against their plain versions:
    exact for unique indices (one row a cell), else rtol 1e-5 and atol
    1e-5 of the largest output (f32 sums in another order).  The blocked
    kernel at the card's block size and at a tile near the shared-memory
    limit; each counter counts its launches."""
    rng = np.random.default_rng(0)
    c0, s = 100_003, 8192
    idx = (np.sort(rng.integers(0, c0 // 8, s)) if dup else
           np.sort(rng.choice(c0, s, replace=False))).astype(np.int32)
    y = torch.from_numpy(rng.standard_normal((s, w)).astype(np.float32)
                         ).cuda()
    ji = torch.from_numpy(idx).cuda()
    before = SS.blocked_sorted_scatter.launches
    for bc in (SS.card_block_cells(w), SS.MAX_TILE_BYTES // (4 * w)):
        starts = torch.from_numpy(SS.block_starts(idx, c0, bc)).cuda()
        got = SS.blocked_sorted_scatter(y, ji, starts, c0, bc)
        ref = SS.blocked_sorted_scatter_plain(y, ji, starts, c0, bc)
        if dup:
            torch.testing.assert_close(got, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))
        else:
            assert torch.equal(got, ref)
    assert SS.blocked_sorted_scatter.launches == before + 2
    r_idx = torch.from_numpy(np.sort(rng.integers(0, 2048, 4096)).astype(
        np.int32)).cuda()
    ry = torch.randn((4096, w), device="cuda", generator=gen)
    for got, ref in ((SS.scatter_rate_write(r_idx, ry, 2048),
                      SS.scatter_rate_write_plain(r_idx, ry, 2048)),
                     (SS.scatter_rate_read(r_idx, ry),
                      SS.scatter_rate_read_plain(r_idx, ry))):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def test_scatter_kernels_reject_bad_input(gen):
    y = torch.zeros((16, 6), device="cuda")
    idx = torch.zeros((16,), dtype=torch.int32, device="cuda")
    starts = torch.tensor([0, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):          # w not a multiple of 4
        SS.blocked_sorted_scatter(y, idx, starts, 16, 16)
    with pytest.raises(ValueError):          # int64 indices
        SS.scatter_rate_write(idx.long(), y, 16)
    with pytest.raises(ValueError):          # tile over shared memory
        SS.blocked_sorted_scatter(torch.zeros((16, 128), device="cuda"),
                                  idx, starts, 16, 1024)


@pytest.mark.parametrize("key", [p.key for p in P.PROBES])
def test_probe_kernel_matches_plain(gen, key):
    """Each probe kernel on its script's input and a random one, against
    its plain version on the card and on the CPU; the counter counts
    both."""
    p = next(p for p in P.PROBES if p.key == key)
    rng = np.random.default_rng(0)
    before = p.launches
    for kind in ("script", "random"):
        ins = p.inputs(kind, rng)
        cu = [torch.from_numpy(x).cuda() for x in ins]
        got = p(*cu)
        torch.cuda.synchronize()
        assert P.agree(got.cpu().numpy(), p.plain(*cu).cpu().numpy(),
                       p.exact)[0], kind
        assert P.agree(got.cpu().numpy(), p.plain(*map(
            torch.from_numpy, ins)).numpy(), p.exact)[0], kind
    assert p.launches == before + 2


def test_probe_kernels_reject_bad_input(gen):
    with pytest.raises(ValueError):
        P.PROBES[0](torch.zeros((32, 256), device="cuda"))
