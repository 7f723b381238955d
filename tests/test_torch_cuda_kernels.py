"""The CUDA kernels (the AV0 cascade pair and slot rows, the dual's
middle built of them, the window, the fused basis rows and field, the
sorted scatters and the probes)
against their plain PyTorch versions on the card (marker ``cuda``;
skipped where there is no CUDA device).  Run on a
machine with the card, where JAX need not be installed (``--noconftest``
skips the JAX set-up of conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from nksr_tpu_torch.fields import basis_kernels as BK
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields import lattice_kernels as LK
from nksr_tpu_torch.ops import probes as P
from nksr_tpu_torch.ops import sorted_scatter as SS
from nksr_tpu_torch.scripts import time_basis as TB

from test_torch_basis_kernels import CASES as BASIS_CASES
from test_torch_basis_kernels import CASE_IDS as BASIS_IDS
from test_torch_basis_kernels import CELL_VS, cell_queries

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


# the slot-row adjoint's cases (also read by the CPU tests of its tables,
# tests/test_torch_lattice_kernels.py)
ADJ_CASES = ("repeats", "edges", "one_brick", "none")


def adjoint_case(spec, case: str, seed: int = 0) -> np.ndarray:
    """Slot cells (R,) int64 of a slot-row adjoint case, -1 for a dropped
    slot, unsorted: ``repeats`` 600 random cells with a third of the slots
    on five cells and a tenth dropped; ``edges`` the depth-0 cells of the
    last x, y and z planes, each twice, every seventh slot dropped;
    ``one_brick`` 200 slots in the brick at (1, 0, 1) (its cells clipped
    to the lattice) with repeats; ``none`` 50 slots, all dropped."""
    rng = np.random.default_rng(seed)
    x0, y0, z0 = spec.dims[0]
    n0 = spec.n_cells(0)
    if case == "repeats":
        c = rng.integers(0, n0, 600)
        c = np.where(rng.random(600) < 0.33, c % 5 + n0 // 2, c)
        return np.where(rng.random(600) < 0.1, -1, c)
    if case == "edges":
        grid = np.arange(n0).reshape(x0, y0, z0)
        c = np.concatenate([grid[-1].ravel(), grid[:, -1].ravel(),
                            grid[:, :, -1].ravel()])
        c = rng.permutation(np.concatenate([c, c]))
        c[::7] = -1
        return c
    if case == "one_brick":
        lo = [min(8 * b, n - 1) for b, n in zip((1, 0, 1), (x0, y0, z0))]
        hi = [min(lo[a] + 8, n) for a, n in enumerate((x0, y0, z0))]
        xyz = [rng.integers(lo[a], hi[a], 200) for a in range(3)]
        c = np.ravel_multi_index(xyz, (x0, y0, z0))
        c[::3] = c[0]
        return c
    assert case == "none"
    return np.full(50, -1)


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


def _forward_spec(depth, k, z0):
    """Depth-0 dims (13, 7, z0), no multiple of 2^d, each coarser lattice
    one cell past its last ancestor.  z0 = 5 is shorter than the rows of
    one CTA (one run of a z-line); z0 = 67 splits a line into runs of
    unequal length wherever a row is wider than 16 B (at depth 4 and
    k = 4: 34 and 33 cells in bf16, 23, 23 and 21 in f32)."""
    dims = tuple(tuple(((n + (1 << d) - 1) >> d) + (d > 0) for n in
                       (13, 7, z0)) for d in range(depth))
    return LAT.LatticeSpec(dims=dims, k=k, depth=depth, adaptive_depth=1,
                           s_pt=8, p_rows=4, s_gr=8, n_pts_cap=8)


@pytest.mark.parametrize("z0", [5, 67], ids=["short-line", "split-line"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_forward_ragged_specs(gen, depth, k, dtype, z0):
    """The dense forward is bit-equal to its plain version (pure selection
    and one rounding) and to the slot-row kernel over every depth-0 cell
    widened back to f32; two calls are bit-equal and each counts one
    launch."""
    spec = _forward_spec(depth, k, z0)
    xs = [torch.randn((spec.n_cells(d), spec.k), device="cuda",
                      generator=gen) for d in range(depth)]
    before = LK.av0_cascade.launches
    got = LK.av0_cascade(spec, xs, dtype)
    again = LK.av0_cascade(spec, xs, dtype)
    torch.cuda.synchronize()
    assert LK.av0_cascade.launches == before + 2
    assert got.dtype == dtype and got.shape == (spec.n_cells(0), spec.lanes)
    assert torch.equal(got, LK.av0_cascade_plain(spec, xs, dtype))
    assert torch.equal(got, again)
    cells = torch.arange(spec.n_cells(0), dtype=torch.int32, device="cuda")
    assert torch.equal(got.float(), LK.av0_rows(spec, xs, cells, dtype))


def test_forward_rejects_bad_input(gen):
    """A coefficient lattice of the wrong shape, type or device and an
    unsupported output dtype raise instead of falling back to the plain
    version (lines past the kernel's grid: the CPU tests)."""
    spec = _spec(3)
    xs = [torch.zeros((spec.n_cells(d), spec.k), device="cuda")
          for d in range(spec.depth)]
    with pytest.raises(ValueError):
        LK.av0_cascade(spec, xs[:-1] + [xs[-1][:-1]], torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_cascade(spec, xs[:-1] + [xs[-1].double()], torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_cascade(spec, [xs[0]] + [x.cpu() for x in xs[1:]],
                       torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_cascade(spec, xs, torch.float16)


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


def _basis_case(params, **kw):
    depth, k, cb, hidden, layers, cdt, approx = params
    return TB.basis_case(depth, k, cb, hidden, layers, seed=depth + k,
                         n_points=900, compute_dtype=cdt, approx_grad=approx,
                         device="cuda", **kw)


@pytest.mark.parametrize("params", BASIS_CASES, ids=BASIS_IDS)
def test_basis_rows_match_plain(gen, params):
    """The fused row kernel (points, then gradients) against its plain
    version on the same CUDA tensors within ROWS_TOL of the largest |row|
    (the MLP's sums in another order), the row mask equal, two calls
    bit-equal; two launches a call."""
    case = _basis_case(params)
    before = BK.basis_rows.launches
    TB.compare_rows(case.rows, timed=False)
    torch.cuda.synchronize()
    assert BK.basis_rows.launches - before == 4


@pytest.mark.parametrize("grad", [False, True], ids=["value", "grad"])
@pytest.mark.parametrize("params", BASIS_CASES, ids=BASIS_IDS)
def test_basis_field_matches_plain(gen, params, grad):
    """The fused field kernel against its plain version on the same CUDA
    tensors within FIELD_TOL of the largest |output|, the mask equal, two
    calls bit-equal; one launch a call."""
    case = _basis_case(params)
    before = BK.basis_field.launches
    TB.compare_field(case.field(case.queries, grad), timed=False)
    torch.cuda.synchronize()
    assert BK.basis_field.launches - before == 2


def test_lattice_paths_launch_the_basis_kernels(gen, monkeypatch):
    """On CUDA tensors ``assemble_rows`` and the evaluator launch the
    fused kernels and never the plain loops: two row launches a solve's
    rows, one field launch a wave."""
    from nksr_tpu_torch.fields.lattice_eval import LatticeEvalContext

    def fail(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    case = _basis_case(BASIS_CASES[1])
    monkeypatch.setattr(BK, "basis_rows_plain", fail)
    monkeypatch.setattr(BK, "basis_field_plain", fail)
    rows, field = BK.basis_rows.launches, BK.basis_field.launches
    LAT.assemble_rows(*case.rows)
    spec, interp, tab, origins, _, vs, _, approx, cdt = case.field(None,
                                                                  False)
    ctx = LatticeEvalContext(spec, origins, interp, None, None, None, vs,
                             approx, cdt, None, tables=tab)
    v, m = ctx.evaluate(case.queries)
    v3, m3 = ctx.evaluate(case.queries, max_chunk=700)
    _, _, g = ctx.evaluate(case.queries, grad=True)
    torch.cuda.synchronize()
    n = case.queries.shape[0]
    assert BK.basis_rows.launches - rows == 2
    assert BK.basis_field.launches - field == 2 + -(-n // 700)
    assert torch.equal(v, v3) and torch.equal(m, m3) and g.shape == (n, 3)


def test_basis_kernels_reject_bad_input(gen):
    """A CUDA tensor of another shape, type or placement raises instead of
    falling back to the plain version."""
    case = _basis_case(BASIS_CASES[1])
    rows = list(case.rows)
    bad = list(rows)
    bad[2] = [t.to(torch.bfloat16) for t in rows[2]]
    with pytest.raises(ValueError, match="features"):
        BK.basis_rows(*bad)
    bad = list(rows)
    bad[5] = rows[5][:-1]
    with pytest.raises(ValueError, match="pt_cell0"):
        BK.basis_rows(*bad)
    bad = list(rows)
    bad[3] = [t.cpu() for t in rows[3]]
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        BK.basis_rows(*bad)
    args = list(case.field(case.queries, True))
    bad = list(args)
    bad[4] = case.queries.double()
    with pytest.raises(ValueError, match="basis_field x"):
        BK.basis_field(*bad)
    bad = list(args)
    bad[8] = torch.float32
    with pytest.raises(ValueError, match="features"):
        BK.basis_field(*bad)
    bad = list(args)
    bad[4] = case.queries[:, :2].contiguous()
    with pytest.raises(ValueError, match="basis_field x"):
        BK.basis_field(*bad)


def test_evaluator_cells_divide_correctly_on_the_card(gen):
    """At points where ``x * fl(1 / vs)`` floors into the next cell, a
    division by the host scalar does so on the card (CUDA multiplies by
    the reciprocal: the fault the evaluator had), while the evaluator's
    cells, its plain version's and the field kernel's mask are numpy's
    correctly rounded ``floor(x / vs)``."""
    case = TB.basis_case(2, 4, 4, 8, 2, seed=3, n_points=900,
                         voxel_size=CELL_VS, device="cuda")
    q, cells, mask0, want = cell_queries(case, np.random.default_rng(0))
    xq = torch.as_tensor(q, device="cuda")
    assert (torch.floor(xq / CELL_VS).long().cpu().numpy() != cells).any()
    assert np.array_equal(BK.query_cells0(xq, CELL_VS).cpu().numpy(), cells)
    args = list(case.field(xq, False))
    args[2] = args[2]._replace(mask0=mask0.cuda())
    for fn in (BK.basis_field, BK.basis_field_plain):
        _, mask = fn(*args)
        assert np.array_equal(mask.cpu().numpy(), want)


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


RATE_CASES = ["empty", "one-cell", "empty-ends", "ragged-bc", "study",
              "many-cells", "unaligned"]


def _rate_case(case: str, w: int):
    """(idx sorted int32, y (n, w) f32, bc) on the CPU: no rows; every row
    in one cell; empty first and last cells; bc not a multiple of any
    CTA's tile of cells; the study's cap 16384 rows into 8192 cells; a
    table large enough that a thread of the write owns several cells;
    and (with ``_on_card``) rows that are not 16 B aligned."""
    rng = np.random.default_rng(len(case) * 1000 + w)
    bc, n = {"empty": (100, 0), "one-cell": (100, 5000),
             "empty-ends": (1000, 3000), "ragged-bc": (8192 + 13, 16384),
             "study": (8192, 16384), "many-cells": (300_001, 100_000),
             "unaligned": (2053, 4000)}[case]
    lo, hi = (10, bc - 10) if case == "empty-ends" else (0, bc)
    idx = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    if case == "one-cell":
        idx[:] = 37
    return (torch.from_numpy(idx),
            torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)),
            bc)


def _on_card(y: torch.Tensor, case: str) -> torch.Tensor:
    """y on the card; for the "unaligned" case 4 B past a 16 B boundary."""
    if case != "unaligned":
        return y.cuda()
    buf = torch.empty(y.numel() + 1, device="cuda")
    out = buf[1:].view(y.shape)
    out.copy_(y)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("w", [4, 32, 128, 6])
@pytest.mark.parametrize("case", RATE_CASES)
def test_rate_write_equals_cpu_index_add(gen, case, w):
    """Bit for bit CPU ``index_add_`` (rows added in row order from 0.0);
    two calls bit-equal; one launch counted a call."""
    idx, y, bc = _rate_case(case, w)
    ref = torch.zeros((bc, w)).index_add_(0, idx.long(), y)
    ji, yc = idx.cuda(), _on_card(y, case)
    before = SS.scatter_rate_write.launches
    got = SS.scatter_rate_write(ji, yc, bc)
    again = SS.scatter_rate_write(ji, yc, bc)
    torch.cuda.synchronize()
    assert SS.scatter_rate_write.launches == before + 2
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, again)


@pytest.mark.parametrize("w", [4, 32, 128, 6])
@pytest.mark.parametrize("case", RATE_CASES)
def test_rate_read_matches_plain(gen, case, w):
    """Against y[idx].sum(0) on the CPU: rtol 1e-5 and atol 1e-5 of the
    largest output (f32 sums in another order); two calls bit-equal; one
    launch counted a call."""
    idx, y, bc = _rate_case(case, w)
    if bc > len(y):     # a row of y for every cell an index can name
        y = torch.cat([y, torch.from_numpy(np.random.default_rng(w)
                                           .standard_normal((bc - len(y), w))
                                           .astype(np.float32))])
    ref = SS.scatter_rate_read_plain(idx, y)
    ji, yc = idx.cuda(), _on_card(y, case)
    before = SS.scatter_rate_read.launches
    got = SS.scatter_rate_read(ji, yc)
    again = SS.scatter_rate_read(ji, yc)
    torch.cuda.synchronize()
    assert SS.scatter_rate_read.launches == before + 2
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(got, again)


@pytest.mark.parametrize("w", [32, 6])
def test_rate_kernels_drop_indices_outside_the_table(gen, w):
    """Sorted indices with a few below 0 and past the table (CPU
    ``index_add_`` and ``index_select`` raise on them): the kernels give
    the CPU results of the in-range rows alone, the write bit for bit."""
    rng = np.random.default_rng(w)
    bc = 3000
    idx = np.sort(np.concatenate([[-7, -1, -1], rng.integers(0, bc, 5000),
                                  [bc, bc, bc + 9]])).astype(np.int32)
    y = torch.from_numpy(rng.standard_normal((len(idx), w)).astype(
        np.float32))
    keep = torch.from_numpy((idx >= 0) & (idx < bc))
    ti = torch.from_numpy(idx)
    ref = torch.zeros((bc, w)).index_add_(0, ti[keep].long(), y[keep])
    out = SS.scatter_rate_write(ti.cuda(), y.cuda(), bc)
    assert torch.equal(out.cpu(), ref)
    m = 4000                                   # rows of y for the read
    ri = np.sort(np.concatenate([[-3, -1], rng.integers(0, m, 6000),
                                 [m, m + 5]])).astype(np.int32)
    ry = torch.from_numpy(rng.standard_normal((m, w)).astype(np.float32))
    rk = torch.from_numpy((ri >= 0) & (ri < m))
    rref = SS.scatter_rate_read_plain(torch.from_numpy(ri)[rk], ry)
    got = SS.scatter_rate_read(torch.from_numpy(ri).cuda(), ry.cuda())
    torch.testing.assert_close(got.cpu(), rref, rtol=1e-5,
                               atol=1e-5 * float(rref.abs().max()))


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


# ------------------------------------------------ fixed-order segment sum
def _seg_inputs(gen, r, c, t):
    """R rows of C values onto T targets on the card: a third of the rows
    on three hot targets, empty targets, a tenth dropped (-1), values of
    mixed magnitude."""
    idx = torch.randint(0, t, (r,), device="cuda", generator=gen)
    hot = torch.rand(r, device="cuda", generator=gen) < 0.33
    idx = torch.where(hot, idx % 3, idx)
    idx = torch.where(idx % 7 == 4, (idx + 1) % t, idx)
    idx = torch.where(torch.rand(r, device="cuda", generator=gen) < 0.1,
                      -1, idx)
    scale = 10.0 ** torch.randint(-3, 4, (r, 1), device="cuda",
                                  generator=gen)
    vals = torch.randn((r, c), device="cuda", generator=gen) * scale
    return idx, vals


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("r,c,t", [(5000, 1, 700), (20000, 3, 3000),
                                   (8000, 4, 100), (30000, 7, 5000),
                                   (4096, 128, 900), (10, 6, 4)])
def test_segment_sum_matches_plain(gen, r, c, t, compact):
    """The kernel is bit-equal to its plain version, CPU ``index_add_`` in
    index order, on the same inputs (the order built on the card), and
    two calls are bit-equal; only launches count."""
    from nksr_tpu_torch.ops import segment_sum as SEG
    idx, vals = _seg_inputs(gen, r, c, t)
    order = SEG.segment_order(idx, t)
    before = SEG.segment_sum.launches
    got = SEG.segment_sum(vals, order, compact=compact)
    again = SEG.segment_sum(vals, order, compact=compact)
    torch.cuda.synchronize()
    cpu_order = SEG.segment_order(idx.cpu(), t)
    ref = SEG.segment_sum_plain(vals.cpu(), cpu_order, compact=compact)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, again)
    assert SEG.segment_sum.launches == before + 2
    flat = SEG.segment_sum(vals[:, 0].contiguous(), order, compact=compact)
    assert torch.equal(flat.cpu(), SEG.segment_sum_plain(
        vals[:, 0].cpu(), cpu_order, compact=compact))
    assert torch.equal(SEG.index_sum(vals, idx, t).cpu(),
                       SEG.index_sum(vals.cpu(), idx.cpu(), t))


def test_segment_sum_rejects_bad_input(gen):
    """Values of another type or row count, an order on the CPU or with
    int64 positions raise instead of falling back to the plain version."""
    from nksr_tpu_torch.ops import segment_sum as SEG
    idx, vals = _seg_inputs(gen, 100, 4, 20)
    order = SEG.segment_order(idx, 20)
    with pytest.raises(ValueError):
        SEG.segment_sum(vals.double(), order)
    with pytest.raises(ValueError):
        SEG.segment_sum(vals[:-1], order)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        SEG.segment_sum(vals, SEG.segment_order(idx.cpu(), 20))
    with pytest.raises(ValueError):
        SEG.segment_sum(vals, order._replace(perm=order.perm.long()))
    with pytest.raises(ValueError, match="outside"):
        SEG.segment_order(idx.clamp(min=0) + 20, 20)


# the segment sum at the training step's shapes (rows, columns, targets):
# the depth-0 conv's gather backward, the encoder splat, a support
# scatter, a long hot run, the reconstruction's splat (more targets than
# rows: the tile design, at 128-row tiles) and 128-lane rows (the thread
# design), and more targets than rows at the tile design's full 512-row
# tiles, in floats and in float4
STEP_SEG_SHAPES = [(173232, 32, 6417), (64000, 7, 6416), (51200, 4, 2048),
                   (50000, 3, 400), (80000, 7, 90000), (4096, 128, 900),
                   (600000, 7, 2000000), (300000, 4, 1200000)]


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("design", ["thread", "warp", "tile"])
@pytest.mark.parametrize("r,c,t", STEP_SEG_SHAPES)
def test_segment_sum_designs_match_plain(gen, r, c, t, design, compact):
    """Every design of the sum (forced; the wrapper picks one by shape)
    bit-equal to the plain version, CPU ``index_add_`` in index order,
    dense and compact (the tile design dense only), and bit-equal call to
    call."""
    from nksr_tpu_torch.ops import segment_sum as SEG
    how = ("thread", "warp", "tile").index(design)
    if how != SEG.THREAD and (c // 4 if c % 4 == 0 else c) > 32:
        pytest.skip("rows wider than a warp take the thread design")
    if how == SEG.TILE and compact:
        pytest.skip("the tile design writes the dense form")
    idx, vals = _seg_inputs(gen, r, c, t)
    order = SEG.segment_order(idx, t)
    got = SEG._segment_sum(vals, order, compact, force=how)
    again = SEG._segment_sum(vals, order, compact, force=how)
    ref = SEG.segment_sum_plain(vals.cpu(), SEG.segment_order(idx.cpu(), t),
                                compact=compact)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, again)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("r,c,t", STEP_SEG_SHAPES)
def test_segment_sum_backward_matches_plain(gen, r, c, t, compact):
    """The backward kernel (a row gather) bit-equal to its plain version
    and to autograd of CPU ``index_add_``, call to call, one launch."""
    from nksr_tpu_torch.ops import segment_sum as SEG
    idx, vals = _seg_inputs(gen, r, c, t)
    order = SEG.segment_order(idx, t)
    cpu_order = SEG.segment_order(idx.cpu(), t)
    n = order.targets.numel() if compact else t
    cot = torch.randn((n, c), device="cuda", generator=gen)
    before = SEG.segment_sum_backward.launches
    got = SEG.segment_sum_backward(cot, order, compact)
    again = SEG.segment_sum_backward(cot, order, compact)
    assert SEG.segment_sum_backward.launches == before + 2
    ref = SEG.segment_sum_backward_plain(cot.cpu(), cpu_order, compact)
    assert torch.equal(got.cpu(), ref) and torch.equal(got, again)
    v = vals.cpu().requires_grad_()
    (auto,) = torch.autograd.grad(
        SEG.segment_sum(v, cpu_order, compact), v, cot.cpu())
    assert torch.equal(got.cpu(), auto)


def _kernels_of(fn):
    """The device kernels one call of ``fn`` launches (profiler), those
    between two spin kernels: a profile that did not see both spins
    (CUPTI at times drops a profile's first or last events) is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "memcpy" not in e.name.lower()
                        and "memset" not in e.name.lower())
        spins = [i for i, (_, n) in enumerate(events) if "spin" in n.lower()]
        if len(spins) == 2:
            return [n for _, n in events[spins[0] + 1:spins[1]]]
    raise AssertionError("the profiler did not see the call's bounds in "
                         "three profiles")


@pytest.mark.parametrize("r,c,t", STEP_SEG_SHAPES[:2] + STEP_SEG_SHAPES[4:])
def test_segment_sum_is_one_launch(gen, r, c, t):
    """The dense sum and the backward are one kernel each on the device,
    no zero fill beside them."""
    from nksr_tpu_torch.ops import segment_sum as SEG
    idx, vals = _seg_inputs(gen, r, c, t)
    order = SEG.segment_order(idx, t)
    fwd = _kernels_of(lambda: SEG.segment_sum(vals, order))
    cot = torch.randn((t, c), device="cuda", generator=gen)
    bwd = _kernels_of(lambda: SEG.segment_sum_backward(cot, order))
    assert len(fwd) == 1 and "segment_sum" in fwd[0], fwd
    assert len(bwd) == 1 and "gather_rows" in bwd[0], bwd


def test_orders_sums_and_backwards_make_no_host_sync(gen):
    """Building an order (unchecked, as a step does) and a batch of them
    (``segment_orders``), summing over them, a gather's backward through
    ``table_order`` and the segment sum's own backward run under
    ``set_sync_debug_mode("error")``."""
    from nksr_tpu_torch.ops import gather_scatter as gs
    from nksr_tpu_torch.ops import segment_sum as SEG
    r, c, t = STEP_SEG_SHAPES[0]
    idx, vals = _seg_inputs(gen, r, c, t)
    table = idx.reshape(-1, 27)
    src = torch.randn((t, c), device="cuda", generator=gen)
    splat = idx[:64000].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        order = SEG.segment_order(idx, t, check=False)
        out = SEG.segment_sum(vals, order)
        pair = SEG.segment_orders([(idx, t), (splat, t), (table[:9], t)])
        outs = [SEG.segment_sum(v.contiguous(), o) for v, o in
                zip((vals, vals[:64000], vals[:243]), pair)]
        a = src.clone().requires_grad_()
        g = gs.gather_rows(a, table.clamp(min=0), order_idx=table)
        (g * 2.0).sum().backward()
        v = vals[:64000].clone().requires_grad_()
        s = SEG.index_sum(v, splat, t)
        (s * 3.0).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), SEG.segment_sum_plain(
        vals.cpu(), SEG.segment_order(idx.cpu(), t)))
    for o, w, (i, n) in zip(outs, (vals, vals[:64000], vals[:243]),
                            ((idx, t), (splat, t), (table[:9], t))):
        assert torch.equal(o.cpu(), SEG.segment_sum_plain(
            w.cpu(), SEG.segment_order(i.cpu(), n, check=False)))
    b = src.cpu().requires_grad_()
    (b.index_select(0, table.clamp(min=0).reshape(-1).cpu()).reshape(
        *table.shape, c) * torch.where((table >= 0)[..., None].cpu(), 2.0,
                                       0.0)).sum().backward()
    assert torch.equal(a.grad.cpu(), b.grad)
    assert torch.equal(v.grad.cpu(), torch.where(
        (splat >= 0)[:, None].cpu(), 3.0, 0.0).expand(64000, c))


# ---------------------------------------------------- slot-row adjoint
def _slot_cells(spec, gen, r):
    """R sorted slot cells with heavy repeats (a third on a few cells),
    the last x, y and z planes and a run of pad repeats of the last
    cell, as the plan pads its slots."""
    x0, y0, z0 = spec.dims[0]
    grid = torch.arange(spec.n_cells(0), device="cuda").view(x0, y0, z0)
    cells = torch.randint(0, spec.n_cells(0), (r,), device="cuda",
                          generator=gen)
    cells = torch.where(torch.rand(r, device="cuda", generator=gen) < 0.33,
                        cells % 5 + spec.n_cells(0) // 2, cells)
    cells = torch.cat([cells, grid[-1, :, :3].reshape(-1),
                       grid[:3, -1].reshape(-1), grid[:, :3, -1].reshape(-1)])
    cells = torch.sort(cells).values
    return torch.cat([cells, cells[-1:].expand(37)]).to(torch.int32)


def _dense_z0(spec, cells, y):
    """The dense buffer of the chain the slot-row adjoint replaces, built
    on the CPU by ``index_add_`` (index-order sums), back on the card."""
    z0 = torch.zeros((spec.n_cells(0), spec.lanes))
    z0.index_add_(0, cells.cpu().long(), y.cpu())
    return z0.cuda()


@pytest.mark.parametrize("pads", ["summed", "dropped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_adjoint_rows_equals_dense_kernel(gen, depth, k, dtype, pads):
    """``av0_adjoint_rows`` equals PR 5's dense adjoint kernel on the
    buffer CPU ``index_add_`` builds from the same slot rows, bit for bit
    up to the sign of a zero (compared as a + 0.0), in the solve's form
    (bf16) and the Jacobi diagonal's (f32), with the pad slots' rows
    summed or, zero as in the solve, dropped from the tables; it matches
    the plain version to rtol 1e-5 and atol 1e-5 of the largest output
    (the plain cascade sums in another order); two calls are bit-equal;
    the launch counters count it, never the dense adjoint nor the
    segment sum (its sums are folded into its first stage)."""
    spec = _ragged_spec(depth, k)
    cells = _slot_cells(spec, gen, 600)
    y = torch.randn((cells.numel(), spec.lanes), device="cuda",
                    generator=gen)
    kept = cells
    if pads == "dropped":
        kept = cells.clone()
        kept[-37:] = -1
        y[-37:] = 0.0
    tab = LK.adjoint_rows_tables(spec, kept)
    from nksr_tpu_torch.ops import segment_sum as SEG
    before = (LK.av0_adjoint_rows.launches, LK.av0_adjoint_cascade.launches,
              SEG.segment_sum.launches)
    got = LK.av0_adjoint_rows(spec, tab, y, dtype)
    again = LK.av0_adjoint_rows(spec, tab, y, dtype)
    torch.cuda.synchronize()
    assert (LK.av0_adjoint_rows.launches, LK.av0_adjoint_cascade.launches,
            SEG.segment_sum.launches) == (before[0] + 2, before[1],
                                          before[2])
    dense = LK.av0_adjoint_cascade(spec, _dense_z0(spec, cells, y), dtype)
    plain = LK.av0_adjoint_rows_plain(
        spec, LK.adjoint_rows_tables(spec, kept.cpu()), y.cpu(), dtype)
    for g, a, dn, p in zip(got, again, dense, plain):
        assert torch.equal(g, a)
        assert torch.equal(g + 0.0, dn + 0.0)
        torch.testing.assert_close(g.cpu(), p, rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("case", ADJ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_adjoint_rows_cases_equal_dense_kernel(gen, depth, k, dtype, case):
    """On the ragged specs and slot cells whose tables the CPU tests hold
    against numpy (heavy repeats, edge planes, one occupied brick, no
    kept slot; dropped slots hold zero rows, as in the solve): the dense
    kernel's result on the buffer CPU ``index_add_`` builds from all the
    rows, bit for bit up to the sign of a zero, and two calls
    bit-equal."""
    spec = _ragged_spec(depth, k)
    kept = torch.from_numpy(adjoint_case(spec, case)).cuda()
    y = torch.randn((kept.numel(), spec.lanes), device="cuda",
                    generator=gen) * (kept >= 0)[:, None]
    tab = LK.adjoint_rows_tables(spec, kept)
    got = LK.av0_adjoint_rows(spec, tab, y, dtype)
    again = LK.av0_adjoint_rows(spec, tab, y, dtype)
    dense = LK.av0_adjoint_cascade(
        spec, _dense_z0(spec, kept.clamp(min=0), y), dtype)
    assert len(got) == spec.depth
    for g, a, dn in zip(got, again, dense):
        assert torch.equal(g, a)
        assert torch.equal(g + 0.0, dn + 0.0)


@pytest.mark.parametrize("case", ADJ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_gram_middle_equals_dense_chain(gen, depth, k, dtype, case):
    """The dual matvec's middle ``C C^T`` in slot-row space
    (``lattice.gram_middle``: the slot-row adjoint in f32, then the slot
    rows in ``dtype``) equals the literal middle the JAX package runs
    (``_gram_middle``): the dense buffer CPU ``index_add_`` builds from
    the slot rows, the dense adjoint kernel in f32, the dense forward in
    ``dtype``, then the rows at the slot cells; bit for bit up to the
    sign of a zero, two calls bit-equal, one launch of each slot-row
    kernel a call and none of the dense ones."""
    spec = _ragged_spec(depth, k)
    kept = torch.from_numpy(adjoint_case(spec, case)).cuda()
    cells = kept.clamp(min=0).to(torch.int32)
    y = torch.randn((kept.numel(), spec.lanes), device="cuda",
                    generator=gen) * (kept >= 0)[:, None]
    tab = LK.adjoint_rows_tables(spec, kept)
    counted = (LK.av0_adjoint_rows, LK.av0_rows, LK.av0_adjoint_cascade,
               LK.av0_cascade)
    before = [fn.launches for fn in counted]
    got = LAT.gram_middle(spec, tab, y, cells, dtype)
    again = LAT.gram_middle(spec, tab, y, cells, dtype)
    assert [fn.launches - b for fn, b in zip(counted, before)] == \
        [2, 2, 0, 0]
    xs = LK.av0_adjoint_cascade(spec, _dense_z0(spec, cells, y),
                                torch.float32)
    ref = LK.av0_cascade(spec, xs, dtype).index_select(0, cells.long())
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, again)
    assert torch.equal(got + 0.0, ref.float() + 0.0)


def test_adjoint_rows_real_plan_sizes(gen):
    """At the test spec with every 8^3 brick but one empty and all slots
    on one cell: still the dense kernel's result (a + 0.0)."""
    spec = _spec(4)
    for cells in (torch.full((50,), 700, dtype=torch.int32, device="cuda"),
                  torch.tensor([0, spec.n_cells(0) - 1], dtype=torch.int32,
                               device="cuda")):
        y = torch.randn((cells.numel(), spec.lanes), device="cuda",
                        generator=gen)
        tab = LK.adjoint_rows_tables(spec, cells)
        for dt in (torch.float32, torch.bfloat16):
            got = LK.av0_adjoint_rows(spec, tab, y, dt)
            ref = LK.av0_adjoint_cascade(spec, _dense_z0(spec, cells, y), dt)
            assert all(torch.equal(g + 0.0, r + 0.0)
                       for g, r in zip(got, ref))


def test_adjoint_rows_rejects_bad_input(gen):
    """Rows of another type or shape, tables on the CPU, and tables of
    another spec raise instead of falling back to the plain version."""
    spec = _spec(3)
    cells = _slot_cells(spec, gen, 64)
    tab = LK.adjoint_rows_tables(spec, cells)
    y = torch.zeros((cells.numel(), spec.lanes), device="cuda")
    with pytest.raises(ValueError):
        LK.av0_adjoint_rows(spec, tab, y.to(torch.bfloat16), torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_adjoint_rows(spec, tab, y[:, :-4], torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_adjoint_rows(spec, LK.adjoint_rows_tables(spec, cells.cpu()),
                            y, torch.bfloat16)
    with pytest.raises(ValueError):
        LK.av0_adjoint_rows(_spec(4), tab, y, torch.float32)
    with pytest.raises(ValueError):
        LK.av0_adjoint_rows(spec, tab, y, torch.float16)


# ------------------------------------- reproducible scatters on the routes
def test_support_scatter_rows_reproducible(gen):
    """Route B's matvec scatter: two calls of ``support.scatter_rows`` on
    the card, with the solve's orders and without, are bit-equal, and the
    value rows equal the CPU's index-order sums exactly (their per-row
    products are exact in both places)."""
    from nksr_tpu_torch.fields import support as S
    q, c, k = 20000, 3000, 4
    idx = torch.randint(0, c, (q, 8), device="cuda", generator=gen)
    idx = torch.where(idx % 11 == 0, -1, idx % 400)     # heavy repeats
    sup = [S.DepthSupport(S._expand_idx(idx, k),
                          torch.randn((q, 8 * k), device="cuda",
                                      generator=gen),
                          torch.randn((q, 3 * 8 * k), device="cuda",
                                      generator=gen), k)]
    shapes = [(c, k)]
    r1 = torch.randn(q, device="cuda", generator=gen)
    r3 = torch.randn((q, 3), device="cuda", generator=gen)
    orders = S.scatter_orders(sup, shapes)
    for grad, r in ((False, r1), (True, r3)):
        a = S.scatter_rows(sup, shapes, r, grad=grad, orders=orders)
        b = S.scatter_rows(sup, shapes, r, grad=grad)
        assert torch.equal(a[0], b[0])
    cpu = [S.DepthSupport(*(t.cpu() if torch.is_tensor(t) else t
                            for t in sup[0]))]
    assert torch.equal(S.scatter_rows(sup, shapes, r1)[0].cpu(),
                       S.scatter_rows(cpu, shapes, r1.cpu())[0])


def test_sparse_encoder_reproducible(gen):
    """The gather-conv UNet's point encoder splats through the segment
    sum: two calls on the card are bit-equal."""
    from nksr_tpu_torch.models import pipeline as P
    from nksr_tpu_torch.models import sparse_unet as SU
    from nksr_tpu_torch.models.network import NKSRNetwork
    from nksr_tpu_torch.ops import segment_sum as SEG
    cfg = P.PipelineConfig(tree_depth=2, f_maps=8)
    net = NKSRNetwork(cfg).cuda().eval()
    n, n0 = 20000, 500
    xyz = torch.rand((n, 3), device="cuda", generator=gen) * 2.0
    feat = torch.randn((n, 3), device="cuda", generator=gen)
    idx = torch.randint(0, n0, (n, 8), device="cuda", generator=gen)
    idx = torch.where(idx % 13 == 0, -1, idx)
    before = SEG.segment_sum.launches
    with torch.no_grad():
        a = SU.encode_points(cfg, net, n0, xyz, feat, idx)
        b = SU.encode_points(cfg, net, n0, xyz, feat, idx)
    assert torch.equal(a, b)
    assert SEG.segment_sum.launches == before + 2


def test_knn_on_the_card_matches_its_cpu_run(gen):
    """The normal-estimation preprocess's kNN (plain PyTorch, no hand
    kernel: the JAX package has none there) on the card: neighbour sets
    and squared distances equal to its run on CPU tensors, on a terrain
    with an overfilled bucket, in several waves; the keep masks equal
    away from the 85-degree cut."""
    from nksr_tpu_torch.ops import knn as K
    rng = np.random.default_rng(3)
    xy = rng.uniform(-4, 4, (200000, 2))
    z = 0.3 * np.sin(1.5 * xy[:, 0]) * np.cos(xy[:, 1])
    xyz = np.concatenate([np.concatenate([xy, z[:, None]], 1),
                          0.3 + rng.uniform(0, 0.01, (80, 3))]
                         ).astype(np.float32)
    sens = np.zeros_like(xyz)
    sens[:, 2] = 0.8
    cs = K.estimate_cell_size(xyz, 64)
    out = []
    for dev in ("cuda", "cpu"):
        x = torch.as_tensor(xyz, device=dev)
        idx, d2 = K.knn_search(K.build_buckets(x, cs, 14), x, x, 64)
        nrm, keep = K.estimate_normals(x, 64, cs, 14,
                                       sensor=torch.as_tensor(sens,
                                                              device=dev))
        out.append([t.cpu() for t in (torch.sort(idx, 1).values, d2, nrm,
                                      keep)])
    (gi, gd, gn, gk), (ci, cd, cn, ck) = out
    assert torch.equal(gi, ci) and torch.equal(gd, cd)
    view = torch.as_tensor(sens - xyz)
    cos = (view / view.norm(dim=1, keepdim=True) * cn).sum(1).abs()
    away = (cos - np.cos(np.deg2rad(85.0))).abs() > 1e-4
    assert torch.equal(gk[away], ck[away]) and 0 < int((~ck).sum())
