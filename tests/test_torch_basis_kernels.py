"""The fused basis kernels' plain versions and contracts on the CPU
(``nksr_tpu_torch/fields/basis_kernels.py``, ``csrc/basis_eval.cu``).

A numpy emulation of each kernel's per-thread order (the correctly
rounded offsets, the MLP read from the packed weights in the kernel's
FMA order, the window as ``csrc/window_basis.cu`` rounds it, the corner
sum in the shuffles' tree order) is held against the plain versions at
small specs, within the tolerance ``chip_smoke.py`` holds the kernels to
on the card (``scripts/time_basis.ROWS_TOL`` / ``FIELD_TOL``: the MLP's
sums in another order).  The packing, the dispatch (a CPU call launches
nothing, a non-CPU tensor never takes the plain version), the refusal of
inputs that require grad, the shape and dtype checks, and the evaluator's
cells at points where a division by the voxel size's reciprocal floors
into the wrong cell.  The kernels themselves run in the ``cuda`` cases of
``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from nksr_tpu_torch.fields import basis_kernels as BK
from nksr_tpu_torch.scripts import time_basis as TB

F32 = np.float32
# (depth, k, basis width, hidden width, hidden layers, tables' dtype,
# approx_kernel_grad): hidden 8 and 20 pad to 16 and 32, basis width 6
# takes the kernels' scalar feature loads
CASES = [(2, 2, 4, 8, 1, torch.float32, False),
         (3, 4, 8, 16, 2, torch.bfloat16, False),
         (3, 4, 6, 20, 2, torch.float32, True),
         (2, 8, 8, 8, 2, torch.bfloat16, False)]
CASE_IDS = ["d2k2", "d3k4-bf16", "d3k4-scalar-approx", "d2k8-bf16"]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    depth, k, cb, hidden, layers, cdt, approx = request.param
    return TB.basis_case(depth, k, cb, hidden, layers, seed=depth + k,
                         n_points=900, compute_dtype=cdt,
                         approx_grad=approx)


# ------------------------------------------------------- the emulation
def _fma(a, b, c):
    """f32 fused multiply-add (the f64 product is exact; one rounding of
    the sum to f64, then to f32)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def emulate_mlp(packed, d, z, feat, tan):
    """The kernel's ``mlp``: (..., 3) offsets and (..., cb) features ->
    raw (..., k) and, when ``tan``, [d raw / d z_a (..., k)] * 3."""
    buf = packed.buf.numpy()[d * packed.stride:(d + 1) * packed.stride]
    lay, _ = BK._layout(packed.dims, packed.hidden)
    H, cb = packed.hidden, packed.dims[0] - 3
    (o0, n_in, _), *mid, (oo, _, k) = lay
    w0 = buf[o0:o0 + n_in * H].reshape(n_in, H)
    h = np.broadcast_to(buf[o0 + n_in * H:o0 + n_in * H + H],
                        z.shape[:-1] + (H,)).astype(F32)
    for a in range(3):
        h = _fma(w0[a], z[..., a:a + 1], h)
    for i in range(cb):
        h = _fma(w0[3 + i], feat[..., i:i + 1], h)
    t = [np.broadcast_to(w0[a], h.shape).astype(F32) for a in range(3)]
    for off in [m[0] for m in mid] + [None]:
        s = (F32(1) / (F32(1) + np.exp(-h))).astype(F32)
        ds = s * (F32(1) + h * (F32(1) - s))
        h = h * s
        t = [ds * ta for ta in t]
        if off is None:
            break
        wt = buf[off:off + H * H].reshape(H, H)
        h2 = np.broadcast_to(buf[off + H * H:off + H * H + H],
                             h.shape).astype(F32)
        t2 = [np.zeros_like(h) for _ in range(3)]
        for i in range(H):
            h2 = _fma(wt[i], h[..., i:i + 1], h2)
            t2 = [_fma(wt[i], ta[..., i:i + 1], t2a)
                  for ta, t2a in zip(t, t2)]
        h, t = h2, t2
    wo = buf[oo:oo + H * k].reshape(H, k)
    o = np.broadcast_to(buf[oo + H * k:oo + H * k + k],
                        h.shape[:-1] + (k,)).astype(F32)
    dr = [np.zeros_like(o) for _ in range(3)]
    for i in range(H):
        o = _fma(wo[i], h[..., i:i + 1], o)
        if tan:
            dr = [_fma(wo[i], ta[..., i:i + 1], da) for ta, da in zip(t, dr)]
    return F32(1) + o, dr


def emulate_window(z):
    """The window and its gradient, each product rounded in the kernel's
    (and ``window_grad``'s) order."""
    u = np.maximum(F32(1) - z * z, F32(0))
    s = u * u
    du = (F32(-4) * z) * u
    w = (s[..., 0] * s[..., 1]) * s[..., 2]
    dw = np.stack([(du[..., a] * s[..., (a + 1) % 3]) * s[..., (a + 2) % 3]
                   for a in range(3)], -1)
    return w, dw


def _offsets(x, cells, vs_d):
    """The kernel's z0: x / vs_d correctly rounded, minus the cell, minus
    the corner offset, each difference rounded."""
    return (x / F32(vs_d))[:, None, :] - cells.astype(F32)[:, None, :] \
        - BK.CORNER_OFFS


def _corners(spec, d, cells):
    return cells[:, None] + np.asarray(spec.corner_strides(d))


def emulate_rows(case):
    """``basis_rows`` as the kernel computes it, thread by thread."""
    (spec, interp, fdp, adp, xyz, c0, dest, slots_pt, coords, gdepth,
     active, slots_gr, vs, approx) = case.rows
    packed = BK.pack_mlps(interp, spec.depth)
    k, lanes = spec.k, spec.lanes
    x, c0, dest = xyz.numpy(), c0.numpy(), dest.numpy()
    slot = dest % spec.s_pt
    row = slot * spec.p_rows + dest // spec.s_pt
    b_pt = np.zeros((spec.s_pt * spec.p_rows, lanes), F32)
    coords, gd = coords.numpy(), gdepth.numpy()
    scale = (F32(vs) * np.exp2(gd).astype(F32))[:, None]
    xg = coords.astype(F32) * scale
    am = active.numpy().astype(F32)[:, None, None]
    b_gr = np.zeros((spec.s_gr, 3, lanes), F32)
    for d in range(spec.depth):
        vs_d = F32(vs) * F32(2 ** d)
        lo, hi = d * 8 * k, (d + 1) * 8 * k
        fd, ad = fdp[d].numpy(), adp[d].numpy()[:, 0]
        z = _offsets(x, c0 >> d, vs_d)
        r = _corners(spec, d, slots_pt.numpy()[d, slot])
        raw, _ = emulate_mlp(packed, d, z, fd[r], False)
        w, _ = emulate_window(z)
        b_pt[row, lo:hi] = (raw * (w * ad[r])[..., None]).reshape(-1, 8 * k)
        rel = (gd - d)[:, None]
        cell = np.where(rel >= 0, coords << np.maximum(rel, 0),
                        coords >> np.maximum(-rel, 0))
        z = _offsets(xg, cell, vs_d)
        r = _corners(spec, d, slots_gr.numpy()[d])
        act = ad[r]
        raw, dr = emulate_mlp(packed, d, z, fd[r], not approx)
        w, dw = emulate_window(z)
        wa = (w * act)[..., None]
        for a in range(3):
            db = raw * (dw[..., a] * act)[..., None]
            if not approx:
                db = db + dr[a] * wa
            b_gr[:, a, lo:hi] = (db / vs_d).reshape(-1, 8 * k)
    b_gr *= am
    return b_pt.reshape(spec.s_pt, spec.p_rows, lanes), b_gr


def _tree(s):
    """The 8 corners' sum as lane 0 of the xor shuffles (4, 2, 1) adds
    it: ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))."""
    t = [s[:, c] + s[:, c + 4] for c in range(4)]
    return (t[0] + t[2]) + (t[1] + t[3])


def _as_tables(t):
    return t.float().numpy()


def emulate_field(case, x, grad):
    """``basis_field`` as the kernel computes it, thread by thread."""
    (spec, interp, tab, origins, _, vs, _, approx, cdt) = case.field(x, grad)
    packed = BK.pack_mlps(interp, spec.depth)
    k = spec.k
    tan = grad and not approx
    x = x.numpy()
    c0 = np.floor(x / F32(vs)).astype(np.int64)
    cells = []
    for d in range(spec.depth):
        dims = np.asarray(spec.dims[d])
        loc = (c0 >> d) - origins[d].astype(np.int64)
        ok = ((loc >= 0) & (loc < dims)).all(-1)
        flat = (loc[:, 0] * dims[1] + loc[:, 1]) * dims[2] + loc[:, 2]
        cells.append(np.where(ok, flat, 0))
    av0 = _as_tables(tab.av0)
    v = np.zeros(len(x), F32)
    g = np.zeros((len(x), 3), F32)
    for d in range(spec.depth):
        vs_d = F32(vs) * F32(2 ** d)
        z = _offsets(x, c0 >> d, vs_d)
        zr = torch.from_numpy(z).to(cdt).float().numpy()
        feat = _as_tables(tab.fdp[d])[_corners(spec, d, cells[d])]
        raw, dr = emulate_mlp(packed, d, zr, feat, tan)
        w, dw = emulate_window(z)
        av = av0[cells[0], d * 8 * k:(d + 1) * 8 * k].reshape(-1, 8, k)
        sv = np.zeros((len(x), 8), F32)
        sg = [np.zeros((len(x), 8), F32) for _ in range(3)]
        for kk in range(k):
            sv = sv + (raw[..., kk] * w) * av[..., kk]
            for a in range(3):
                db = raw[..., kk] * dw[..., a]
                if tan:
                    db = db + dr[a][..., kk] * w
                sg[a] = sg[a] + db * av[..., kk]
        v = v + _tree(sv)
        for a in range(3):
            g[:, a] = g[:, a] + _tree(sg[a]) / vs_d
    mask = tab.mask0.numpy()[cells[0]]
    return v, mask, g


def _within(got, ref, tol):
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, tol)


# ------------------------------------------------------------- the tests
def test_rows_emulation_matches_plain(case):
    """The point and gradient rows of the kernel's per-thread order
    within ROWS_TOL of the largest |row| of the plain version's (the
    MLP's sums in FMA order against F.linear's)."""
    b_pt, m_pt, b_gr = BK.basis_rows_plain(*case.rows)
    e_pt, e_gr = emulate_rows(case)
    assert np.array_equal(e_pt != 0, b_pt.numpy() != 0)
    _within(e_pt, b_pt.numpy(), TB.ROWS_TOL)
    _within(e_gr, b_gr.numpy(), TB.ROWS_TOL)
    # the rows the kernel writes are the rows the mask marks
    assert torch.equal(m_pt, (b_pt != 0).any(-1).float())


@pytest.mark.parametrize("grad", [False, True], ids=["value", "grad"])
def test_field_emulation_matches_plain(case, grad):
    """Values and gradients of the kernel's per-thread order and corner
    tree within FIELD_TOL of the largest |output| of the plain version's;
    the mask equal."""
    x = case.queries
    out = BK.basis_field_plain(*case.field(x, grad))
    v, mask, g = emulate_field(case, x, grad)
    assert np.array_equal(mask, out[1].numpy())
    _within(v, out[0].numpy(), TB.FIELD_TOL)
    if grad:
        _within(g, out[2].numpy(), TB.FIELD_TOL)


def test_offsets_and_window_are_the_plain_versions_bit_for_bit(case):
    """What the kernel rounds explicitly is the plain version's to the
    bit: the offsets (a correctly rounded division, two differences) and
    the window with its gradient."""
    spec, xyz, c0, vs = case.rows[0], case.rows[4], case.rows[5], \
        case.rows[12]
    for d in range(spec.depth):
        vs_d = vs * 2.0 ** d
        plain = BK._div(xyz, vs_d)[:, None, :] \
            - (c0 >> d).float()[:, None, :] - torch.as_tensor(BK.CORNER_OFFS)
        z = _offsets(xyz.numpy(), c0.numpy() >> d, F32(vs_d))
        assert np.array_equal(z, plain.numpy())
        w, dw = BK.window_grad(plain)
        ew, edw = emulate_window(z)
        assert np.array_equal(ew, w.numpy())
        assert np.array_equal(edw, dw.numpy())


@pytest.mark.parametrize("hidden,layers", [(8, 1), (16, 2), (20, 3)])
def test_packing_returns_the_mlp_tensors(hidden, layers):
    """``unpack_mlp`` reads every depth's layers back exactly, and the
    padding (hidden units past the width, the block's tail) is zero."""
    rng = np.random.default_rng(hidden)
    interp = TB.seeded_interp(3, 4, 6, hidden, layers, rng)
    packed = BK.pack_mlps(interp, 3)
    assert packed.hidden == (16 if hidden <= 16 else 32)
    assert packed.dims == (9,) + (hidden,) * layers + (4,)
    assert packed.buf.numel() == 3 * packed.stride
    assert packed.stride % 4 == 0
    nonzero = 0
    for d in range(3):
        layers_d = interp.level(d).layers()
        got = BK.unpack_mlp(packed, d)
        assert len(got) == len(layers_d)
        for (w, b), layer in zip(got, layers_d):
            assert torch.equal(w, layer.weight)
            assert torch.equal(b, layer.bias)
            nonzero += int((layer.weight != 0).sum() + (layer.bias != 0)
                           .sum())
    assert int((packed.buf != 0).sum()) == nonzero


def test_packing_rejects_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="hidden width 40"):
        BK.pack_mlps(TB.seeded_interp(2, 4, 4, 40, 2, rng), 2)
    with pytest.raises(ValueError, match="no hidden layer"):
        BK.pack_mlps(TB.seeded_interp(2, 4, 4, 8, 0, rng), 2)
    mixed = TB.seeded_interp(2, 4, 4, 8, 2, rng)
    mixed.interp_1 = TB.seeded_interp(2, 4, 4, 16, 2, rng).interp_1
    with pytest.raises(ValueError, match="differ by depth"):
        BK.pack_mlps(mixed, 2)


def test_cpu_calls_launch_nothing(case):
    """CPU tensors take the plain versions, which count no launch."""
    before = BK.basis_rows.launches, BK.basis_field.launches
    BK.basis_rows(*case.rows)
    BK.basis_field(*case.field(case.queries, True))
    assert (BK.basis_rows.launches, BK.basis_field.launches) == before


def _meta(t):
    return t.to("meta") if isinstance(t, torch.Tensor) else t


def test_non_cpu_tensor_never_takes_the_plain_version(case, monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; a
    meta tensor stands in for a CUDA tensor on this CUDA-less machine."""
    def fail(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(BK, "basis_rows_plain", fail)
    monkeypatch.setattr(BK, "basis_field_plain", fail)
    rows = [_meta(a) for a in case.rows]
    rows[2] = [_meta(t) for t in rows[2]]
    rows[3] = [_meta(t) for t in rows[3]]
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        BK.basis_rows(*rows)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        BK.basis_field(*case.field(_meta(case.queries), True))


def test_inputs_that_require_grad_are_refused(case):
    """With grad enabled, an input or an MLP parameter that requires grad
    raises on either device (the kernels have no backward); under
    no_grad, or frozen, the plain versions run."""
    x = case.queries.clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        BK.basis_field(*case.field(x, False))
    rows = list(case.rows)
    rows[4] = rows[4].clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        BK.basis_rows(*rows)
    interp = case.interp
    try:
        interp.requires_grad_(True)
        with pytest.raises(ValueError, match="requires grad"):
            BK.basis_rows(*case.rows)
        with pytest.raises(ValueError, match="requires grad"):
            BK.basis_field(*case.field(case.queries, True))
        with torch.no_grad():
            BK.basis_field(*case.field(case.queries, True))
    finally:
        interp.requires_grad_(False)
    with torch.no_grad():
        BK.basis_field(*case.field(x, False))


def test_shapes_and_dtypes_are_checked(case):
    """The kernel path checks its inputs' contract before their device: a
    meta tensor of a wrong shape or dtype raises ValueError."""
    rows = [_meta(a) for a in case.rows]
    rows[2] = [_meta(t) for t in rows[2]]
    rows[3] = [_meta(t) for t in rows[3]]
    bad = list(rows)
    bad[4] = torch.empty((5, 2), device="meta")
    with pytest.raises(ValueError, match="xyz"):
        BK.basis_rows(*bad)
    bad = list(rows)
    bad[2] = [t.to(torch.bfloat16) for t in rows[2]]
    with pytest.raises(ValueError, match="features"):
        BK.basis_rows(*bad)
    bad = list(rows)
    bad[5] = torch.empty((rows[4].shape[0], 2), dtype=torch.int64,
                         device="meta")
    with pytest.raises(ValueError, match="pt_cell0"):
        BK.basis_rows(*bad)
    args = list(case.field(_meta(case.queries), True))
    bad = list(args)
    bad[8] = torch.float16
    with pytest.raises(ValueError, match="float16"):
        BK.basis_field(*bad)
    bad = list(args)
    bad[4] = torch.empty((7, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="basis_field x"):
        BK.basis_field(*bad)


# the voxel size of the cells test, and where x * fl(1 / vs) floors
# into the cell past x / vs (vs = 0.1: 1.3f * 10 rounds to 13.0)
CELL_VS = 0.1


def boundary_points(lo: float, hi: float, vs: float = CELL_VS):
    """f32 values in [lo, hi] whose product with the f32 reciprocal of
    ``vs`` floors into another cell than their correctly rounded quotient
    (candidates: every multiple of vs, and 3 ulps either side)."""
    v = F32(vs)
    m = np.arange(int(np.floor(lo / vs)), int(np.ceil(hi / vs)) + 1)
    base = (m * np.float64(v)).astype(F32)
    cand = np.concatenate([(base.view(np.int32) + j).view(F32)
                           for j in range(-3, 4)])
    cand = cand[(cand >= lo) & (cand <= hi) & (cand != 0)]
    wrong = np.floor(cand / v) != np.floor((cand * (F32(1) / v)).astype(F32))
    return np.unique(cand[wrong])


def cell_queries(case, rng):
    """Queries inside the case's lattice with one coordinate on a
    boundary point each (the others from the cloud), a depth-0 mask that
    alternates cell by cell, and the numpy cells and mask they must
    give."""
    spec, origins = case.spec, case.plan.origins
    xyz = case.rows[4].cpu().numpy()
    lo = (origins[0] + 3) * CELL_VS
    hi = (origins[0] + np.asarray(spec.dims[0]) - 3) * CELL_VS
    q = []
    for a in range(3):
        pts = boundary_points(lo[a], hi[a])
        base = xyz[rng.integers(0, len(xyz), len(pts))].copy()
        base[:, a] = pts
        q.append(base)
    q = np.concatenate(q).astype(F32)
    cells = np.floor(q / F32(CELL_VS)).astype(np.int64)
    grid = np.indices(spec.dims[0]).sum(0) % 2 == 1
    loc = cells - origins[0]
    assert ((loc >= 0) & (loc < np.asarray(spec.dims[0]))).all()
    return q, cells, torch.as_tensor(grid.reshape(-1)), \
        grid[loc[:, 0], loc[:, 1], loc[:, 2]]


def test_evaluator_cells_divide_correctly():
    """The evaluator's depth-0 cells are numpy's correctly rounded
    ``floor(x / vs)`` at points whose reciprocal product floors into the
    next cell: ``query_cells0`` and the mask the plain evaluator reads
    there (an alternating mask flips at a wrong cell)."""
    case = TB.basis_case(2, 4, 4, 8, 2, seed=3, n_points=900,
                         voxel_size=CELL_VS)
    q, cells, mask0, want = cell_queries(case, np.random.default_rng(0))
    assert len(q) >= 4
    assert np.array_equal(BK.query_cells0(torch.as_tensor(q), CELL_VS)
                          .numpy(), cells)
    args = list(case.field(torch.as_tensor(q), False))
    args[2] = args[2]._replace(mask0=mask0)
    _, mask = BK.basis_field(*args)
    assert np.array_equal(mask.numpy(), want)
