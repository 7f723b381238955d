"""The AV0 cascade kernels' module (nksr_tpu_torch/fields/lattice_kernels.py)
against the Pallas kernels of the JAX package, run in interpret mode on
the CPU, and against the XLA cascade the JAX package runs by default.

On the CPU the wrappers take the plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.  The test spec is the one of
tests/test_lattice.py::test_pallas_cascade_matches_xla (depth 3, so 96
lanes: nothing may assume 128).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.fields import lattice_pallas as JLP
from nksr_tpu_torch import cuda_build as CB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields import lattice_kernels as LK
from test_torch_cuda_kernels import ADJ_CASES, adjoint_case

torch.set_num_threads(1)

DIMS = ((24, 24, 16), (16, 16, 8), (8, 8, 8))


def _specs():
    kw = dict(dims=DIMS, k=4, depth=3, adaptive_depth=2, s_pt=64, p_rows=4,
              s_gr=32, n_pts_cap=256)
    return JLAT.LatticeSpec(**kw), LAT.LatticeSpec(**kw)


def _coeffs(spec, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(spec.n_cells(d), spec.k)).astype(np.float32)
            for d in range(spec.depth)]


def _interior(spec) -> np.ndarray:
    """Depth-0 cells whose ancestors avoid every depth's last row, where
    the XLA cascade's flat windows wrap and the kernels zero-fill."""
    x0, y0, z0 = spec.dims[0]
    X, Y, Z = np.meshgrid(np.arange(x0), np.arange(y0), np.arange(z0),
                          indexing="ij")
    inter = np.ones((x0, y0, z0), bool)
    for d in range(spec.depth):
        xd, yd, zd = spec.dims[d]
        inter &= ((X >> d) < xd - 1) & ((Y >> d) < yd - 1) \
            & ((Z >> d) < zd - 1)
    return inter.reshape(-1)


@pytest.mark.parametrize("h_override", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_equals_pallas(h_override, dtype):
    """Pure selection: exactly equal to the Pallas kernel everywhere,
    edge cells included, for one and for several y-blocks."""
    jspec, spec = _specs()
    xs = _coeffs(spec, 11)
    ref = JLP.av0_cascade_pallas(
        jspec, [jnp.asarray(x.reshape(-1, 128)) for x in xs],
        getattr(jnp, dtype), interpret=True, h_override=h_override)
    got = LK.av0_cascade(spec, [torch.from_numpy(x) for x in xs],
                         getattr(torch, dtype))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_adjoint_matches_pallas():
    """f32 sums in another order than the Pallas halo fold: rtol/atol
    1e-5 (each output sums at most 8 * 4^3 unit-normal terms)."""
    jspec, spec = _specs()
    rng = np.random.default_rng(12)
    z = rng.normal(size=(spec.n_cells(0), spec.lanes)).astype(np.float32)
    ref = JLP.av0_adjoint_cascade_pallas(jspec, jnp.asarray(z),
                                         interpret=True)
    got = LK.av0_adjoint_cascade(spec, torch.from_numpy(z), torch.float32)
    for d in range(spec.depth):
        np.testing.assert_allclose(got[d].numpy().reshape(-1),
                                   np.asarray(ref[d]).reshape(-1),
                                   rtol=1e-5, atol=1e-5)


def test_adjoint_bf16_read_of_f32_matches_pallas():
    """The solve's call: an f32 buffer read in bf16, against the Pallas
    kernel reading it with ``compute_dtype=bfloat16``; rtol/atol 1e-5 as
    above (the same bf16 values, f32 sums in another order)."""
    jspec, spec = _specs()
    rng = np.random.default_rng(17)
    z = rng.normal(size=(spec.n_cells(0), spec.lanes)).astype(np.float32)
    ref = JLP.av0_adjoint_cascade_pallas(jspec, jnp.asarray(z),
                                         interpret=True,
                                         compute_dtype=jnp.bfloat16)
    got = LK.av0_adjoint_cascade(spec, torch.from_numpy(z), torch.bfloat16)
    for d in range(spec.depth):
        np.testing.assert_allclose(got[d].numpy().reshape(-1),
                                   np.asarray(ref[d]).reshape(-1),
                                   rtol=1e-5, atol=1e-5)


def _ragged_spec(depth, k):
    dims = tuple(tuple(((n + (1 << d) - 1) >> d) + (d > 0) for n in
                       (20, 12, 10)) for d in range(depth))
    return LAT.LatticeSpec(dims=dims, k=k, depth=depth, adaptive_depth=1,
                           s_pt=8, p_rows=4, s_gr=8, n_pts_cap=8)


def _staged_adjoint(spec, z: np.ndarray):
    """The adjoint kernel's two stages in numpy (f64): partials of each
    depth d >= 1 at ``adjoint_partials``' grids, then, per coefficient
    cell, the 8 corner ancestors, each the sum of the partials under it;
    depth 0 reads the buffer's own depth-0 lanes."""
    x0, y0, z0 = spec.dims[0]
    k = spec.k
    zz = z.reshape(x0, y0, z0, spec.depth, 8, k).astype(np.float64)
    cells = np.stack(np.meshgrid(np.arange(x0), np.arange(y0),
                                 np.arange(z0), indexing="ij"), -1)
    parts, _ = LK.adjoint_partials(spec)
    outs = []
    for d in range(spec.depth):
        g = min(d, 3)
        src = zz[:, :, :, 0]
        if d:
            src = np.zeros(parts[d - 1][0] + (8, k))
            q = cells >> g
            np.add.at(src, (q[..., 0], q[..., 1], q[..., 2]), zz[:, :, :, d])
        f = d - g
        grid = np.array(src.shape[:3])
        anc = np.zeros(tuple((grid + (1 << f) - 1) >> f) + (8, k))
        qs = np.stack(np.meshgrid(*(np.arange(n) for n in grid),
                                  indexing="ij"), -1) >> f
        np.add.at(anc, (qs[..., 0], qs[..., 1], qs[..., 2]), src)
        out = np.zeros(spec.dims[d] + (k,))
        for c, off in enumerate(LK._CORNERS):
            hi = [min(n, e + o) for n, e, o in
                  zip(spec.dims[d], anc.shape[:3], off)]
            out[off[0]:hi[0], off[1]:hi[1], off[2]:hi[2]] += \
                anc[:hi[0] - off[0], :hi[1] - off[1], :hi[2] - off[2], c]
        outs.append(out.reshape(-1, k))
    return outs


@pytest.mark.parametrize("depth,k", [(1, 4), (3, 4), (4, 4), (5, 2),
                                     (6, 1), (3, 8)])
def test_adjoint_partials_cover_every_ancestor(depth, k):
    """``adjoint_partials`` (the host side of the adjoint kernel's
    stage 1) on depth-0 dims (20, 12, 10), which no 8^3 brick divides:
    each grid is the brute-force count of the distinct groups the
    depth-0 cells fall into, the rows of one depth follow the last of
    the one before, and the two stages over that layout give the plain
    adjoint (f64 against f32 sums: rtol 1e-5, atol 1e-5 of the largest
    output)."""
    spec = _ragged_spec(depth, k)
    parts, total = LK.adjoint_partials(spec)
    assert len(parts) == depth - 1
    x0, y0, z0 = spec.dims[0]
    cells = np.stack(np.meshgrid(np.arange(x0), np.arange(y0),
                                 np.arange(z0), indexing="ij"), -1)
    end = 0
    for d, (grid, offset) in enumerate(parts, start=1):
        groups = np.unique((cells >> min(d, 3)).reshape(-1, 3), axis=0)
        assert tuple(groups.max(0) + 1) == grid
        assert len(groups) == grid[0] * grid[1] * grid[2]
        assert offset == end
        end += len(groups) * 8 * k
    assert total == end
    z = np.random.default_rng(18).normal(
        size=(spec.n_cells(0), spec.lanes)).astype(np.float32)
    ref = LK.av0_adjoint_cascade_plain(spec, torch.from_numpy(z),
                                       torch.float32)
    for got, r in zip(_staged_adjoint(spec, z), ref):
        np.testing.assert_allclose(got, r.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


def test_forward_equals_xla_cascade_on_interior():
    """The JAX package's default (XLA) cascade agrees exactly on every
    cell a solve can reach."""
    jspec, spec = _specs()
    xs = _coeffs(spec, 13)
    ref = np.asarray(JLAT._av0_cascade(
        jspec, tuple(jnp.asarray(x.reshape(-1, 128)) for x in xs),
        jnp.float32))
    got = LK.av0_cascade(spec, [torch.from_numpy(x) for x in xs],
                         torch.float32).numpy()
    m = _interior(spec)
    assert m.sum() > 1000
    np.testing.assert_array_equal(got[m], ref[m])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_adjoint_pair(compute_dtype):
    """<fwd(x), z> == <x, adj(z)>: the CG matvec must stay symmetric.
    With a bf16 compute dtype the adjoint reads z rounded to bf16, so
    the pair holds for that rounded z (1e-5 relative: f32 sums of ~1e5
    products in two orders)."""
    _, spec = _specs()
    cdt = getattr(torch, compute_dtype)
    xs = [torch.from_numpy(x) for x in _coeffs(spec, 14)]
    rng = np.random.default_rng(15)
    z = torch.from_numpy(rng.normal(
        size=(spec.n_cells(0), spec.lanes)).astype(np.float32))
    fwd = LK.av0_cascade(spec, xs, torch.float32).double()
    adj = LK.av0_adjoint_cascade(spec, z, cdt)
    lhs = float((fwd * z.to(cdt).double()).sum())
    rhs = float(sum((a.double() * x.double()).sum() for a, x in zip(adj, xs)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def _row_cells(spec, seed, n_random=300):
    """Depth-0 cells for the slot-row tests: random cells with repeats,
    every cell on the last x, y and z planes, and 20 duplicates, in a
    shuffled (unsorted) order."""
    x0, y0, z0 = spec.dims[0]
    rng = np.random.default_rng(seed)
    grid = np.arange(spec.n_cells(0)).reshape(x0, y0, z0)
    cells = np.concatenate([
        rng.integers(0, spec.n_cells(0), n_random),
        grid[-1].ravel(), grid[:, -1].ravel(), grid[:, :, -1].ravel()])
    cells = np.concatenate([cells, cells[rng.integers(0, len(cells), 20)]])
    return rng.permutation(cells).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_equal_pallas_gathered(dtype):
    """The slot rows are exactly the Pallas forward's rows at the same
    cells (the TPU pair: ``av0_cascade_pallas``, then the row gather),
    edge planes, duplicates and an unsorted order included."""
    jspec, spec = _specs()
    xs = _coeffs(spec, 21)
    cells = _row_cells(spec, 22)
    ref = JLP.av0_cascade_pallas(
        jspec, [jnp.asarray(x.reshape(-1, 128)) for x in xs],
        getattr(jnp, dtype), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))[cells]
    tx = [torch.from_numpy(x) for x in xs]
    cdt = getattr(torch, dtype)
    got = LK.av0_rows_plain(spec, tx, torch.from_numpy(cells), cdt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        LK.av0_rows(spec, tx, torch.from_numpy(cells), cdt).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_equal_row_blocks_on_interior(dtype):
    """Exactly the JAX package's own ``_row_blocks`` on every interior
    cell, its per-depth slot cells being the depth-d flat index of each
    cell's ancestor ``(x>>d, y>>d, z>>d)``."""
    jspec, spec = _specs()
    xs = _coeffs(spec, 23)
    inner = np.flatnonzero(_interior(spec))
    cells = np.random.default_rng(24).permutation(inner).astype(np.int32)
    x0, y0, z0 = spec.dims[0]
    cx, cy, cz = cells // (y0 * z0), (cells // z0) % y0, cells % z0
    slot_cells = np.stack([
        (((cx >> d) * spec.dims[d][1] + (cy >> d)) * spec.dims[d][2]
         + (cz >> d)) for d in range(spec.depth)]).astype(np.int32)
    ref = JLAT._row_blocks(jspec, tuple(jnp.asarray(x.reshape(-1))
                                        for x in xs),
                           jnp.asarray(slot_cells), getattr(jnp, dtype))
    got = LK.av0_rows_plain(spec, [torch.from_numpy(x) for x in xs],
                            torch.from_numpy(cells), getattr(torch, dtype))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("depth,k", [(1, 4), (3, 4), (4, 2), (5, 1),
                                     (3, 8)])
def test_rows_equal_dense_forward(depth, k, dtype):
    """``av0_rows_plain`` is the dense plain forward's rows, cast to f32,
    on the ragged depth-0 dims (20, 12, 10); a cell outside the lattice
    gives a zero row."""
    spec = _ragged_spec(depth, k)
    xs = [torch.from_numpy(x) for x in _coeffs(spec, 25)]
    cells = torch.from_numpy(_row_cells(spec, 26))
    ref = LK.av0_cascade_plain(spec, xs, dtype)[cells.long()].float()
    assert torch.equal(LK.av0_rows_plain(spec, xs, cells, dtype), ref)
    bad = torch.tensor([-1, spec.n_cells(0)], dtype=torch.int32)
    assert not LK.av0_rows_plain(spec, xs, bad, dtype).any()
    assert LK.av0_rows_plain(spec, xs, cells[:0], dtype).shape == \
        (0, spec.lanes)


def test_cpu_calls_do_not_count_launches():
    _, spec = _specs()
    xs = [torch.from_numpy(x) for x in _coeffs(spec, 16)]
    before = (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches,
              LK.av0_rows.launches)
    LK.av0_adjoint_cascade(spec, LK.av0_cascade(spec, xs, torch.float32),
                           torch.float32)
    LK.av0_rows(spec, xs, torch.arange(8, dtype=torch.int32), torch.float32)
    assert (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches,
            LK.av0_rows.launches) == before


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; a
    meta tensor stands in for a CUDA tensor on this CUDA-less machine."""
    _, spec = _specs()

    def fail(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(LK, "av0_cascade_plain", fail)
    monkeypatch.setattr(LK, "av0_adjoint_cascade_plain", fail)
    monkeypatch.setattr(LK, "av0_rows_plain", fail)
    xs = [torch.empty((spec.n_cells(d), spec.k), device="meta")
          for d in range(spec.depth)]
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_cascade(spec, xs, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_rows(spec, xs, torch.zeros(4, dtype=torch.int32,
                                          device="meta"), torch.bfloat16)
    z = torch.empty((spec.n_cells(0), spec.lanes), device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_adjoint_cascade(spec, z, torch.float32)


def test_forward_rejects_lines_past_its_grid():
    """Depth-0 lines past the dense forward's grid (more than 65535 along x
    or y) raise with the limit in the message before a launch; a meta
    tensor stands in for a CUDA tensor on this CUDA-less machine."""
    for dims in (((70000, 2, 2),), ((2, 65536, 2),)):
        spec = LAT.LatticeSpec(dims=dims, k=4, depth=1, adaptive_depth=1,
                               s_pt=8, p_rows=4, s_gr=8, n_pts_cap=8)
        xs = [torch.empty((spec.n_cells(0), spec.k), device="meta")]
        with pytest.raises(ValueError, match="65535"):
            LK.av0_cascade(spec, xs, torch.bfloat16)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernels' build (nksr_tpu_torch/cuda_build.py) raises where
    there is no nvcc."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CB.build_kernels()


# ------------------------------------------- the slot-row adjoint's tables
def _plan_slot_cells():
    """A small plan built by the port's ``plan_lattice`` (the slice test's
    2500-point terrain at tree depth 3): the spec, the plan and its slot
    cells, point slots then gradient slots, as the solve concatenates
    them."""
    from test_torch_dense_unet import SMALL
    from test_torch_slice import _solve_inputs
    from nksr_tpu_torch.models import pipeline as P
    _, plan, _, _ = _solve_inputs(P.PipelineConfig(**SMALL), 7)
    cells = np.concatenate([plan.slot_cell0_pt, plan.slot_cell0_gr])
    return plan.spec, plan, cells


def _reckon_tables(spec, cells):
    """The slot-row adjoint's tables reckoned in numpy from their
    definition: the kept slots sorted by (8^3 brick, depth-1 group of 4^3
    row-major in the brick, child place x, y, z bits, slot), one segment
    per cell, the map from cell to segment, the occupied bricks, the
    first segment of each (brick, group) of the brick grid counted from
    the segments before it, and each depth's live 8^3 coefficient tiles:
    those with an occupied brick under the ancestors their cells' corners
    read, side by side."""
    x0, y0, z0 = spec.dims[0]
    g = [(n + 7) // 8 for n in spec.dims[0]]
    kept = np.flatnonzero(cells >= 0)
    x, y, z = np.unravel_index(cells[kept], (x0, y0, z0))
    brick = np.ravel_multi_index((x // 8, y // 8, z // 8), g)
    group = (x // 2 % 4 * 4 + y // 2 % 4) * 4 + z // 2 % 4
    child = x % 2 * 4 + y % 2 * 2 + z % 2
    order = np.lexsort((kept, child, group, brick))
    perm = kept[order]
    pc = cells[perm]
    starts = np.flatnonzero(np.r_[True, pc[1:] != pc[:-1]][:len(pc)])
    seg_cells = pc[starts]
    cell_row = np.full(spec.n_cells(0), -1)
    cell_row[seg_cells] = np.arange(len(starts))
    sb, sg = brick[order][starts], group[order][starts]
    bricks = np.unique(brick)
    group_seg = [int(((sb < bk) | ((sb == bk) & (sg < a))).sum())
                 for bk in range(np.prod(g)) for a in range(64)] \
        + [len(starts)]
    occ = np.zeros(g, bool)
    occ.reshape(-1)[bricks] = True
    live = []
    for d in range(spec.depth):
        tg = [(n + 7) // 8 for n in spec.dims[d]]
        for t in np.ndindex(*tg):
            side = []
            for a in range(3):
                anc = {v - i for v in range(8 * t[a], min(8 * t[a] + 8,
                                                          spec.dims[d][a]))
                       for i in (0, 1) if v - i >= 0}
                side.append(sorted({p // 8 for v in anc for p in range(
                    v << d, min((v + 1) << d, spec.dims[0][a]))}))
            live.append(bool(occ[np.ix_(*side)].any()))
    return dict(perm=perm, seg_off=np.r_[starts, len(perm)],
                cells=seg_cells, cell_row=cell_row, bricks=bricks,
                group_seg=np.array(group_seg),
                brick_occ=occ.reshape(-1).astype(np.uint8),
                tile_live=np.array(live, np.uint8))


@pytest.mark.parametrize("case", ADJ_CASES)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_adjoint_tables_match_numpy(depth, k, case):
    """``adjoint_rows_tables`` on ragged specs (dims no multiple of 8,
    each coarser lattice a cell past its last ancestor) and the cases
    the card's tests run (heavy repeats, edge planes, dropped slots, one
    occupied brick, no kept slot) equals the numpy reckoning of every
    table."""
    spec = _ragged_spec(depth, k)
    cells = adjoint_case(spec, case)
    tab = LK.adjoint_rows_tables(spec, torch.from_numpy(cells))
    want = _reckon_tables(spec, cells)
    np.testing.assert_array_equal(tab.index.numpy(), cells)
    for name, ref in want.items():
        np.testing.assert_array_equal(getattr(tab, name).numpy(), ref,
                                      err_msg=name)
    assert len(tab.tile_live) == sum(
        a * b * c for a, b, c in LK.tile_grids(spec))


def test_adjoint_tables_give_back_dense_z0():
    """``adjoint_rows_tables`` on a real plan, walked as the kernel's first
    stage walks it: per occupied brick and depth-1 group, the group's
    segments hold exactly its slot cells in child order, and folding each
    segment's slot rows in order from 0.0 in f32 gives back the rows of
    the dense buffer CPU ``index_add_`` builds, bit for bit; every
    nonzero row of that buffer lies in an occupied brick; the tables
    equal the numpy reckoning."""
    spec, plan, cells = _plan_slot_cells()
    n0 = spec.n_cells(0)
    tab = LK.adjoint_rows_tables(spec, torch.from_numpy(cells))
    for name, ref in _reckon_tables(spec, cells).items():
        np.testing.assert_array_equal(getattr(tab, name).numpy(), ref,
                                      err_msg=name)
    assert len(np.unique(cells)) < len(cells)  # repeats: pad, shared cells
    perm, offs = tab.perm.numpy(), tab.seg_off.numpy()
    gseg, seg_cells = tab.group_seg.numpy(), tab.cells.numpy()
    x0, y0, z0 = spec.dims[0]
    gx, gy, gz = LK.brick_grid(spec)
    slot_cells = set(cells)

    rng = np.random.default_rng(30)
    y = rng.standard_normal((len(cells), spec.lanes)).astype(np.float32)
    ref = torch.zeros((n0, spec.lanes)).index_add_(
        0, torch.from_numpy(cells.astype(np.int64)), torch.from_numpy(y))
    z = np.zeros((n0, spec.lanes), np.float32)
    for brick in tab.bricks.numpy():
        bx, by, bz = np.unravel_index(brick, (gx, gy, gz))
        for a in range(64):
            ox, oy, oz = 8 * bx + 2 * (a >> 4), 8 * by + 2 * (a >> 2 & 3), \
                8 * bz + 2 * (a & 3)
            children = [(ox + (ch >> 2)) * y0 * z0 + (oy + (ch >> 1 & 1)) * z0
                        + oz + (ch & 1) for ch in range(8)
                        if ox + (ch >> 2) < x0 and oy + (ch >> 1 & 1) < y0
                        and oz + (ch & 1) < z0]
            segs = range(gseg[64 * brick + a], gseg[64 * brick + a + 1])
            assert list(seg_cells[segs]) == [c for c in children
                                             if c in slot_cells]
            for s in segs:
                acc = np.zeros(spec.lanes, np.float32)
                for i in perm[offs[s]:offs[s + 1]]:
                    acc = acc + y[i]
                z[seg_cells[s]] = acc
    np.testing.assert_array_equal(z, ref.numpy())
    nz = np.flatnonzero(np.abs(z).sum(1))
    nb = np.ravel_multi_index(
        (np.stack(np.unravel_index(nz, (x0, y0, z0)), -1) >> 3).T,
        (gx, gy, gz))
    assert tab.brick_occ.numpy()[nb].all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ADJ_CASES)
@pytest.mark.parametrize("depth,k", [(1, 8), (2, 1), (3, 2), (4, 4)])
def test_adjoint_rows_plain_cases_are_the_dense_chain(depth, k, case, dtype):
    """On the ragged cases, the plain slot-row adjoint driven by the tables
    equals the dense chain (``index_add_`` of the kept rows into a zeroed
    buffer, then ``av0_adjoint_cascade_plain``) bit for bit, and that
    chain is +0.0 on every coefficient tile ``tile_live`` marks dead,
    which the kernel writes without reading anything."""
    spec = _ragged_spec(depth, k)
    cells = adjoint_case(spec, case, seed=1)
    rng = np.random.default_rng(32)
    y = torch.from_numpy(rng.standard_normal(
        (len(cells), spec.lanes)).astype(np.float32))
    keep = torch.from_numpy(cells >= 0)
    z0 = torch.zeros((spec.n_cells(0), spec.lanes)).index_add_(
        0, torch.from_numpy(cells)[keep], y[keep])
    ref = LK.av0_adjoint_cascade_plain(spec, z0, dtype)
    tab = LK.adjoint_rows_tables(spec, torch.from_numpy(cells))
    got = LK.av0_adjoint_rows_plain(spec, tab, y, dtype)
    live = tab.tile_live.numpy().astype(bool)
    for d, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r)
        tg = LK.tile_grids(spec)[d]
        n = int(np.prod(tg))
        dims = spec.dims[d]
        t = np.stack(np.unravel_index(np.arange(np.prod(dims)), dims), -1)
        tile = np.ravel_multi_index((t >> 3).T, tg)
        dead = ~live[:n][tile]
        live = live[n:]
        assert (r.numpy()[dead] == 0).all() and not torch.signbit(
            r[torch.from_numpy(dead)]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adjoint_rows_plain_is_the_dense_chain(dtype):
    """``av0_adjoint_rows_plain`` (and the wrapper on the CPU) equals the
    chain it replaces, ``av0_adjoint_cascade_plain`` of the two
    ``index_add_`` of the point and gradient slot rows, bit for bit, with
    the summed rows read in the compute dtype."""
    spec, plan, cells = _plan_slot_cells()
    s_pt = len(plan.slot_cell0_pt)
    rng = np.random.default_rng(31)
    y = torch.from_numpy(rng.standard_normal(
        (len(cells), spec.lanes)).astype(np.float32))
    pt = torch.from_numpy(plan.slot_cell0_pt.astype(np.int64))
    gr = torch.from_numpy(plan.slot_cell0_gr.astype(np.int64))
    z0 = torch.zeros((spec.n_cells(0), spec.lanes))
    z0.index_add_(0, pt, y[:s_pt]).index_add_(0, gr, y[s_pt:])
    ref = LK.av0_adjoint_cascade_plain(spec, z0, dtype)
    tab = LK.adjoint_rows_tables(spec, torch.from_numpy(cells))
    for got in (LK.av0_adjoint_rows_plain(spec, tab, y, dtype),
                LK.av0_adjoint_rows(spec, tab, y, dtype)):
        assert len(got) == spec.depth
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_splat_index_add_sites_see_no_repeats():
    """The ``index_add_`` sites left on the splat path stay in a fixed
    order on the card only because no index repeats: ``scatter_tables``
    (one row per active voxel's cell, each depth) and ``assemble_rows``
    (one row per point's (slot, row) destination)."""
    spec, plan, _ = _plan_slot_cells()
    for d in range(spec.depth):
        cells = plan.vox_cell[d][plan.vox_active[d]]
        assert len(cells) and len(np.unique(cells)) == len(cells)
    slot = plan.pt_dest % spec.s_pt
    dest = slot * spec.p_rows + plan.pt_dest // spec.s_pt
    assert len(dest) and len(np.unique(dest)) == len(dest)


def test_solve_goes_through_adjoint_rows(monkeypatch):
    """The solve maps its slot rows back with ``av0_adjoint_rows`` only:
    the rhs, the Jacobi diagonal (f32) and one call a CG iteration, never
    the dense adjoint, and still matches nksr_tpu after 3 iterations as
    tests/test_torch_slice.py::test_solve_matches_jax does, at its
    tolerance (rtol 1e-4, atol 1e-4 of the largest coefficient).  The
    slots its tables drop (pad point slots, inactive gradient slots)
    hold zero rows in every call, so dropping them moves at most a
    zero's sign."""
    from test_torch_slice import _check_solve_against_jax

    def fail(*a, **k):
        raise AssertionError("lattice_solve called the dense adjoint")

    calls, real = [], LK.av0_adjoint_rows

    def record(spec, tables, y, dtype):
        dropped = tables.index < 0
        calls.append((dtype, int(dropped.sum()),
                      bool((y[dropped] == 0).all())))
        return real(spec, tables, y, dtype)

    monkeypatch.setattr(LK, "av0_adjoint_cascade", fail)
    monkeypatch.setattr(LK, "av0_adjoint_rows", record)
    _check_solve_against_jax(3)
    assert len(calls) == 3 + 2 and calls[1][0] == torch.float32
    assert all(n > 0 and zero for _, n, zero in calls)
