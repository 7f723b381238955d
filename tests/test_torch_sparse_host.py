"""The port's host tables of the sparse fallback (nksr_tpu_torch/core/
host_build.py, nksr_tpu_torch/native.py, nksr_tpu_torch/core/grid.py) are
byte-identical to the JAX package's, or to the device lookups they
replace, on a bench-terrain cloud; and the host dual MC
(nksr_tpu_torch/meshing/host_mc.py) gives the JAX package's mesh on the
same field."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench import synthetic_scene
from nksr_tpu import native as JN
from nksr_tpu.core import grid as JG
from nksr_tpu.core import host_build as JHB
from nksr_tpu.meshing import host_mc as JMC
from nksr_tpu.ops.gather_scatter import stencil_offsets as j_stencil
from nksr_tpu_torch import native
from nksr_tpu_torch.core import grid as G
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.meshing import host_mc as MC
from nksr_tpu_torch.ops import gather_scatter as GS

torch.set_num_threads(1)

VS = 0.1


def _caps(grids):
    return tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def hier():
    xyz, _ = synthetic_scene(3000, seed=8, half_extent=2.0)
    grids, orders = HB.build_splat_grids_ex(xyz, VS, 3)
    return xyz, grids, orders, _caps(grids)


def _keys(rng, n, lo=-(1 << 40), hi=1 << 40):
    return rng.integers(lo, hi, size=n, dtype=np.int64)


@pytest.mark.parametrize("fallback", [False, True])
def test_native_joins_match(monkeypatch, fallback):
    """sort_unique, sorted_join, keysearch and stencil_join equal the JAX
    package's, with the C++ library and with the numpy versions."""
    rng = np.random.default_rng(0)
    raw = _keys(rng, 5000, -3000, 3000)
    ref_keys = JN.sort_unique(raw.copy())
    if fallback:
        monkeypatch.setattr(native, "_load", lambda: None)
    keys = native.sort_unique(raw.copy())
    _same(keys, ref_keys)
    q = _keys(rng, 4000, -3500, 3500)
    _same(native.keysearch(keys, q), JN.keysearch(ref_keys, q))
    qs = np.sort(q)
    _same(native.sorted_join(keys, qs), JN.sorted_join(ref_keys, qs))
    deltas = np.array([-7, -1, 0, 2, 5], np.int64)
    for cap in (None, 1000):
        _same(native.stencil_join(keys, qs, deltas, cap=cap),
              JN.stencil_join(ref_keys, qs, deltas, cap=cap))


def test_unet_tables_match(hier):
    """nbr and child tables equal nksr_tpu's build_unet_tables."""
    _, grids, _, caps = hier
    ref = JHB.build_unet_tables(grids, caps, j_stencil(3))
    got = HB.build_unet_tables(grids, caps, GS.stencil_offsets(3))
    for d in range(3):
        _same(got.nbr[d], ref.nbr[d])
    for d in range(2):
        _same(got.child[d], ref.child[d])


def test_parent_and_skip_match_device_lookups(hier):
    """The host parent and skip rows equal the lookups the JAX SparseUNet
    makes on the device in its teacher-forced decoder:
    ``cand.lookup(floor(c / 2))`` and ``enc.lookup(c)`` over each level's
    capacity-padded coords (padding rows look up coordinate 0)."""
    _, grids, _, caps = hier
    svh = JHB.to_device_svh(grids, caps, VS)
    got = HB.build_unet_tables(grids, caps, GS.stencil_offsets(3))
    for d in range(2):
        fine, coarse = svh.grids[d], svh.grids[d + 1]
        parent = coarse.lookup(jnp.floor_divide(fine.coords, 2))
        skip = fine.lookup(fine.coords)
        _same(got.parent[d], np.asarray(parent))
        _same(got.skip[d], np.asarray(skip))


@pytest.mark.parametrize("presorted", [False, True])
def test_support_indices_match(hier, presorted):
    xyz, grids, orders, caps = hier
    kw = dict(presorted=orders) if presorted else {}
    ref = JHB.support_indices(grids, caps, xyz, **kw)
    got = HB.support_indices(grids, caps, xyz, **kw)
    for r, g in zip(ref, got):
        _same(g, r)
    # queries off the points: voxel centers, corners and random points
    rng = np.random.default_rng(1)
    q = rng.uniform(-2.6, 2.6, (3000, 3)).astype(np.float32)
    for r, g in zip(JHB.support_indices(grids, caps, q),
                    HB.support_indices(grids, caps, q)):
        _same(g, r)


def test_lookups_match(hier):
    _, grids, _, _ = hier
    rng = np.random.default_rng(2)
    g = grids[1]
    c = np.concatenate([g.coords[::3],
                        rng.integers(-20, 20, (500, 3)).astype(np.int32)])
    _same(HB.lookup(g, c), JHB.lookup(g, c))
    keys = HB.pack64(c)
    _same(HB.keys_lookup(g, keys), JHB.keys_lookup(g, keys))
    _same(HB.nbr_table(g, 4096, GS.stencil_offsets(3)),
          JHB.nbr_table(g, 4096, j_stencil(3)))


def test_grid_geometry_matches():
    """splat_coords / point_splat_coords / grid_to_world and the voxel
    centers equal nksr_tpu.core.grid on the CPU (f32 on both sides)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    vs = float(np.float32(VS * 2))
    jgrid = JG.SparseGrid.empty(8, vs)
    jc, jw = JG.point_splat_coords(jgrid, jnp.asarray(x))
    c, w = G.point_splat_coords(vs, torch.from_numpy(x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    ijk = rng.integers(-50, 50, (300, 3)).astype(np.int32)
    ref = np.asarray(jgrid.grid_to_world(jnp.asarray(ijk)))
    np.testing.assert_array_equal(
        G.grid_to_world(torch.from_numpy(ijk), vs).numpy(), ref)
    np.testing.assert_array_equal(G.get_voxel_centers(ijk, vs), ref)


def _sphere(p):
    """Signed field of a sphere of radius 0.6 about (0.05, 0.02, 0),
    positive inside, and its gradient."""
    d = p - np.array([0.05, 0.02, 0.0], np.float32)
    r = np.linalg.norm(d, axis=1, keepdims=True)
    return (0.6 - r[:, 0]).astype(np.float32), (-d / r).astype(np.float32)


@pytest.mark.parametrize("mise_iter", [0, 1])
def test_host_dual_mc_matches_jax(mise_iter):
    """The same lattice and field through both host meshers: identical
    vertices and faces (the same numpy steps over the same joins)."""
    xyz, _ = synthetic_scene(400, seed=1, half_extent=0.5)
    r = np.linalg.norm(xyz, axis=1, keepdims=True)
    grids, _ = HB.build_splat_grids_ex(0.6 * xyz / r, VS, 2)
    vox = MC.extraction_lattice_host(grids, 1)
    np.testing.assert_array_equal(vox, JMC.extraction_lattice_host(grids, 1))
    fbar = lambda p: _sphere(p)[0]  # noqa: E731
    ref = JMC.dual_mc_on_lattice(vox, VS, fbar, _sphere, mise_iter)
    got = MC.dual_mc_on_lattice(vox, VS, fbar, _sphere, mise_iter)
    assert len(got.f) > 100
    _same(got.v, np.asarray(ref.v))
    _same(got.f, np.asarray(ref.f))


def test_mise_key_budget_raises():
    """MISE doubling would overflow pack64's 21 bits an axis."""
    vox = np.array([[1 << 19, 0, 0], [0, 0, 0]], np.int64)
    with pytest.raises(ValueError, match="21-bit"):
        MC.dual_mc_on_lattice(vox, VS, lambda p: np.zeros(len(p), np.float32),
                              None, mise_iter=1)
