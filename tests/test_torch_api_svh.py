"""The port's ``SparseGrid``, ``SparseFeatureHierarchy``, ``LayerField``
and the fields' public signatures against the JAX package's on the CPU.

The JAX classes run under ``jax.jit``.  The cloud: 300 points of a
sphere of radius 0.3 (seeded normals), a far outlier that is masked
out, at voxel 0.1 and depth 3; level 0's capacity (256) is under its
voxel count, so it keeps its first 256 voxels in (i, j, k) order.
Voxel sets, lookups, statuses and masks are compared exactly, the
wireframe within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nksr_tpu.core.grid import SparseGrid as JSparseGrid
from nksr_tpu.core.svh import SparseFeatureHierarchy as JSVH
from nksr_tpu.fields import LayerField as JLayerField

from nksr_tpu_torch import svh as S
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.core import svh as CS
from nksr_tpu_torch.fields import KernelField, LayerField, NeuralField
from nksr_tpu_torch.models.network import MLP

from test_field import sphere_points

VS, DEPTH, CAPS = 0.1, 3, (256, 512, 256)
ORIGIN = np.array([0.013, -0.021, 0.037], np.float32)


def cloud():
    xyz, nrm = sphere_points(300, r=0.3, seed=4)
    xyz = np.concatenate([xyz, [[3.0, 3.0, 3.0]]]).astype(np.float32)
    nrm = np.concatenate([nrm, [[0.0, 0.0, 1.0]]]).astype(np.float32)
    mask = np.ones(len(xyz), bool)
    mask[-1] = False
    return xyz, nrm, mask


@functools.lru_cache(maxsize=None)
def _jit_splat():
    return jax.jit(JSVH.build_point_splatting, static_argnums=(3, 4))


@functools.lru_cache(maxsize=None)
def _jit_adaptive(adaptive_depth):
    def build(xyz, nrm, mask, tau, origin):
        return JSVH.build_adaptive_normal_variation(
            xyz, nrm, mask, VS, DEPTH, CAPS, tau=tau,
            adaptive_depth=adaptive_depth, origin=origin)
    return jax.jit(build)


# (structure, tau, adaptive depth, origin)
CASES = {
    "splat": ("splat", None, None, None),
    "splat-origin": ("splat", None, None, ORIGIN),
    "adaptive-0.1-1": ("adaptive", 0.1, 1, None),
    "adaptive-0.1-2": ("adaptive", 0.1, 2, ORIGIN),
    "adaptive-0.001-1": ("adaptive", 0.001, 1, ORIGIN),
    "adaptive-0.001-2": ("adaptive", 0.001, 2, None),
}


@functools.lru_cache(maxsize=None)
def build_pair(case):
    """(JAX hierarchy, port hierarchy) of the cloud."""
    structure, tau, ad, origin = CASES[case]
    xyz, nrm, mask = cloud()
    o = None if origin is None else jnp.asarray(origin)
    if structure == "splat":
        j = _jit_splat()(jnp.asarray(xyz), jnp.asarray(mask), VS, DEPTH,
                         CAPS, o)
        t = S.SparseFeatureHierarchy.build_point_splatting(
            torch.from_numpy(xyz), torch.from_numpy(mask), VS, DEPTH, CAPS,
            origin=origin)
    else:
        j = _jit_adaptive(ad)(jnp.asarray(xyz), jnp.asarray(nrm),
                              jnp.asarray(mask), tau,
                              jnp.zeros(3) if o is None else o)
        t = S.SparseFeatureHierarchy.build_adaptive_normal_variation(
            torch.from_numpy(xyz), torch.from_numpy(nrm),
            torch.from_numpy(mask), VS, DEPTH, CAPS, tau=tau,
            adaptive_depth=ad, origin=origin)
    return j, t


def jax_levels(j):
    return [np.asarray(g.coords)[:int(g.num_voxels)] for g in j.grids]


@pytest.mark.parametrize("case", list(CASES))
def test_hierarchy_equals_jax(case):
    """Level by level the same voxels, in the same order, at the same
    counts and capacities; level 0 cut at its capacity."""
    j, t = build_pair(case)
    assert t.depth == j.depth == DEPTH
    assert t.voxel_size == float(j.voxel_size)
    for d, (jc, g) in enumerate(zip(jax_levels(j), t.grids)):
        assert g.capacity == CAPS[d] and g.num_voxels == len(jc), d
        np.testing.assert_array_equal(g.coords.numpy(),
                                      np.asarray(j.grids[d].coords))
        np.testing.assert_array_equal(g.active_mask().numpy(),
                                      np.asarray(j.level_mask(d)))
        np.testing.assert_array_equal(g.origin.numpy(),
                                      np.asarray(j.grids[d].origin))
        np.testing.assert_array_equal(t.get_voxel_centers(d).numpy(),
                                      np.asarray(j.get_voxel_centers(d)))
    if CASES[case][0] == "splat" or CASES[case][2] == 1:
        assert t.grids[0].num_voxels == CAPS[0]
    # the masked outlier splats nothing
    far = torch.tensor([[3.0, 3.0, 3.0]])
    assert not any(bool(g.contains_point(far)[0]) for g in t.grids)


def test_adaptive_refines_fewer_at_a_larger_tau():
    n = {tau: build_pair(f"adaptive-{tau}-2")[1].grids[0].num_voxels
         for tau in (0.1, 0.001)}
    assert 0 < n[0.1] < n[0.001]


def queries(t, d):
    """Level d's voxels (hits), the same voxels shifted far (misses), and
    seven of them shifted by one voxel (either)."""
    c = t.grids[d].coords[:t.grids[d].num_voxels]
    return torch.cat([c, c + 1000, c[:7] - 1]).long()


@pytest.mark.parametrize("case", ["splat-origin", "adaptive-0.001-2"])
def test_lookup_contains_and_status_equal_jax(case):
    j, t = build_pair(case)
    xyz, _, _ = cloud()
    rng = np.random.default_rng(3)
    pts = np.concatenate([xyz, rng.uniform(-0.8, 0.8, (500, 3))]
                         ).astype(np.float32)
    qs = [queries(t, d) for d in range(DEPTH)]

    @jax.jit
    def jax_side(h, qs, x):
        return [(h.grids[d].lookup(qs[d]), h.evaluate_voxel_status(qs[d], d),
                 h.grids[d].contains_point(x)) for d in range(DEPTH)]
    ref = jax_side(j, [jnp.asarray(q.numpy().astype(np.int32)) for q in qs],
                   jnp.asarray(pts))
    for d, (q, (jlook, jstatus, jcontains)) in enumerate(zip(qs, ref)):
        np.testing.assert_array_equal(t.grids[d].lookup(q).numpy(),
                                      np.asarray(jlook))
        st = t.evaluate_voxel_status(q, d).numpy()
        np.testing.assert_array_equal(st, np.asarray(jstatus))
        # the host statuses of the same grids
        host = [HB.HostGrid(g.coords[:g.num_voxels].numpy(),
                            HB.pack64(g.coords[:g.num_voxels].numpy()),
                            g.voxel_size) for g in t.grids]
        np.testing.assert_array_equal(
            st, CS.evaluate_voxel_status(host, q.numpy(), d))
        if d:
            assert {0, 1, 2} <= set(st.tolist()), d
        np.testing.assert_array_equal(
            t.grids[d].contains_point(torch.from_numpy(pts)).numpy(),
            np.asarray(jcontains))


def test_sparse_grid_from_coords_and_empty_equal_jax():
    """Duplicated, masked and out-of-capacity coords: the first
    ``capacity`` distinct voxels in (i, j, k) order, as in the JAX
    package; an empty grid has no voxel and finds none."""
    rng = np.random.default_rng(8)
    ijk = rng.integers(-6, 6, (400, 3)).astype(np.int32)
    mask = rng.random(400) < 0.8
    cap = 100
    j = jax.jit(JSparseGrid.from_coords, static_argnums=2)(
        jnp.asarray(ijk), jnp.asarray(mask), cap, 0.25, jnp.asarray(ORIGIN))
    t = S.SparseGrid.from_coords(torch.from_numpy(ijk),
                                 torch.from_numpy(mask), cap, 0.25, ORIGIN)
    assert t.num_voxels == int(j.num_voxels) == cap
    np.testing.assert_array_equal(t.active_grid_coords().numpy(),
                                  np.asarray(j.active_grid_coords()))
    np.testing.assert_array_equal(t.voxel_centers().numpy(),
                                  np.asarray(j.voxel_centers()))
    np.testing.assert_array_equal(
        t.lookup(torch.from_numpy(ijk)).numpy(),
        np.asarray(j.lookup(jnp.asarray(ijk))))
    e = S.SparseGrid.empty(16, 0.25, device="cpu")
    assert e.capacity == 16 and e.num_voxels == 0
    assert not e.active_mask().any()
    assert (e.lookup(torch.from_numpy(ijk)) == -1).all()


def test_visualization_matches_jax():
    j, t = build_pair("splat-origin")
    for (ts, te), (js, je) in zip(t.get_visualization(),
                                  j.get_visualization()):
        assert ts.shape == js.shape and ts.shape[0] > 0
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
        np.testing.assert_allclose(te, je, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["splat-origin", "adaptive-0.1-2"])
def test_layer_field_mask_equals_jax(case):
    j, t = build_pair(case)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32)
    ref = jax.jit(lambda h, p: JLayerField(h, 2).evaluate_mask(p))(
        j, jnp.asarray(x))
    got = LayerField(t, 2).evaluate_mask(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert set(got.numpy().tolist()) == {-1.0, 1.0}
    ev = LayerField(t).evaluate_f(torch.from_numpy(x), grad=True)
    assert torch.equal(ev.value, got) and not ev.gradient.any()


def small_kernel_field():
    """A ``KernelField`` with seeded features and coefficients on the
    cloud's splat grids (host grids, capacities of their sizes)."""
    xyz, _, _ = cloud()
    grids, _ = HB.build_splat_grids_ex(xyz[:-1], VS, 2)
    caps = [len(g.keys) for g in grids]
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn((c, 8), generator=gen) for c in caps]
    torch.manual_seed(0)
    mlps = [MLP(3 + 8, (16,), 4) for _ in range(2)]
    alpha = tuple(torch.randn(c * 4, generator=gen) for c in caps)
    return KernelField([VS, 2 * VS], caps, feats, mlps, 4, alpha=alpha,
                       host_grids=grids), grids


def test_kernel_field_public_signatures():
    """``evaluate_f(x, grad=False, sup_idx=None)`` joins the supports
    itself; ``evaluate_mask`` is the union of the supports (the
    ``LayerField`` of ``kf.svh``); ``evaluate_f_bar`` masks with it, and
    ``set_mask_field(LayerField)`` gives a masked copy that reads the
    same, as the JAX package's ``replace`` does; ``.svh`` holds the
    host grids."""
    kf, grids = small_kernel_field()
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.8, 0.8, (400, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        joined = kf.evaluate_f(xt, sup_idx=kf.host_supports(x))
        ev = kf.evaluate_f(xt)
        assert ev.gradient is None and torch.equal(ev.value, joined.value)
        g = kf.evaluate_f(xt, True)
        assert torch.equal(g.value, joined.value) and g.gradient.shape == \
            (400, 3)
        svh = kf.svh
        assert svh.voxel_size == np.float32(VS) and svh.depth == 2
        for sg, hg in zip(svh.grids, grids):
            np.testing.assert_array_equal(
                sg.coords[:sg.num_voxels].numpy(), hg.coords)
        m = kf.evaluate_mask(x)
        assert torch.equal(m, LayerField(svh).evaluate_mask(xt))
        fbar = kf.evaluate_f_bar(x)
        assert torch.equal(fbar, torch.where(m > 0, ev.value,
                                             -np.float32(VS)))
        assert (m < 0).any() and (m > 0).any()
        masked = kf.set_mask_field(LayerField(svh, 2))
        assert masked is not kf and kf.mask_field is None
        assert masked.mesh_adaptive_depth == 2
        assert torch.equal(masked.evaluate_f_bar(x), fbar)
        assert torch.equal(masked.evaluate_mask(x), m)

    # the neural field joins its supports itself too
    nf = NeuralField([VS, 2 * VS], kf.features, MLP(8, (16, 16), 1),
                     level_set=0.01, host_grids=grids)
    with torch.no_grad():
        joined = nf.evaluate_f(xt, sup_idx=nf.host_supports(x)).value
        assert torch.equal(nf.evaluate_f(x).value, joined)
        assert torch.equal(nf.evaluate_mask(x), np.float32(0.01) - joined)
