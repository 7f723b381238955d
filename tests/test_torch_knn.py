"""The port's grid-bucket kNN, PCA normals and the normal-estimation
preprocess (nksr_tpu_torch/ops/knn.py, ``get_estimate_normal_preprocess_fn``)
against nksr_tpu/ops/knn.py on the CPU, on seeded clouds.

Neighbour sets are compared as sets (a tie at the k-th place may order
two rows differently, never choose differently), squared distances to
rtol 1e-6 (the same f32 terms).  Eigenvectors are defined only up to
sign, and not at all where the two smallest eigenvalues nearly
coincide: normals are held where the eigen-gap is clear.  The grazing
cut (85 degrees) is held away from the threshold only: a point on it may
fall either way in f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nksr_tpu import get_estimate_normal_preprocess_fn as jax_preprocess
from nksr_tpu.ops import knn as JK
from nksr_tpu_torch import get_estimate_normal_preprocess_fn
from nksr_tpu_torch.ops import knn as K

torch.set_num_threads(1)

# a normal's |dot| with the JAX package's; the two smallest eigenvalues
# this far apart (relative to the largest) make the eigenvector stable
# to well below that in f32
DOT_TOL = 1e-5
EIGEN_GAP = 1e-2
# |cos| this far from cos(85 degrees) decides the grazing cut alike
COS_CLEAR = 1e-4


N, KNN, M = 3000, 16, 8     # one shape for every JAX call: one compile
SENSOR_Z = 0.6              # over a 4 m patch: about 13% past 85 degrees


def _terrain(n, seed, half=2.0, noise=0.02):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-half, half, (n, 2))
    z = 0.3 * np.sin(1.5 * xy[:, 0]) * np.cos(xy[:, 1]) \
        + noise * rng.normal(size=n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def _sensor(xyz, z):
    sens = np.zeros_like(xyz)
    sens[:, 2] = z
    return sens


def _jax_knn(xyz, queries, cs):
    table = JK.build_buckets(jnp.asarray(xyz), jnp.ones(len(xyz), bool), cs,
                             1 << 12, M)
    idx, d2 = JK.knn_search(table, jnp.asarray(xyz), jnp.asarray(queries),
                            KNN)
    return np.asarray(idx), np.asarray(d2)


def _jax_normals(xyz, cs, sens):
    nrm, keep = JK.estimate_normals(
        jnp.asarray(xyz), jnp.ones(len(xyz), bool), KNN, cs, 1 << 12, M,
        sensor=jnp.asarray(sens))
    return np.asarray(nrm), np.asarray(keep)


def _gap(xyz, idx):
    """Relative gap of the two smallest eigenvalues of each neighbour
    covariance (float64)."""
    p = xyz[np.maximum(idx, 0)].astype(np.float64)
    w = (idx >= 0)[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(1), 1.0)                          # (Q, 1)
    d = (p - ((p * w).sum(1) / cnt)[:, None]) * w
    ev = np.linalg.eigvalsh(np.einsum("qki,qkj->qij", d, d)
                            / cnt[:, :, None])
    return (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-30)


@pytest.fixture(scope="module")
def crowded():
    """A terrain with a clump of 60 points inside one bucket (far past
    max_per_cell), queried at its points and at 400 points within 1e-4
    of bucket faces; the JAX package's neighbours."""
    rng = np.random.default_rng(2)
    xyz = _terrain(N - 60, 2)
    cs0 = K.estimate_cell_size(xyz, KNN)
    clump = np.array([0.3, -0.2, 0.1]) + rng.uniform(0, 0.2 * cs0, (60, 3))
    xyz = np.concatenate([xyz, clump]).astype(np.float32)
    cs = K.estimate_cell_size(xyz, KNN)
    # the bucket of x is round(x / cs): its faces lie at (i + 0.5) * cs
    q = xyz[:400].copy()
    axis = rng.integers(0, 3, 400)
    face = (np.round(q / cs) + 0.5) * cs + rng.uniform(-1e-4, 1e-4, q.shape)
    q[np.arange(400), axis] = face[np.arange(400), axis]
    queries = np.concatenate([xyz[400:], q]).astype(np.float32)
    return (xyz, queries, cs) + _jax_knn(xyz, queries, cs)


@pytest.fixture(scope="module")
def lit():
    """A terrain lit from a low sensor: the JAX package's neighbours,
    normals and keep mask, and where the eigen-gap is clear."""
    xyz = _terrain(N, 4)
    sens = _sensor(xyz, SENSOR_Z)
    cs = K.estimate_cell_size(xyz, KNN)
    idx, _ = _jax_knn(xyz, xyz, cs)
    nrm, keep = _jax_normals(xyz, cs, sens)
    return xyz, sens, cs, idx, nrm, keep, _gap(xyz, idx) > EIGEN_GAP


@pytest.mark.parametrize("shape", ["planar", "volume", "line", "single"])
def test_estimate_cell_size_matches_jax(shape):
    rng = np.random.default_rng(1)
    xyz = {"planar": _terrain(N, 1, noise=0.0) * [1, 1, 0.01],
           "volume": rng.uniform(-1, 1, (N, 3)),
           "line": np.outer(rng.uniform(0, 5, 500), [1.0, 0.5, 0.2]),
           "single": np.zeros((1, 3))}[shape].astype(np.float32)
    for k in (8, 64):
        assert K.estimate_cell_size(xyz, k) == JK.estimate_cell_size(xyz, k)


@pytest.mark.parametrize("wave", [257, K._WAVE])
def test_neighbour_sets_match_jax(crowded, wave, monkeypatch):
    """An overfilled bucket and queries on bucket faces, in one wave and
    in several ragged ones."""
    xyz, queries, cs, jidx, jd2 = crowded
    monkeypatch.setattr(K, "_WAVE", wave)
    table = K.build_buckets(torch.from_numpy(xyz), cs, M)
    per_cell = torch.bincount(torch.unique(K._pack(K._cells(
        torch.from_numpy(xyz), table.cell_size)), return_inverse=True)[1])
    assert int(per_cell.max()) > 3 * M, "no bucket overfilled"
    idx, d2 = K.knn_search(table, torch.from_numpy(xyz),
                           torch.from_numpy(queries), KNN)
    idx, d2 = idx.numpy(), d2.numpy()
    assert idx.shape == jidx.shape == (len(queries), KNN)
    np.testing.assert_array_equal(np.sort(idx, 1), np.sort(jidx, 1))
    fin = np.isfinite(jd2)
    np.testing.assert_array_equal(np.isfinite(d2), fin)
    np.testing.assert_allclose(d2[fin], jd2[fin], rtol=1e-6)


def test_pca_normals_match_jax(lit):
    xyz, _, _, jidx, _, _, clear = lit
    jn = np.asarray(JK.pca_normals(jnp.asarray(xyz), jnp.asarray(jidx)))
    tn = K.pca_normals(torch.from_numpy(xyz), torch.from_numpy(
        jidx.astype(np.int64))).numpy()
    assert clear.mean() > 0.9
    dot = np.abs((jn * tn).sum(1))
    assert (dot[clear] >= 1 - DOT_TOL).all(), dot[clear].min()


def test_estimate_normals_with_sensor_matches_jax(lit):
    """Normals flipped toward the sensor to 1e-5 where the eigen-gap is
    clear and the view is not edge-on; keep masks equal away from the
    cut, which drops some of the points."""
    xyz, sens, cs, _, jn, jkeep, clear = lit
    tn, tkeep = K.estimate_normals(torch.from_numpy(xyz), KNN, cs, M,
                                   sensor=torch.from_numpy(sens))
    tn, tkeep = tn.numpy(), tkeep.numpy()
    view = sens - xyz
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    cos = np.abs((view * jn).sum(1))
    away = np.abs(cos - np.cos(np.deg2rad(85.0))) > COS_CLEAR
    np.testing.assert_array_equal(tkeep[away], jkeep[away])
    assert 0.05 < 1 - jkeep.mean() < 0.5, "no grazing points cut"
    held = clear & (cos > 1e-3)
    assert held.mean() > 0.9
    np.testing.assert_allclose(tn[held], jn[held], atol=1e-5)


def test_estimate_normals_without_sensor_keeps_every_point(lit):
    """No sensor: PCA's sign (held by |dot|), every point kept."""
    xyz, _, cs, _, jn, _, clear = lit
    tn, tkeep = K.estimate_normals(torch.from_numpy(xyz), KNN, cs, M)
    assert tkeep.all()
    dot = np.abs((tn.numpy() * jn).sum(1))
    assert (dot[clear] >= 1 - DOT_TOL).all()


def test_preprocess_matches_jax(lit):
    """The preprocess's outputs row for row: the kept points bit-equal,
    their normals to 1e-5 where the eigen-gap is clear, no sensor."""
    xyz, sens, _, _, _, jkeep, clear = lit
    jx, jn, js = jax_preprocess(KNN, 85.0)(xyz, None, sens)
    fn = get_estimate_normal_preprocess_fn(KNN, 85.0, device="cpu")
    tx, tn, ts = fn(xyz, None, sens)
    assert js is None and ts is None
    assert tx.dtype == tn.dtype == np.float32 and len(tx) < len(xyz)
    np.testing.assert_array_equal(tx, jx)
    held = clear[jkeep]
    np.testing.assert_allclose(tn[held], jn[held], atol=1e-5)
    assert {"knn: buckets", "knn: waves", "knn: pca eigh",
            "knn: orientation"} <= set(fn.phase_times)


def test_preprocess_refuses_bad_input():
    xyz = _terrain(100, 6)
    fn = get_estimate_normal_preprocess_fn(KNN, 85.0, device="cpu")
    with pytest.raises(ValueError, match="normals already provided"):
        fn(xyz, xyz, xyz)
    with pytest.raises(ValueError, match="sensor positions required"):
        fn(xyz, None, None)


def test_preprocess_defaults_to_the_card_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    xyz = _terrain(100, 7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_estimate_normal_preprocess_fn(KNN, 85.0)(xyz, None, xyz + 1.0)


def test_closed_form_eigenvector_matches_lapack():
    """The 3x3 solver against numpy's (LAPACK) float64 ``eigh`` on random
    symmetric matrices from isotropic to nearly planar and linear, where
    the two smallest eigenvalues are 1e-4 of the largest apart (|dot|
    to 1e-6: the float64 solve, then f32); the identity and zero
    matrices read (1, 0, 0)."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(4000, 3, 3)))
    ev = np.sort(rng.uniform(0, 1, (4000, 3)) * 10.0 ** rng.uniform(
        -6, 0, (4000, 3)), 1)
    cov = np.einsum("qij,qj,qkj->qik", q, ev, q)
    got = K._smallest_eigenvector(torch.from_numpy(cov)).numpy()
    w, v = np.linalg.eigh(cov)
    clear = (w[:, 1] - w[:, 0]) > 1e-4 * w[:, 2]
    assert clear.mean() > 0.5
    dot = np.abs((got * v[:, :, 0]).sum(1))
    assert (dot[clear] > 1 - 1e-6).all(), dot[clear].min()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    special = torch.stack([torch.eye(3), torch.zeros(3, 3)]).double()
    np.testing.assert_array_equal(K._smallest_eigenvector(special).numpy(),
                                  [[1, 0, 0], [1, 0, 0]])
