"""The port's evaluation layer against the JAX package's on the CPU:
``data/io.py`` (``read_ply``, ``read_ply_full``), the host kd-tree and
ray-cast of ``native.py`` (the port's copy of nksr_tpu/native/
raycast.cpp among its sources) and ``utils/metrics.py`` (``sample_mesh``,
``MeshEvaluator``).  Both sides run numpy and the same C++ code, so the
gates are equality, and 1e-6 relative for the metrics (the same float
sums in the same order)."""

import numpy as np
import pytest

from nksr_tpu import native as jnative
from nksr_tpu.data import io as jio
from nksr_tpu.utils import metrics as jmetrics
from nksr_tpu_torch import native
from nksr_tpu_torch.data import io
from nksr_tpu_torch.utils import metrics

from test_field import sphere_points


def _icosphere():
    """A closed sphere mesh (subdivided icosahedron, r 0.5) as (v, f)."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(3):
        mid = {}
        verts = list(v)

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(verts)
                verts.append((verts[a] + verts[b]) / 2)
            return mid[key]
        nf = []
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.array(verts), np.array(nf)
    v = 0.5 * v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), f.astype(np.int32)


class Mesh:
    def __init__(self, v, f):
        self.v, self.f = v, f


@pytest.fixture(scope="module")
def mesh():
    return _icosphere()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("parts", ["points", "normals", "mesh", "colors"])
def test_read_ply_matches_jax(tmp_path, mesh, writer, parts):
    """A binary PLY written by either package's ``write_ply`` reads back
    array for array through both packages' readers."""
    v, f = mesh
    rng = np.random.default_rng(0)
    kw = {}
    if parts in ("normals", "mesh", "colors"):
        kw["normals"] = v / np.linalg.norm(v, axis=1, keepdims=True)
    if parts in ("mesh", "colors"):
        kw["faces"] = f
    if parts == "colors":
        kw["colors"] = rng.random((len(v), 3)).astype(np.float32)
    path = tmp_path / "m.ply"
    (io if writer == "port" else jio).write_ply(path, v, **kw)
    got, ref = io.read_ply_full(path), jio.read_ply_full(path)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert g.dtype == r.dtype and np.array_equal(g, r)
    for g, r in zip(io.read_ply(path), jio.read_ply(path)):
        assert (g is None) == (r is None)
        if r is not None:
            assert np.array_equal(g, r)
    assert np.array_equal(got[0], v)


def test_read_ascii_ply_matches_jax(tmp_path):
    """An ASCII PLY with normals, colours in 0-255 and a quad face."""
    path = tmp_path / "a.ply"
    path.write_text(
        "ply\nformat ascii 1.0\ncomment hand-written\nelement vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 0 0 1 255 0 0\n1 0 0 0 0 1 0 255 0\n"
        "1 1 0 0 0 1 0 0 255\n0 1 0 0 0 1 10 20 30\n4 0 1 2 3\n")
    got, ref = io.read_ply_full(path), jio.read_ply_full(path)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    assert got[1].tolist() == [[0, 1, 2]]


def test_port_builds_its_raycast_copy():
    lib = native._load()
    assert lib is not None and hasattr(lib, "raycast_inside")


@pytest.mark.parametrize("fallback", [False, True])
def test_raycast_matches_jax(mesh, fallback, monkeypatch):
    """Occupancy of 4,000 queries in the closed sphere bit-equal to the
    JAX package's (the C++ routine, and the numpy fallback), and right
    away from the surface."""
    v, f = mesh
    q = np.random.default_rng(1).uniform(-0.7, 0.7, (4000, 3)).astype(
        np.float32)
    ref = jnative.raycast_inside(v, f, q)
    if fallback:
        monkeypatch.setattr(native, "_load", lambda: None)
    got = native.raycast_inside(v, f, q)
    assert got.dtype == bool and np.array_equal(got, ref)
    r = np.linalg.norm(q, axis=1)
    assert got[r < 0.45].all() and not got[r > 0.55].any()


def test_kdtree_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    q = rng.normal(size=(3000, 3)).astype(np.float32)
    for k in (1, 4):
        d, i = native.KDTree(pts).query(q, k)
        jd, ji = jnative.KDTree(pts).query(q, k)
        assert d.dtype == np.float32 and i.dtype == np.int32
        assert np.array_equal(d, jd) and np.array_equal(i, ji)


def test_sample_mesh_matches_jax(mesh):
    v, f = mesh
    got = metrics.sample_mesh(v, f, 20000, np.random.default_rng(5))
    ref = jmetrics.sample_mesh(v, f, 20000, np.random.default_rng(5))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    empty = metrics.sample_mesh(v, f[:0], 10)
    assert empty[0].shape == (0, 3)


def test_mesh_evaluator_matches_jax(mesh):
    """Every metric (all thresholds, normals, ray-cast IoU on ONet-style
    samples) within 1e-6 relative of the JAX package's, on the sphere
    mesh against a noisy sphere cloud larger than the sample count (so
    the reference subsample is drawn too)."""
    v, f = mesh
    xyz, nrm = sphere_points(30000, r=0.5, seed=3)
    xyz = xyz + np.random.default_rng(4).normal(0, 0.004, xyz.shape).astype(
        np.float32)
    q = np.random.default_rng(6).uniform(-0.6, 0.6, (3000, 3)).astype(
        np.float32)
    occ = (np.linalg.norm(q, axis=1) < 0.5).astype(np.float32)
    kw = dict(n_points=20000,
              metric_names=metrics.MeshEvaluator.ALL_METRICS, seed=7)
    got = metrics.MeshEvaluator(**kw).eval_mesh(Mesh(v, f), xyz, nrm,
                                                 onet_samples=(q, occ))
    ref = jmetrics.MeshEvaluator(**kw).eval_mesh(Mesh(v, f), xyz, nrm,
                                                  onet_samples=(q, occ))
    assert set(got) == set(ref) and "iou" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert got["chamfer-L1"] < 0.01 and got["iou"] > 0.9
    nan = metrics.MeshEvaluator().eval_mesh(Mesh(v, f[:0]), xyz)
    assert all(np.isnan(x) for x in nan.values())
