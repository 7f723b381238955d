"""The port's texture field (``fields/neural_field.PCNNField``) and the
coloured meshes of every mesher against the JAX package on the CPU.

``PCNNField``: the bucket cells, their representatives and the nearest
point of each query, hence the colours, equal the JAX package's bit for
bit, on duplicates in a cell, half-cell coordinates (round half to even),
a cloud with more cells than ``capacity`` (the smallest keys stay),
masked-out points and queries with no point in their 27 cells.

Coloured meshes, each from ``Reconstructor(device="cpu").reconstruct``
then ``set_texture_field(PCNNField.build(xyz, colour, cell_size=4 *
voxel, capacity=2048))`` and ``extract_dual_mesh(mise_iter=1)``: the
dense mesher (the splat route's lattice), the host mesher (route B: two
patches 200 m apart; route A: the port's budgets monkeypatched to 0),
and, in ``tests/test_torch_texture_chunked.py``, the in-graph mesher
(``dual_mc.py``, ``structure="predicted_ingraph"`` from
runs/synth_r3c/best.ckpt) and the chunked meshes (the union mesh of
splat chunks, per-chunk meshing of in-graph chunks).  Each mesh's
``v`` and ``f`` equal the same field's uncoloured mesh bit for bit, and
its colours equal the JAX ``PCNNField`` evaluated at its own vertices
bit for bit (the port's solves and meshes are held against the JAX
package in the other test files).  The weights are random (no parity
of fields is asked here), the solves short.

Last, ``nksr_tpu_torch/examples/recons_colored_mesh.py`` on a small
coloured PLY and on one without colours.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_scene
from nksr_tpu.fields import PCNNField as JPCNNField
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.data import read_ply_full, write_ply
from nksr_tpu_torch.examples import recons_colored_mesh
from nksr_tpu_torch.fields.neural_field import PCNNField
from nksr_tpu_torch.meshing import lattice_mc as LMC
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.recon import reconstructor as R
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.utils.checkpoint import load_tree, model_params
from nksr_tpu_torch.utils.config import load_config

from test_field import sphere_points
from test_torch_dense_unet import SMALL, random_params
from test_torch_sparse_slice import _params, _two_patches

torch.set_num_threads(1)

VS = 0.1
KW = dict(detail_level=None, voxel_size=VS, solver_tol=1e-4,
          solver_max_iters=16)
# the bucket capacity throughout: one compile of the JAX package's build
CAP = 2048
RUN = Path(__file__).resolve().parents[1] / "runs" / "synth_r3c"


# ------------------------------------------------------------- PCNNField
def _cloud(case, rng):
    """(points, mask, cell size) of a case: 3,000 points in [-1, 1]^3 in
    cells of 0.2 (at most 1,331 cells), or of 0.1 (about 2,300: over
    ``CAP``)."""
    n = 3000
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    cell = 0.2
    if case == "duplicates":
        xyz[1000:2500] = xyz[:1500]
    elif case == "half_cell":
        # on a 0.1 lattice: every other coordinate is half a cell
        xyz = (rng.integers(-10, 11, (n, 3)) * 0.1).astype(np.float32)
    elif case == "overflow":
        cell = 0.1
    elif case == "masked":
        mask = rng.random(n) > 0.3
    return xyz, mask, cell


PAD = 8192


def _jax_pcnn(xyz, attrs, mask, q, cell, cap):
    """The JAX field over ``xyz`` (at most ``PAD`` points) at ``q``: per
    attribute its values, then its representatives and cell count.  Op
    by op, as the JAX package's dense and host meshers evaluate a
    texture (jitted whole, XLA may contract the squared distances into
    FMAs and break exact ties the other way), on arrays padded to shared
    shapes so that the compiles of its ops are reused: padded points are
    masked out and padded queries dropped, which changes no value."""
    def pad(a, m):
        return jnp.asarray(np.pad(a, [(0, m - len(a))] + [(0, 0)] *
                                  (a.ndim - 1)))
    f = JPCNNField.build(pad(xyz, PAD), pad(attrs[0], PAD),
                         pad(np.asarray(mask, bool), PAD), cell, cap)
    outs = []
    for attr in attrs:
        g = f.replace(attr=pad(attr, PAD))
        outs.append(np.concatenate([
            np.asarray(g.evaluate_f(pad(q[i:i + PAD], PAD)).value)
            [:len(q[i:i + PAD])] for i in range(0, len(q), PAD)]))
    return outs + [np.asarray(f.cell_point), int(f.grid.num_voxels)]


@pytest.mark.parametrize("case", ["duplicates", "half_cell", "overflow",
                                  "masked"])
def test_pcnn_field_matches_jax(case):
    """Cells, representatives, nearest points and colours bit for bit;
    the queries span three times the cloud, so many have no point in
    their 27 cells (zeros in both)."""
    rng = np.random.default_rng(["duplicates", "half_cell", "overflow",
                                 "masked"].index(case))
    xyz, mask, cell = _cloud(case, rng)
    col = rng.random((len(xyz), 3)).astype(np.float32)
    # the point index plus one, as a colour (shapes shared with col)
    idx = np.repeat((np.arange(len(xyz)) + 1).astype(np.float32)[:, None],
                    3, 1)
    q = rng.uniform(-1.5, 1.5, (6000, 3)).astype(np.float32)
    if case == "half_cell":
        # halfway between lattice points: distance ties
        q[:3000] = ((rng.integers(-20, 20, (3000, 3)) + 0.5) * 0.05
                    ).astype(np.float32)
    jval, jpick, jcp, n = _jax_pcnn(xyz, (col, idx), mask, q, cell, CAP)
    tf = PCNNField.build(torch.from_numpy(xyz), torch.from_numpy(col),
                         torch.from_numpy(mask), cell, CAP)
    assert tf.cells.numel() == n and (n == CAP) == (case == "overflow")
    np.testing.assert_array_equal(tf.cell_point.numpy(),
                                  np.asarray(jcp)[:n])
    pick = tf.nearest(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(pick, jpick[:, 0].astype(np.int64) - 1)
    assert 0 < (pick < 0).sum() < len(q)
    got = tf.evaluate_f(torch.from_numpy(q)).value.numpy()
    np.testing.assert_array_equal(got, jval)
    assert (got[pick < 0] == 0).all()


# -------------------------------------------------------- coloured meshes
def _by_position(xyz):
    return ((xyz - xyz.min(0)) / (xyz.max(0) - xyz.min(0))).astype(
        np.float32)


def _texture(xyz):
    """The example's texture (colour by position) and a function of
    vertices giving the JAX package's colours there."""
    col = _by_position(xyz)
    cell = 4 * float(np.float32(VS))
    tex = PCNNField.build(torch.from_numpy(xyz), torch.from_numpy(col),
                          torch.ones(len(xyz), dtype=torch.bool), cell, CAP)

    def jax_colours(v):
        return _jax_pcnn(xyz, (col,), np.ones(len(xyz), bool), v, cell,
                         CAP)[0]
    return jax_colours, tex


def _check_coloured(plain, coloured, jax_colours, min_faces=100):
    """The texture moves no geometry; the colours are the JAX field's at
    the mesh's vertices."""
    assert len(plain.f) > min_faces and plain.c is None
    np.testing.assert_array_equal(coloured.v, plain.v)
    np.testing.assert_array_equal(coloured.f, plain.f)
    assert coloured.c.shape == (len(coloured.v), 3)
    assert coloured.c.dtype == np.float32 and np.isfinite(coloured.c).all()
    np.testing.assert_array_equal(coloured.c, jax_colours(coloured.v))


def _mesh_both(field, xyz, **kw):
    plain = field.extract_dual_mesh(mise_iter=1, **kw)
    jcol, tex = _texture(xyz)
    assert field.set_texture_field(tex) is field
    coloured = field.extract_dual_mesh(mise_iter=1, **kw)
    field.set_texture_field(None)
    return plain, coloured, jcol


def _small_recon():
    cfg = P.PipelineConfig(**SMALL)
    return Reconstructor(device="cpu", config=cfg, params=_params(cfg))


def test_dense_mesher_colours():
    xyz, nrm = synthetic_scene(1500, seed=3, half_extent=1.25)
    field = _small_recon().reconstruct(xyz, nrm, structure="splat", **KW)
    assert field.lattice_ctx is not None
    plain, coloured, jcol = _mesh_both(field, xyz)
    assert "dual mc" in field.phase_times
    _check_coloured(plain, coloured, jcol)


@pytest.mark.parametrize("route", ["B", "A"])
def test_host_mesher_colours(route, monkeypatch):
    """Route B (the support-row field) and route A (the lattice field
    over the dense mesher's budget) mesh on the host."""
    if route == "B":
        xyz, nrm = _two_patches(400, 0.8)
    else:
        xyz, nrm = synthetic_scene(1500, seed=3, half_extent=1.25)
        monkeypatch.setattr(R, "DENSE_UNET_CELLMAP_BUDGET", 0)
        monkeypatch.setattr(LMC, "DENSE_CELL_BUDGET", 0)
    field = _small_recon().reconstruct(xyz, nrm, structure="splat", **KW)
    assert (field.lattice_ctx is None) == (route == "B")
    plain, coloured, jcol = _mesh_both(field, xyz)
    assert "host dual mc" in field.phase_times
    assert "mc: colours" in field.phase_times
    _check_coloured(plain, coloured, jcol)


# ------------------------------------------------------------ the example
@pytest.mark.parametrize("with_colours", [True, False])
def test_recons_colored_mesh_example(with_colours, tmp_path):
    """The example on a small PLY on ``device="cpu"``: the written mesh
    reads back with a colour per vertex (the cloud's, or by position)."""
    xyz, nrm = sphere_points(800, r=0.5, seed=2)
    col = np.random.default_rng(2).random((len(xyz), 3)).astype(np.float32)
    write_ply(tmp_path / "cloud.ply", xyz, normals=nrm,
              colors=col if with_colours else None)
    cfg = P.PipelineConfig(tree_depth=2, f_maps=8, basis_dim=8, udf_dim=8)
    mesh = recons_colored_mesh.main(
        str(tmp_path / "cloud.ply"), str(tmp_path / "colored.ply"),
        reconstructor=Reconstructor(device="cpu", config=cfg))
    v, f, _, c = read_ply_full(tmp_path / "colored.ply")
    assert len(f) == len(mesh.f) > 0 and c.shape == (len(v), 3)
    np.testing.assert_allclose(c, mesh.c, rtol=0, atol=1 / 255 + 1e-6)
    assert (c >= 0).all() and (c <= 1).all()
    if with_colours:
        # every vertex carries one of the cloud's colours (as read back)
        def code(a):
            q = np.round(a * 255).astype(np.int64)
            return (q[:, 0] << 16) | (q[:, 1] << 8) | q[:, 2]
        cloud = read_ply_full(tmp_path / "cloud.ply")[3]
        assert np.isin(code(mesh.c), code(cloud)).all()
