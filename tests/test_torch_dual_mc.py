"""The port's in-graph mesher (nksr_tpu_torch/meshing/dual_mc.py, through
``KernelField.extract_dual_mesh``) against the JAX package's
``nksr_tpu.meshing.dual_mc.extract_dual_mesh`` on the CPU, on one field
carried from JAX into the port: tests/test_meshing.py's sphere (3,000
points, r 0.5, voxel 0.1, tree depth 3, capacities 8192/4096/2048)
solved to tol 1e-6 in the JAX package, with seeded numpy basis features
and interpolator weights; its coefficients, features and grids go to
the port as numpy.  The mask is the union of supports (the JAX
``LayerField``) or a UDF ``NeuralField`` on the same hierarchy.

Gates: vertex and face counts equal, faces equal as index arrays (the
vertex array is the extraction lattice in packed-key order in both) and
vertices within 1e-4 voxel; the mesher fed the JAX package's own corner
values within 1e-5 voxel at ``mise_iter=0``.  The end-to-end vertices
are held at the Newton steps' bound throughout because a crossing
between two corners of nearly equal value magnifies the fields' f32
differences (other summation orders) by 1 / |f_a - f_b|: at
``grid_upsample=2`` one vertex in 9,840 reads 1.29e-5 voxel off, from
corner values 1.5e-4 and -1.0e-4 that differ by 2e-8 (4e-7 of the
largest |f|) between the packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nksr_tpu.core import host_build as JHB
from nksr_tpu.fields import DecoderFn, KernelField as JKernelField
from nksr_tpu.fields import LayerField
from nksr_tpu.fields import NeuralField as JNeuralField
from nksr_tpu.fields import support as JS
from nksr_tpu.meshing import dual_mc as JDMC
from nksr_tpu.models.network import MLP as JMLP, Interpolators
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields.kernel_field import KernelField
from nksr_tpu_torch.fields.neural_field import NeuralField, PCNNField
from nksr_tpu_torch.meshing import dual_mc as DMC
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from test_field import solve_sphere, sphere_points
from test_torch_dense_unet import SMALL, random_params, to_jax

VS = 0.1
CAPS = (8192, 4096, 2048)


@pytest.fixture(scope="module")
def fields():
    cfg = P.PipelineConfig(**SMALL)
    params = random_params(cfg, 5)
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    net.requires_grad_(False)
    xyz, nrm = sphere_points(3000, r=0.5, seed=11)
    grids, _ = HB.build_splat_grids_ex(xyz, VS, cfg.tree_depth)
    rng = np.random.default_rng(8)
    feats = [(0.05 * rng.normal(size=(c, cfg.basis_dim))).astype(np.float32)
             for c in CAPS]
    svh = JHB.to_device_svh(grids, CAPS, VS)
    jinterp = JS.InterpolatorFn(
        params={"params": to_jax(params["params"]["interpolators"])},
        module=Interpolators(depth=cfg.tree_depth, kernel_dim=cfg.kernel_dim,
                             n_hidden=cfg.interp_layers,
                             hidden_dim=cfg.interp_hidden))
    jfield = JKernelField(svh=svh, features=tuple(map(jnp.asarray, feats)),
                          interp=jinterp, kernel_dim=cfg.kernel_dim)
    jfield = jax.jit(functools.partial(
        solve_sphere, solver_tol=1e-6, max_iters=300))(jfield, xyz, nrm)
    vss = [P.level_voxel_size(cfg, d) for d in range(cfg.tree_depth)]
    field = KernelField(
        vss, CAPS, [torch.from_numpy(f) for f in feats],
        [net.interpolators.level(d) for d in range(cfg.tree_depth)],
        cfg.kernel_dim,
        alpha=tuple(torch.from_numpy(np.array(a).reshape(-1))
                    for a in jfield.alpha),
        host_grids=grids, adaptive_depth=1)

    # the UDF mask: random features on the same hierarchy, the level set
    # at the median of the UDF over the input points (half the shell)
    ufeats = [rng.normal(size=(c, cfg.udf_dim)).astype(np.float32)
              for c in CAPS]
    mask = NeuralField(vss, [torch.from_numpy(f) for f in ufeats],
                       net.udf_decoder, host_grids=grids)
    udf = mask.evaluate_f(torch.from_numpy(xyz),
                          sup_idx=mask.host_supports(xyz)).value
    level = float(np.float32(np.median(udf.numpy())))
    mask = mask.set_level_set(level)
    jmask = JNeuralField(
        svh=svh, features=tuple(map(jnp.asarray, ufeats)),
        decoder=DecoderFn(params=to_jax({"params": params["params"][
            "udf_decoder"]}), module=JMLP(hidden=(2 * cfg.udf_dim,) * 2,
                                          out=1))).set_level_set(level)
    return dict(jax=jfield, port=field, mask=mask, jmask=jmask)


def jax_mesh(field, **kw):
    """The JAX package's mesher, jitted whole (its compile takes seconds
    where op-by-op dispatch takes tens of them), trimmed on the host."""
    return jax.jit(functools.partial(JDMC.extract_dual_mesh, trim=False,
                                     **kw))(field).trim()


def _check(got, ref, tol_voxels):
    assert got.v.shape == ref.v.shape and got.f.shape == ref.f.shape
    assert got.v.dtype == np.float32 and got.f.dtype == np.int32
    assert len(got.f) > 100 and got.c is None
    np.testing.assert_array_equal(got.f, ref.f)
    np.testing.assert_allclose(got.v, ref.v, rtol=0, atol=tol_voxels * VS)


@pytest.mark.parametrize("mise_iter,upsample,max_quads,udf", [
    (0, 1, None, False), (1, 1, None, False), (2, 1, None, False),
    (0, 2, None, False), (1, 1, 300, False), (0, 1, None, True)])
def test_dual_mc_matches_jax(fields, mise_iter, upsample, max_quads, udf,
                             monkeypatch):
    jfield = fields["jax"].set_mask_field(
        fields["jmask"] if udf else LayerField(fields["jax"].svh, 1))
    field = fields["port"]
    field.mask_field = fields["mask"] if udf else None
    kw = dict(mise_iter=mise_iter, grid_upsample=upsample,
              max_quads=max_quads)
    ref = jax_mesh(jfield, **kw)
    got = field.extract_dual_mesh(max_points=3000, **kw)
    _check(got, ref, 1e-4)
    if max_quads:
        assert len(got.f) == 2 * max_quads
    if udf:
        field.mask_field = None
        assert len(got.f) < len(field.extract_dual_mesh(mise_iter=0).f)
    if mise_iter == 0:
        # the mesher's own arithmetic on the JAX package's corner values
        f_bar = jax.jit(lambda f, x: f.evaluate_f_bar(x))
        field.mask_field = fields["mask"] if udf else None
        monkeypatch.setattr(
            field, "evaluate_f_bar", lambda x: torch.from_numpy(
                np.array(f_bar(jfield, jnp.asarray(x)))), raising=False)
        _check(field.extract_dual_mesh(**kw), ref, 1e-5)


def test_lattice_and_texture_guard(fields):
    """The extraction lattice is the JAX package's (keys, capacity, cell
    size); a field with a texture meshes the same ``v`` and ``f`` with a
    colour per vertex (held against the JAX package in
    ``tests/test_torch_texture_chunked.py``)."""
    field = fields["port"]
    field.mask_field = None
    keys, cap, s = DMC.extraction_lattice(field, 2)
    ext, js = JDMC.extraction_lattice(
        fields["jax"].set_mask_field(LayerField(fields["jax"].svh, 1)), 2)
    n = int(ext.num_voxels)
    assert cap == ext.capacity and s == np.float32(js)
    np.testing.assert_array_equal(HB.unpack64(keys),
                                  np.asarray(ext.coords)[:n])

    plain = field.extract_dual_mesh()
    xyz = plain.v[::7].copy()
    tex = PCNNField.build(torch.from_numpy(xyz), torch.from_numpy(xyz),
                          torch.ones(len(xyz), dtype=torch.bool), 0.1, 4096)
    try:
        got = field.set_texture_field(tex).extract_dual_mesh()
    finally:
        field.set_texture_field(None)
    np.testing.assert_array_equal(got.v, plain.v)
    np.testing.assert_array_equal(got.f, plain.f)
    assert got.c.shape == got.v.shape
    np.testing.assert_array_equal(got.c[::7], xyz)
