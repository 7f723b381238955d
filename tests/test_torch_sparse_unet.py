"""The port's gather ops and gather-conv UNet (nksr_tpu_torch/ops/
gather_scatter.py, nksr_tpu_torch/models/sparse_unet.py) against
nksr_tpu's on the CPU: the encoder and the teacher-forced SparseUNet of
``_compiled_structure`` with the same host tables and random weights, at
tree depth 3 and 8 feature maps."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench import synthetic_scene
from nksr_tpu.core import host_build as JHB
from nksr_tpu.models import pipeline as JP
from nksr_tpu.ops import gather_scatter as JGS
from nksr_tpu.recon.reconstructor import _compiled_structure
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models import sparse_unet as SU
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.ops import gather_scatter as GS
from nksr_tpu_torch.utils.checkpoint import params_to_torch

from test_torch_dense_unet import SMALL, random_params, to_jax

torch.set_num_threads(1)

VS = 0.1


def test_offsets_and_octants_match():
    np.testing.assert_array_equal(GS.stencil_offsets(3),
                                  JGS.stencil_offsets(3))
    np.testing.assert_array_equal(GS.child_offsets(), JGS.child_offsets())
    c = np.random.default_rng(0).integers(-9, 9, (400, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        GS.octant_id(torch.from_numpy(c.astype(np.int64))).numpy(),
        np.asarray(JGS.octant_id(jnp.asarray(c))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_conv_matches(dtype):
    """take_rows and gather_conv with missing neighbours, more table rows
    than feature rows (a stride-2 conv's shape) and a bias.  f32: rtol
    1e-5 (sums in another order).  bf16: gathers and products in bf16,
    one f32 sum over all taps, rounded once, as the JAX package does; the
    two may then differ by one bf16 rounding step (rtol 2^-7)."""
    rng = np.random.default_rng(1)
    n_feat, n_rows, k, cin, cout = 300, 420, 27, 8, 12
    feat = rng.normal(size=(n_feat, cin)).astype(np.float32)
    nbr = rng.integers(-1, n_feat, (n_rows, k)).astype(np.int32)
    nbr[rng.random((n_rows, k)) < 0.3] = -1
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(JGS.gather_conv(
        jnp.asarray(feat).astype(jdt), jnp.asarray(nbr),
        jnp.asarray(w).astype(jdt), jnp.asarray(b)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = GS.gather_conv(torch.from_numpy(feat).to(tdt),
                         torch.from_numpy(nbr.astype(np.int64)),
                         torch.from_numpy(w).to(tdt),
                         torch.from_numpy(b)).float().numpy()
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    rows = GS.take_rows(torch.from_numpy(feat),
                        torch.from_numpy(nbr[:, :5].astype(np.int64)))
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(JGS.take_rows(jnp.asarray(feat),
                                               jnp.asarray(nbr[:, :5]))))


@pytest.fixture(scope="module")
def unet_pair():
    """One JAX and one port pass of encoder + UNet + heads over the same
    splat hierarchy, host tables and random weights, in f32."""
    xyz, nrm = synthetic_scene(3000, seed=3, half_extent=2.0)
    cfg = P.PipelineConfig(**SMALL)
    params = random_params(cfg, 1)
    grids, orders = HB.build_splat_grids_ex(xyz, VS, cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    jcfg = dataclasses.replace(JP.PipelineConfig(**SMALL), capacities=caps,
                               voxel_size=VS, structure_mode="splat")
    svh = JHB.to_device_svh(grids, caps, VS)
    jt = JHB.build_unet_tables(grids, caps, JGS.stencil_offsets(3))
    splat0 = HB.support_indices(grids[:1], caps[:1], xyz,
                                presorted=orders[:1])[0]
    out, _, _ = _compiled_structure(jcfg)(
        to_jax(params), jnp.asarray(xyz), jnp.ones(len(xyz), bool),
        jnp.asarray(nrm), svh, svh, jt, jnp.asarray(splat0))

    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    ut = HB.build_unet_tables(grids, caps, GS.stencil_offsets(3))
    ut = HB.UNetTables(*(tuple(torch.from_numpy(t.astype(np.int64))
                               for t in part) for part in ut))
    basis, normal, _ = SU.sparse_unet_apply(
        cfg, net, ut, [len(g.keys) for g in grids], caps,
        [torch.from_numpy(g.coords.astype(np.int64)) for g in grids],
        torch.from_numpy(xyz), torch.from_numpy(nrm),
        torch.from_numpy(splat0.astype(np.int64)))
    return grids, caps, out, basis, normal


@pytest.mark.parametrize("d", [0, 1, 2])
def test_sparse_unet_matches_jax(unet_pair, d):
    """Basis and normal features per depth on the active rows: rtol
    1e-4 / atol 1e-5 of the largest feature (f32 on both sides; the 27
    taps, the GroupNorm statistics and the scatters sum in other
    orders).  Padding rows hold what the JAX package writes there: the
    basis head's bias and zero normals."""
    grids, caps, out, basis, normal = unet_pair
    n = len(grids[d].keys)
    assert basis[d].shape == out.basis_features[d].shape == (caps[d], 8)
    assert normal[d].shape == out.normal_features[d].shape == (caps[d], 3)
    for got, ref in ((basis[d], out.basis_features[d]),
                     (normal[d], out.normal_features[d])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[:n].numpy(), ref[:n], rtol=1e-4,
                                   atol=1e-5 * np.abs(ref[:n]).max())
        np.testing.assert_allclose(got[n:].numpy(), ref[n:], rtol=1e-6,
                                   atol=1e-7)
