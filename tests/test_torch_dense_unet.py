"""The port's dense conv3d UNet (nksr_tpu_torch/models/dense_unet.py)
against nksr_tpu's dense_unet_apply, with the same random weights mapped
by params_to_torch, in f32."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bench import synthetic_scene
from nksr_tpu.models import dense_unet as JDU
from nksr_tpu.models import pipeline as JP
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.models import dense_unet as DU
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.utils.checkpoint import params_to_torch, torch_to_params

torch.set_num_threads(1)

SMALL = dict(tree_depth=3, f_maps=8, basis_dim=8, udf_dim=8)


def random_params(cfg, seed):
    """Every leaf random (init_params leaves the stride-2 weights and the
    normal heads at zero, which would test nothing): kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), GroupNorm scales 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(node, name):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        shape = node.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if len(shape) == 1:
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return {"params": fill(torch_to_params(NKSRNetwork(cfg).state_dict()),
                           "")}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_dense_unet_matches_jax():
    """Basis and normal features per active voxel: rtol 1e-4 / atol 1e-5
    (f32 on both sides, convs summed in other orders by XLA and by
    PyTorch's CPU conv3d)."""
    cfg = P.PipelineConfig(**SMALL)
    jcfg = JP.PipelineConfig(**SMALL)
    xyz, nrm = synthetic_scene(3000, seed=2, half_extent=2.0)
    grids, orders = HB.build_splat_grids_ex(xyz, cfg.voxel_size,
                                            cfg.tree_depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    plan = LAT.plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            cfg.voxel_size, cfg.tree_depth,
                            cfg.adaptive_depth, k=cfg.kernel_dim)
    params = random_params(cfg, 0)

    jt = JDU.build_tables(plan.spec, plan.origins, grids, caps, grids, caps)
    jbasis, jnormal, _, _ = jax.jit(
        lambda p, x, f, m: JDU.dense_unet_apply(
            jcfg, p, plan.spec, jnp.asarray(plan.origins), jt, x, f, m))(
        to_jax(params), jnp.asarray(xyz), jnp.asarray(nrm),
        jnp.ones(len(xyz), bool))

    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    tables = DU.build_tables(plan.spec, plan.origins, grids, caps, "cpu")
    perm = orders[0][1]
    with torch.no_grad():
        basis, normal = DU.dense_unet_apply(
            cfg, net, plan.spec, plan.origins, tables,
            torch.from_numpy(xyz[perm]), torch.from_numpy(nrm[perm]),
            torch.from_numpy(HB.unpack64(orders[0][0]).astype(np.int64)))

    for d in range(cfg.tree_depth):
        n = len(grids[d].keys)
        for name, ref, got in (("basis", jbasis[d], basis[d]),
                               ("normal", jnormal[d], normal[d])):
            ref = np.asarray(ref)
            got = got.numpy()
            assert got.shape == ref.shape, name
            assert np.abs(ref[:n]).max() > 0.1, (name, d)
            np.testing.assert_allclose(got[:n], ref[:n], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {d}")
            assert not got[n:].any() or name == "basis"
