"""The port's flax-free checkpoint reader and parameter map
(nksr_tpu_torch/utils/checkpoint.py) against flax itself."""

import os

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from nksr_tpu.models import pipeline as JP
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.utils import checkpoint as CK

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("ckpt", ["runs/scene_big/best.ckpt",
                                  "runs/scene_big/last.ckpt",
                                  "runs/synth_r3c/best.ckpt"])
def test_reader_equals_flax(ckpt):
    """Leaf for leaf: same paths, dtypes, shapes and bytes (TrainState
    trees, optimizer state and numpy scalars included)."""
    path = os.path.join(ROOT, ckpt)
    if not os.path.exists(path):
        pytest.skip(f"{ckpt} is not in this checkout")
    with open(path, "rb") as f:
        data = f.read()
    ref = dict(_leaves(serialization.msgpack_restore(data)))
    got = dict(_leaves(CK.msgpack_restore(data)))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r)
        else:
            assert type(g) is type(r) and g == r, k


def test_default_config_tree_matches_jax_and_checkpoint():
    """NKSRNetwork of the default PipelineConfig, in flax layout, has the
    shapes of JAX init_params and of the scene_big checkpoint: 145
    leaves."""
    ref = dict(_leaves(JP.init_params(JP.PipelineConfig(),
                                      jax.random.PRNGKey(0))["params"]))
    shapes = {k: v.shape for k, v in _leaves(CK.torch_to_params(
        NKSRNetwork(P.PipelineConfig()).state_dict()))}
    assert shapes == {k: tuple(v.shape) for k, v in ref.items()}
    ck = CK.model_params(CK.load_tree(
        os.path.join(ROOT, "runs/scene_big/best.ckpt")))
    assert {k: v.shape for k, v in _leaves(ck)} == shapes
    assert len(shapes) == 145


def test_params_to_torch_round_trips():
    """checkpoint -> state dict -> NKSRNetwork (strict load) -> state
    dict -> flax layout reproduces every leaf exactly."""
    tree = CK.load_tree(os.path.join(ROOT, "runs/scene_big/best.ckpt"))
    net = NKSRNetwork(P.PipelineConfig())
    net.load_state_dict(CK.params_to_torch(tree), strict=True)
    back = dict(_leaves(CK.torch_to_params(net.state_dict())))
    ref = dict(_leaves(CK.model_params(tree)))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v)


def test_conv_weight_map_is_the_jax_cross_correlation():
    """SparseConv tap ((ox+1)*3+(oy+1))*3+(oz+1) of a (27, Cin, Cout)
    kernel becomes conv3d weight[:, :, ox+1, oy+1, oz+1]: a unit impulse
    through F.conv3d reads the tap of the mirrored offset."""
    rng = np.random.default_rng(0)
    w27 = rng.normal(size=(27, 2, 3)).astype(np.float32)
    sd = CK.params_to_torch({"unet": {"enc_0": {"SparseConv_0": {
        "kernel": w27, "bias": np.zeros(3, np.float32)}}}})
    w = sd["unet.enc_0.SparseConv_0.weight"]
    x = torch.zeros((1, 2, 3, 3, 3))
    x[0, 1, 0, 1, 2] = 1.0                     # offset (-1, 0, +1)
    out = torch.nn.functional.conv3d(x, w, padding=1)[0, :, 1, 1, 1]
    np.testing.assert_allclose(out.numpy(), w27[(0 * 3 + 1) * 3 + 2, 1],
                               rtol=1e-6)


def test_seeded_init_follows_the_jax_rules():
    """Same rules as nksr_tpu's init_params: normal heads, biases and the
    stride-2 weights (not named ``kernel``) zero, GroupNorm scales one,
    ``kernel`` leaves glorot-uniform; the same seed gives the same
    tree."""
    cfg = P.PipelineConfig(tree_depth=2, f_maps=8)
    a = dict(_leaves(P.init_params(cfg, seed=3)))
    b = dict(_leaves(P.init_params(cfg, seed=3)))
    c = dict(_leaves(P.init_params(cfg, seed=4)))
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k])
        name, path = k[-1], "/".join(k)
        if "normal_" in path or name not in ("kernel", "scale"):
            assert not v.any(), k
        elif name == "scale":
            assert (v == 1).all(), k
        else:
            lim = np.sqrt(6.0 / (np.prod(v.shape[:-1]) + v.shape[-1]))
            assert np.abs(v).max() <= lim and v.std() > 0.2 * lim, k
            assert not np.array_equal(v, c[k]), k
