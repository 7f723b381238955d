"""The port's public API against the JAX package's on the CPU: the
public names, the torch-style state-dict shims (``utils/checkpoint.py``),
``Reconstructor().network.load_state_dict`` on the three layouts it
takes, and ``configs.load_checkpoint_from_url``.

The configuration is ``tests/test_data_utils.py``'s tiny one; the
wheel-layout dicts are its two fixtures rebuilt here (a ``net.<i>``
layout from numpy draws, and the ``state_dict()`` of an ``nn.Sequential``
/ ``nn.ModuleList`` module tree).  Shim results are compared array for
array, exactly.
"""

import pickle

import jax
import numpy as np
import pytest
import torch
from torch import nn

import nksr_tpu
from nksr_tpu.models import pipeline as JP
from nksr_tpu.recon.reconstructor import NetworkHandle
from nksr_tpu.utils import checkpoint as JCK

import nksr_tpu_torch
from nksr_tpu_torch import Reconstructor, configs
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.utils import checkpoint as CK

from test_field import sphere_points

CFG = dict(capacities=(512, 256), tree_depth=2, f_maps=8, basis_dim=8,
           udf_dim=8, interp_hidden=16, interp_layers=2, kernel_dim=4)
FAMILIES = ("interpolators", "sdf_decoder", "udf_decoder")


@pytest.fixture(scope="module")
def jparams():
    """A seeded flax-layout tree (numpy) of the configuration's shapes
    (the port's init: the JAX package's would only add its compile)."""
    return P.init_params(P.PipelineConfig(**CFG), 0)


def leaves(tree):
    return dict(CK._flat_dotted(tree))


def assert_trees_equal(got, ref):
    got, ref = leaves(got), leaves(ref)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


def net_i_dict():
    """Wheel keys ``<family>.net.<2i>.weight`` from numpy draws, and
    encoder / UNet tensors of another architecture."""
    rng = np.random.default_rng(11)

    def mlp_keys(prefix, sizes):
        out = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out[f"{prefix}.net.{2 * i}.weight"] = \
                rng.normal(size=(b, a)).astype(np.float32)
            out[f"{prefix}.net.{2 * i}.bias"] = \
                rng.normal(size=(b,)).astype(np.float32)
        return out

    sd = {}
    for d in range(2):
        sd.update(mlp_keys(f"interpolators.{d}", [11, 16, 16, 4]))
    sd.update(mlp_keys("sdf_decoder", [8, 16, 16, 1]))
    sd.update(mlp_keys("udf_decoder", [8, 16, 16, 1]))
    sd["encoder.fc.weight"] = np.zeros((8, 4), np.float32)
    sd["unet.enc.0.conv.weight"] = np.zeros((27, 8, 8), np.float32)
    return sd


def module_dict():
    """``state_dict()`` of a torch module tree of the wheel's shape:
    nested ``nn.ModuleList`` / ``nn.Sequential`` names, torch tensors."""
    torch.manual_seed(7)

    def mlp(sizes):
        layers = []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            layers.append(nn.Linear(a, b))
            if i < len(sizes) - 2:
                layers.append(nn.SiLU())
        return nn.Sequential(*layers)

    class WheelNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = nn.Sequential(nn.Linear(7, 8), nn.Linear(8, 8))
            self.unet = nn.ModuleDict({"enc0": nn.Linear(8, 8),
                                       "dec0": nn.Linear(8, 8)})
            self.interpolators = nn.ModuleList(
                [mlp([3 + 8, 16, 16, 4]) for _ in range(2)])
            self.sdf_decoder = mlp([8, 16, 16, 1])
            self.udf_decoder = mlp([8, 16, 16, 1])
    return WheelNet().state_dict()


def mismatch_dict():
    """The ``net.<i>`` dict with interpolator 1's last layer removed."""
    sd = net_i_dict()
    sd.pop("interpolators.1.net.4.weight")
    sd.pop("interpolators.1.net.4.bias")
    return sd


WHEEL_CASES = {"net_i": net_i_dict, "modules": module_dict,
               "layer_count_mismatch": mismatch_dict}


# ----------------------------------------------------------- public names
def test_public_names_cover_the_jax_packages():
    assert set(nksr_tpu.__all__) <= set(nksr_tpu_torch.__all__)
    assert set(nksr_tpu.fields.__all__) <= set(nksr_tpu_torch.fields.__all__)
    assert set(nksr_tpu.svh.__all__) <= set(nksr_tpu_torch.svh.__all__)
    assert set(nksr_tpu.configs.__all__) <= \
        set(nksr_tpu_torch.configs.__all__)
    assert nksr_tpu_torch.__version__ == nksr_tpu.__version__
    assert configs.PRETRAINED == nksr_tpu.configs.PRETRAINED


# ------------------------------------------------------------------ shims
@pytest.mark.parametrize("case", list(WHEEL_CASES))
@pytest.mark.parametrize("strict", [False, True])
def test_import_reference_matches_jax(jparams, case, strict):
    """Report strings and parameter trees equal to the JAX function's;
    with ``strict`` the layer-count mismatch raises the same error."""
    sd = WHEEL_CASES[case]()
    assert CK.looks_like_reference_state_dict(sd) == \
        JCK.looks_like_reference_state_dict(sd) == True  # noqa: E712
    if strict and case == "layer_count_mismatch":
        with pytest.raises(ValueError) as jerr:
            JCK.import_reference_state_dict(sd, jparams, strict=True)
        with pytest.raises(ValueError) as err:
            CK.import_reference_state_dict(sd, jparams, strict=True)
        assert str(err.value) == str(jerr.value)
        return
    jtree, jrep = JCK.import_reference_state_dict(sd, jparams, strict=strict)
    tree, rep = CK.import_reference_state_dict(sd, jparams, strict=strict)
    assert rep == jrep
    assert_trees_equal(tree, jax.tree_util.tree_map(np.asarray, jtree))
    mapped = [f for f in FAMILIES if rep[f].startswith("mapped")]
    assert mapped == ([f for f in FAMILIES if f != "interpolators"]
                      if case == "layer_count_mismatch" else list(FAMILIES))


def test_export_round_trip_matches_jax(jparams):
    """The canonical export equals the JAX package's key for key, and its
    inverse onto a zero template equals the JAX inverse (and the
    original tree)."""
    jsd = JCK.params_to_torch_state_dict(jparams)
    sd = CK.params_to_torch_state_dict(jparams)
    assert sd.keys() == jsd.keys()
    for k in jsd:
        np.testing.assert_array_equal(sd[k], np.asarray(jsd[k]), err_msg=k)
    zeros = jax.tree_util.tree_map(np.zeros_like, jparams)
    jback = JCK.torch_state_dict_to_params(JP.PipelineConfig(**CFG), jsd,
                                           zeros)
    back = CK.torch_state_dict_to_params(None, sd, zeros)
    assert_trees_equal(back, jax.tree_util.tree_map(np.asarray, jback))
    assert_trees_equal(back, jparams)
    # a dict with no matching key raises in both
    for fn in (JCK.torch_state_dict_to_params, CK.torch_state_dict_to_params):
        with pytest.raises(ValueError):
            fn(None, {"x.weight": np.zeros(3, np.float32)}, zeros)


# ------------------------------------------------------- network loading
def port_net(seed: int):
    return Reconstructor(device="cpu", config=P.PipelineConfig(**CFG),
                         seed=seed).network


def assert_net_is(net, tree):
    want = CK.params_to_torch(tree)
    got = net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


def test_network_loads_its_own_state_dict():
    src, dst = port_net(1), port_net(2)
    res = dst.load_state_dict(src.state_dict())
    assert not res.missing_keys and not res.unexpected_keys
    assert_net_is(dst, {"params": CK.torch_to_params(src.state_dict())})


def test_network_loads_the_jax_export_whole(jparams):
    """The JAX package's canonical export restores all five families,
    ``encoder`` and ``unet`` included.  The JAX package's own handle does
    not: ``looks_like_reference_state_dict`` is true of its export (the
    same five top-level names as the wheel's), so ``NetworkHandle.
    load_state_dict`` sends it to the family import, which reports the
    encoder and the UNet skipped and keeps the weights it held.  The
    port tells the layouts apart by key set and shapes first."""
    export = JCK.params_to_torch_state_dict(jparams)
    assert JCK.looks_like_reference_state_dict(export)
    net = port_net(1)
    res = net.load_state_dict(export)
    assert not res.missing_keys and not res.unexpected_keys
    assert_net_is(net, jparams)
    # torch tensors load the same
    net = port_net(2)
    net.load_state_dict({k: torch.tensor(v) for k, v in export.items()})
    assert_net_is(net, jparams)


OTHER_CONFIGS = {"f_maps": dict(CFG, f_maps=16),
                 "depth": dict(CFG, tree_depth=3,
                               capacities=(512, 256, 128))}


@pytest.mark.parametrize("other", list(OTHER_CONFIGS))
def test_reconstructor_refuses_another_configs_tree(other, capsys):
    """The port's own layout at another width or depth raises through
    ``Reconstructor(params=...)``'s strict load.  It has the wheel's
    five top-level names and no ``params.`` key, yet it never reaches
    the family import, which would keep the seeded encoder and UNet."""
    tree = P.init_params(P.PipelineConfig(**OTHER_CONFIGS[other]), 0)
    with pytest.raises(RuntimeError):
        Reconstructor(device="cpu", config=P.PipelineConfig(**CFG),
                      params=tree)
    assert "checkpoint import" not in capsys.readouterr().out


def test_network_refuses_its_own_dict_with_a_key_missing(capsys):
    """A missing key raises under ``strict`` and is reported without it,
    as torch's load does; the family import is never reached."""
    src, dst = port_net(1), port_net(2)
    sd = src.state_dict()
    gone = sorted(k for k in sd if k.startswith("unet"))[0]
    sd.pop(gone)
    with pytest.raises(RuntimeError, match="Missing key"):
        dst.load_state_dict(sd)
    res = dst.load_state_dict(sd, strict=False)
    assert res.missing_keys == [gone] and not res.unexpected_keys
    assert "checkpoint import" not in capsys.readouterr().out


@pytest.mark.parametrize("case", list(WHEEL_CASES))
def test_network_imports_a_wheel_dict_as_jax_does(jparams, case, capsys):
    """The families the JAX handle maps, and those alone: the network
    equals the JAX handle's tree after the same import, the encoder and
    the UNet stay as they were, and the report lines are the JAX
    handle's."""
    sd = WHEEL_CASES[case]()
    h = NetworkHandle(JP.PipelineConfig(**CFG),
                      jax.tree_util.tree_map(jax.numpy.asarray, jparams))
    h.load_state_dict(sd)
    jlines = [ln.split("import: ", 1)[1]
              for ln in capsys.readouterr().out.splitlines()]
    net = port_net(0)
    net.load_state_dict(CK.params_to_torch(jparams))
    assert net.load_state_dict(sd) is net
    lines = [ln.split("import: ", 1)[1]
             for ln in capsys.readouterr().out.splitlines()]
    assert lines == jlines and len(lines) == 5
    assert_net_is(net, jax.tree_util.tree_map(np.asarray, h.params))
    before = CK.params_to_torch(jparams)
    for k, v in net.state_dict().items():
        if k.split(".")[0] in ("encoder", "unet"):
            assert torch.equal(v, before[k]), k


def test_imported_interpolators_change_the_converged_field(jparams):
    """The wheel's interpolators and decoders, once imported, change the
    field: the same sphere, both solves converged to 1e-4."""
    xyz, nrm = sphere_points(200, r=0.5, seed=2)
    probes = (xyz[:64] * 0.9).astype(np.float32)
    cfg = P.PipelineConfig(**CFG)

    def field_vals(load):
        r = Reconstructor(device="cpu", config=cfg, params=jparams)
        load(r.network)
        hf = r.reconstruct(xyz, nrm, voxel_size=0.2, detail_level=None,
                           structure="splat", solver_tol=1e-4,
                           solver_max_iters=1000)
        assert hf.solver_stats.converged, hf.solver_stats
        # the field's hierarchy as the public class
        assert hf.svh.voxel_size == np.float32(0.2)
        for g, hg in zip(hf.svh.grids, hf.host_grids):
            np.testing.assert_array_equal(g.coords[:g.num_voxels].numpy(),
                                          hg.coords)
        return hf.evaluate_f(probes).value

    before = field_vals(lambda net: None)
    after = field_vals(lambda net: net.load_state_dict(module_dict()))
    assert np.abs(before - after).max() > 1e-4


# ------------------------------------------------------ checkpoint lookup
def test_load_checkpoint_from_url(tmp_path, monkeypatch):
    """A ``.pth`` by name and by URL, a ``.pkl`` by URL, from the
    ``NKSR_TPU_CKPT_DIR`` cache, as the JAX package resolves them; an
    absent name raises ``FileNotFoundError`` in both."""
    monkeypatch.setenv("NKSR_TPU_CKPT_DIR", str(tmp_path))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in net_i_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "ks.pth")
    with open(tmp_path / "mine.pkl", "wb") as f:
        pickle.dump({"state_dict": net_i_dict()}, f)
    for name in ("ks", "https://example.invalid/ckpts/ks.pth/"):
        got = configs.load_checkpoint_from_url(name)["state_dict"]
        ref = nksr_tpu.configs.load_checkpoint_from_url(name)["state_dict"]
        assert got.keys() == sd.keys() == ref.keys()
        for k in sd:
            assert torch.equal(got[k], sd[k]) and torch.equal(ref[k], sd[k])
    got = configs.load_checkpoint_from_url("https://example.invalid/mine.pkl")
    ref = nksr_tpu.configs.load_checkpoint_from_url("mine.pkl")
    for k, v in net_i_dict().items():
        np.testing.assert_array_equal(got["state_dict"][k], v)
        np.testing.assert_array_equal(ref["state_dict"][k], v)
    for fn in (configs.load_checkpoint_from_url,
               nksr_tpu.configs.load_checkpoint_from_url):
        with pytest.raises(FileNotFoundError):
            fn("carla")
