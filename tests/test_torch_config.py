"""The port's config reader (``nksr_tpu_torch.utils.config``, no PyYAML)
against the JAX package's ``load_config`` on every config the repo
ships, its ``save_config`` against ``yaml.safe_load``, and the port's
train script on the README's smoke config.
"""

import glob
import importlib.util
import os

import pytest
import yaml

from nksr_tpu.utils import config as JCFG
from nksr_tpu_torch.utils import config as CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                         recursive=True)) + \
    sorted(glob.glob(os.path.join(ROOT, "runs", "*", "config.yaml")))
IDS = [os.path.relpath(p, ROOT) for p in PATHS]
SYNTH = os.path.join(ROOT, "configs", "synth", "train.yaml")


def test_every_config_is_found():
    assert len(PATHS) >= 28


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_file_reads_as_pyyaml_reads_it(path):
    """Each file's own document, before includes and interpolation: the
    same keys, values and Python types."""
    text = open(path).read()
    assert repr(CFG.parse_yaml(text, path)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_load_config_matches_jax(path):
    """Include chains, interpolation: the JAX package's config."""
    assert CFG.load_config(path) == dict(JCFG.load_config(path))


@pytest.mark.parametrize("overrides,includes", [
    (["voxel_size=0.05", "unet.f_maps=8", "_shapenet_points=500",
      "learning_rate.init=2.0e-4", "new.key=[1, 2]", "name='a b'"], []),
    ([], [os.path.join(ROOT, "configs", "synth", "train_scene.yaml")]),
    (["solver_tol=1.0e-6"],
     [os.path.join(ROOT, "configs", "carla", "data_no_patch.yaml")]),
])
def test_overrides_and_includes_match_jax(overrides, includes):
    """Dotted overrides (read as YAML, applied before interpolation, so
    an override of an interpolated variable reaches its uses) and extra
    includes merged on top."""
    path = os.path.join(ROOT, "configs", "shapenet", "train.yaml")
    got = CFG.load_config(path, overrides=overrides, includes=includes)
    assert got == dict(JCFG.load_config(path, overrides=overrides,
                                        includes=includes))
    if "_shapenet_points=500" in overrides:
        assert got["train_dataset"]["args"]["num_input_points"] == 500


def test_interpolation_inside_strings(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("root: data\nsub: {n: 3}\npath: ${root}/x_${sub.n}\n"
                 "whole: ${sub}\n")
    got = CFG.load_config(p)
    assert got == dict(JCFG.load_config(p))
    assert got["path"] == "data/x_3" and got["whole"] == {"n": 3}


@pytest.mark.parametrize("path", PATHS[:1] + [SYNTH], ids=["first", "synth"])
def test_save_config_round_trip(tmp_path, path):
    """``save_config``'s file reads back equal through the port's reader
    and through ``yaml.safe_load``, with the same types."""
    cfg = CFG.load_config(path)
    cfg["odd"] = {"s": ["yes", "1e-4", "", "a: b", "#x", "-1", "é"],
                  "f": [1e-05, 2.5e20, -0.0, float("inf")], "n": None,
                  "nested": [[1, [2]], {"k": []}], "e": {}}
    out = tmp_path / "config.yaml"
    CFG.save_config(cfg, out)
    text = out.read_text()
    assert CFG.load_config(out) == cfg
    assert repr(CFG.parse_yaml(text)) == repr(yaml.safe_load(text))
    assert yaml.safe_load(text) == cfg


def test_train_script_on_the_smoke_config(tmp_path, monkeypatch):
    """``python -m nksr_tpu_torch.scripts.train configs/synth/train.yaml
    --device cpu --max_steps 0`` (in this process) on a tiny corpus at
    the config's ``data/synth``: it reaches ``fit`` and saves the merged
    config into the run directory."""
    from nksr_tpu_torch.scripts import train
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", os.path.join(ROOT, "scripts",
                                           "make_synth_dataset.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    monkeypatch.chdir(tmp_path)
    mk.main(str(tmp_path / "data" / "synth"), 8, 2000)
    state = train.main([SYNTH, "--device", "cpu", "--max_steps", "0",
                        "--run_dir", str(tmp_path / "run"),
                        "--exec", "logger=csv"])
    assert state.step == 0
    saved = CFG.load_config(tmp_path / "run" / "config.yaml")
    assert saved == CFG.load_config(SYNTH, overrides=["logger=csv"])
    assert saved["name"] == "synth/smoke"
    assert (tmp_path / "run" / "last.ckpt").exists()
