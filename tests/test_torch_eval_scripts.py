"""The port's evaluation entry points and PLY examples on the CPU at toy
size: ``scripts/eval.py`` (the inference forward, the in-graph mesher,
``MeshEvaluator``, metrics.csv) on a synthetic object set, the two
quality scripts (every row, one item, few samples) on a synthetic object
set and a synthetic scene corpus, and ``examples/recons_simple.py``,
``recons_scannet.py`` and ``gis_app.py`` on a PLY the test writes or the
synthetic terrain.  These check that each runs end to end and writes
what it says; the numbers are held against the JAX package in
test_torch_metrics.py, test_torch_dual_mc.py and test_torch_ingraph.py."""

import csv
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.data import read_ply_full, write_ply
from nksr_tpu_torch.examples import gis_app, recons_scannet, recons_simple
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.scripts import eval as EV
from nksr_tpu_torch.scripts import make_quality_report as MQ
from nksr_tpu_torch.scripts import make_scene_quality as MS
from nksr_tpu_torch.train.driver import pipeline_config_from_yaml
from nksr_tpu_torch.utils.checkpoint import load_tree, model_params
from nksr_tpu_torch.utils.config import load_config

from test_field import sphere_points

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(tree_depth=2, f_maps=8, basis_dim=8, udf_dim=8)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config_pcfg(path):
    return pipeline_config_from_yaml(load_config(path))


def _config(tmp_path, run: str, root: Path) -> str:
    """The run's config.yaml with its datasets' root moved to ``root``."""
    text = (REPO / "runs" / run / "config.yaml").read_text()
    old = "data/synth_scene" if run == "scene_big" else "data/synth"
    out = tmp_path / f"{run}.yaml"
    out.write_text(text.replace(f"root: {old}", f"root: {root}"))
    return str(out)


@pytest.fixture(scope="module")
def objects(tmp_path_factory):
    root = tmp_path_factory.mktemp("objects")
    _script("make_synth_dataset").main(str(root), 8, 4000)
    return root


def test_eval_script(objects, tmp_path, capsys):
    cfg = _config(tmp_path, "synth_r3c", objects)
    rows, agg = EV.main([cfg, "--ckpt",
                         str(REPO / "runs/synth_r3c/best.ckpt"),
                         "--run_dir", str(tmp_path / "eval"),
                         "--eval_points", "20000", "--save_meshes",
                         "--exec", "solver_max_iters=8", "--device", "cpu"])
    assert len(rows) == 1 and np.isfinite(agg["chamfer-L1"])
    assert agg["chamfer-L1"] < 0.05 and "iou" in agg
    with open(tmp_path / "eval" / "metrics.csv") as f:
        assert len(list(csv.DictReader(f))) == 1
    ply = next((tmp_path / "eval").glob("*.ply"))
    assert len(read_ply_full(ply)[1]) > 0
    assert "AGGREGATE" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        EV.main([cfg, "--ckpt", str(REPO / "runs/synth_r3c/best.ckpt"),
                 "--focus", "no-such-shape", "--device", "cpu"])


def test_object_quality_script(objects, tmp_path):
    cfg = _config(tmp_path, "synth_r3c", objects)
    out_md = tmp_path / "q.md"
    res = MQ.main([cfg, str(REPO / "runs/synth_r3c/best.ckpt"),
                   "--noise_ckpt", str(REPO / "runs/synth_noise/best.ckpt"),
                   "--limit", "1", "--eval_points", "20000", "--out_md",
                   str(out_md), "--out_dir", str(tmp_path / "rows"),
                   "--device", "cpu"])
    assert len(res) == 7 and all(len(r[0]) == 1 for r in res.values())
    text = out_md.read_text()
    assert "| trained/predicted |" in text and "untrained/splat" in text
    # the JAX package's row beside the port's, from runs/quality/
    assert "0.00311" in text
    rows = json.loads((tmp_path / "rows" /
                       "metrics_trained_splat+noise.json").read_text())
    assert rows["rows"][0]["source"].startswith("synth/")


def test_scene_quality_script(tmp_path):
    """The scene rows on one scene of a toy corpus; the terrain rows on a
    4 m patch of the bench terrain (the 40 m tile takes minutes on the
    CPU)."""
    root = tmp_path / "scenes"
    _script("make_synth_scenes").main(str(root), 8, 3000, 2.0)
    cfg = _config(tmp_path, "scene_big", root)
    out_md = tmp_path / "s.md"
    res, terrain = MS.main(
        [cfg, str(REPO / "runs/scene_big/best.ckpt"), "--limit", "1",
         "--eval_points", "20000", "--terrain_points", "0",
         "--structures", "splat", "predicted_ingraph", "--out_md",
         str(out_md), "--out_dir", str(tmp_path / "rows"),
         "--device", "cpu"])
    assert set(res) == {"scene/splat", "scene/predicted_ingraph"}
    assert all(len(r[0]) == 1 for r in res.values()) and terrain == []
    text = out_md.read_text()
    assert "| scene/splat |" in text and "0.0094" in text
    assert (tmp_path / "rows" / "terrain.json").exists()
    recon = Reconstructor(device="cpu", config=load_config_pcfg(cfg),
                          params={"params": model_params(load_tree(
                              REPO / "runs/scene_big/best.ckpt"))})
    rows = MS.terrain_rows(recon, ["predicted_ingraph"], 20000,
                           half_extent=2.0)
    assert rows[0]["verts"] > 100 and rows[0]["vert_err_mean"] < 0.1


@pytest.fixture
def small_recon():
    return Reconstructor(device="cpu", config=P.PipelineConfig(**SMALL))


def test_recons_simple_and_scannet(tmp_path, small_recon):
    xyz, nrm = sphere_points(1500, r=0.5, seed=2)
    write_ply(tmp_path / "cloud.ply", xyz, normals=nrm)
    mesh = recons_simple.main(str(tmp_path / "cloud.ply"),
                              str(tmp_path / "simple.ply"),
                              reconstructor=small_recon)
    assert len(mesh.f) and len(read_ply_full(tmp_path / "simple.ply")[1])
    mesh = recons_scannet.main(str(tmp_path / "cloud.ply"), scale=0.3,
                               out=str(tmp_path / "scannet.ply"),
                               reconstructor=small_recon)
    assert len(mesh.f) and (tmp_path / "scannet.ply").exists()
    write_ply(tmp_path / "bare.ply", xyz)
    with pytest.raises(ValueError, match="no normals"):
        recons_simple.main(str(tmp_path / "bare.ply"),
                           reconstructor=small_recon)


def test_gis_app_falls_back_to_the_terrain(tmp_path, small_recon, capsys):
    mesh = gis_app.main(str(tmp_path / "missing.las"),
                        str(tmp_path / "gis.ply"), n_fallback=8000,
                        reconstructor=small_recon)
    assert len(mesh.f) and (tmp_path / "gis.ply").exists()
    assert "synthetic terrain" in capsys.readouterr().out
