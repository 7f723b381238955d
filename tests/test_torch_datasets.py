"""The port's dataset readers past ShapeNet and its ground-truth geometry
(nksr_tpu_torch/data/datasets.py, gt_geometry.py) against the JAX
package's on the CPU, on files the tests write: AV/CARLA frames, user
PLY pairs ("Customized"), the Points2Surf and Matterport layouts and a
"Combined" mixture with its read-count rotation, item for item through
each config's transform chain; the dense-points and TSDF-volume GT
geometries query for query (the SDF within 1e-5 of its largest
magnitude: kNN sums in another order)."""

import numpy as np
import pytest
import torch

from nksr_tpu.data import datasets as JD
from nksr_tpu.data import gt_geometry as JG
from nksr_tpu.data import io as jio
from nksr_tpu.data import transforms as JT
from nksr_tpu_torch.data import DatasetSpec as DS
from nksr_tpu_torch.data import build_dataset
from nksr_tpu_torch.data import gt_geometry as G
from nksr_tpu_torch.data import transforms as T
from nksr_tpu_torch.data.io import write_ply

from test_field import sphere_points

SPEC = [DS.SHAPE_NAME, DS.INPUT_PC, DS.INPUT_SENSOR_POS, DS.TARGET_NORMAL,
        DS.GT_DENSE_PC, DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
CARLA_T = [{"name": "Centralize", "args": {}},
           {"name": "BBoxCrop", "args": {"size": [1.2, 1.2, 1.2]}}]
# configs/matterport/data.yaml's chain, in the arguments both packages'
# transforms take (the config spells the reference's: axis "x",
# deg_min/deg_max, min_a/max_a)
MP_T = [{"name": "FixedAxisRotation", "args": {"axis": 0,
                                               "angle_deg": 90.0}},
        {"name": "BoundScale", "args": {"min_bound": 5.0,
                                        "max_bound": 10.0}}]


def jspec(spec):
    return [getattr(JD.DS, s.name) for s in spec]


def same_item(got, ref):
    """One item of each package: the same keys, arrays equal."""
    assert {k.name for k in got} == {k.name for k in ref}
    for k, v in got.items():
        r = ref[getattr(JD.DS, k.name)]
        if isinstance(v, tuple):
            for a, b in zip(v, r):
                np.testing.assert_array_equal(a, b)
        elif isinstance(v, np.ndarray):
            assert v.dtype == r.dtype
            np.testing.assert_array_equal(v, r)
        else:
            assert v == r


def both(name, spec=SPEC, **kw):
    return (build_dataset(name, spec, **kw),
            JD.build_dataset(name, jspec(spec), **kw))


def _cloud(n, seed):
    xyz, nrm = sphere_points(n, r=0.5, seed=seed)
    return xyz, nrm


@pytest.fixture
def carla(tmp_path):
    for i in range(3):
        xyz, nrm = _cloud(400, i)
        gx, gn = _cloud(900, 10 + i)
        np.savez(tmp_path / f"frame_{i}.npz", xyz=xyz, normal=nrm,
                 sensor=np.tile([0, 0, 2], (400, 1)).astype(np.float32),
                 gt_xyz=gx, gt_normal=gn)
    (tmp_path / "train.lst").write_text(
        "frame_0.npz\nframe_1.npz\nmissing.npz\nframe_2.npz\n")
    return tmp_path


@pytest.mark.parametrize("name", ["AV", "CARLA"])
def test_av_reader_matches_jax(carla, name):
    """Frames with sensor, normals and GT, through the CARLA crop chain;
    a missing frame is resampled (skip_on_error) the same way."""
    ds, jds = both(name, root=str(carla), split="train", transforms=CARLA_T)
    assert len(ds) == len(jds) == 4
    for i in range(len(ds)):
        for _ in range(2):       # a second read draws another crop
            same_item(ds[i], jds[i])
    ds, jds = both(name, root=str(carla), split="none")   # glob of *.npz
    assert len(ds) == len(jds) == 3
    same_item(ds[1], jds[1])


def test_customized_reader_matches_jax(tmp_path):
    files = []
    for i in range(2):
        xyz, nrm = _cloud(300, i)
        write_ply(tmp_path / f"in{i}.ply", xyz, normals=nrm)
        write_ply(tmp_path / f"gt{i}.ply", *_cloud(600, 5 + i)[:1])
        files.append((str(tmp_path / f"in{i}.ply"),
                      str(tmp_path / f"gt{i}.ply")))
    files.append(str(tmp_path / "in0.ply"))            # input is its GT
    ds, jds = both("Customized", files=files)
    for i in range(len(files)):
        same_item(ds[i], jds[i])
    assert DS.GT_DENSE_NORMAL not in ds[0] and DS.GT_DENSE_NORMAL in ds[2]


def test_points2surf_reader_matches_jax(tmp_path):
    inp = tmp_path / "abc" / "04_pts_vis" / "input"
    gt = tmp_path / "abc" / "gt"
    inp.mkdir(parents=True)
    gt.mkdir(parents=True)
    for i in range(2):
        jio.write_ply(inp / f"s{i}.ply", *_cloud(300, i))
        jio.write_ply(gt / f"s{i}.ply", *_cloud(700, 4 + i))
    (tmp_path / "abc" / "test.lst").write_text("s0\ns1\n")
    t = [{"name": "BoundScale", "args": {"min_bound": 2.0,
                                         "max_bound": 4.0}},
         {"name": "UniformDensityFixedScaleSample",
          "args": {"voxel_size": 0.1, "min_density": 1.0,
                   "max_density": 5.0}}]
    jt = [t[0], dict(t[1], name="UniformDensityFixedSampleScale")]
    ds = build_dataset("Points2Surf", SPEC, root=str(tmp_path),
                       transforms=t)
    jds = JD.build_dataset("Points2Surf", jspec(SPEC), root=str(tmp_path),
                           transforms=jt)
    assert ds.get_name() == jds.get_name()
    for i in range(2):
        same_item(ds[i], jds[i])


@pytest.fixture
def matterport(tmp_path):
    scenes = [f"scene{i}" for i in range(6)]
    for s_i, s in enumerate(scenes):
        for r in range(2):
            d = tmp_path / s / f"region{r}"
            d.mkdir(parents=True)
            xyz, nrm = _cloud(300, 10 * s_i + r)
            np.savez(d / "full.npz", points=xyz, normals=nrm)
            np.savez(d / "partial.npz", points=xyz[:150], normals=nrm[:150])
    (tmp_path / "scenes_train.txt").write_text("\n".join(scenes[:5]) + "\n")
    (tmp_path / "scenes_test.txt").write_text(scenes[5] + "\n")
    return tmp_path


@pytest.mark.parametrize("split,partial", [("train", True), ("val", False),
                                           ("test", False),
                                           ("custom", True)])
def test_matterport_reader_matches_jax(matterport, split, partial):
    ds, jds = both("Matterport", root=str(matterport), split=split,
                   partial_input=partial, transforms=MP_T,
                   custom_scenes=["scene2"])
    assert len(ds) == len(jds) > 0 and ds.regions == jds.regions
    assert ds.get_name() == jds.get_name()
    for i in range(len(ds)):
        same_item(ds[i], jds[i])


def test_combined_reader_matches_jax(carla, matterport):
    """Ratios and the read-count rotation over a CARLA and a Matterport
    subset, the same physical item read by read."""
    cl = [{"name": "CARLA", "ratio": 0.5,
           "args": {"root": str(carla), "split": "none"}},
          {"name": "Matterport",
           "args": {"root": str(matterport), "split": "train"}}]
    ds = build_dataset("Combined", SPEC, config_list=cl)
    jds = JD.build_dataset("Combined", jspec(SPEC), config_list=cl)
    assert len(ds) == len(jds) and ds.counts == jds.counts
    for _ in range(3):
        for i in range(len(ds)):
            same_item(ds[i], jds[i])
    with pytest.raises(ValueError, match="DatasetSpec"):
        type(ds)(config_list=cl)


def test_transform_alias_matches_jax():
    xyz, _ = _cloud(2000, 3)
    t = T.ComposedTransforms([{"name": "UniformDensityFixedScaleSample",
                               "args": {"voxel_size": 0.1,
                                        "min_density": 1.0,
                                        "max_density": 5.0}}])
    j = JT.UniformDensityFixedSampleScale(0.1, 1.0, 5.0)
    got = t({DS.INPUT_PC: xyz}, np.random.default_rng(0))[DS.INPUT_PC]
    ref = j({JD.DS.INPUT_PC: xyz}, np.random.default_rng(0))[JD.DS.INPUT_PC]
    np.testing.assert_array_equal(got, ref)


def _close(got, ref, rtol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["vote", "imls"])
def test_dense_points_gt_matches_jax(mode):
    xyz, nrm = _cloud(4000, 7)
    q = np.random.default_rng(8).uniform(-0.7, 0.7, (500, 3)).astype(
        np.float32)
    g = G.get_class("DensePoints")(xyz, nrm, voxel_size=0.05, mode=mode,
                                   device="cpu")
    jg = JG.get_class("DensePoints")(xyz, nrm, voxel_size=0.05, mode=mode)
    _close(g.query_sdf(q), jg.query_sdf(q))
    np.testing.assert_array_equal(g.query_classification(q).numpy(),
                                  np.asarray(jg.query_classification(q)))
    lo, hi = np.array([-0.6, -0.6, 0.0]), np.array([0.6, 0.6, 0.6])
    c, jc = g.crop(lo, hi), jg.crop(lo, hi)
    np.testing.assert_array_equal(c.xyz, jc.xyz)
    assert c.mode == mode and c.device == torch.device("cpu")
    assert g.torch_attr()[0] is g.xyz


def test_tsdf_volume_gt_matches_jax():
    xyz, nrm = _cloud(3000, 9)
    g = G.PointTSDFVolumeGroundTruthGeometry.from_points(xyz, nrm, 0.1,
                                                        device="cpu")
    jg = JG.PointTSDFVolumeGroundTruthGeometry.from_points(xyz, nrm, 0.1)
    _close(g.tsdf, jg.tsdf)
    np.testing.assert_array_equal(g.origin, jg.origin)
    q = np.random.default_rng(10).uniform(-1.2, 1.2, (800, 3)).astype(
        np.float32)
    cls = g.query_classification(q).numpy()
    np.testing.assert_array_equal(cls, np.asarray(
        jg.query_classification(q)))
    assert set(np.unique(cls)) == {0, 1, 2}
    lo, hi = np.array([-0.3, -0.3, -0.3]), np.array([0.6, 0.6, 0.6])
    c, jc = g.crop(lo, hi), jg.crop(lo, hi)
    assert c.tsdf.shape == jc.tsdf.shape
    _close(c.tsdf, jc.tsdf)
    np.testing.assert_array_equal(c.origin, jc.origin)
    np.testing.assert_array_equal(c.query_classification(q).numpy(),
                                  np.asarray(jc.query_classification(q)))


def test_gt_geometry_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.DensePointsGroundTruthGeometry(*_cloud(10, 0))
