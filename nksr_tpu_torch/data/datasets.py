"""Dataset readers (counterpart of nksr_tpu/data/datasets.py): the
ONet/ShapeNet layout (the one ``scripts/make_synth_scenes.py`` and
``make_synth_dataset.py`` write), AV/CARLA frames, user point clouds
("Customized"), Points2Surf, Matterport regions and mixtures
("Combined"), each a DatasetSpec-keyed numpy dict through the
deterministic ``RandomSafeDataset`` base; ``build_dataset`` takes a
config's name."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import DatasetSpec as DS, RandomSafeDataset
from .io import read_ply
from .transforms import ComposedTransforms


class ShapeNetDataset(RandomSafeDataset):
    """A directory per category, a directory per shape holding
    ``pointcloud.npz`` (points, normals) and ``points.npz`` (occupancy
    samples, packed bits); ``<split>.lst`` names a split's shapes."""

    def __init__(self, root: str, spec: Sequence[DS], split: str = "train",
                 categories: Optional[Sequence[str]] = None,
                 transforms: Optional[Sequence[Dict]] = None,
                 num_input_points: int = 3000, seed: int = 0,
                 skip_on_error: bool = False):
        super().__init__(seed, skip_on_error)
        self.root = Path(root)
        self.spec = list(spec)
        self.transforms = ComposedTransforms(transforms)
        self.num_input_points = num_input_points
        self.items: List[Path] = []
        cats = categories or sorted(
            p.name for p in self.root.iterdir() if p.is_dir())
        for c in cats:
            lst = self.root / c / f"{split}.lst"
            if lst.exists():
                names = [ln.strip() for ln in lst.read_text().splitlines()
                         if ln.strip()]
            else:
                names = sorted(p.name for p in (self.root / c).iterdir()
                               if p.is_dir())
            self.items += [self.root / c / n for n in names]

    def __len__(self):
        return len(self.items)

    def _get_item(self, idx, rng):
        path = self.items[idx]
        data: Dict = {DS.SHAPE_NAME: f"{path.parent.name}/{path.name}"}
        pc = np.load(path / "pointcloud.npz")
        points = pc["points"].astype(np.float32)
        normals = pc["normals"].astype(np.float32)
        if DS.GT_DENSE_PC in self.spec:
            data[DS.GT_DENSE_PC] = points
            data[DS.GT_DENSE_NORMAL] = normals
        sel = rng.integers(0, points.shape[0], self.num_input_points)
        data[DS.INPUT_PC] = points[sel]
        if DS.TARGET_NORMAL in self.spec:
            data[DS.TARGET_NORMAL] = normals[sel]
        if DS.GT_ONET_SAMPLE in self.spec and (path / "points.npz").exists():
            iou = np.load(path / "points.npz")
            occ = np.unpackbits(iou["occupancies"])[: iou["points"].shape[0]]
            data[DS.GT_ONET_SAMPLE] = (
                iou["points"].astype(np.float32), occ.astype(np.float32))
        return self.transforms(data, rng)


class AVDataset(RandomSafeDataset):
    """Driving scenes: per-frame npz with input cloud (+sensor) and a dense
    GT cloud (the reference's dataset/av.py:59-99; a missing file is
    resampled through skip_on_error, as av.py:65-72)."""

    def __init__(self, root: str, spec: Sequence[DS], split: str = "train",
                 transforms: Optional[Sequence[Dict]] = None, seed: int = 0,
                 skip_on_error: bool = True):
        super().__init__(seed, skip_on_error)
        self.root = Path(root)
        self.spec = list(spec)
        self.transforms = ComposedTransforms(transforms)
        split_file = self.root / f"{split}.lst"
        if split_file.exists():
            self.items = [self.root / ln.strip() for ln in
                          split_file.read_text().splitlines() if ln.strip()]
        else:
            self.items = sorted(self.root.glob("*.npz"))

    def __len__(self):
        return len(self.items)

    def _get_item(self, idx, rng):
        path = self.items[idx]
        if not path.exists():
            raise FileNotFoundError(path)  # -> resample via skip_on_error
        z = np.load(path)
        data: Dict = {DS.SHAPE_NAME: path.stem}
        data[DS.INPUT_PC] = z["xyz"].astype(np.float32)
        if DS.INPUT_SENSOR_POS in self.spec and "sensor" in z:
            data[DS.INPUT_SENSOR_POS] = z["sensor"].astype(np.float32)
        if DS.TARGET_NORMAL in self.spec and "normal" in z:
            data[DS.TARGET_NORMAL] = z["normal"].astype(np.float32)
        if "gt_xyz" in z:
            data[DS.GT_DENSE_PC] = z["gt_xyz"].astype(np.float32)
            data[DS.GT_DENSE_NORMAL] = z["gt_normal"].astype(np.float32)
        return self.transforms(data, rng)


class PointCloudDataset(RandomSafeDataset):
    """User data: ply pairs (input, gt) or single files
    (the reference's Customized dataset)."""

    def __init__(self, files: Sequence, spec: Sequence[DS],
                 transforms: Optional[Sequence[Dict]] = None, seed: int = 0):
        super().__init__(seed, False)
        self.files = list(files)   # str or (input, gt) tuples
        self.spec = list(spec)
        self.transforms = ComposedTransforms(transforms)

    def __len__(self):
        return len(self.files)

    def _get_item(self, idx, rng):
        f = self.files[idx]
        inp, gt = (f, f) if isinstance(f, (str, Path)) else f
        xyz, nrm = read_ply(inp)
        data: Dict = {DS.SHAPE_NAME: Path(str(inp)).stem,
                      DS.INPUT_PC: xyz}
        if nrm is not None and DS.TARGET_NORMAL in self.spec:
            data[DS.TARGET_NORMAL] = nrm
        gx, gn = read_ply(gt)
        data[DS.GT_DENSE_PC] = gx
        if gn is not None:
            data[DS.GT_DENSE_NORMAL] = gn
        return self.transforms(data, rng)


class Points2SurfDataset(RandomSafeDataset):
    """Points2Surf benchmark layout: ``<root>/<dataset_name>/<split>.lst``
    lists items; inputs at ``<dataset_name>/<type_name>/input/<item>.ply``
    (points + normals), dense GT at ``<dataset_name>/gt/<item>.ply``
    (the reference's dataset/points2surf.py:11-66)."""

    def __init__(self, root: str, spec: Sequence[DS],
                 dataset_name: str = "abc", type_name: str = "04_pts_vis",
                 split: str = "test",
                 transforms: Optional[Sequence[Dict]] = None, seed: int = 0,
                 skip_on_error: bool = False):
        super().__init__(seed, skip_on_error)
        self.root = Path(root)
        self.dataset_name = dataset_name
        self.type_name = type_name
        self.spec = list(spec)
        self.transforms = ComposedTransforms(transforms)
        lst = self.root / dataset_name / f"{split}.lst"
        self.items = [ln.strip() for ln in lst.read_text().splitlines()
                      if ln.strip()]

    def __len__(self):
        return len(self.items)

    def get_name(self):
        return f"p2s-{self.dataset_name}-{self.type_name}"

    def _get_item(self, idx, rng):
        name = self.items[idx]
        data: Dict = {DS.SHAPE_NAME: f"{self.type_name}/{name}"}
        xyz, nrm = read_ply(self.root / self.dataset_name / self.type_name
                            / "input" / f"{name}.ply")
        data[DS.INPUT_PC] = xyz
        if nrm is not None and DS.TARGET_NORMAL in self.spec:
            data[DS.TARGET_NORMAL] = nrm
        gx, gn = read_ply(self.root / self.dataset_name / "gt"
                          / f"{name}.ply")
        data[DS.GT_DENSE_PC] = gx
        if gn is not None:
            data[DS.GT_DENSE_NORMAL] = gn
        return self.transforms(data, rng)


class MatterportDataset(RandomSafeDataset):
    """Matterport indoor regions: ``<root>/<scene>/<region>/full.npz``
    (dense GT points+normals) and ``partial.npz`` (scanned input), with
    scene-level splits from ``scenes_train.txt``/``scenes_test.txt`` and a
    deterministic train/val subdivision of the train scene list
    (reference layout + semantics: the reference's dataset/matterport.py:
    22-50 scene splits, :61-96 region enumeration and npz fields)."""

    def __init__(self, root: str, spec: Sequence[DS], split: str = "train",
                 tv_ratio: float = 0.7 / 0.8, partial_input: bool = False,
                 custom_scenes: Optional[Sequence[str]] = None,
                 transforms: Optional[Sequence[Dict]] = None, seed: int = 0,
                 skip_on_error: bool = False):
        super().__init__(seed, skip_on_error)
        self.root = Path(root)
        self.spec = list(spec)
        self.split = split
        self.partial_input = partial_input
        self.transforms = ComposedTransforms(transforms)

        if split == "test":
            scenes = [ln.strip() for ln in
                      (self.root / "scenes_test.txt").read_text()
                      .splitlines() if ln.strip()]
        elif split == "custom":
            scenes = list(custom_scenes or [])
        else:
            scenes = [ln.strip() for ln in
                      (self.root / "scenes_train.txt").read_text()
                      .splitlines() if ln.strip()]
            # deterministic shuffle so train/val partitions are disjoint
            # across runs (mirrors the reference's RandomState(0) split)
            np.random.RandomState(0).shuffle(scenes)
            n_train = int(len(scenes) * tv_ratio)
            scenes = scenes[:n_train] if split == "train" \
                else scenes[n_train:]
        self.regions = [(s, r.name) for s in scenes
                        for r in sorted((self.root / s).iterdir())
                        if r.is_dir()]

    def __len__(self):
        return len(self.regions)

    def get_name(self):
        return f"matterport-{self.split}"

    def _get_item(self, idx, rng):
        scene, region = self.regions[idx]
        base = self.root / scene / region
        full = np.load(base / "full.npz")
        gx = full["points"].astype(np.float32)
        gn = full["normals"].astype(np.float32)
        if self.partial_input:
            part = np.load(base / "partial.npz")
            px = part["points"].astype(np.float32)
            pn = part["normals"].astype(np.float32)
        else:
            px, pn = gx.copy(), gn.copy()
        data: Dict = {DS.SHAPE_NAME: f"{scene}/{region}",
                      DS.INPUT_PC: px}
        if DS.TARGET_NORMAL in self.spec:
            data[DS.TARGET_NORMAL] = pn
        if DS.GT_DENSE_PC in self.spec:
            data[DS.GT_DENSE_PC] = gx
        if DS.GT_DENSE_NORMAL in self.spec:
            data[DS.GT_DENSE_NORMAL] = gn
        return self.transforms(data, rng)


class CombinedDataset(RandomSafeDataset):
    """Mixture of datasets with logical subsampling: each epoch sees
    ``ratio`` of each subset, and repeated reads of the same logical slot
    rotate through the subset's physical items so the whole subset is
    eventually visited (reference dataset/combined.py:45-59 semantics:
    physical = (read_count * logical_len + slot) % physical_len)."""

    def __init__(self, datasets: Optional[Sequence[RandomSafeDataset]] = None,
                 ratios: Optional[Sequence[float]] = None, seed: int = 0,
                 spec: Optional[Sequence[DS]] = None,
                 config_list: Optional[Sequence[Dict]] = None):
        """Construct from built datasets OR a YAML-friendly
        ``config_list`` of ``{name, ratio, args}`` entries (the
        reference's combined config_list shape,
        the reference's configs/mixed/data.yaml)."""
        super().__init__(seed, False)
        if config_list is not None:
            if spec is None:
                raise ValueError("config_list needs the DatasetSpec")
            datasets = [build_dataset(c["name"], spec,
                                      **c.get("args", {}))
                        for c in config_list]
            ratios = [c.get("ratio", c.get("subsample", 1.0))
                      for c in config_list]
        self.datasets = list(datasets)
        ratios = ratios or [1.0] * len(datasets)
        self.counts = [max(1, int(len(d) * r))
                       for d, r in zip(self.datasets, ratios)]
        # per-(subset, logical slot) read counters
        self._slot_reads: Dict = {}

    def __len__(self):
        return sum(self.counts)

    def _get_item(self, idx, rng):
        for di, (d, c) in enumerate(zip(self.datasets, self.counts)):
            if idx < c:
                reads = self._slot_reads.get((di, idx), 0)
                self._slot_reads[(di, idx)] = reads + 1
                base = (reads * c + idx) % len(d)
                return d[base]
            idx -= c
        raise IndexError


_DATASETS = {
    "ShapeNet": ShapeNetDataset,
    "AV": AVDataset,
    "CARLA": AVDataset,
    "Matterport": MatterportDataset,
    "Points2Surf": Points2SurfDataset,
    "Customized": PointCloudDataset,
    "Combined": CombinedDataset,
}


def build_dataset(name: str, spec: Sequence[DS], **kwargs):
    """A dataset by its config name."""
    return _DATASETS[name](spec=spec, **kwargs)
