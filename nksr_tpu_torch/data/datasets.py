"""The ONet/ShapeNet dataset layout (counterpart of nksr_tpu/data/
datasets.py ``ShapeNetDataset`` and ``build_dataset``), the layout
``scripts/make_synth_scenes.py`` and ``make_synth_dataset.py`` write.
The JAX package's other readers (AV/CARLA, Matterport, Points2Surf,
user clouds, mixtures) belong to ROADMAP queue 1, item 16."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import DatasetSpec as DS, RandomSafeDataset
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


_DATASETS = {"ShapeNet": ShapeNetDataset}


def build_dataset(name: str, spec: Sequence[DS], **kwargs):
    """A dataset by its config name."""
    if name not in _DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to nksr_tpu_torch yet "
            "(ROADMAP.md queue 1, item 16)")
    return _DATASETS[name](spec=spec, **kwargs)
