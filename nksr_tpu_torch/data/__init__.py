"""Data layer of the PyTorch port: the mesh writer, the dataset spec and
transforms, the ShapeNet-layout reader and the padded-batch loader (the
JAX package's other readers and ``gt_geometry`` are ROADMAP queue 1,
item 16)."""

from . import transforms
from .base import DatasetSpec, RandomSafeDataset
from .datasets import ShapeNetDataset, build_dataset
from .io import write_ply
from .loader import PrefetchLoader, to_device_batch

__all__ = ["DatasetSpec", "RandomSafeDataset", "ShapeNetDataset", "build_dataset", "PrefetchLoader",
           "to_device_batch", "transforms", "write_ply"]
