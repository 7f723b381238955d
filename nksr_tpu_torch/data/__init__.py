"""Data layer of the PyTorch port: PLY read and write, the dataset spec
and transforms, the dataset readers, the ground-truth geometry providers
and the padded-batch loader."""

from . import gt_geometry, transforms
from .base import DatasetSpec, RandomSafeDataset
from .datasets import (AVDataset, CombinedDataset, MatterportDataset,
                       PointCloudDataset, Points2SurfDataset,
                       ShapeNetDataset, build_dataset)
from .io import read_ply, read_ply_full, write_ply
from .loader import PrefetchLoader, to_device_batch

__all__ = ["AVDataset", "CombinedDataset", "DatasetSpec",
           "MatterportDataset", "PointCloudDataset", "Points2SurfDataset",
           "PrefetchLoader", "RandomSafeDataset", "ShapeNetDataset",
           "build_dataset", "gt_geometry", "read_ply", "read_ply_full",
           "to_device_batch", "transforms", "write_ply"]
