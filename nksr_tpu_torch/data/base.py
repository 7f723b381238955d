"""Dataset core: the spec enum and the deterministic-RNG dataset base
(a copy of those two of nksr_tpu/data/base.py, which the port does not
import), the reference data-layer semantics (reference dataset/base.py):

  * ``DatasetSpec`` — the 13 batch field names (base.py:12-25)
  * deterministic per-(index, epoch, seed) RNG with error re-sampling
    (base.py:28-85)
"""

from __future__ import annotations

import enum
import hashlib
from typing import Dict

import numpy as np


class DatasetSpec(enum.Enum):
    SHAPE_NAME = enum.auto()
    INPUT_PC = enum.auto()
    INPUT_COLOR = enum.auto()
    INPUT_SENSOR_POS = enum.auto()
    TARGET_NORMAL = enum.auto()
    GT_DENSE_PC = enum.auto()
    GT_DENSE_NORMAL = enum.auto()
    GT_DENSE_COLOR = enum.auto()
    GT_MESH = enum.auto()
    GT_MESH_SOUP = enum.auto()
    GT_ONET_SAMPLE = enum.auto()
    GT_GEOMETRY = enum.auto()
    DATASET_CFG = enum.auto()


class RandomSafeDataset:
    """Deterministic, fault-tolerant dataset base.

    Each ``__getitem__`` gets an RNG derived from (seed, index, read_count)
    so epochs see different but reproducible augmentations; item errors are
    re-sampled from the same dataset when ``skip_on_error`` is set.
    """

    def __init__(self, seed: int = 0, skip_on_error: bool = False):
        self.seed = seed
        self.skip_on_error = skip_on_error
        self._read_counts: Dict[int, int] = {}

    def __len__(self) -> int:
        raise NotImplementedError

    def _get_item(self, idx: int, rng: np.random.Generator) -> Dict:
        raise NotImplementedError

    def get_rng(self, idx: int) -> np.random.Generator:
        count = self._read_counts.get(idx, 0)
        self._read_counts[idx] = count + 1
        h = hashlib.sha256(
            f"{self.seed}:{idx}:{count}".encode()).digest()[:8]
        return np.random.default_rng(int.from_bytes(h, "little"))

    def __getitem__(self, idx: int) -> Dict:
        rng = self.get_rng(idx)
        try:
            return self._get_item(idx, rng)
        except Exception:
            if not self.skip_on_error:
                raise
            alt = int(rng.integers(0, len(self)))
            return self.__getitem__(alt)

