"""Batches of one cloud, padded to capacity buckets, and a prefetching
loader (counterpart of nksr_tpu/data/loader.py).

The train step reads the padded arrays with their masks, the layout of
the JAX package's batches, and keeps the real rows (``models/pipeline.
prepare_inputs``): its hierarchies are built on the host, so a batch is
a dict of CPU tensors; the step moves what the device needs.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .base import DatasetSpec as DS
from .transforms import pad_cloud


def _bucket(n: int, lo: int = 512) -> int:
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), int(math.log2(lo)))


def to_device_batch(item: Dict, point_bucket: Optional[int] = None,
                    gt_bucket: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One dataset item (DatasetSpec keys) -> the padded train-step batch:
    ``xyz``/``mask`` (and ``normal``, ``sensor``) at ``point_bucket`` or
    the next power of two (at least 512), ``gt_xyz``/``gt_normal``/
    ``gt_mask`` at ``gt_bucket``, ``onet_*`` at their own bucket; the
    arrays of the JAX package's ``to_device_batch``, as CPU tensors."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    xyz = np.asarray(item[DS.INPUT_PC], np.float32)
    cap = point_bucket or _bucket(xyz.shape[0])
    out: Dict[str, torch.Tensor] = {}
    p, m = pad_cloud(xyz, cap)
    out["xyz"], out["mask"] = t(p), t(m)
    if DS.TARGET_NORMAL in item:
        out["normal"] = t(pad_cloud(
            np.asarray(item[DS.TARGET_NORMAL], np.float32), cap)[0])
    if DS.INPUT_SENSOR_POS in item:
        out["sensor"] = t(pad_cloud(
            np.asarray(item[DS.INPUT_SENSOR_POS], np.float32), cap)[0])
    gt = np.asarray(item.get(DS.GT_DENSE_PC, xyz), np.float32)
    gcap = gt_bucket or _bucket(gt.shape[0])
    gp, gm = pad_cloud(gt, gcap)
    out["gt_xyz"], out["gt_mask"] = t(gp), t(gm)
    gn = item.get(DS.GT_DENSE_NORMAL, item.get(DS.TARGET_NORMAL))
    if gn is None:
        gn = np.zeros_like(gt)
    out["gt_normal"] = t(pad_cloud(np.asarray(gn, np.float32), gcap)[0])
    if DS.GT_ONET_SAMPLE in item:
        pts, occ = item[DS.GT_ONET_SAMPLE]
        ocap = _bucket(pts.shape[0])
        pp, pm = pad_cloud(np.asarray(pts, np.float32), ocap)
        oo, _ = pad_cloud(np.asarray(occ, np.float32)[:, None], ocap)
        out["onet_xyz"] = t(pp)
        out["onet_occ"] = t(oo[:, 0])
        out["onet_mask"] = t(pm)
    return out


class PrefetchLoader:
    """Iterate a dataset's padded batches, read ahead on a thread."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 4,
                 point_bucket: Optional[int] = None,
                 gt_bucket: Optional[int] = None, epochs: int = 1):
        self.dataset = dataset
        self.indices = list(indices if indices is not None
                            else range(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.point_bucket = point_bucket
        self.gt_bucket = gt_bucket
        self.epochs = epochs

    def __len__(self):
        return len(self.indices) * self.epochs

    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            rng = np.random.default_rng(self.seed)
            try:
                for _ in range(self.epochs):
                    order = list(self.indices)
                    if self.shuffle:
                        rng.shuffle(order)
                    for i in order:
                        if stop.is_set():
                            return
                        q.put(to_device_batch(self.dataset[i],
                                              self.point_bucket,
                                              self.gt_bucket))
            finally:
                q.put(None)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
