"""The fixed-order segment sum (nksr_tpu_torch/ops/segment_sum.py) on the
CPU: its plain version against ``np.add.at``, and its order tables
against the fold the CUDA kernel makes, bit for bit.

The CUDA kernel walks each segment of ``segment_order``'s tables in
order, adding from 0.0; the numpy fold below does the same in f32, so
the tables are held to giving the sums of ``np.add.at`` exactly.  The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from nksr_tpu_torch.models import dense_unet as DU
from nksr_tpu_torch.ops import segment_sum as SEG

torch.set_num_threads(1)


def _inputs(seed, r, c, t, drop=True):
    """R rows of C f32 values onto T targets: heavy duplication (a few
    hot targets take a third of the rows), empty targets, and dropped
    entries (-1) when ``drop``."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, t, r)
    hot = rng.random(r) < 0.33
    idx[hot] = rng.integers(0, t, 3)[rng.integers(0, 3, int(hot.sum()))]
    empty = idx % 7 == 3                   # no entry targets 3 mod 7
    idx[empty] = (idx[empty] + 1) % t
    if drop:
        idx[rng.random(r) < 0.1] = -1
    vals = rng.standard_normal((r, c)).astype(np.float32) \
        * rng.choice([1e-3, 1.0, 1e3], (r, 1)).astype(np.float32)
    return idx, vals


def _add_at(idx, vals, t):
    out = np.zeros((t,) + vals.shape[1:], np.float32)
    keep = idx >= 0
    np.add.at(out, idx[keep], vals[keep])
    return out


def _fold(order: SEG.SegmentOrder, vals: np.ndarray, compact: bool):
    """What the kernel computes from the tables: each target's run of
    ``perm`` added to 0.0 one row at a time, in f32."""
    perm = order.perm.numpy()
    offs = order.offsets.numpy()
    tgt = order.targets.numpy() if compact else np.arange(order.n_targets)
    out = np.zeros((len(tgt),) + vals.shape[1:], np.float32)
    for s, t in enumerate(tgt):
        acc = np.zeros(vals.shape[1:], np.float32)
        for i in perm[offs[t]:offs[t + 1]]:
            acc = acc + vals[i]
        out[s] = acc
    return out


@pytest.mark.parametrize("r,c,t", [(2000, 1, 300), (3000, 3, 500),
                                   (2000, 4, 64), (1500, 7, 900),
                                   (600, 128, 40)])
def test_plain_matches_add_at(r, c, t):
    """Dense and compact forms of the plain version equal ``np.add.at``
    bit for bit (index-order f32 sums from 0.0), the compact rows being
    the dense rows of ``order.targets``; 1-D values as (R,)."""
    idx, vals = _inputs(r + c, r, c, t)
    order = SEG.segment_order(torch.from_numpy(idx), t)
    ref = _add_at(idx, vals, t)
    dense = SEG.segment_sum(torch.from_numpy(vals), order)
    np.testing.assert_array_equal(dense.numpy(), ref)
    comp = SEG.segment_sum(torch.from_numpy(vals), order, compact=True)
    np.testing.assert_array_equal(comp.numpy(), ref[order.targets.numpy()])
    flat = SEG.segment_sum(torch.from_numpy(vals[:, 0].copy()), order)
    np.testing.assert_array_equal(flat.numpy(), ref[:, 0])


@pytest.mark.parametrize("r,c,t", [(2000, 3, 500), (800, 128, 40),
                                   (300, 2, 3)])
def test_order_tables_fold_to_add_at(r, c, t):
    """``segment_order``'s tables: entries sorted by (target, entry), the
    dropped ones first, and a run for every target (empty where no entry
    has it), the distinct kept targets ascending; the kernel's fold over
    them equals ``np.add.at`` bit for bit in both forms."""
    idx, vals = _inputs(r * 3 + c, r, c, t)
    order = SEG.segment_order(torch.from_numpy(idx), t)
    perm = order.perm.numpy()
    offs = order.offsets.numpy()
    assert order.perm.dtype == order.offsets.dtype == torch.int32
    assert order.index.dtype == torch.int32
    np.testing.assert_array_equal(perm, np.argsort(idx, kind="stable"))
    kept = idx[idx >= 0]
    uniq = np.unique(kept)
    np.testing.assert_array_equal(order.targets.numpy(), uniq)
    assert offs.shape == (t + 1,)
    np.testing.assert_array_equal(np.diff(offs),
                                  np.bincount(kept, minlength=t))
    assert offs[-1] == len(idx) and offs[0] == (idx < 0).sum()
    ref = _add_at(idx, vals, t)
    np.testing.assert_array_equal(_fold(order, vals, False), ref)
    np.testing.assert_array_equal(_fold(order, vals, True), ref[uniq])


def test_index_sum_is_index_add():
    """``index_sum`` on the CPU is ``index_add_`` of the kept entries."""
    idx, vals = _inputs(5, 3000, 5, 700)
    got = SEG.index_sum(torch.from_numpy(vals), torch.from_numpy(idx), 700)
    keep = torch.from_numpy(idx >= 0)
    ref = torch.zeros((700, 5)).index_add_(
        0, torch.from_numpy(idx)[keep], torch.from_numpy(vals)[keep])
    assert torch.equal(got, ref)


def test_trilinear_splat_unchanged():
    """The dense UNet's splat through ``index_sum`` is bit for bit the
    ``index_add_`` of its kept (point, corner) rows, corners off the
    lattice dropped."""
    rng = np.random.default_rng(9)
    n, dims, origin = 4000, (12, 10, 9), (-2, -1, -3)
    base = torch.from_numpy(rng.integers(-3, 11, (n, 3)))
    frac = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    vals = torch.from_numpy(rng.standard_normal((n, 8, 5)).astype(
        np.float32))
    acc, w = DU.trilinear_splat(dims, origin, base, frac, vals)
    offs = torch.as_tensor(DU._OFFS)
    loc = base[:, None, :] + offs - torch.tensor(origin)
    ok = ((loc >= 0) & (loc < torch.tensor(dims))).all(-1)
    flat = (loc[..., 0] * dims[1] + loc[..., 1]) * dims[2] + loc[..., 2]
    ref = torch.zeros((int(np.prod(dims)), 5)).index_add_(
        0, flat[ok], (vals * w[..., None])[ok])
    assert 0 < int(ok.sum()) < ok.numel()
    assert torch.equal(acc, ref)


def test_empty_and_out_of_range():
    """No entries gives zeros (dense) and no rows (compact); a target past
    the range raises."""
    order = SEG.segment_order(torch.zeros(0, dtype=torch.int64), 5)
    assert order.offsets.tolist() == [0] * 6
    assert not SEG.segment_sum(torch.zeros((0, 3)), order).any()
    assert SEG.segment_sum(torch.zeros((0, 3)), order,
                           compact=True).shape == (0, 3)
    dropped = SEG.segment_order(torch.tensor([-1, -1]), 5)
    assert dropped.targets.numel() == 0
    assert dropped.offsets.tolist() == [2] * 6
    with pytest.raises(ValueError, match="outside"):
        SEG.segment_order(torch.tensor([0, 5]), 5)


def test_cpu_calls_do_not_count_launches():
    idx, vals = _inputs(6, 200, 4, 30)
    before = SEG.segment_sum.launches
    SEG.segment_sum(torch.from_numpy(vals),
                    SEG.segment_order(torch.from_numpy(idx), 30))
    SEG.index_sum(torch.from_numpy(vals), torch.from_numpy(idx), 30)
    assert SEG.segment_sum.launches == before


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; a
    meta tensor stands in for a CUDA tensor on this CUDA-less machine."""
    def fail(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(SEG, "segment_sum_plain", fail)
    monkeypatch.setattr(SEG, "segment_sum_backward_plain", fail)
    m = dict(device="meta")
    order = SEG.SegmentOrder(
        torch.zeros(8, dtype=torch.int32, **m),
        torch.zeros(8, dtype=torch.int32, **m),
        torch.zeros(5, dtype=torch.int32, **m), 4)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        SEG.segment_sum(torch.zeros((8, 4), **m), order)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        SEG.segment_sum_backward(torch.zeros((4, 4), **m), order)
