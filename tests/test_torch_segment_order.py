"""The fixed-order segment sum's order and its kernels' arithmetic on the
CPU (nksr_tpu_torch/ops/segment_sum.py, csrc/segment_sum.cu).

The order is built without a host sync: a stable sort of the targets and
a run for every target found by ``searchsorted``.  Here it is held to the
order the port built before (the stable argsort and one run a distinct
target), the kernels' summation designs are emulated in numpy lane
group by lane group and held to ``np.add.at`` bit for bit, the
backward's plain version to autograd of CPU ``index_add_``, the host
check of a step's tables is made to raise, and a teacher-forced and a
predicted training step at ``tests/test_train.py``'s size are shown to
build the same orders as before.  The kernels themselves are held to
their plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_train import CFG as JCFG, LCFG as JLCFG, make_batch
from test_torch_train import port_configs

from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.models.network import NKSRNetwork
from nksr_tpu_torch.ops import segment_sum as SEG
from nksr_tpu_torch.train import loop as T
from nksr_tpu_torch.utils.checkpoint import params_to_torch

torch.set_num_threads(1)

# segment lengths the kernels meet: empty, one row, a conv backward's 27,
# one past a 32-entry perm chunk, and a long run of several hundred
SEGMENT_LENGTHS = (0, 1, 27, 33, 420)


def _old_order(idx: np.ndarray):
    """The order the port built before: the stable argsort, then one run
    a distinct kept target (its start in the sorted entries)."""
    perm = np.argsort(idx, kind="stable")
    key = idx[perm]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.nonzero(first & (key >= 0))[0]
    return perm, starts, key[starts]


def _add_at(idx, vals, t):
    out = np.zeros((t,) + vals.shape[1:], np.float32)
    keep = idx >= 0
    np.add.at(out, idx[keep], vals[keep])
    return out


def _segments_input(c: int, seed: int):
    """Entries in random order onto targets with the runs of
    ``SEGMENT_LENGTHS`` (each twice), empty targets between them, and a
    tenth of the entries dropped; values of mixed magnitude."""
    rng = np.random.default_rng(seed)
    lengths = np.repeat(SEGMENT_LENGTHS, 2)
    t = 3 * len(lengths)
    targets = rng.permutation(t)[:len(lengths)]
    idx = np.repeat(targets, lengths)
    idx = np.concatenate([idx, -np.ones(len(idx) // 10, np.int64)])
    idx = idx[rng.permutation(len(idx))]
    vals = rng.standard_normal((len(idx), c)).astype(np.float32) \
        * rng.choice([1e-3, 1.0, 1e3], (len(idx), 1)).astype(np.float32)
    return idx, vals, t


def _warp_fold(order: SEG.SegmentOrder, vals: np.ndarray) -> np.ndarray:
    """``segment_sum_warp`` in numpy: per target, rounds of G x 8 perm
    entries (G = 32 // L lane groups, 8 rows a lane); in a round group g
    loads entry d * G + g for d < 8, and the loaded rows are added into
    the running sum d by d, group by group."""
    perm, offs = order.perm.numpy(), order.offsets.numpy()
    c = vals.shape[1]
    lanes = c // 4 if c % 4 == 0 else c
    groups, rows = 32 // lanes, 8
    out = np.zeros((order.n_targets, c), np.float32)
    for t in range(order.n_targets):
        lo, hi = offs[t], offs[t + 1]
        acc = np.zeros(c, np.float32)
        for base in range(lo, hi, groups * rows):
            n = min(groups * rows, hi - base)
            loaded = [[vals[perm[base + d * groups + g]]
                       if d * groups + g < n else None
                       for g in range(groups)] for d in range(rows)]
            for d in range(rows):
                for q in range(min(groups, n - d * groups)):
                    acc = acc + loaded[d][q]
        out[t] = acc
    return out


def _walk_fold(order: SEG.SegmentOrder, vals: np.ndarray) -> np.ndarray:
    """``walk_run`` in numpy, the run walk of the thread and the tile
    designs: per target, rounds of eight rows loaded (those past the run
    masked off), then added in order."""
    perm, offs = order.perm.numpy(), order.offsets.numpy()
    out = np.zeros((order.n_targets, vals.shape[1]), np.float32)
    for t in range(order.n_targets):
        lo, hi = offs[t], offs[t + 1]
        acc = np.zeros(vals.shape[1], np.float32)
        for e in range(lo, hi, 8):
            rows = [vals[perm[e + u]] if e + u < hi else None
                    for u in range(8)]
            for u in range(8):
                if e + u < hi:
                    acc = acc + rows[u]
        out[t] = acc
    return out


@pytest.mark.parametrize("r,t", [(3000, 500), (5000, 40), (300, 3),
                                 (0, 7), (50, 9000)])
def test_sync_free_order_is_the_old_order(r, t):
    """The order built without a host sync: its perm is the old order's,
    its runs over all targets are the old segments (empty elsewhere), and
    the dropped entries lie before the first run."""
    rng = np.random.default_rng(r + t)
    idx = rng.integers(-1, t, r)
    idx[rng.random(r) < 0.3] = t // 2
    order = SEG.segment_order(torch.from_numpy(idx), t, check=False)
    perm, starts, targets = _old_order(idx)
    np.testing.assert_array_equal(order.perm.numpy(), perm)
    offs = order.offsets.numpy()
    np.testing.assert_array_equal(offs[targets], starts)
    np.testing.assert_array_equal(order.targets.numpy(), targets)
    ends = np.append(starts[1:], r)[:len(starts)]
    np.testing.assert_array_equal(offs[targets + 1], ends)
    assert offs[0] == (idx < 0).sum() and offs[-1] == r
    assert (np.diff(offs) >= 0).all()
    assert np.diff(offs).sum() == (idx >= 0).sum()


@pytest.mark.parametrize("c", [1, 3, 4, 7, 32, 128])
def test_warp_combine_order_folds_to_add_at(c):
    """The warp design's combine order (lane groups loading rows side by
    side, eight a lane a round, added in entry order) folds to
    ``np.add.at`` bit for bit, on runs of 0, 1, 27, 33 and 420 rows with
    dropped entries; so does the thread and tile designs' run walk."""
    idx, vals, t = _segments_input(c, seed=c)
    order = SEG.segment_order(torch.from_numpy(idx), t)
    ref = _add_at(idx, vals, t)
    np.testing.assert_array_equal(_warp_fold(order, vals), ref)
    np.testing.assert_array_equal(_walk_fold(order, vals), ref)
    np.testing.assert_array_equal(
        SEG.segment_sum(torch.from_numpy(vals), order).numpy(), ref)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("c", [1, 7, 32])
def test_backward_plain_is_index_add_autograd(c, compact):
    """``segment_sum_backward_plain`` (what the backward kernel computes)
    against autograd of CPU ``index_add_``: each entry the cotangent row
    of its target, zeros where dropped, bit for bit; and it is what the
    segment sum's autograd backward gives."""
    idx, vals, t = _segments_input(c, seed=100 + c)
    order = SEG.segment_order(torch.from_numpy(idx), t)
    v = torch.from_numpy(vals).requires_grad_()
    keep = torch.from_numpy(idx >= 0)
    dense = torch.zeros((t, c)).index_add(0, torch.from_numpy(idx)[keep],
                                          v[keep])
    out = dense[order.targets] if compact else dense
    cot = torch.from_numpy(np.random.default_rng(c).standard_normal(
        tuple(out.shape)).astype(np.float32))
    (ref,) = torch.autograd.grad(out, v, cot)
    got = SEG.segment_sum_backward_plain(cot, order, compact)
    assert torch.equal(got, ref)
    assert torch.equal(SEG.segment_sum_backward(cot, order, compact), ref)
    a = torch.from_numpy(vals).requires_grad_()
    (via,) = torch.autograd.grad(SEG.segment_sum(a, order, compact), a, cot)
    assert torch.equal(via, ref)


def test_host_check_raises_on_a_table_out_of_range(monkeypatch):
    """The step's index tables are checked on the host before their
    upload: a row past its table's bound raises there, while the sync-free
    order would leave it in no run; an unchecked order is also built on
    such a table without raising, a checked one raises."""
    with pytest.raises(ValueError, match="outside"):
        P.checked_rows(np.array([[0, -1], [4, 5]]), 5, "test rows")
    assert P.checked_rows(np.array([[0, -1], [4, 3]]), 5, "ok").shape \
        == (2, 2)
    bad = torch.tensor([0, 2, 5])
    assert SEG.segment_order(bad, 5, check=False).offsets[-1] == 2
    with pytest.raises(ValueError, match="outside"):
        SEG.segment_order(bad, 5)
    real = HB.support_indices

    def off_by_one(grids, caps, x, presorted=None):
        out = real(grids, caps, x, presorted)
        return tuple(np.where(t >= 0, t + caps[d], t)
                     for d, t in enumerate(out))
    monkeypatch.setattr(HB, "support_indices", off_by_one)
    cfg, _ = port_configs(JCFG, JLCFG)
    batch = {k: np.asarray(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match="outside"):
        P.prepare_inputs(cfg, batch, "cpu")


def _own(order: SEG.SegmentOrder):
    """An order's kept entries in summation order and its runs relative to
    the first, whether its perm is its own (``segment_order``) or a
    batch's (``segment_orders``)."""
    offs = order.offsets.numpy().astype(np.int64)
    return order.perm.numpy()[offs[0]:offs[-1]], offs - offs[0]


def _assert_old_order(idx: np.ndarray, n: int, order: SEG.SegmentOrder):
    """``order`` sums ``idx``'s entries as the old order did: the kept
    entries of the stable argsort, a run from each old segment start, and
    the dense fold ``np.add.at``."""
    in_range = bool((idx < n).all())
    idx = np.where(idx < n, idx, -1)      # past n: in no run
    perm, starts, targets = _old_order(idx)
    kept = perm[idx[perm] >= 0]
    got, rel = _own(order)
    np.testing.assert_array_equal(got, kept)
    dropped = len(perm) - len(kept)
    assert order.offsets.shape == (n + 1,) and rel[-1] == len(kept)
    np.testing.assert_array_equal(rel[targets], starts - dropped)
    if not in_range:       # the plain version (CPU index_add_) raises
        return
    vals = np.random.default_rng(len(idx)).standard_normal(
        (len(idx), 3)).astype(np.float32)
    np.testing.assert_array_equal(
        SEG.segment_sum(torch.from_numpy(vals), order).numpy(),
        _add_at(idx, vals, n))


def test_batched_orders_are_the_tables_own():
    """``segment_orders`` builds each table's order in one sort: the same
    summation order and sums as ``segment_order`` unchecked (an entry at
    or past its table's n dropped, not summed into the next table), for
    tables of every kind: long runs, all dropped, empty, more targets
    than entries."""
    rng = np.random.default_rng(7)
    tables = [(rng.integers(-1, 40, (300, 27)), 40),
              (rng.integers(-1, 3, 500), 3),
              (-np.ones(20, np.int64), 9),
              (np.zeros(0, np.int64), 5),
              (rng.integers(-1, 900, 200), 900),
              (np.append(rng.integers(-1, 60, 400), [60, 75]), 60),
              (rng.integers(0, 7, (50, 8)), 7)]
    orders = SEG.segment_orders([(torch.from_numpy(t), n)
                                 for t, n in tables])
    for (t, n), order in zip(tables, orders):
        _assert_old_order(t.reshape(-1), n, order)
    assert all(o.perm is orders[0].perm for o in orders)    # one sort


def test_expected_orders_are_built_together(monkeypatch):
    """The tables a forward notes (``expect_order``) are built with the
    first ``table_order`` that misses, in one ``segment_orders`` call, and
    kept on their tables; a dead table is skipped, a written one sorted
    again."""
    calls = []
    real = SEG.segment_orders
    monkeypatch.setattr(SEG, "segment_orders",
                        lambda t: calls.append(len(t)) or real(t))
    monkeypatch.setattr(SEG, "_expected", [])
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-1, 30, (64, 27), generator=g)
    b = torch.randint(-1, 50, (400,), generator=g)
    dead = torch.randint(-1, 9, (40,), generator=g)
    SEG.expect_order(a[:50].reshape(-1), 31)
    SEG.expect_order(b, 50)
    SEG.expect_order(dead, 9)
    del dead
    ob = SEG.table_order(b, 50)
    assert calls == [2]
    oa = SEG.table_order(a[:50].reshape(-1), 31)
    assert calls == [2] and SEG.table_order(b, 50) is ob
    _assert_old_order(a[:50].reshape(-1).numpy(), 31, oa)
    _assert_old_order(b.numpy(), 50, ob)
    b[0] = 7
    SEG.expect_order(b, 50)
    SEG.table_order(b, 50)
    assert calls == [2, 1]


@pytest.fixture(scope="module")
def step_orders():
    """Every order a teacher-forced and a predicted training step build
    (its entries, target count and order, one sort or a batch's), at
    ``tests/test_train.py``'s size from the port's seeded init, the solves
    cut to 4 iterations."""
    jcfg = dataclasses.replace(JCFG, solver_max_iters=4)
    cfg, lcfg = port_configs(jcfg, JLCFG)
    batch = {k: np.asarray(v) for k, v in make_batch().items()}
    real, real_batch = SEG.segment_order, SEG.segment_orders
    built = {}
    for mode, gt in (("teacher", True), ("predicted", False)):
        seen = built[mode] = []

        def record(index, n, check=True):
            order = real(index, n, check)
            seen.append((index.reshape(-1).numpy().copy(), n, order))
            return order

        def record_batch(tables):
            orders = real_batch(tables)
            seen.extend((i.reshape(-1).numpy().copy(), n, o)
                        for (i, n), o in zip(tables, orders))
            return orders
        net = NKSRNetwork(cfg)
        net.load_state_dict(params_to_torch(P.init_params(cfg)["params"]),
                            strict=True)
        SEG.segment_order, SEG.segment_orders = record, record_batch
        try:
            inp = P.prepare_inputs(cfg, batch, "cpu", use_gt_structure=gt)
            T.loss_and_grads(cfg, lcfg, net, inp, None, use_gt_structure=gt,
                             gen=torch.Generator().manual_seed(0))
        finally:
            SEG.segment_order, SEG.segment_orders = real, real_batch
    return built


@pytest.mark.parametrize("mode", ["teacher", "predicted"])
def test_step_builds_the_old_orders(step_orders, mode):
    """A step's orders (the gathers' backwards, the splat, the support
    scatters; most built in batches) are the old ones: the same kept
    entries in the same order, a run at each old segment's start, and
    their dense fold ``np.add.at`` of the kept entries."""
    orders = step_orders[mode]
    assert len(orders) > 10
    for idx, n, order in orders:
        _assert_old_order(idx, n, order)
