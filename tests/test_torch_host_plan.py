"""The port's numpy host build and lattice plan (nksr_tpu_torch/core/
host_build.py, nksr_tpu_torch/fields/lattice.py, nksr_tpu_torch/native.py)
are byte-identical to the JAX package's on a bench-terrain cloud."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import synthetic_scene
from nksr_tpu.core import host_build as JHB
from nksr_tpu.fields import lattice as JLAT
from nksr_tpu_torch import native
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.fields import lattice as LAT

torch.set_num_threads(1)


def _caps(grids):
    return tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)


def build_plan(hb, lat, xyz, voxel_size=0.1, depth=3):
    grids, orders = hb.build_splat_grids_ex(xyz, voxel_size, depth)
    caps = _caps(grids)
    plan = lat.plan_lattice(grids, caps, xyz, orders[0][0], orders[0][1],
                            voxel_size, depth, 1, k=4)
    return grids, orders, caps, plan


def _assert_same(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


def _assert_plans_equal(ref, got):
    r_grids, r_orders, r_caps, r_plan = ref
    g_grids, g_orders, g_caps, g_plan = got
    assert r_caps == g_caps
    for d, (rg, gg) in enumerate(zip(r_grids, g_grids)):
        _assert_same(tuple(rg), tuple(gg), f"grid {d}")
    _assert_same(r_orders, g_orders, "orders")
    assert dataclasses.asdict(r_plan.spec) == dataclasses.asdict(g_plan.spec)
    for name in r_plan._fields[1:]:
        _assert_same(getattr(r_plan, name), getattr(g_plan, name), name)


@pytest.mark.parametrize("n,half_extent", [(4000, 3.0), (2500, 1.5)])
def test_plan_is_byte_identical(n, half_extent):
    xyz, _ = synthetic_scene(n, seed=5, half_extent=half_extent)
    ref = build_plan(JHB, JLAT, xyz)
    got = build_plan(HB, LAT, xyz)
    assert got[3] is not None
    _assert_plans_equal(ref, got)


def test_numpy_fallbacks_give_the_same_plan(monkeypatch):
    """Without a C++ toolchain every native op takes its numpy form,
    as the JAX package's do; the plan does not change."""
    xyz, _ = synthetic_scene(3000, seed=6, half_extent=2.0)
    ref = build_plan(JHB, JLAT, xyz)
    monkeypatch.setattr(native, "_load", lambda: None)
    got = build_plan(HB, LAT, xyz)
    _assert_plans_equal(ref, got)


def test_unpack_pack_round_trip():
    rng = np.random.default_rng(0)
    c = rng.integers(-1000, 1000, size=(500, 3)).astype(np.int32)
    np.testing.assert_array_equal(HB.unpack64(HB.pack64(c)), c)
    np.testing.assert_array_equal(HB.pack64(c), JHB.pack64(c))
