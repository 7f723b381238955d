"""Multi-device reconstruction (``reconstruct(..., mesh=)``) against the
port's single-device routes and the JAX package's sharded ones, on CPU
tensors under gloo worlds of 2 and 4 processes.

Each world is one spawn of ``tests/torch_parallel_worker.py`` a rank
(a ``FileStore`` under ``tmp_path``, one thread a rank, the parent
waiting at most ``WORLD_TIMEOUT`` seconds and killing the ranks past
it) that runs every scenario and saves its arrays; the world of 4 also
shares out the single-device references.  The JAX side is
``scripts/parallel_reference.py``'s, kept in
``tests/data/parallel_reference.npz`` (its sharded routes compile for
minutes); the plan is compared live (numpy).  Rewrite the file after a
change to ``tests/torch_parallel_cases.py``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python scripts/parallel_reference.py

The solves do not converge at these iteration counts (ROADMAP queue 3,
facts), so fields are held to each other only by distance: the JAX
test's gates (95% of probes within 5e-3 x scale, all within 2e-2 x
scale, tests/test_parallel.py:235-237), or, where the CG trajectory
breaks them, 1.5x the JAX package's own sharded-vs-single distance at
that world.  Operators, meshes of one field and chunks are held exactly.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from scipy.spatial import cKDTree

import torch_parallel_cases as C
from nksr_tpu.parallel import lattice_shard as JLS
from nksr_tpu_torch.core import host_build as HB
from nksr_tpu_torch.parallel import lattice_shard as LS

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
REF = os.path.join(HERE, "data", "parallel_reference.npz")
WORLD_TIMEOUT = 240
ROUTES = ("splat", "adaptive", "predicted")
# the world of 4 runs splat alone (it also computes the references)
ROUTES_4 = ("splat",)


def spawn(groups, timeout: float = WORLD_TIMEOUT):
    """Run every group ``(argv_of_rank, n, tmp)``'s ``n`` ranks at once,
    one thread each; wait for all of them at most ``timeout`` seconds,
    kill every rank past it, and fail unless all exited 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    ranks = []
    for argv_of_rank, n, tmp in groups:
        for r in range(n):
            log = open(tmp / f"rank{r}.log", "w+")
            ranks.append((tmp, r, log, subprocess.Popen(
                argv_of_rank(r), env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=tmp)))
    deadline = time.monotonic() + timeout
    try:
        for *_, p in ranks:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for *_, p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = ""
    for tmp, r, log, p in ranks:
        if p.returncode:
            log.seek(0)
            failed += (f"\n--- {tmp.name} rank {r}: exit code "
                       f"{p.returncode} ---\n" + log.read()[-3000:])
        log.close()
    assert not failed, "ranks failed:" + failed


def world_argv(n: int, tmp, *extra):
    return lambda r: [sys.executable, WORKER, str(r), str(n),
                      str(tmp / "store"), str(tmp), *extra]


def example_argv(tmp):
    """``examples/recons_sharded.py`` at world 2 over gloo on a file
    rendezvous, small: 3,000 points at voxel 0.4, 4 CG iterations."""
    root = os.path.dirname(HERE)
    return lambda r: [
        "env", "WORLD_SIZE=2", f"RANK={r}", f"PYTHONPATH={root}",
        sys.executable, "-m", "nksr_tpu_torch.examples.recons_sharded",
        "--device", "cpu", "--points", "3000", "--voxel-size", "0.4",
        "--max-iters", "4", "--out", str(tmp / "terrain.ply"),
        "--dist-init", f"file://{tmp / 'store'}"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' per-rank arrays, by world size, and the example's
    output directory, from one spawn of all three: the world of 2 runs
    every route, the world of 4 splat and shares out the single-device
    references."""
    from nksr_tpu_torch import native
    native._load()          # build the host library once, not in each rank
    tmps = {n: tmp_path_factory.mktemp(f"world{n}") for n in C.WORLDS}
    example = tmp_path_factory.mktemp("example")
    spawn([(world_argv(2, tmps[2], "--routes", ",".join(ROUTES)), 2, tmps[2]),
           (world_argv(4, tmps[4], "--routes", ",".join(ROUTES_4),
                       "--refs"), 4, tmps[4]),
           (example_argv(example), 2, example)])
    out = {n: [dict(np.load(tmps[n] / f"rank{r}.npz")) for r in range(n)]
           for n in C.WORLDS}
    out["example"] = example
    return out


@pytest.fixture(scope="module")
def refs(worlds):
    out = {}
    for ranks in (worlds[n] for n in C.WORLDS):
        for arrays in ranks:
            out.update({k[4:]: v for k, v in arrays.items()
                        if k.startswith("ref_")})
    return out


@pytest.fixture(scope="module")
def jax_ref():
    return np.load(REF)


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("structure", ["splat", "adaptive"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_plan_sharded_matches_jax(n, structure):
    """``plan_sharded`` on the same host grids: the global plan and every
    field of the JAX package's ShardedPlan byte for byte."""
    scene, cfg, kw, _ = C.SCENES[structure]
    xyz, nrm = scene()
    vs, depth = kw["voxel_size"], cfg["tree_depth"]
    grids, orders = HB.build_splat_grids_ex(xyz, vs, depth)
    caps = tuple(max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
                 for g in grids)
    dec, ad = {}, 1
    if structure == "adaptive":
        # a pruned decoder hierarchy: normals vary over x < 2 only
        ad = 2
        dg = HB.build_adaptive_grids(xyz, nrm, vs, depth, tau=0.02,
                                     adaptive_depth=ad, splat=(grids, orders))
        dec = dict(dec_grids=dg, dec_caps=tuple(
            max(1 << int(np.ceil(np.log2(len(g.keys) * 1.05))), 512)
            for g in dg))
        assert len(dg[0].keys) < len(grids[0].keys)
    args = (grids, caps, xyz, orders[0][0], orders[0][1], vs, depth, ad, n)
    plan, splan = LS.plan_sharded(*args, k=4, **dec)
    jplan, jsplan = JLS.plan_sharded(*args, k=4, **dec)

    def same(a, b, name):
        if isinstance(b, tuple):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                same(x, y, name)
            return
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    for a, b in ((plan.spec, jplan.spec), (splan.spec_local, jsplan.spec_local)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in jplan._fields[1:]:
        same(getattr(plan, name), getattr(jplan, name), name)
    for name in jsplan._fields[1:]:
        same(getattr(splan, name), getattr(jsplan, name), name)
    assert splan.slab_x[0] * n == plan.spec.dims[0][0]


# ----------------------------------------------------------- collectives
@pytest.mark.parametrize("n", C.WORLDS)
def test_halo_exchange_ring_and_chain(worlds, n):
    """JAX's test_halo_ring: the first entry is the left neighbour's last
    row, the last the right neighbour's first; the open chain's ends
    read zeros."""
    L = 4
    for r, arrays in enumerate(worlds[n]):
        x = np.arange(L * r, L * r + L, dtype=np.float32)
        left, right = ((r - 1) % n) * L + L - 1, ((r + 1) % n) * L
        np.testing.assert_array_equal(arrays["halo_ring"],
                                      np.r_[left, x, right])
        np.testing.assert_array_equal(
            arrays["halo_open"],
            np.r_[left if r else 0, x, right if r < n - 1 else 0])


@pytest.mark.parametrize("n", C.WORLDS)
def test_operator_matches_single_device(worlds, n):
    """The sharded matvec and right-hand side on seeded inputs, gathered,
    equal the port's single-device operator on the same aligned plan to
    1e-5 relative."""
    arrays = worlds[n][0]
    for key in ("op", "op_rhs"):
        got, want = arrays[key + "_sharded"], arrays[key + "_single"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key


# ---------------------------------------------------------------- routes
ROUTE_CASES = [(n, r) for n, routes in ((2, ROUTES), (4, ROUTES_4))
               for r in routes]


@pytest.mark.parametrize("n,route", ROUTE_CASES)
def test_field_matches_single_device(worlds, refs, jax_ref, n, route):
    """The sharded field (the same on every rank) against the port's
    single-device field at the probes: the JAX test's gates, or 1.5x the
    JAX package's own distance at this world where the unconverged
    trajectory breaks them."""
    ranks = worlds[n]
    assert all(a[f"{route}_sharded"] == 1 for a in ranks), "demoted"
    got = ranks[0][f"{route}_f"]
    for a in ranks[1:]:
        np.testing.assert_array_equal(a[f"{route}_f"], got)
    want = refs[f"{route}_f"]
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    err = np.abs(got - want)
    q95_gate = max(5e-3 * scale, 1.5 * float(jax_ref[f"{route}_n{n}_q95"]))
    max_gate = max(2e-2 * scale, 1.5 * float(jax_ref[f"{route}_n{n}_max"]))
    assert np.quantile(err, 0.95) < q95_gate, (np.quantile(err, 0.95), scale)
    assert err.max() < max_gate, (err.max(), scale)


@pytest.mark.parametrize("n,route", ROUTE_CASES)
def test_mesh_matches_single_device(worlds, refs, n, route):
    """The sharded mesh: every rank's the same; the dense mesher's mesh
    of the same gathered field vertex for vertex (counts equal, each
    vertex within 1e-5 of the other's); against the single-device
    reconstruction's mesh under tests/test_parallel.py:242-245's gates
    (vertex count within 1%, sampled vertices within 0.05)."""
    ranks = worlds[n]
    v, f = ranks[0][f"{route}_mesh_v"], ranks[0][f"{route}_mesh_f"]
    assert len(v) > 1000 and np.isfinite(v).all()
    for a in ranks[1:]:
        np.testing.assert_array_equal(a[f"{route}_mesh_v"], v)
        np.testing.assert_array_equal(a[f"{route}_mesh_f"], f)
    dv, df = ranks[0][f"{route}_dense_v"], ranks[0][f"{route}_dense_f"]
    assert (len(v), len(f)) == (len(dv), len(df))
    assert cKDTree(dv).query(v)[0].max() < 1e-5
    assert cKDTree(v).query(dv)[0].max() < 1e-5
    rv = refs[f"{route}_mesh_v"]
    assert abs(len(v) - len(rv)) <= 0.01 * len(rv)
    assert cKDTree(rv).query(v[::max(len(v) // 512, 1)])[0].max() < 0.05


@pytest.mark.parametrize("n", C.WORLDS)
def test_udf_trim_on_merged_mesh(worlds, n):
    """The splat scene with the UDF mask head: the merged sharded mesh is
    trimmed as the dense mesher trims the same field (the JAX package's
    sharded mesher ignores the mask): the same faces before the trim and
    dropped by it, and a trim that drops some."""
    a = worlds[n][0]
    faces, dropped = a["splat_trim"]
    np.testing.assert_array_equal(a["splat_trim"], a["splat_dense_trim"])
    assert 0 < dropped < faces
    assert len(a["splat_mesh_f"]) == faces - dropped


@pytest.mark.parametrize("n", C.WORLDS)
def test_mesher_on_jax_coefficients(worlds, jax_ref, n):
    """The port's sharded mesher fed the JAX package's slab coefficients
    and basis features of the mesh scene: JAX's
    ``extract_dual_mesh_sharded`` vertex for vertex (1e-5) and face for
    face."""
    for a in worlds[n]:
        want_v = jax_ref[f"mesh_n{n}_v"]
        assert a["jax_mesh_v"].shape == want_v.shape
        np.testing.assert_allclose(a["jax_mesh_v"], want_v, atol=1e-5)
        np.testing.assert_array_equal(a["jax_mesh_f"],
                                      jax_ref[f"mesh_n{n}_f_mesh"])


@pytest.mark.parametrize("n", C.WORLDS)
def test_sharded_chunks_bit_equal_serial(worlds, refs, jax_ref, n):
    """``chunk_size=`` with ``mesh=``: chunk i solved on rank i % n and
    broadcast; every rank's chunks bit-equal to the serial chunked
    field's, and so its blend at the probes (the JAX package's sharded
    chunks differ from its serial ones by a solve tolerance: a common
    forced lattice spec)."""
    for a in worlds[n]:
        assert a["chunks_n"] == 4
        np.testing.assert_array_equal(a["chunks_alpha"], refs["chunks_alpha"])
        np.testing.assert_array_equal(a["chunks_f"], refs["chunks_f"])
    jax_gap = np.abs(jax_ref[f"chunks_n{n}_f"] - jax_ref["chunks_serial_f"])
    assert np.isfinite(jax_gap).all()


def test_dual_with_mesh_raises(worlds):
    """The sharded solve is the primal's: ``solver_formulation="dual"``
    with ``mesh=`` raises ValueError naming it, with and without
    chunks (the JAX package runs the primal silently)."""
    for a in worlds[2]:
        np.testing.assert_array_equal(a["dual_raised"], [1, 1])


def test_example_writes_ply(worlds):
    """``examples/recons_sharded.py`` at world 2 (gloo, a file
    rendezvous): rank 0 writes the mesh."""
    from nksr_tpu_torch.data.io import read_ply_full
    verts, faces, _, _ = read_ply_full(str(worlds["example"] / "terrain.ply"))
    assert len(faces) > 100 and np.isfinite(verts).all()
