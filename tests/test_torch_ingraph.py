"""The port's in-graph route, ``Reconstructor(structure=
"predicted_ingraph")`` (the inference forward ``models/pipeline.infer``
at capacities estimated from a subsample, meshed by
``meshing/dual_mc.py``), and per-chunk meshing of its chunks, against
the JAX package's on the CPU.

From runs/synth_r3c/best.ckpt under its config.yaml (f_maps 16, tree
depth 3, UDF off) at voxel 0.1, on a 1,200-point sphere, solved to tol
1e-5 (at 16 or 40 iterations the solve does not converge and the field
follows the summation order; at 1e-5 both packages stop near 1,700
iterations).  Gates: the capacities equal the JAX package's estimate,
the decoder hierarchy equal voxel for voxel, the mesh counts within
0.5%, and the symmetric chamfer between the two meshes under 1e-2 voxel
(measured on this CPU: the counts equal, faces equal, chamfer 3.2e-6,
3.2e-5 voxel).  Per-chunk meshing: the port's ``ChunkedField`` on
chunks that return the JAX package's mesh equals the JAX package's
``_extract_per_chunk`` array for array, and on the port's own field is
within the same gates of it."""

import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from bench import synthetic_scene
from nksr_tpu import Reconstructor as JReconstructor
from nksr_tpu.meshing import dual_mc as JDMC
from nksr_tpu.models import pipeline as JP
from nksr_tpu.recon import chunking as JCH
from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.recon import chunking as CH
from nksr_tpu_torch.recon.reconstructor import estimate_capacities
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.utils.checkpoint import load_tree, model_params
from nksr_tpu_torch.utils.config import load_config

from test_field import sphere_points

RUN = Path(__file__).resolve().parents[1] / "runs" / "synth_r3c"
VS = 0.1
KW = dict(detail_level=None, voxel_size=VS, structure="predicted_ingraph",
          solver_tol=1e-5, solver_max_iters=4000)


def _configs():
    cfg = driver.pipeline_config_from_yaml(load_config(RUN / "config.yaml"))
    jcfg = JP.PipelineConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(JP.PipelineConfig)})
    return cfg, jcfg


def jax_mesh(field, **kw):
    """The JAX package's mesher jitted whole, trimmed on the host."""
    return jax.jit(functools.partial(JDMC.extract_dual_mesh, trim=False,
                                     **kw))(field).trim()


def chamfer(a, b) -> float:
    a, b = a.v[np.unique(a.f)], b.v[np.unique(b.f)]
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


@pytest.fixture(scope="module")
def ingraph():
    cfg, jcfg = _configs()
    params = {"params": model_params(load_tree(RUN / "best.ckpt"))}
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    jf = JReconstructor(config=jcfg, params=jax.tree_util.tree_map(
        jnp.asarray, params)).reconstruct(xyz, nrm, **KW)
    jmesh = jax_mesh(jf, mise_iter=1)
    rec = Reconstructor(device="cpu", config=cfg, params=params)
    field = rec.reconstruct(xyz, nrm, **KW)
    return dict(jf=jf, jmesh=jmesh, field=field, rec=rec,
                mesh=field.extract_dual_mesh(mise_iter=1))


@pytest.mark.parametrize("n,half_extent", [(1200, 1.0), (250_000, 10.0),
                                           (1_000_000, 20.0)])
def test_capacity_estimate_matches_jax(n, half_extent):
    """The estimate of the JAX route's ``_runtime_config`` (every
    ceil(n/1e5)-th point; 1 and 10 here past 1e5)."""
    _, jcfg = _configs()
    xyz, _ = synthetic_scene(n, seed=1, half_extent=half_extent)
    # the method reads only self.config: no network to initialise
    ref = JReconstructor._runtime_config(
        SimpleNamespace(config=jcfg), n, xyz, VS, False, 1e-5, None,
        "normal").capacities
    assert estimate_capacities(xyz, VS, jcfg.tree_depth) == tuple(ref)


def test_ingraph_hierarchy_matches_jax(ingraph):
    jf, field = ingraph["jf"], ingraph["field"]
    assert field.capacities == tuple(g.capacity for g in jf.svh.grids)
    for d, g in enumerate(field.host_grids):
        jg = jf.svh.grids[d]
        np.testing.assert_array_equal(
            g.coords, np.asarray(jg.coords)[:int(jg.num_voxels)])
    assert field.mask_field is None          # UDF off: the support mask
    assert ingraph["rec"]._last_unet_engine == "sparse"
    assert field.cg_stats[1] <= 1e-5
    assert "infer: solve" in field.phase_times


def test_ingraph_mesh_matches_jax(ingraph):
    got, ref = ingraph["mesh"], ingraph["jmesh"]
    assert len(ref.f) > 500
    for a, b in ((len(got.v), len(ref.v)), (len(got.f), len(ref.f))):
        assert abs(a - b) <= 0.005 * b
    assert chamfer(got, ref) < 1e-2 * VS


class _MeshField:
    """A chunk field whose mesh is given."""

    def __init__(self, mesh):
        self.mesh = mesh

    def extract_dual_mesh(self, **kw):
        return self.mesh

    def to(self, device):
        return self


def _chunks(fields):
    """Two 0.5-unit chunk cells split at x = 0 over the sphere."""
    return [{"cid": np.array([i, 0, 0]), "field": f}
            for i, f in enumerate(fields)]


def test_per_chunk_mesh_matches_jax(ingraph, monkeypatch):
    origin, lo, hi = np.array([-0.5, -0.6, -0.6]), np.zeros(3, np.int64), \
        np.array([1, 0, 0])
    jmesh = ingraph["jmesh"]
    jcf = JCH.ChunkedField(_chunks([_MeshField(jmesh)] * 2), 0.5, VS,
                           origin=origin, id_lo=lo, id_hi=hi)
    monkeypatch.setattr(JCH.jax, "device_put", lambda x, *a: x)
    ref = jcf.extract_dual_mesh(mise_iter=1)
    monkeypatch.undo()
    cf = CH.ChunkedField(_chunks([_MeshField(jmesh)] * 2), 0.5, VS,
                         origin=origin, id_lo=lo, id_hi=hi)
    got = cf.extract_dual_mesh(mise_iter=1)
    for a, b in ((got.v, ref.v), (got.f, ref.f)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # welded back into one closed sphere
    assert len(ref.f) == len(jmesh.f)
    cf = CH.ChunkedField(_chunks([ingraph["field"]] * 2), 0.5, VS,
                         origin=origin, id_lo=lo, id_hi=hi, device="cpu")
    own = cf.extract_dual_mesh(mise_iter=1)
    assert abs(len(own.f) - len(ref.f)) <= 0.005 * len(ref.f)
    assert chamfer(own, ref) < 1e-2 * VS
    assert "mc: weld" in cf.phase_times
    # the chunked field's value is each point's owning chunk's
    x = np.array([[-0.2, 0, 0], [0.2, 0, 0.3]], np.float32)
    np.testing.assert_array_equal(
        cf.evaluate_f_bar(x),
        ingraph["field"].evaluate_f_bar(x).numpy())


def test_chunked_ingraph_route_runs(ingraph):
    """reconstruct(chunk_size=...) under structure_mode
    "predicted_ingraph": every chunk an in-graph field, meshed one by
    one and welded."""
    cfg, _ = _configs()
    rec = Reconstructor(device="cpu", config=dataclasses.replace(
        cfg, structure_mode="predicted_ingraph", voxel_size=VS),
        params={"params": model_params(load_tree(RUN / "best.ckpt"))})
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    cf = rec.reconstruct(xyz, nrm, chunk_size=0.6, solver_tol=1e-4)
    assert len(cf.chunks) >= 2 and not cf._host_chunks()
    mesh = cf.extract_dual_mesh(mise_iter=1)
    assert len(mesh.f) > 0.9 * len(ingraph["mesh"].f)
    assert chamfer(mesh, ingraph["mesh"]) < 0.5 * VS


def test_infer_splat_mode_teacher_forces_on_the_encoder(ingraph):
    """``structure_mode="splat"`` with no GT: the decoder is the encoder's
    splat hierarchy, cut at the capacities (the JAX forward's
    ``gt_svh = enc_svh``), and its field meshes."""
    from nksr_tpu_torch.core import svh as SVH
    from nksr_tpu_torch.models import pipeline as P
    rec = ingraph["rec"]
    cfg = dataclasses.replace(rec.config, voxel_size=VS,
                              structure_mode="splat",
                              capacities=(512, 256, 128))
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    out = P.infer(cfg, rec.network, xyz, torch.from_numpy(nrm))
    enc, _ = SVH.build_point_splatting(xyz, VS, cfg.tree_depth,
                                       cfg.capacities)
    assert len(enc[0].keys) == 512           # the cut bites at depth 0
    for g, e in zip(out.dec_grids, enc):
        np.testing.assert_array_equal(g.keys, e.keys)
    assert out.structure_status == () and out.field.alpha is not None
    assert len(out.field.extract_dual_mesh().f) > 0
