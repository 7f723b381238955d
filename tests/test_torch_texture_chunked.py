"""Coloured meshes of the in-graph mesher and of the chunked meshes
against the JAX package on the CPU (``tests/test_torch_texture.py``'s
checks, split off to keep each file's run short): ``dual_mc.py`` on
``structure="predicted_ingraph"`` from runs/synth_r3c/best.ckpt, the
union mesh of splat chunks (it takes the first chunk's texture field,
None when that chunk has none, as the JAX package does) and per-chunk
meshing of in-graph chunks (each chunk's colours over the vertices it
keeps).  ``v`` and ``f`` equal the uncoloured mesh's bit for bit, the
colours the JAX ``PCNNField``'s at the mesh's own vertices bit for
bit."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from nksr_tpu_torch import Reconstructor
from nksr_tpu_torch.models import pipeline as P
from nksr_tpu_torch.train import driver
from nksr_tpu_torch.utils.checkpoint import load_tree, model_params
from nksr_tpu_torch.utils.config import load_config

from test_field import sphere_points
from test_torch_dense_unet import random_params
from test_torch_texture import KW, VS, _check_coloured, _mesh_both, _texture

torch.set_num_threads(1)

RUN = Path(__file__).resolve().parents[1] / "runs" / "synth_r3c"


@pytest.fixture(scope="module")
def ingraph_recon():
    cfg = driver.pipeline_config_from_yaml(load_config(RUN / "config.yaml"))
    return Reconstructor(device="cpu", config=cfg, params={
        "params": model_params(load_tree(RUN / "best.ckpt"))})


def test_ingraph_mesher_colours(ingraph_recon):
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    field = ingraph_recon.reconstruct(
        xyz, nrm, structure="predicted_ingraph", **KW)
    plain, coloured, jcol = _mesh_both(field, xyz)
    _check_coloured(plain, coloured, jcol)


def test_union_mesh_takes_the_first_chunks_texture():
    """Splat chunks meshed as one: a texture on every chunk colours the
    mesh; one on the second chunk alone does not (the first chunk's,
    None, is the union's, as in the JAX package)."""
    rng = np.random.default_rng(24)
    xyz = np.zeros((2000, 3), np.float32)
    xyz[:, :2] = rng.uniform(0, 1.6, (2000, 2))
    xyz[:, 2] = 0.1 * np.sin(3 * xyz[:, 0])
    nrm = np.tile(np.float32([0, 0, 1]), (2000, 1))
    cfg = P.PipelineConfig(tree_depth=2, f_maps=8, basis_dim=8, udf_dim=8,
                           voxel_size=VS, normal_weight=1e6,
                           structure_mode="splat", solver_max_iters=16,
                           solver_tol=1e-4)
    rec = Reconstructor(device="cpu", config=cfg,
                        params=random_params(cfg, 0))
    cf = rec.reconstruct(xyz, nrm, chunk_size=0.8)
    assert len(cf.chunks) == 4 and len(cf._host_chunks()) == 4
    plain = cf.extract_dual_mesh(mise_iter=1)
    jcol, tex = _texture(xyz)
    cf.chunks[1]["field"].set_texture_field(tex)
    assert cf.extract_dual_mesh(mise_iter=1).c is None
    for ch in cf.chunks:
        ch["field"].set_texture_field(tex)
    _check_coloured(plain, cf.extract_dual_mesh(mise_iter=1), jcol)


def test_per_chunk_meshes_append_colours(ingraph_recon):
    """In-graph chunks meshed one by one: each chunk's colours over the
    vertices it keeps, welded with them; a texture on some chunks only
    is refused."""
    xyz, nrm = sphere_points(1200, r=0.5, seed=3)
    rec = ingraph_recon
    cfg = rec.config
    rec.config = dataclasses.replace(cfg, voxel_size=VS,
                                     structure_mode="predicted_ingraph")
    try:
        cf = rec.reconstruct(xyz, nrm, chunk_size=0.6, solver_tol=1e-4,
                             solver_max_iters=16)
    finally:
        rec.config = cfg
    assert len(cf.chunks) >= 2 and not cf._host_chunks()
    plain = cf.extract_dual_mesh(mise_iter=1)
    jcol, tex = _texture(xyz)
    cf.chunks[0]["field"].set_texture_field(tex)
    with pytest.raises(ValueError, match="some chunks"):
        cf.extract_dual_mesh(mise_iter=1)
    for ch in cf.chunks:
        ch["field"].set_texture_field(tex)
    _check_coloured(plain, cf.extract_dual_mesh(mise_iter=1), jcol)
