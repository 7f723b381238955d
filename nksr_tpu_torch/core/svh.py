"""Host-built hierarchies of the training forward (counterpart of
nksr_tpu/core/svh.py ``SparseFeatureHierarchy.build_point_splatting``,
``build_adaptive_normal_variation`` and ``evaluate_voxel_status``).

The JAX package builds them on the device at static capacities: each
level is the sorted set of its voxel keys, and a level with more voxels
than its capacity keeps the first ``capacity`` keys in (i, j, k) order
and drops the rest (``core/coords.unique_coords``).  Here they are
numpy ``HostGrid``s (``core/host_build.py``), cut the same way: the
packed keys sort in the same (i, j, k) order, so a full level keeps the
same voxels.  A finer adaptive level is refined from its parent as the
parent was cut, as on the device.

Also the decoder's structure, one level at a time
(``decoder_step``): the JAX ``SparseUNet`` starts from the encoder's
coarsest grid and, level by level, prunes the candidates whose status
is empty and keeps the children of those it refines.  With
``use_gt_structure=True`` the statuses are the GT hierarchy's, which
depend on the data only, so ``teacher_hierarchy`` builds every level
with every table its decoder reads before the forward; with
``use_gt_structure=False`` they are the argmax of the network's
structure logits, read back level by level inside the forward
(``models/sparse_unet.predicted_unet``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import host_build as HB

VOXEL_EMPTY, VOXEL_LEAF, VOXEL_REFINED = 0, 1, 2


def truncate(grid: HB.HostGrid, cap: int) -> HB.HostGrid:
    """The first ``cap`` voxels of a sorted grid (a full level's cut)."""
    if len(grid.keys) <= cap:
        return grid
    return HB.HostGrid(coords=grid.coords[:cap], keys=grid.keys[:cap],
                       voxel_size=grid.voxel_size)


def build_point_splatting(xyz: np.ndarray, voxel_size: float, depth: int,
                          capacities: Sequence[int]):
    """Per level the 8 voxels around every point, cut at the level's
    capacity.  Returns (grids, orders): ``orders`` the per-level sorted
    point keys of ``HB.build_splat_grids_ex`` (support joins reuse
    them)."""
    grids, orders = HB.build_splat_grids_ex(
        np.asarray(xyz, np.float32), voxel_size, depth)
    return [truncate(g, c) for g, c in zip(grids, capacities)], orders


def build_adaptive_normal_variation(xyz: np.ndarray, normal: np.ndarray,
                                    voxel_size: float, depth: int,
                                    capacities: Sequence[int],
                                    tau: float = 0.1,
                                    adaptive_depth: int = 1
                                    ) -> List[HB.HostGrid]:
    """Levels >= adaptive_depth - 1 are splat levels; a finer level keeps
    a splat corner where its (cut) parent's normal variation exceeds
    ``tau``; every level cut at its capacity."""
    xyz = np.asarray(xyz, np.float32)
    splat, orders = build_point_splatting(xyz, voxel_size, depth,
                                          capacities)
    grids = HB.build_adaptive_grids(
        xyz, np.asarray(normal, np.float32), voxel_size, depth, tau=tau,
        adaptive_depth=adaptive_depth, splat=(splat, orders))
    return [truncate(g, c) for g, c in zip(grids, capacities)]


def evaluate_voxel_status(grids: Sequence[HB.HostGrid], coords: np.ndarray,
                          depth: int) -> np.ndarray:
    """GT structure class (empty, leaf, refined) of (n, 3) voxel coords
    at ``depth``: present in the level, and (above depth 0) with a child
    present one level finer."""
    coords = np.asarray(coords, np.int64).reshape(-1, 3)
    exists = HB.lookup(grids[depth], coords) >= 0
    if depth == 0:
        return np.where(exists, VOXEL_LEAF, VOXEL_EMPTY).astype(np.int64)
    child = 2 * coords[:, None, :] + HB._OFFS2[None]
    has_child = (HB.lookup(grids[depth - 1], child.reshape(-1, 3))
                 .reshape(-1, 8) >= 0).any(1)
    return np.where(exists, np.where(has_child, VOXEL_REFINED, VOXEL_LEAF),
                    VOXEL_EMPTY).astype(np.int64)


class LevelStep(NamedTuple):
    """The host step between two decoder levels (numpy): ``dec`` the
    decoder grid (the candidates whose status is not empty) and
    ``dec_rows`` their candidate rows; toward level d-1 (None at depth
    0): ``nxt`` the next candidate grid (the children of the refined
    candidates, sorted and cut at the next capacity), ``nbr`` (n_nxt, 27)
    its stencil rows, ``parent`` and ``octant`` of each of its voxels in
    this level, ``skip`` its encoder row at level d-1 (-1 absent)."""
    dec: HB.HostGrid
    dec_rows: np.ndarray
    nxt: Optional[HB.HostGrid]
    nbr: Optional[np.ndarray]
    parent: Optional[np.ndarray]
    octant: Optional[np.ndarray]
    skip: Optional[np.ndarray]


def stencil_rows(grid: HB.HostGrid, stencil: np.ndarray) -> np.ndarray:
    """(n, K) stencil rows of a grid's n voxels, int64."""
    n = len(grid.keys)
    return HB.nbr_table(grid, max(n, 1), stencil)[:n].astype(np.int64)


def decoder_step(cand: HB.HostGrid, status: np.ndarray,
                 enc_next: Optional[HB.HostGrid], cap_next: int,
                 stencil: np.ndarray) -> LevelStep:
    """One level of the decoder's structure (nksr_tpu/models/network.py
    SparseUNet, either mode): prune the candidates ``cand`` to those whose
    ``status`` (one class a row, GT or predicted) is not empty; expand the
    refined ones to their children, sorted and cut at ``cap_next`` (the
    first keys in (i, j, k) order, as ``SparseGrid.from_coords`` keeps),
    with their stencil, parent, octant and skip rows into ``enc_next``,
    the cut encoder grid of the next level (None at depth 0)."""
    status = np.asarray(status)
    keep = status > VOXEL_EMPTY
    dec = HB.prune(cand, keep)
    dec_rows = np.nonzero(keep)[0].astype(np.int64)
    if enc_next is None:
        return LevelStep(dec, dec_rows, None, None, None, None, None)
    refined = np.nonzero(status == VOXEL_REFINED)[0]
    nxt, parent, octant = HB.children_of(cand, refined)
    nxt = truncate(nxt, cap_next)
    return LevelStep(
        dec, dec_rows, nxt, stencil_rows(nxt, stencil),
        parent[:cap_next].astype(np.int64),
        octant[:cap_next].astype(np.int64),
        HB.lookup(enc_next, nxt.coords).astype(np.int64))


class TeacherLevel(NamedTuple):
    """One decoder level of the teacher-forced UNet (numpy).

    ``cand`` the candidate grid (the decoder block runs on its rows);
    ``nbr`` (n_cand, 27) its stencil rows; ``status`` (n_cand,) the GT
    class of each candidate (the structure loss's target); ``dec_rows``
    (n_gt,) the candidate row of each GT voxel of the level, -1 absent
    (the heads read those rows).  Toward level d-1 (None at depth 0):
    ``parent`` and ``octant`` of each candidate of level d-1 in this
    level, ``skip`` its encoder row at level d-1 (-1 absent)."""
    cand: HB.HostGrid
    nbr: np.ndarray
    status: np.ndarray
    dec_rows: np.ndarray
    parent: np.ndarray
    octant: np.ndarray
    skip: np.ndarray


def teacher_hierarchy(enc: Sequence[HB.HostGrid],
                      gt: Sequence[HB.HostGrid],
                      capacities: Sequence[int],
                      stencil: np.ndarray) -> Tuple[TeacherLevel, ...]:
    """The candidate grids and tables of the teacher-forced decoder, level
    by level from the coarsest (nksr_tpu/models/network.py SparseUNet,
    ``use_gt_structure=True`` with an in-graph GT hierarchy): the
    coarsest candidates are the encoder's grid; each level's
    ``decoder_step`` runs on the GT statuses of its candidates.  The
    heads read the GT grid's voxels.  Returned finest first."""
    depth = len(enc)
    levels: List[TeacherLevel] = [None] * depth
    cand = enc[depth - 1]
    nbr = stencil_rows(cand, stencil)
    for d in range(depth - 1, -1, -1):
        status = evaluate_voxel_status(gt, cand.coords, d)
        step = decoder_step(cand, status, enc[d - 1] if d else None,
                            capacities[d - 1] if d else 0, stencil)
        dec_rows = HB.lookup(cand, gt[d].coords).astype(np.int64)
        levels[d] = TeacherLevel(cand, nbr, status, dec_rows, step.parent,
                                 step.octant, step.skip)
        cand, nbr = step.nxt, step.nbr
    return tuple(levels)
