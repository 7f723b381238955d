#!/usr/bin/env python3
"""Smoke run of nksr_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every kernel of nksr_tpu_torch/csrc with nvcc for sm_90a (one
     nvcc per source, all at once), then run the kernel probes
     (``python -m nksr_tpu_torch.scripts.probe_kernels``: 17 probe
     kernels and the cascade kernels at the TPU bisect's specs, each on
     its script's input and a random one) and hold each probe kernel
     against its plain version, both timed as device time in a CUDA graph;
     and the launch floor, an empty kernel timed in a CUDA graph and by
     CUDA events over back-to-back launches (``floor_ms`` of each record
     in the kernels line, by the way that kernel is timed);
  2. hold each cascade, slot-row and window kernel against its plain
     PyTorch version on the card, at small sizes (the bisect's depth-2
     spec and the test's depth-3 spec) and at the size its route gives
     it, and time both; the dense forward also equal to the slot rows of
     every cell, and timed beside the write ceiling (a plain
     ``empty_like(out).zero_()`` of its bytes, a yardstick the port never
     calls); the adjoint in its three input forms (an f32
     buffer read in bf16, as the solve calls it and as it is timed; a
     bf16 buffer; an f32 buffer read in f32), each also bit-equal from
     call to call; the slot rows bit-equal to their plain version in f32
     and bf16, at the main path on the plan's real slot cells and the
     coefficients of its first matvec (both captured in the warm-up
     lap), and timed in turns against the chain they replace (the dense
     bf16 forward, the two row gathers and their casts to f32); the
     fixed-order segment sum bit-equal to its plain version (CPU
     index_add_) at small shapes with heavy duplication and at the
     encoder splat's rows (captured in the warm-up lap), timed beside
     zeros + index_add_; the slot-row adjoint at small specs and at the
     plan's real slot cells (random f32 slot rows), in bf16 and f32,
     equal to the dense adjoint kernel on the buffer CPU index_add_
     builds (up to the sign of a zero) and bit-equal from call to call,
     timed in turns against the chain it replaces (zeros, two
     index_add_ and the dense adjoint), with its two kernels' device
     time under torch.profiler;
  3. the splat path on the dense lattice at the bench's size: the
     scene_big checkpoint, utils.scenes.synthetic_scene(1_000_000),
     reconstruct(structure="splat", voxel_size=0.1, solver_tol=1e-4,
     solver_max_iters=16) and extract_dual_mesh(mise_iter=1); one
     warm-up lap and two timed laps, the kernels' launch counts (one
     slot-row launch a matvec, one slot-row adjoint a matvec plus the
     rhs and the Jacobi diagonal, no dense adjoint, the dense forward
     once, for the evaluator tables, the segment sum at the two splats
     only), the two laps' coefficients and
     meshes bit-equal (a gate), and the terrain vertex error against the
     analytic height field, of the whole tile and of its four 20 m
     quadrants reconstructed alone (the JAX reference's configuration);
     then one more lap in which
     torch.profiler records one lattice-solve matvec (the ten device ops
     by device time and the matvec's device total), and one in which it
     records the whole lattice solve (host and device ms of each of its
     ``lattice_solve: ...`` ranges);
  4. route B, the sparse fallback: the same call on a 100 m x 100 m tile
     of 1M points, whose lattice plan is over budget (gather-conv UNet,
     support-row solve with the window kernel, host dual MC);
  5. route A: a 60 m x 60 m tile of 1M points, whose feature lattices are
     over the dense UNet's budget (gather-conv UNet, lattice solve with
     the cascade kernels, host dual MC over the lattice evaluator);
  6. the row-stage scatter microbenchmark at its study's shapes
     (``python -m nksr_tpu_torch.scripts.microbench_scatter``: S = 2^19
     rows into C0 = 5,326,848 cells at 32 and 128 lanes), which holds the
     three sorted-scatter kernels against their plain versions (the rate
     write bit for bit against CPU index_add_, both rate kernels
     bit-equal from call to call) and times them beside PyTorch's
     index_add_, index_copy_, index_select and embedding_bag; the rate
     kernels at the study's shape (16,384 rows into 8,192 cells) and at
     the row stage's (2^19 rows into 2^18 cells), as device time in one
     CUDA graph and by CUDA events.
  7. (run after phase 5) the predicted structure, the default route, on
     the same scene and weights: reconstruct(xyz, nrm) with no structure
     argument and extract_dual_mesh(mise_iter=1), a warm-up lap and two
     timed laps on the per-level engine (the JAX package's engine at
     this size), the lattice solve and the dense mesher; the two laps
     bit-equal, their launches those of a lattice lap, the terrain error
     under 1.5x the JAX package's predicted error on the quadrants
     (scripts/terrain_reference_predicted.py); the four 20 m quadrants
     alone on the one-pass dense engine under the same gate; then one
     adaptive lap (adaptive depth 2) on the dense lattice route, its
     decoder smaller than the splat hierarchy at depth 0, under the
     splat gate, and its quadrants alone under 1.5x the JAX package's
     adaptive error there.  The kernels line gains each lattice kernel's
     launches on the predicted lap (``launches_predicted``).
  8. (run after phase 7) the checkpoint under its own configuration, UDF
     mask head on: runs/scene_big/config.yaml through the port's
     load_config and pipeline_config_from_yaml, with bf16 convs, as
     bench.py's predicted row runs the JAX package.  The predicted
     structure on the 40 m tile (a warm-up lap and two timed laps on the
     per-level engine; bit-equal, the lattice launches, the dense mesher
     trimming, the trim's time and the faces it dropped printed) and its
     four 20 m quadrants on the one-pass dense engine, each under 1.5x
     the JAX package's UDF-on predicted error on the quadrants; one splat
     lap on the dense lattice and its quadrants under 1.5x the JAX
     package's UDF-on splat error (both from
     scripts/terrain_reference_udf.py); one lap of route A (the 60 m
     tile), whose host mesher seals at the mask, its "mc: ..." stages
     beside phase 5's, and its four central 20 m sub-tiles alone on route
     A, both under 1.5x the JAX package's sealed error on those sub-tiles
     (the same script's --route-a; the seal's second sheet puts it 8x
     over the UDF-off routes' gate).  The kernels line gains
     each lattice kernel's launches on the UDF predicted lap
     (``launches_udf``).
  9. (run after phase 8) the README's lidar recipe under the same
     configuration: the 40 m tile without its normals, a sensor at
     (0, 0, 10) for every point, reconstruct(xyz, sensor=sensor,
     chunk_size=..., preprocess_fn=get_estimate_normal_preprocess_fn(64,
     85.0)) and extract_dual_mesh(mise_iter=1).  The normal estimation
     on the card (kept share, angle to the analytic normals, time by
     stage; the kNN's neighbour sets at 4,096 seeded queries equal to
     its run on CPU tensors); the four 20 m quadrants alone with
     chunk_size=10.0 under 1.5x the JAX package's error for the same
     recipe there (scripts/terrain_reference_chunked.py), one of them
     twice bit-equal; the whole tile with chunk_size=20.0 in four chunks
     under the same gate, each chunk parked on the CPU after its solve
     and back on the card for the mesh (the host mesher, sealed at each
     chunk's UDF mask), the dense forward launched once per chunk there.
     The kernels line gains each lattice kernel's launches on the whole
     tile's lap (``launches_chunked``).
 10. (run after phase 9) the dual (row-space) formulation,
     solver_formulation="dual": (a) its middle C C^T at the 40 m plan's
     slot cells on random f32 slot rows, the slot-row adjoint in f32 then
     the slot rows in bf16, within one bf16 ulp of the literal middle of
     the JAX package's ``_gram_middle`` (segment sum into the dense
     buffer, dense adjoint in f32, dense forward in bf16, row gather) and
     bit-equal from call to call, both timed in turns; (b) phase 3's
     splat tile with the dual at tol 1e-4 and at most 64 iterations, a
     warm-up lap and two timed laps bit-equal, the launches of a dual
     lap (the slot rows once a matvec, the slot-row adjoint once a
     matvec and once for the back-substitution), the terrain error of
     the tile and of its quadrants alone under 1.5x the JAX package's
     dual error there (scripts/terrain_reference_dual.py), one dual
     matvec under torch.profiler; (c) tests/test_torch_dual.py's sphere
     solved to tol 1e-4 with f32 rows, converged, its field at the probes
     within 5e-3 of the same call on CPU tensors, and its bf16 run
     beside it; (d) one predicted lap with the dual; (e) the primal
     against the dual at equal budgets
     (``nksr_tpu_torch.scripts.compare_formulations``).  The kernels line
     gains each lattice kernel's launches on the dual splat and
     predicted laps (``launches_dual``, ``launches_dual_predicted``) and
     the middle's times.
 11. (run after phase 10) training, teacher-forced and on the predicted
     structure, at the full width of
     runs/scene_big/config.yaml (UDF head on, f32 convs), on item 0 of
     scripts/make_synth_scenes.py's corpus (5 m terrain patches, 8,000
     input points of 30,000), written under the checkout's data/: (a) the
     training step's two backwards at its shapes on the card, bit-equal
     to their plain versions on CPU copies and call to call, timed: the
     gather's (the fixed-order segment sum over the order sorted once per
     index table, at the depth-0 conv gather) and the segment sum's (a
     row gather, at the encoder splat); (b) solve_spd's gradients on the card
     against its CPU run on an f64 system, and one step on
     tests/test_train.py's sphere with the solve converged, card against
     CPU; (c) one step from runs/scene_big/best.ckpt on the item, card
     against the same step on CPU tensors with one set of draws: at the
     run's 16 iterations the UNet's outputs and the structure losses
     gated, every loss term and gradient leaf printed; with the solve to
     convergence every loss term, every gradient leaf and the whole
     gradient gated (iterations printed); then three steps with the
     optimizer: seconds a warm step by phase, peak memory, the launches
     of one step (the segment sum and the window kernel must run), the
     gathers' backwards and their sorts in a step, and the window kernel
     against its plain version on every input the first of those steps
     gave it, timed; (d) 30 overfit steps from the
     port's seeded init, the last 3 sums under 0.85x the first 3; (e) two
     runs of 5 steps from one state, parameters and losses bit-equal;
     (f) ``train.driver.fit`` for 4 steps with one validation from the
     checkpoint, its best.ckpt through ``Reconstructor`` on the item,
     the mesh's vertices within FIT_MESH_LIMIT of the GT cloud on
     average; (g) the predicted structure (``use_gt_structure=False``)
     from the same checkpoint on the item: one step at the run's 16
     iterations, card against the same step on CPU tensors with one set
     of draws (taken from the predicted decoder hierarchy), the
     candidate and decoder hierarchies gated voxel for voxel (a status
     that differs only where its top-2 margin is under TRAIN_TIE_FRAC of
     the level's largest |logit| is a tie, reported, not a fault) with
     each level's smallest margin printed, the UNet's outputs and the
     structure losses gated as in (c), every loss term and leaf printed;
     three predicted steps with the optimizer (seconds a warm step by
     phase, the status readbacks and host tables among them, peak
     memory, launches: the segment sum and the window kernel must run);
     two runs of 5 predicted steps from one state, parameters and
     losses bit-equal; ``fit`` for 5 steps with the schedule from step 0
     to 1, whose steps 1-4 draw the predicted structure (step 0's
     probability is 0).  The CPU side of (b), (c) and (g) runs in a
     second process
     (``--train-cpu-reference``) on the host's last TRAIN_REF_THREADS
     cores, started after phase 1 so that its minutes overlap phases
     2-10; once it has ended, phase 3's splat lap and phase 7's
     predicted lap run again, and their host times are printed beside
     those taken while it ran.  The kernels line gains each kernel's
     launches in one training step (``launches_train``) and in one
     predicted step (``launches_train_predicted``), the backwards' times
     and the window kernel's at the step's inputs.
 12. (run after phase 11) the in-graph route, structure=
     "predicted_ingraph" (capacities estimated from a subsample as the
     JAX package estimates them, the inference forward models/pipeline.
     infer, the support-row solve, the in-graph mesher meshing/dual_mc.py
     with mise_iter Newton steps) under runs/scene_big/config.yaml (UDF
     head on, f32 convs): (a) the 5 held-out scenes of a 40-patch
     scripts/make_synth_scenes.py corpus (written under the checkout's
     data/), two laps each bit-equal in coefficients and mesh, the
     predicted hierarchy equal to the inference forward's on CPU tensors
     voxel for voxel (a tie as in phase 11 (g) reported), MeshEvaluator
     at 5e6 samples, each scene's chamfer-L1 under 1.1x the JAX
     package's in-graph figure (scripts/quality_reference_ingraph.py),
     seconds, vertices, faces, peak memory and launches printed (the
     window kernel and the segment sum must run); (b) the (-x, -y) 20 m
     quadrant of the 1M-point tile alone, under 1.5x the JAX package's
     in-graph terrain error there; (c) the same quadrant with
     chunk_size=10, four in-graph chunks each meshed alone and welded,
     under 1.5x (b)'s error; (d) the predicted, splat and adaptive
     routes on the first scene at 5e6 samples beside QUALITY.md's rows;
     (e) the window kernel against its plain version on the Newton
     step's own inputs, timed.  The kernels line gains each kernel's
     launches on a scene lap (``launches_ingraph``) and the window
     kernel's record at the Newton step (``ingraph_newton``).
 13. (run after phase 12) texture fields and the neural geometry head
     (ROADMAP item 17): (a) phase 3's splat tile with a texture field
     (``PCNNField.build`` over the cloud, colours a fixed function of
     position) through the dense mesher, its v and f bit-equal to an
     uncoloured lap's, c (Nv, 3) and finite, each colour equal to the
     same texture's on CPU tensors but at a distance tie (the count
     printed), the colour evaluation's seconds and the lap's launches
     (a lattice lap's); (b) the (-x, -y) quadrant in four 10 m splat
     chunks, a texture on each, the union lattice's host mesher, the
     same checks; (c) runs/scene_big/config.yaml with geometry: neural
     from best.ckpt (its SDF decoder's last bias offset so that the
     zero set runs through the shell) on the in-graph route over phase
     12's held-out scenes: two laps bit-equal (mesh and field at the
     probes), the hierarchy equal to the inference forward's on CPU
     tensors (a tie reported), the field at seeded probes within 1e-4
     of the CPU run's largest |f|, the mesh from meshing/dual_mc.py, the
     segment sum the one kernel launched; (d) the neural head in
     training on phase 11's item: one step card against CPU under
     phase 11's gates, two runs of three steps from one state
     bit-equal.  The CPU side of (c) and (d) runs in phase 11's CPU
     reference process.  The kernels line gains each kernel's launches
     on the coloured splat lap (``launches_colored``), the coloured
     chunked lap (``launches_colored_chunked``), a neural in-graph lap
     (``launches_neural_ingraph``) and a neural training step
     (``launches_neural_train``).
 14. (run after phase 13) the adaptive structure on the sparse routes
     (ROADMAP item 8b): the scene_big weights in PipelineConfig(
     conv_dtype="bfloat16", adaptive_depth=2, adaptive_tau=
     ADAPTIVE_ROUTE_TAU), reconstruct(structure="adaptive") and
     extract_dual_mesh(mise_iter=1).  (a) phase 5's 60 m tile on route A
     (the gather-conv UNet with its heads at the decoder voxels, the
     lattice solve on the decoder, the host mesher on a hierarchy of
     adaptive depth 2): the route, a depth-0 decoder above 0 and below
     the splat's, the lattice launches with the segment sum at the
     encoder's splat and at each gradient depth's normal prior (1 +
     adaptive depth), the tile's error under ROUTE_ERR_LIMIT, its host-MC
     stages beside phase 5's; its four central 20 m sub-tiles alone on
     route A (the budgets at 0, as phase 8) under 1.5x the JAX package's
     figure there.  (b) phase 4's 100 m tile on route B (the support-row
     solve on the decoder): window and segment-sum launches, the tile's
     error under ROUTE_ERR_LIMIT; its four central 20 m sub-tiles alone,
     forced onto route B by LATTICE_COEFF_BUDGET = 0, under 1.5x the JAX
     package's figure.  (b)'s tile lap runs in its own process (``python3
     chip_smoke.py --route-b-tile OUT``), started after phase 11 on the
     cores phase 11's CPU reference used, beside phases 12 to 14 (a): its
     host mesher is the script's longest stage.  (c) one sub-tile on each
     route twice (its lap among the four and one more): coefficients and
     mesh bit-equal.  (d) on route A's first sub-tile
     with f32 convs, the gather-conv UNet's basis and normal heads on the
     adaptive decoder within ADAPTIVE_CARD_CPU_TOL of the same call on
     CPU tensors.  The kernels line gains each kernel's launches on the
     two tile laps (``launches_adaptive_a``, ``launches_adaptive_b``).
 15. (run after phase 14) the public API (ROADMAP item 1): (a) the
     reference recipe, the scene_big weights as a reference-wheel
     ``ks.pth`` (interpolator and decoder MLPs as ``nn.Sequential``
     layers, the backbone under other names) in a temporary
     ``NKSR_TPU_CKPT_DIR``, ``configs.load_checkpoint_from_url("ks")``,
     then ``Reconstructor().network.load_state_dict`` into a network
     that holds scene_big's backbone with its interpolators and decoders
     scrambled (the import report printed); every tensor then equal to
     the load_tree weights, and the (-x, -y) 20 m quadrant's lap with
     phase 3's settings bit-equal (coefficients and mesh) to the same
     lap under load_tree weights, with phase 3's launch counts; (b)
     ``svh.SparseFeatureHierarchy.build_point_splatting`` and
     ``build_adaptive_normal_variation`` (adaptive depth 2, tau
     ADAPTIVE_ROUTE_TAU) from the quadrant's points as CUDA tensors,
     built on the host and placed on the card, level by level equal to
     the lap's host grids and to the host builder's;
     ``evaluate_voxel_status`` on the card equal to the host's; (c) the JAX package's canonical export of scene_big
     (``utils/checkpoint.params_to_torch_state_dict``) loaded whole into
     a seeded network.  Under API_PHASE_LIMIT_S seconds.  The kernels
     line gains each kernel's launches on (a)'s lap (``launches_api``).
Each path (the probe run, the reconstructions, the microbenchmark) is
driven with every launch count set to 0 just before it and read just
after.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing any
result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from nksr_tpu_torch.utils.profiling import bound_ms, graph_ms  # noqa: E402
N_POINTS = 1_000_000
KW = dict(detail_level=None, voxel_size=0.1, solver_tol=1e-4,
          solver_max_iters=16)
# The JAX package's interior terrain vertex error mean under the
# configuration this script gives the port (PipelineConfig(conv_dtype=
# "bfloat16"), UDF head off, structure "splat", voxel 0.1, 16 CG
# iterations), on this scene's 1M points reconstructed as its four 20 m
# quadrants, vertices 1 m inside each (scripts/terrain_reference.py, on
# the CPU, where a whole-tile run would hold about 25 GiB).
# The splat gate is 1.5x that, for the whole tile and for the quadrants.
JAX_QUADRANT_ERR = 0.003831
ERR_LIMIT = 1.5 * JAX_QUADRANT_ERR
# 1.5x the JAX package's sparse-route error mean at the 100 m tile's
# density (0.00562, 160k points on 40 m x 40 m, measured on the CPU)
ROUTE_ERR_LIMIT = 0.0085
# The JAX package's interior terrain vertex error mean with the predicted
# structure (the default route), under the same configuration, on the
# same four 20 m quadrants (scripts/terrain_reference_predicted.py, on the
# CPU).  The predicted gate is 1.5x that, for the tile and the quadrants.
JAX_PRED_QUADRANT_ERR = 0.003712
PRED_ERR_LIMIT = 1.5 * JAX_PRED_QUADRANT_ERR
# The same with the adaptive structure at adaptive depth 2 (the script's
# --structure adaptive --adaptive-depth 2); the adaptive quadrants' gate
# is 1.5x that, the adaptive tile's the splat gate.
JAX_ADAPTIVE_QUADRANT_ERR = 0.005881
ADAPTIVE_QUADRANT_LIMIT = 1.5 * JAX_ADAPTIVE_QUADRANT_ERR
# The checkpoint's own configuration (runs/scene_big/config.yaml, UDF
# mask head on) with bf16 convs: the JAX package's interior terrain error
# mean on the same four 20 m quadrants with the predicted and the splat
# structure (scripts/terrain_reference_udf.py and its --structure splat,
# on the CPU; the dense mesher trims).  Phase 8's gates are 1.5x these,
# for the tiles and the quadrants.
UDF_CONFIG = os.path.join("runs", "scene_big", "config.yaml")
JAX_UDF_PRED_QUADRANT_ERR = 0.003712
UDF_PRED_ERR_LIMIT = 1.5 * JAX_UDF_PRED_QUADRANT_ERR
JAX_UDF_SPLAT_QUADRANT_ERR = 0.003831
UDF_SPLAT_ERR_LIMIT = 1.5 * JAX_UDF_SPLAT_QUADRANT_ERR
# The same on route A's scene (the 60 m tile): its four central 20 m
# sub-tiles, each alone on route A, whose host mesher seals at the UDF
# mask with a second sheet at the mask's edge (the script's --route-a).
# Under the UDF head the route-A gate is 1.5x that, for the tile and the
# sub-tiles: ROUTE_ERR_LIMIT holds the UDF-off routes, and the JAX
# package's own sealed mesh is 8x over it.
JAX_UDF_ROUTE_A_ERR = 0.069686
UDF_ROUTE_A_ERR_LIMIT = 1.5 * JAX_UDF_ROUTE_A_ERR
# The README's lidar recipe under the same configuration: no normals, a
# sensor at (0, 0, 10) for every point, get_estimate_normal_preprocess_fn(
# 64, 85.0), chunked reconstruction and ChunkedField.extract_dual_mesh(
# mise_iter=1), whose host mesher seals at each chunk's UDF mask.  The JAX
# package's interior terrain error mean on the same four 20 m quadrants,
# each alone with chunk_size=10.0 (scripts/terrain_reference_chunked.py,
# on the CPU: 0.082588, 0.082977, 0.085382, 0.083859 by quadrant).
# Phase 9's gate is 1.5x that, for the quadrants and for the whole tile
# in four 20 m chunks.
JAX_CHUNKED_QUADRANT_ERR = 0.083710
CHUNKED_ERR_LIMIT = 1.5 * JAX_CHUNKED_QUADRANT_ERR
# Phase 10, the dual (row-space) solve: the splat path of phase 3 with
# solver_formulation="dual" at tol 1e-4 and at most 64 CG iterations.  The
# JAX package's interior terrain error mean under that configuration on
# the same four 20 m quadrants (scripts/terrain_reference_dual.py, on the
# CPU, f32 rows: 0.075950, 0.078004, 0.077618, 0.079404 by quadrant, each
# solve at its 64th iteration with rel_res 2.0-2.4).  At 64 iterations the
# JAX package's dual is 20x the primal's error at 16 (0.003831): its
# Jacobi-preconditioned Gram converges slowly at scene size
# (nksr_tpu/models/pipeline.py:54-61).  With bf16 row values, as on the
# card, the same script gives 0.079243 (its --solver-compute-dtype
# bfloat16).  The gate is 1.5x the f32 figure, for the tile and the
# quadrants.
DUAL_KW = dict(KW, solver_max_iters=64)
JAX_DUAL_QUADRANT_ERR = 0.077736
DUAL_ERR_LIMIT = 1.5 * JAX_DUAL_QUADRANT_ERR
# Phase 10's converged parity: the scene of tests/test_torch_dual.py
# (tests/test_pipeline.py's pin: a 1,200-point sphere, 150 probes inside
# it, the port's seeded weights), the dual to tol 1e-4 in f32 on the card
# against the same call on CPU tensors, field values within 5e-3 of the
# largest |f|.
PARITY_CFG = dict(voxel_size=0.1, tree_depth=3, adaptive_depth=1, f_maps=16,
                  basis_dim=8, udf_dim=8, solver_formulation="dual")
PARITY_KW = dict(detail_level=None, voxel_size=0.1, structure="splat",
                 solver_tol=1e-4, solver_max_iters=500)
PARITY_BOUND = 5e-3
# Phase 11, training (teacher-forced) at runs/scene_big's width under its
# config.yaml (UDF head on, f32 convs, 16 CG iterations at tol 1e-4), on
# item 0 of scripts/make_synth_scenes.py's corpus (5 m terrain patches of
# 30,000 points; 8,000 input points, as the config's train_dataset draws),
# written under the checkout's gitignored data/.  Card against the same
# step on CPU tensors with one set of draws: the UNet's structure logits
# and basis features within TRAIN_UNET_TOL of their largest magnitude and
# the structure losses within TRAIN_STRUCT_RTOL (f32, other summation
# orders; the port's CPU run is 1e-6 from the JAX package's there), at
# the run's 16 iterations; with the solve to convergence (tol
# TRAIN_CONV_TOL, at most TRAIN_CONV_ITERS iterations) every loss term
# within TRAIN_LOSS_RTOL, the whole gradient (all leaves at once) within
# TRAIN_GRAD_RTOL relative L2 and each leaf within TRAIN_SCENE_LEAF_RTOL.
# At this width the f32 backward solve takes some 6,200 iterations to
# tol 1e-4, and along its slow modes two runs that differ only in
# summation order still differ by a few percent on some leaves: the port
# on the CPU at 4 and at 8 threads 5.4e-2 on interp_2's last layer (9.6e-4
# over the whole gradient), the card against the CPU 9.3e-2 there (1.3e-3
# whole); a leaf whose gradient is lost or wrong reads about 1.  The
# sphere of (b), whose backward converges in some 370 iterations, has
# each leaf within TRAIN_GRAD_RTOL.  The bounds are
# tests/test_torch_train.py's against the JAX package.
TRAIN_ROOT = os.path.join("data", "synth_scene_smoke")
TRAIN_ITEMS = 8
TRAIN_UNET_TOL = 1e-4
TRAIN_STRUCT_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 1e-2
TRAIN_SCENE_LEAF_RTOL = 0.3
TRAIN_CONV_TOL = 1e-4
TRAIN_CONV_ITERS = 12000
# phase 11 (g): the predicted step's draws (CPU generator seed), and the
# top-2 logit margin, as a share of the level's largest |logit|, under
# which a status that differs between card and CPU is a tie (the UNet's
# outputs agree within 1.27e-6 relative on an H100 in phase 11 (c))
TRAIN_PRED_SEED = 0
TRAIN_TIE_FRAC = 1e-4
# the CPU side of phase 11 (b), (c) and (g) runs in its own process, on this
# many threads pinned to the host's last cores, beside phases 2-10 on the
# card: alone it takes some 400 s, which would bring the script near its
# time limit; phase 11 waits for it at most TRAIN_REF_TIMEOUT seconds
TRAIN_REF_THREADS = 4
TRAIN_REF_TIMEOUT = 900
# the overfit of tests/test_train.py:163-176 (its learning rate 2e-3, the
# last 3 sums' mean under 0.85x the first 3's), 30 steps at full width
OVERFIT_STEPS = 30
OVERFIT_LR = 2e-3
# the port-trained checkpoint's mesh of item 0: mean distance of its
# vertices to the GT cloud under half a voxel
FIT_MESH_LIMIT = 0.05
# phase 11 (b): tests/test_train.py's sphere configuration, its solve
# raised to convergence as tests/test_torch_train.py raises it
SPHERE_TRAIN_CFG = dict(voxel_size=0.1, tree_depth=3, adaptive_depth=1,
                        f_maps=16, basis_dim=8, udf_dim=8,
                        capacities=(2048, 1024, 512), solver_max_iters=600,
                        solver_tol=1e-4)
SPHERE_TRAIN_LOSS = dict(gt_surface_subsample=2048)
# Phase 12, the in-graph route (structure="predicted_ingraph": capacities
# estimated from a subsample, the inference forward, the support-row
# solve, meshed by meshing/dual_mc.py with mise_iter Newton steps) under
# runs/scene_big/config.yaml (UDF head on, f32 convs), 16 CG iterations at
# tol 1e-4.  (a) the held-out scenes of scripts/make_synth_scenes.py's
# corpus of 40 patches (its test split, 5 scenes; 8,000 input points each
# as the config's test_dataset draws them), MeshEvaluator at 5e6 samples:
# the JAX package's in-graph chamfer-L1 and f-score per scene
# (scripts/quality_reference_ingraph.py --scenes, on the CPU); each
# scene's chamfer-L1 gated at INGRAPH_CHAMFER_GATE x its JAX figure.
INGRAPH_ROOT = os.path.join("data", "synth_scene_eval")
INGRAPH_ITEMS = 40
INGRAPH_KW = dict(detail_level=None, voxel_size=0.1, solver_tol=1e-4,
                  solver_max_iters=16, structure="predicted_ingraph")
JAX_INGRAPH_SCENES = {
    "terrain/terrain_035": (0.008918, 0.444244),
    "terrain/terrain_036": (0.009477, 0.427907),
    "terrain/terrain_037": (0.008864, 0.446586),
    "terrain/terrain_038": (0.009565, 0.411266),
    "terrain/terrain_039": (0.009834, 0.407954)}
INGRAPH_CHAMFER_GATE = 1.1
# (b) the (-x, -y) 20 m quadrant of the 1M-point tile alone, one lap: the
# JAX package's interior terrain error mean there (the same script's
# --quadrant; 249,856 points, 113 s and 5.4 GiB on the CPU), gated at
# 1.5x; (c) the same quadrant with chunk_size=10 (four 10 m chunks, each
# meshed alone, welded), gated at 1.5x (b)'s own error; the JAX
# package's figure (--chunked) printed beside it.
JAX_INGRAPH_QUADRANT_ERR = 0.006218
INGRAPH_ERR_LIMIT = 1.5 * JAX_INGRAPH_QUADRANT_ERR
JAX_INGRAPH_CHUNKED_ERR = 0.005573
# (d) the host routes on one held-out scene at 5e6 samples, beside the JAX
# package's QUALITY.md rows (the mean over its held-out scenes)
JAX_QUALITY_SCENE = {"predicted": (0.0094, 0.4275), "splat": (0.0094, 0.4229),
                     "adaptive": (0.0094, 0.4224)}
# Phase 13, texture fields and the neural geometry head (ROADMAP item 17).
# (a), (b): colours a fixed function of position (``texture_colours``)
# through PCNNField.build(cell_size=4 * voxel, capacity=TEXTURE_CAPACITY),
# as examples/recons_colored_mesh.py builds it; each vertex's colour equal
# to the same field's on CPU tensors, a difference allowed only at a
# distance tie (the two picks' squared distances within TEXTURE_TIE_RTOL
# of each other).  (c), (d): runs/scene_big/config.yaml with geometry:
# neural; the in-graph route on phase 12's held-out scenes from best.ckpt
# (a kernel model: its SDF decoder is its init's, the last bias offset by
# minus the median of the field at the first scene's points, on the CPU,
# so that the zero set runs through the shell), the field at NEURAL_PROBES
# seeded probes a scene within NEURAL_FIELD_TOL of the CPU run's largest
# |f| (PERF.md section 2's UNet gate); NEURAL_STEPS training steps on
# phase 11's item, card against CPU under phase 11's gates.
TEXTURE_CAPACITY = 1 << 16
# Phase 14, the adaptive structure on routes A and B (ROADMAP item 8b)
# under PipelineConfig(conv_dtype="bfloat16", adaptive_depth=2) with
# adaptive_tau ADAPTIVE_ROUTE_TAU: at the configuration's 0.1 (and at
# 0.005) no depth-1 voxel of this terrain has normals that vary by tau,
# so the decoder keeps no depth-0 voxel (the tile's count at 0.1 is
# printed); at 0.001 it keeps the curved parts' (about 12% of the splat's
# depth-0 voxels at route A's density, 4% at route B's).  The JAX
# package's interior terrain error mean there, on the central 20 m
# sub-tiles of the 60 m tile alone on route A and of the 100 m tile alone
# on route B (scripts/terrain_reference_adaptive_routes.py --route A|B
# --tau 0.001, on the CPU: route A 0.005876, 0.005683, 0.005502, 0.007634
# by sub-tile, q90 0.008902, max 0.829548; route B 0.008597, 0.006943,
# 0.007176, 0.008054, q90 0.012319, max 0.410895); the sub-tile gates are
# 1.5x these, the tiles' ROUTE_ERR_LIMIT.  (d)'s tolerance: the UNet card
# against CPU, as a share of the largest |head| (PERF.md section 2's UNet
# gate).
ADAPTIVE_ROUTE_TAU = 0.001
JAX_ADAPTIVE_ROUTE_A_ERR = 0.006175
ADAPTIVE_ROUTE_A_LIMIT = 1.5 * JAX_ADAPTIVE_ROUTE_A_ERR
JAX_ADAPTIVE_ROUTE_B_ERR = 0.007694
ADAPTIVE_ROUTE_B_LIMIT = 1.5 * JAX_ADAPTIVE_ROUTE_B_ERR
ADAPTIVE_CARD_CPU_TOL = 1e-4
# (b)'s tile lap: the whole tile.  Route B's host mesher is phase 14's
# longest stage (179 s of its 318 s, alone, on an NVIDIA H100 80GB HBM3 at
# 700 W); at 500k points of the same tile (its route unchanged) it takes
# 119 s, but the tile's error mean rises to 0.00848 against
# ROUTE_ERR_LIMIT's 0.0085 (half the density).
ADAPTIVE_ROUTE_B_POINTS = N_POINTS
ROUTE_B_TILE_TIMEOUT = 600
# Phase 15, the public API: its time limit, so that the script stays
# within its own
API_PHASE_LIMIT_S = 30.0
TEXTURE_TIE_RTOL = 1e-6
NEURAL_PROBES = 4096
NEURAL_FIELD_TOL = 1e-4
NEURAL_STEPS = 3
SENSOR_Z = 10.0
KNN, MAX_ANGLE = 64, 85.0
KNN_CHECK_QUERIES = 4096
SMALL_DIMS = ((24, 24, 16), (16, 16, 8), (8, 8, 8))
BISECT_DIMS = ((16, 16, 8), (8, 8, 8))   # scripts/probe_mosaic_cascade.py
# the adjoint's input forms: (buffer dtype, compute dtype) of the solve's
# matvec and right-hand side, of a bf16 buffer, of the Jacobi diagonal
ADJ_FORMS = ((torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.float32))


def _height(x, y):
    return np.sin(0.3 * x) * np.cos(0.25 * y) + 0.3 * np.sin(1.1 * x + 0.7 * y)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events over ``reps`` calls,
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def av0_bounds(spec):
    """Bounds of the bf16 forward, of the adjoint reading an f32 buffer
    (the solve's form) and of the adjoint reading a bf16 buffer, at
    ``spec``: every coefficient row read (written) once in f32, every
    cell-0 lane written (read) once in its buffer's type; the adjoint
    adds each lane into its coefficient once."""
    coef = sum(spec.n_cells(d) for d in range(spec.depth)) * spec.k * 4
    lanes = spec.n_cells(0) * spec.lanes
    return (bound_ms(coef + 2 * lanes, 0), bound_ms(coef + 4 * lanes, lanes),
            bound_ms(coef + 2 * lanes, lanes))


def compare_kernels(LK, spec, gen, timed: bool):
    """Kernel vs plain version on the same random inputs.  Forward: exact
    in f32 and bf16 (pure selection), and equal to the slot-row kernel
    over every depth-0 cell widened back to f32.  Adjoint: rtol 1e-5, atol
    1e-5 of the largest output (f32 sums in another order), in each of
    ``ADJ_FORMS``, and two calls bit-equal.  Pair <fwd(x), z> = <x,
    adj(z)> to 1e-5 relative.  Timed: the bf16 forward in turns with its
    plain version and with the write ceiling (``empty_like(out).zero_()``
    of the same bytes, a yardstick the port never calls), the adjoint in
    the solve's form (f32 buffer read in bf16) and on a bf16 buffer."""
    dev = "cuda"
    xs = [torch.randn((spec.n_cells(d), spec.k), device=dev, generator=gen)
          for d in range(spec.depth)]
    z = torch.randn((spec.n_cells(0), spec.lanes), device=dev, generator=gen)
    out = {"fwd_err": 0.0, "adj_err": 0.0}
    every_cell = torch.arange(spec.n_cells(0), dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        got = LK.av0_cascade(spec, xs, dt)
        ref = LK.av0_cascade_plain(spec, xs, dt)
        if not torch.equal(got, ref):
            raise AssertionError(f"av0_cascade {dt} differs from plain: max "
                                 f"{(got.float() - ref.float()).abs().max()}")
        del ref
        if not torch.equal(got.float(), LK.av0_rows(spec, xs, every_cell,
                                                    dt)):
            raise AssertionError(f"av0_cascade {dt} differs from av0_rows "
                                 "over every cell")
        del got
        torch.cuda.empty_cache()
    for zdt, cdt in ADJ_FORMS:
        zt = z.to(zdt)
        got = LK.av0_adjoint_cascade(spec, zt, cdt)
        ref = LK.av0_adjoint_cascade_plain(spec, zt, cdt)
        for g, r in zip(got, ref):
            err = float((g - r).abs().max())
            torch.testing.assert_close(g, r, rtol=1e-5,
                                       atol=1e-5 * float(r.abs().max()))
            out["adj_err"] = max(out["adj_err"], err)
        del ref
        again = LK.av0_adjoint_cascade(spec, zt, cdt)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"av0_adjoint_cascade {zdt} read in {cdt}:"
                                 " two calls differ")
        del got, again, zt
    fwd = LK.av0_cascade(spec, xs, torch.float32)
    lhs = float((fwd.double() * z.double()).sum())
    del fwd
    adj = LK.av0_adjoint_cascade(spec, z, torch.float32)
    rhs = float(sum((a.double() * x.double()).sum() for a, x in zip(adj, xs)))
    if abs(lhs - rhs) > 1e-5 * abs(lhs):
        raise AssertionError(f"adjoint pair: {lhs} vs {rhs}")
    out["pair_rel"] = abs(lhs - rhs) / abs(lhs)
    if timed:
        bf = torch.bfloat16
        table = LK.av0_cascade(spec, xs, bf)
        # plain, ceiling, kernel, kernel, ceiling, plain: each timed in
        # two turns
        p1 = cuda_ms(lambda: LK.av0_cascade_plain(spec, xs, bf), 2)
        w1 = cuda_ms(lambda: torch.empty_like(table).zero_(), 10)
        k1 = cuda_ms(lambda: LK.av0_cascade(spec, xs, bf), 10)
        k2 = cuda_ms(lambda: LK.av0_cascade(spec, xs, bf), 10)
        w2 = cuda_ms(lambda: torch.empty_like(table).zero_(), 10)
        p2 = cuda_ms(lambda: LK.av0_cascade_plain(spec, xs, bf), 2)
        del table
        out["fwd_ms"], out["fwd_plain_ms"] = min(k1, k2), min(p1, p2)
        out["fwd_turns"], out["fwd_ceiling_ms"] = (k1, k2), min(w1, w2)
        p1 = cuda_ms(lambda: LK.av0_adjoint_cascade_plain(spec, z, bf), 2)
        k1 = cuda_ms(lambda: LK.av0_adjoint_cascade(spec, z, bf), 10)
        k2 = cuda_ms(lambda: LK.av0_adjoint_cascade(spec, z, bf), 10)
        p2 = cuda_ms(lambda: LK.av0_adjoint_cascade_plain(spec, z, bf), 2)
        out["adj_ms"], out["adj_plain_ms"] = min(k1, k2), min(p1, p2)
        zb = z.to(bf)
        out["adj_bf16_ms"] = min(
            cuda_ms(lambda: LK.av0_adjoint_cascade(spec, zb, bf), 10)
            for _ in range(2))
    return out


def row_cells(spec, gen, n_random: int = 4000):
    """Random depth-0 cells, every cell on the last x, y and z planes and
    repeats of them, in a random (unsorted) order, int32 on the card."""
    x0, y0, z0 = spec.dims[0]
    grid = torch.arange(spec.n_cells(0), device="cuda").view(x0, y0, z0)
    cells = torch.cat([
        torch.randint(0, spec.n_cells(0), (n_random,), device="cuda",
                      generator=gen),
        grid[-1].reshape(-1), grid[:, -1].reshape(-1),
        grid[:, :, -1].reshape(-1)])
    cells = torch.cat([cells, cells[:256]])
    perm = torch.randperm(len(cells), device="cuda", generator=gen)
    return cells[perm].to(torch.int32).contiguous()


def rows_bound(spec, cells):
    """Bound of the slot rows in the solve's form (bf16 values): the f32
    rows written, the int32 cells read, and each distinct coefficient row
    the cells' corners touch read once (counted with torch.unique); one
    rounding a value."""
    u = torch.unique(cells.long())
    x0, y0, z0 = spec.dims[0]
    cz, cxy = u % z0, u // z0
    cy, cx = cxy % y0, cxy // y0
    n_coef = 0
    for d in range(spec.depth):
        xd, yd, zd = spec.dims[d]
        flats = []
        for i in (0, 1):
            for j in (0, 1):
                for l in (0, 1):
                    ax, ay, az = (cx >> d) + i, (cy >> d) + j, (cz >> d) + l
                    ok = (ax < xd) & (ay < yd) & (az < zd)
                    flats.append(((ax * yd + ay) * zd + az)[ok])
        n_coef += int(torch.unique(torch.cat(flats)).numel())
    r = cells.numel()
    return bound_ms(r * spec.lanes * 4 + r * 4 + n_coef * spec.k * 4,
                    r * spec.lanes)


def compare_rows(LK, spec, xs, cells, timed: bool):
    """Slot-row kernel vs its plain version on the same inputs: exactly
    equal in f32 and bf16 (pure selection, one rounding), and to the
    dense plain forward's rows.  Timed (bf16, the
    solve's form): kernel and plain version in turns, and the chain the
    kernel replaces in the matvec (the dense bf16 forward, then the
    point-slot and gradient-slot row gathers, each cast to f32), chain,
    kernel, kernel, chain."""
    out = {"err": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        got = LK.av0_rows(spec, xs, cells, dt)
        ref = LK.av0_rows_plain(spec, xs, cells, dt)
        if not torch.equal(got, ref):
            raise AssertionError(f"av0_rows {dt} differs from plain: max "
                                 f"{(got - ref).abs().max()}")
        if not torch.equal(
                got, LK.av0_cascade_plain(spec, xs, dt)[cells.long()]
                .float()):
            raise AssertionError(f"av0_rows {dt} differs from the dense "
                                 "plain forward's rows")
        del got, ref
    if timed:
        bf = torch.bfloat16
        pt, gr = cells[:spec.s_pt].long(), cells[spec.s_pt:].long()

        def chain():
            av0 = LK.av0_cascade(spec, xs, bf)
            return (av0.index_select(0, pt).float(),
                    av0.index_select(0, gr).float())

        c1 = cuda_ms(chain, 10)
        k1 = cuda_ms(lambda: LK.av0_rows(spec, xs, cells, bf), 20)
        k2 = cuda_ms(lambda: LK.av0_rows(spec, xs, cells, bf), 20)
        c2 = cuda_ms(chain, 10)
        p1 = cuda_ms(lambda: LK.av0_rows_plain(spec, xs, cells, bf), 2)
        p2 = cuda_ms(lambda: LK.av0_rows_plain(spec, xs, cells, bf), 2)
        out.update(ms=min(k1, k2), ms_turns=(k1, k2), chain_ms=min(c1, c2),
                   chain_turns=(c1, c2), plain_ms=min(p1, p2),
                   bound=rows_bound(spec, cells))
    return out


def seg_inputs(gen, r: int, c: int, t: int):
    """R rows of C values onto T targets: a third of the rows on three
    hot targets, a tenth dropped (-1), values of mixed magnitude."""
    idx = torch.randint(0, t, (r,), device="cuda", generator=gen)
    hot = torch.rand(r, device="cuda", generator=gen) < 0.33
    idx = torch.where(hot, idx % 3, idx)
    idx = torch.where(torch.rand(r, device="cuda", generator=gen) < 0.1,
                      -1, idx)
    scale = 10.0 ** torch.randint(-3, 4, (r, 1), device="cuda",
                                  generator=gen)
    return idx, torch.randn((r, c), device="cuda", generator=gen) * scale


def compare_segment_sum(SEG, values, index, n_rows: int, timed: bool):
    """Segment-sum kernel vs its plain version (CPU ``index_add_`` in
    index order, on CPU copies of the same inputs): bit-equal, dense and
    compact, and two calls bit-equal.  Timed (dense, the splat's form,
    the order built beforehand): kernel and plain version (on the card:
    its mask and ``index_add_``) in turns, the library call (``zeros`` +
    ``index_add_`` of the kept rows, f32 atomics) likewise, and the
    order's build (stable sort and segment starts)."""
    order = SEG.segment_order(index, n_rows)
    cpu_order = SEG.segment_order(index.cpu(), n_rows)
    for compact in (False, True):
        got = SEG.segment_sum(values, order, compact=compact)
        again = SEG.segment_sum(values, order, compact=compact)
        ref = SEG.segment_sum_plain(values.cpu(), cpu_order, compact=compact)
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(
                f"segment_sum (compact={compact}) differs from plain: max "
                f"{(got.cpu() - ref).abs().max()}")
        if not torch.equal(got, again):
            raise AssertionError("segment_sum: two calls differ")
        del got, again, ref
    out = {"err": 0.0, "rows": index.numel(), "segments":
           order.targets.numel(), "longest": int(
               (order.offsets[1:] - order.offsets[:-1]).max())
           if order.targets.numel() else 0}
    if timed:
        keep = index >= 0
        kv, ki = values[keep].contiguous(), index[keep]

        def library():
            return torch.zeros((n_rows, values.shape[1]),
                               device="cuda").index_add_(0, ki, kv)

        p1 = cuda_ms(lambda: SEG.segment_sum_plain(values, order), 5)
        l1 = cuda_ms(library, 10)
        k1 = cuda_ms(lambda: SEG.segment_sum(values, order), 10)
        k2 = cuda_ms(lambda: SEG.segment_sum(values, order), 10)
        l2 = cuda_ms(library, 10)
        p2 = cuda_ms(lambda: SEG.segment_sum_plain(values, order), 5)
        n_kept = int(keep.sum())
        c = values.shape[1]
        out.update(ms=min(k1, k2), ms_turns=(k1, k2), plain_ms=min(p1, p2),
                   library_ms=min(l1, l2),
                   order_ms=cuda_ms(lambda: SEG.segment_order(index, n_rows),
                                    3),
                   bound=bound_ms(values.numel() * 4 + index.numel() * 8
                                  + n_rows * c * 4, n_kept * c))
    return out


def random_slot_cells(spec, gen, r: int):
    """R sorted depth-0 slot cells with heavy repeats (a third on five
    cells) and edge planes, then 37 pad slots repeating the last cell,
    int32; and the same cells with the pads dropped (-1), as the solve
    builds its adjoint tables."""
    x0, y0, z0 = spec.dims[0]
    grid = torch.arange(spec.n_cells(0), device="cuda").view(x0, y0, z0)
    cells = torch.randint(0, spec.n_cells(0), (r,), device="cuda",
                          generator=gen)
    cells = torch.where(torch.rand(r, device="cuda", generator=gen) < 0.33,
                        cells % 5 + spec.n_cells(0) // 2, cells)
    cells = torch.cat([cells, grid[-1].reshape(-1), grid[:, -1].reshape(-1),
                       grid[:, :, -1].reshape(-1)])
    cells = torch.sort(cells).values.to(torch.int32)
    pads = cells[-1:].expand(37)
    return torch.cat([cells, pads]), torch.cat([cells, torch.full_like(
        pads, -1)])


def compare_adjoint_rows(LK, TA, spec, cells, kept, s_pt: int, gen,
                         timed: bool):
    """Slot-row adjoint on random f32 slot rows at the slot cells
    ``cells`` (the first ``s_pt`` point slots, then gradient slots), with
    tables of ``kept`` (-1 at the pad slots, whose rows are zero, as in
    the solve): equal to the dense adjoint kernel on the buffer CPU
    ``index_add_`` builds from all the rows at ``cells``, bit for bit up
    to the sign of a zero (a + 0.0), in the solve's form (bf16) and the
    Jacobi diagonal's (f32); two calls bit-equal; against the plain
    adjoint on that buffer rtol 1e-5, atol 1e-5 of the largest output.
    Timed (bf16): the wrapper and the chain it replaces (zeros + the two
    ``index_add_`` + the dense adjoint kernel) in turns, the f32 form,
    the plain version, its kernels' device time a call under
    torch.profiler, and its tables.  The bound counts the rows the tables
    keep (the pad slots' rows are never read), their int32 order and the
    coefficients written; each kept value is added once into its cell's
    sum and each cell's value once into a coefficient."""
    r = cells.numel()
    y = torch.randn((r, spec.lanes), device="cuda", generator=gen) \
        * (kept >= 0)[:, None]
    tab = LK.adjoint_rows_tables(spec, kept)
    z0 = torch.zeros((spec.n_cells(0), spec.lanes))
    z0.index_add_(0, cells.cpu().long(), y.cpu())
    z0 = z0.cuda()
    out = {"err": 0.0, "distinct": tab.cells.numel(),
           "bricks": tab.bricks.numel(), "of_bricks": tab.brick_occ.numel(),
           "live_tiles": int(tab.tile_live.sum()),
           "tiles": tab.tile_live.numel()}
    for dt in (torch.bfloat16, torch.float32):
        got = LK.av0_adjoint_rows(spec, tab, y, dt)
        again = LK.av0_adjoint_rows(spec, tab, y, dt)
        dense = LK.av0_adjoint_cascade(spec, z0, dt)
        plain = LK.av0_adjoint_cascade_plain(spec, z0, dt)
        for g, a, dn, p in zip(got, again, dense, plain):
            if not torch.equal(g, a):
                raise AssertionError(f"av0_adjoint_rows {dt}: two calls "
                                     "differ")
            if not torch.equal(g + 0.0, dn + 0.0):
                raise AssertionError(
                    f"av0_adjoint_rows {dt} differs from the dense kernel "
                    f"on the CPU-built buffer: max {(g - dn).abs().max()}")
            torch.testing.assert_close(g, p, rtol=1e-5,
                                       atol=1e-5 * float(p.abs().max()))
            out["err"] = max(out["err"], float((g - p).abs().max()))
        del got, again, dense, plain
    del z0
    torch.cuda.empty_cache()
    if timed:
        bf = torch.bfloat16
        pt, gr = cells[:s_pt].long(), cells[s_pt:].long()

        def chain():
            z = torch.zeros((spec.n_cells(0), spec.lanes), device="cuda")
            z.index_add_(0, pt, y[:s_pt]).index_add_(0, gr, y[s_pt:])
            return LK.av0_adjoint_cascade(spec, z, bf)

        c1 = cuda_ms(chain, 10)
        k1 = cuda_ms(lambda: LK.av0_adjoint_rows(spec, tab, y, bf), 20)
        k2 = cuda_ms(lambda: LK.av0_adjoint_rows(spec, tab, y, bf), 20)
        c2 = cuda_ms(chain, 10)
        f1 = cuda_ms(lambda: LK.av0_adjoint_rows(spec, tab, y,
                                                 torch.float32), 20)
        p1 = cuda_ms(lambda: LK.av0_adjoint_rows_plain(spec, tab, y, bf), 2)
        coef = sum(spec.n_cells(d) for d in range(spec.depth)) * spec.k * 4
        n_kept = tab.perm.numel()
        out.update(ms=min(k1, k2), ms_turns=(k1, k2), chain_ms=min(c1, c2),
                   chain_turns=(c1, c2), f32_ms=f1, plain_ms=p1,
                   stage_ms=TA.kernel_ms(
                       torch, lambda: LK.av0_adjoint_rows(spec, tab, y, bf)),
                   tables_ms=cuda_ms(
                       lambda: LK.adjoint_rows_tables(spec, kept), 3),
                   bound=bound_ms(n_kept * spec.lanes * 4 + n_kept * 4
                                  + coef,
                                  (n_kept + out["distinct"]) * spec.lanes))
    return out


def quadrant_error(recon, xyz, nrm, structure="splat", on_lap=None,
                   lap=None):
    """The scene's four 20 m quadrants, each reconstructed and meshed
    alone (the configuration of JAX_QUADRANT_ERR): the vertex errors over
    used vertices 1 m inside each quadrant, pooled.  ``on_lap(field,
    t_recon, t_mesh)`` sees each quadrant's lap; ``lap(xyz, nrm)``
    replaces ``main_path_lap``."""
    errs = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            m = (np.sign(xyz[:, 0]) == sx) & (np.sign(xyz[:, 1]) == sy)
            tr, tm, field, mesh = (
                main_path_lap(recon, xyz[m], nrm[m], structure)
                if lap is None else lap(xyz[m], nrm[m]))
            if on_lap is not None:
                on_lap(field, tr, tm)
            del field
            v = mesh.v[np.unique(mesh.f)]
            ax, ay = np.abs(v[:, 0]), np.abs(v[:, 1])
            v = v[(ax > 1) & (ax < 19) & (ay > 1) & (ay < 19)
                  & (np.sign(v[:, 0]) == sx) & (np.sign(v[:, 1]) == sy)]
            errs.append(np.abs(v[:, 2] - _height(v[:, 0], v[:, 1])))
    return np.concatenate(errs)


def window_offsets(q: int, gen):
    """(q, 8, 3) local offsets in [-1.25, 1.25] (the support's [-1, 1)
    plus the clamped margin)."""
    return torch.rand((q, 8, 3), device="cuda", generator=gen) * 2.5 - 1.25


def compare_window(WB, x, timed: bool):
    """Window kernel vs plain version on the (Q, 8, 3) local offsets
    ``x``: rtol 1e-5 / atol 1e-6, the bound of the JAX package's own
    window test (FMA contraction may move an ulp)."""
    q = x.shape[0]
    w, dw = WB.window_and_grad_fused(x)
    rw, rdw = WB.window_and_grad_plain(x)
    torch.testing.assert_close(w, rw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-6)
    out = {"err": max(float((w - rw).abs().max()),
                      float((dw - rdw).abs().max()))}
    del w, dw, rw, rdw
    if timed:
        p1 = cuda_ms(lambda: WB.window_and_grad_plain(x), 10)
        k1 = cuda_ms(lambda: WB.window_and_grad_fused(x), 50)
        k2 = cuda_ms(lambda: WB.window_and_grad_fused(x), 50)
        p2 = cuda_ms(lambda: WB.window_and_grad_plain(x), 10)
        out["ms"], out["plain_ms"] = min(k1, k2), min(p1, p2)
        # 96 B read, 128 B written and 26 f32 operations a (query, corner)
        out["bound"] = bound_ms(q * 224, q * 8 * 26)
    return out


def profile_matvec(LAT, recon, xyz, nrm):
    """One more splat reconstruct in which the lattice solve's first
    matvec runs once more, warmed, under torch.profiler (CPU and CUDA
    activity), and is then timed by CUDA events over 3 calls.  Returns
    (device events, the kernels and copies, as (device ms, name, calls)
    by device time; their total in ms; CUDA-event ms a matvec)."""
    real_pcg = LAT.pcg
    rec = {}

    def pcg_probe(matvec, rhs, **kw):
        matvec(rhs)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            matvec(rhs)
            torch.cuda.synchronize()
        rec["prof"] = prof
        rec["ms"] = cuda_ms(lambda: matvec(rhs), 3)
        return real_pcg(matvec, rhs, **kw)

    LAT.pcg = pcg_probe
    try:
        recon.reconstruct(xyz, nrm, structure="splat", **KW)
    finally:
        LAT.pcg = real_pcg
    rows = []
    for e in rec["prof"].key_averages():
        # device events only: an operator's row repeats its kernels' time
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        t = e.self_device_time_total
        if t > 0:
            rows.append((t / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows), rec["ms"]


def profile_solve(ST, recon, xyz, nrm):
    """One more splat reconstruct whose whole lattice solve runs under
    torch.profiler (CPU and CUDA activity).  Returns, for the solve and
    each of its ``lattice_solve: ...`` ranges in order, (name, host ms,
    device ms): the range's host span, and the device time of the kernels
    launched inside it."""
    real_solve = ST.lattice_solve
    rec = {}

    def solve_probe(*a, **kw):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("lattice_solve"):
                out = real_solve(*a, **kw)
            torch.cuda.synchronize()
        rec["prof"] = prof
        return out

    ST.lattice_solve = solve_probe
    try:
        recon.reconstruct(xyz, nrm, structure="splat", **KW)
    finally:
        ST.lattice_solve = real_solve
    out = []
    for e in rec["prof"].events():
        if e.device_type != torch.autograd.DeviceType.CPU or not \
                e.name.startswith("lattice_solve"):
            continue
        out.append((e.time_range.start, e.name, e.cpu_time_total / 1e3,
                    e.device_time_total / 1e3))
    out.sort()
    return [r[1:] for r in out]


def compare_probes(P, seed: int):
    """Each probe kernel against its plain version on a random input:
    exact, except the two f32 sums (rtol 1e-5, atol 1e-5 of the largest
    value); both timed in turns by ``graph_ms``.  The bound counts the
    bytes each probe's function needs (``Probe.n_bytes``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in P.PROBES:
        ins = [torch.from_numpy(x).cuda() for x in p.inputs("random", rng)]
        got = p(*ins)
        ok, err = P.agree(got.cpu().numpy(), p.plain(*ins).cpu().numpy(),
                          p.exact)
        if not ok:
            raise AssertionError(f"probe {p.key}: kernel differs from its "
                                 f"plain version, max abs error {err}")
        p1 = graph_ms(lambda: p.plain(*ins), 100)
        k1 = graph_ms(lambda: p(*ins), 100)
        k2 = graph_ms(lambda: p(*ins), 100)
        p2 = graph_ms(lambda: p.plain(*ins), 100)
        out[p.key] = {"err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "bound": bound_ms(p.n_bytes(), p.ops)}
    return out


def main_path_lap(recon, xyz, nrm, structure="splat", kw=KW):
    """One reconstruct + extract_dual_mesh; (t_recon, t_mesh, field, mesh)."""
    t0 = time.perf_counter()
    field = recon.reconstruct(xyz, nrm, structure=structure, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mesh = field.extract_dual_mesh(mise_iter=1)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, field, mesh


def terrain_error(mesh, inner: float = 19.0):
    """|v_z - h(v_x, v_y)| over used vertices with |x|, |y| < ``inner``
    (scripts/make_scene_quality.py)."""
    v = mesh.v[np.unique(mesh.f)]
    v = v[(np.abs(v[:, 0]) < inner) & (np.abs(v[:, 1]) < inner)]
    return np.abs(v[:, 2] - _height(v[:, 0], v[:, 1])), len(v)


def reset_counts(counters):
    for fn in counters:
        fn.launches = 0


def read_counts(counters) -> dict:
    """Launches of each counted kernel wrapper, by its key."""
    return {key: fn.launches for key, fn in counters.items()}


def route_lap(recon, synthetic_scene, counters, half_extent: float,
              structure="splat", n_points=N_POINTS):
    """One lap of a sparse route on ``n_points`` of a terrain tile of
    side 2 * half_extent.  Returns (field, mesh, launches, lap record);
    the record also holds the route taken (``unet``, ``solve``,
    ``mesher``), the phases, the solver statistics and the decoder's
    voxels per depth."""
    xyz, nrm = synthetic_scene(n_points, half_extent=half_extent)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, structure)
    launches = read_counts(counters)
    err, n_inner = terrain_error(mesh, half_extent - 1.0)
    lap = {"reconstruct_s": tr, "extract_mesh_s": tm,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "verts": len(mesh.v), "faces": len(mesh.f),
           "err_mean": float(err.mean()),
           "err_q90": float(np.quantile(err, 0.9)),
           "err_max": float(err.max()), "n_inner": n_inner,
           "unet": recon._last_unet_engine,
           "solve": "lattice" if field.lattice_ctx is not None
           else "support-row",
           "mesher": "host" if "host dual mc" in field.phase_times
           else "dense",
           "phases": dict(field.phase_times),
           "solver": str(field.solver_stats),
           "decoder": [len(g.keys) for g in field.host_grids]}
    return field, mesh, launches, lap


def print_route(tag, launches, lap, limit=ROUTE_ERR_LIMIT):
    """A ``route_lap`` record: its route, phases, launches, memory, mesh
    and the terrain error, which must be at most ``limit``."""
    print(f"[{tag}] route: unet {lap['unet']}, solve {lap['solve']}, "
          f"mesher {lap['mesher']}", flush=True)
    print(f"[{tag}] reconstruct_s {lap['reconstruct_s']:.3f} extract_mesh_s "
          f"{lap['extract_mesh_s']:.3f} phases "
          + json.dumps({k: round(v, 4) for k, v in lap["phases"].items()}),
          flush=True)
    print(f"[{tag}] {lap['solver']}  launches {launches}  peak memory "
          f"{lap['peak_gib']:.2f} GiB  mesh verts {lap['verts']} faces "
          f"{lap['faces']}", flush=True)
    print(f"[{tag}] terrain vertex error on {lap['n_inner']} interior "
          f"vertices: mean {lap['err_mean']:.5f} q90 {lap['err_q90']:.5f} "
          f"max {lap['err_max']:.5f} (limit {limit})", flush=True)
    if not lap["faces"] or not lap["err_mean"] <= limit:
        raise AssertionError(f"[{tag}] empty mesh or terrain error mean "
                             f"{lap['err_mean']} > {limit}")


def check_lattice_launches(tag, launches, field, segsum=2, dual=False):
    """A lattice lap: the slot-row kernel once a matvec (one matvec a CG
    iteration), the slot-row adjoint once a matvec and, in the primal,
    for the rhs and the Jacobi diagonal, in the ``dual`` for the
    back-substitution, the dense adjoint never, the dense forward once
    (the evaluator tables), and the segment sum ``segsum`` times: at the
    encoder's splat and the normal prior's, one a gradient depth (the
    slot-row adjoint sums its rows itself)."""
    iters = field.solver_stats.iters
    want = {"fwd": 1, "rows": iters, "adj_rows": iters + (1 if dual else 2),
            "adj": 0, "segsum": segsum}
    got = {k: launches[k] for k in want}
    if not (iters > 0 and got == want):
        raise AssertionError(
            f"[{tag}] launches {launches}: expected {want} ({iters} CG "
            "iterations)")


def lap_diff(a, b) -> str:
    """Two laps' (alphas, mesh vertices, mesh faces): "bit-equal", or
    the largest absolute and relative differences."""
    (al_a, v_a, f_a), (al_b, v_b, f_b) = a, b
    parts = []
    if all(torch.equal(x, y) for x, y in zip(al_a, al_b)):
        parts.append("coefficients bit-equal")
    else:
        da = max(float((x - y).abs().max()) for x, y in zip(al_a, al_b))
        ra = max(float(((x - y).abs().max() / y.abs().max().clamp(
            min=1e-30))) for x, y in zip(al_a, al_b))
        parts.append(f"coefficients differ: max abs {da:.3e}, max abs "
                     f"over the largest {ra:.3e}")
    if v_a.shape == v_b.shape and np.array_equal(f_a, f_b) \
            and np.array_equal(v_a, v_b):
        parts.append("mesh bit-equal")
    elif v_a.shape == v_b.shape and f_a.shape == f_b.shape:
        dv = float(np.abs(v_a - v_b).max())
        parts.append(f"mesh differs: vertices max abs {dv:.3e} (relative "
                     f"{dv / float(np.abs(v_b).max()):.3e}), faces "
                     f"{'equal' if np.array_equal(f_a, f_b) else 'differ'}")
    else:
        parts.append(f"mesh differs: {len(v_a)} / {len(v_b)} vertices, "
                     f"{len(f_a)} / {len(f_b)} faces")
    return "; ".join(parts)


def print_lap(tag, field, tr, tm, launches, mesh, err, n_inner, limit):
    """One lap's phases, solve, launches, memory, mesh and error."""
    print(f"[{tag}] reconstruct_s {tr:.3f} extract_mesh_s {tm:.3f} phases "
          + json.dumps({k: round(v, 4) for k, v in field.phase_times.items()}),
          flush=True)
    print(f"[{tag}] decoder voxels {[len(g.keys) for g in field.host_grids]}"
          f"  {field.solver_stats}  launches {launches}  peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB  mesh "
          f"verts {len(mesh.v)} faces {len(mesh.f)}", flush=True)
    print(f"[{tag}] terrain vertex error on {n_inner} interior vertices: "
          f"mean {err.mean():.5f} q90 {np.quantile(err, 0.9):.5f} max "
          f"{err.max():.5f} (limit {limit:.5f})", flush=True)


def check_dense_lattice(tag, field, mesh, err, limit):
    """A lap on the lattice solve and the dense mesher, a finite mesh,
    and the terrain error mean under ``limit``."""
    if field.lattice_ctx is None or "dual mc" not in field.phase_times \
            or "host dual mc" in field.phase_times:
        raise AssertionError(f"[{tag}] not the lattice solve and the dense "
                             f"mesher: {sorted(field.phase_times)}")
    if not len(mesh.f) or not np.isfinite(mesh.v).all():
        raise AssertionError(f"[{tag}] empty or non-finite mesh")
    if not err.mean() <= limit:
        raise AssertionError(f"[{tag}] terrain error mean {err.mean()} > "
                             f"{limit}")


def structure_laps(recon, xyz, nrm, counters, splat_n0, adaptive_recon):
    """Phase 7.  The predicted structure (the default) on the 40 m tile:
    a warm-up lap and two timed laps, on the per-level engine (the JAX
    package's route there), the lattice solve and the dense mesher, bit-
    equal, with the lattice launches and the predicted gate; the four
    20 m quadrants alone on the one-pass dense engine, under the same
    gate; one adaptive lap (adaptive depth 2) on the dense lattice route
    with a decoder smaller than the splat hierarchy at depth 0, under the
    splat gate, and its four quadrants alone under 1.5x the JAX package's
    adaptive error there.  Returns the predicted lap's launches and its
    (reconstruct, mesh) seconds, the faster of two laps each."""
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "predicted")
    print(f"[phase 7] predicted warm-up lap: reconstruct_s {tr:.3f} "
          f"extract_mesh_s {tm:.3f}", flush=True)
    del field, mesh
    laps, lap_out = [], []
    for _ in range(2):
        field = mesh = None         # the lap's peak memory is its own
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "predicted")
        launches = read_counts(counters)
        laps.append((tr, tm))
        lap_out.append(([a.clone() for a in field.alpha], mesh.v, mesh.f))
        err, n_inner = terrain_error(mesh)
        print_lap("phase 7", field, tr, tm, launches, mesh, err, n_inner,
                  PRED_ERR_LIMIT)
    tr, tm = min(t[0] for t in laps), min(t[1] for t in laps)
    pred_lap = (tr, tm)
    print(f"[phase 7] predicted, {N_POINTS} points: engine "
          f"{recon._last_pred_engine}, reconstruct_s {tr:.3f} extract_mesh_s "
          f"{tm:.3f} pts/s {N_POINTS / (tr + tm):.1f}", flush=True)
    same = lap_diff(*lap_out)
    print("[phase 7] the two predicted laps on one input: " + same,
          flush=True)
    del lap_out
    if "coefficients bit-equal" not in same or "mesh bit-equal" not in same:
        raise AssertionError("[phase 7] two predicted laps on one input are "
                             "not bit-equal: " + same)
    if recon._last_pred_engine != "host-per-level":
        raise AssertionError("[phase 7] the 40 m tile took the "
                             f"{recon._last_pred_engine!r} engine, not the "
                             "per-level one")
    check_dense_lattice("phase 7", field, mesh, err, PRED_ERR_LIMIT)
    check_lattice_launches("phase 7", launches, field)
    pred_launches = launches
    del field, mesh
    torch.cuda.empty_cache()

    engines = []

    def quadrant_lap(field, tr, tm):
        engines.append(recon._last_pred_engine)
        print(f"[phase 7] quadrant on the {engines[-1]} engine: reconstruct_s "
              f"{tr:.3f} extract_mesh_s {tm:.3f} phases "
              + json.dumps({k: round(v, 4)
                            for k, v in field.phase_times.items()}),
              flush=True)
        if field.lattice_ctx is None:
            raise AssertionError("[phase 7] a quadrant left the lattice "
                                 "solve")

    q_err = quadrant_error(recon, xyz, nrm, "predicted", quadrant_lap)
    print(f"[phase 7] predicted, the four 20 m quadrants alone (engines "
          f"{engines}): terrain vertex error on {len(q_err)} interior "
          f"vertices: mean {q_err.mean():.5f} q90 "
          f"{np.quantile(q_err, 0.9):.5f} max {q_err.max():.5f} (the JAX "
          f"package, CPU: mean {JAX_PRED_QUADRANT_ERR}; limit "
          f"{PRED_ERR_LIMIT:.5f})", flush=True)
    if engines != ["dense"] * 4:
        raise AssertionError(f"[phase 7] quadrant engines {engines}, not "
                             "the one-pass dense engine")
    if not q_err.mean() <= PRED_ERR_LIMIT:
        raise AssertionError(f"[phase 7] predicted quadrant terrain error "
                             f"mean {q_err.mean()} > {PRED_ERR_LIMIT}")
    torch.cuda.empty_cache()

    ad = adaptive_recon.config.adaptive_depth
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    tr, tm, field, mesh = main_path_lap(adaptive_recon, xyz, nrm, "adaptive")
    launches = read_counts(counters)
    err, n_inner = terrain_error(mesh)
    print_lap("phase 7 adaptive", field, tr, tm, launches, mesh, err,
              n_inner, ERR_LIMIT)
    n0 = len(field.host_grids[0].keys)
    print(f"[phase 7 adaptive] adaptive depth {ad}: unet "
          f"{adaptive_recon._last_unet_engine}, {n0} decoder voxels at "
          f"depth 0 against the splat hierarchy's {splat_n0}", flush=True)
    if adaptive_recon._last_unet_engine != "dense" or not n0 < splat_n0:
        raise AssertionError("[phase 7 adaptive] not the dense UNet, or the "
                             "decoder is not smaller than the splat "
                             "hierarchy at depth 0")
    check_dense_lattice("phase 7 adaptive", field, mesh, err, ERR_LIMIT)
    # the segment sum at the encoder splat and at each gradient depth's
    # normal prior
    check_lattice_launches("phase 7 adaptive", launches, field, 1 + ad)
    del field, mesh
    torch.cuda.empty_cache()
    q_err = quadrant_error(adaptive_recon, xyz, nrm, "adaptive")
    print(f"[phase 7 adaptive] the four 20 m quadrants alone: terrain "
          f"vertex error on {len(q_err)} interior vertices: mean "
          f"{q_err.mean():.5f} q90 {np.quantile(q_err, 0.9):.5f} max "
          f"{q_err.max():.5f} (the JAX package, CPU: mean "
          f"{JAX_ADAPTIVE_QUADRANT_ERR}; limit "
          f"{ADAPTIVE_QUADRANT_LIMIT:.5f})", flush=True)
    if not q_err.mean() <= ADAPTIVE_QUADRANT_LIMIT:
        raise AssertionError(f"[phase 7 adaptive] quadrant terrain error "
                             f"mean {q_err.mean()} > "
                             f"{ADAPTIVE_QUADRANT_LIMIT}")
    return pred_launches, pred_lap


def check_trim(tag, field, mesh):
    """A dense-mesher lap with the UDF mask: the trim ran as its own phase
    and kept the mesh's faces.  Prints its time and the faces it
    dropped."""
    st = field.trim_stats
    if not field.has_udf_mask or st is None \
            or "dmc: udf mask trim" not in field.phase_times \
            or st["faces"] - st["dropped"] != len(mesh.f):
        raise AssertionError(f"[{tag}] the dense mesher did not trim at the "
                             f"UDF mask: {st}")
    print(f"[{tag}] UDF trim: dmc: udf mask trim "
          f"{field.phase_times['dmc: udf mask trim']:.4f} s, dropped "
          f"{st['dropped']} of {st['faces']} faces "
          f"({st['dropped'] / max(st['faces'], 1):.4%})", flush=True)


def udf_laps(recon, xyz, nrm, counters, synthetic_scene, a_phases, a_lap):
    """Phase 8.  ``recon`` runs the checkpoint under its own config.yaml
    (UDF mask head on, bf16 convs).  The predicted structure on the 40 m
    tile: a warm-up lap and two timed laps, on the per-level engine, the
    lattice solve and the dense mesher (which trims), bit-equal, with the
    lattice launches, under 1.5x the JAX package's UDF-on predicted
    quadrant error; its four quadrants on the one-pass dense engine under
    the same gate; one splat lap and its quadrants under 1.5x the JAX
    package's UDF-on splat quadrant error; one route-A lap of the 60 m
    tile (host mesher, sealed at the mask), its host-MC stages beside
    phase 5's (``a_phases``, ``a_lap``: its phases and lap record), and
    the tile's four central 20 m sub-tiles alone on route A (the budgets
    set to 0 for them), both under 1.5x the JAX package's sealed
    sub-tile error.  Returns the predicted lap's launches."""
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "predicted")
    print(f"[phase 8] predicted warm-up lap: reconstruct_s {tr:.3f} "
          f"extract_mesh_s {tm:.3f}", flush=True)
    del field, mesh
    laps, lap_out = [], []
    for _ in range(2):
        field = mesh = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "predicted")
        launches = read_counts(counters)
        laps.append((tr, tm))
        lap_out.append(([a.clone() for a in field.alpha], mesh.v, mesh.f))
        err, n_inner = terrain_error(mesh)
        print_lap("phase 8", field, tr, tm, launches, mesh, err, n_inner,
                  UDF_PRED_ERR_LIMIT)
        check_trim("phase 8", field, mesh)
    tr, tm = min(t[0] for t in laps), min(t[1] for t in laps)
    print(f"[phase 8] predicted, UDF on, {N_POINTS} points: engine "
          f"{recon._last_pred_engine}, reconstruct_s {tr:.3f} extract_mesh_s "
          f"{tm:.3f} pts/s {N_POINTS / (tr + tm):.1f}", flush=True)
    same = lap_diff(*lap_out)
    print("[phase 8] the two predicted laps on one input: " + same,
          flush=True)
    del lap_out
    if "coefficients bit-equal" not in same or "mesh bit-equal" not in same:
        raise AssertionError("[phase 8] two predicted laps on one input are "
                             "not bit-equal: " + same)
    if recon._last_pred_engine != "host-per-level":
        raise AssertionError("[phase 8] the 40 m tile took the "
                             f"{recon._last_pred_engine!r} engine, not the "
                             "per-level one")
    check_dense_lattice("phase 8", field, mesh, err, UDF_PRED_ERR_LIMIT)
    check_lattice_launches("phase 8", launches, field)
    udf_launches = launches
    del field, mesh
    torch.cuda.empty_cache()

    engines = []

    def quadrant_lap(field, tr, tm):
        engines.append(recon._last_pred_engine)
        st = field.trim_stats or {}
        print(f"[phase 8] quadrant on the {engines[-1]} engine: reconstruct_s "
              f"{tr:.3f} extract_mesh_s {tm:.3f}, trim dropped "
              f"{st.get('dropped')} of {st.get('faces')} faces, phases "
              + json.dumps({k: round(v, 4)
                            for k, v in field.phase_times.items()}),
              flush=True)
        if field.lattice_ctx is None or not field.has_udf_mask \
                or "dmc: udf mask trim" not in field.phase_times:
            raise AssertionError("[phase 8] a quadrant left the lattice "
                                 "solve or the UDF trim")

    q_err = quadrant_error(recon, xyz, nrm, "predicted", quadrant_lap)
    print(f"[phase 8] predicted, UDF on, the four 20 m quadrants alone "
          f"(engines {engines}): terrain vertex error on {len(q_err)} "
          f"interior vertices: mean {q_err.mean():.5f} q90 "
          f"{np.quantile(q_err, 0.9):.5f} max {q_err.max():.5f} (the JAX "
          f"package, CPU: mean {JAX_UDF_PRED_QUADRANT_ERR}; limit "
          f"{UDF_PRED_ERR_LIMIT:.5f})", flush=True)
    if engines != ["dense"] * 4:
        raise AssertionError(f"[phase 8] quadrant engines {engines}, not "
                             "the one-pass dense engine")
    if not q_err.mean() <= UDF_PRED_ERR_LIMIT:
        raise AssertionError(f"[phase 8] predicted quadrant terrain error "
                             f"mean {q_err.mean()} > {UDF_PRED_ERR_LIMIT}")
    torch.cuda.empty_cache()

    # the splat structure on the dense lattice, one lap
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "splat")
    launches = read_counts(counters)
    err, n_inner = terrain_error(mesh)
    print_lap("phase 8 splat", field, tr, tm, launches, mesh, err, n_inner,
              UDF_SPLAT_ERR_LIMIT)
    check_trim("phase 8 splat", field, mesh)
    check_dense_lattice("phase 8 splat", field, mesh, err,
                        UDF_SPLAT_ERR_LIMIT)
    check_lattice_launches("phase 8 splat", launches, field)
    del field, mesh
    torch.cuda.empty_cache()
    q_err = quadrant_error(recon, xyz, nrm, "splat")
    print(f"[phase 8 splat] the four 20 m quadrants alone: terrain vertex "
          f"error on {len(q_err)} interior vertices: mean {q_err.mean():.5f}"
          f" q90 {np.quantile(q_err, 0.9):.5f} max {q_err.max():.5f} (the "
          f"JAX package, CPU: mean {JAX_UDF_SPLAT_QUADRANT_ERR}; limit "
          f"{UDF_SPLAT_ERR_LIMIT:.5f})", flush=True)
    if not q_err.mean() <= UDF_SPLAT_ERR_LIMIT:
        raise AssertionError(f"[phase 8 splat] quadrant terrain error mean "
                             f"{q_err.mean()} > {UDF_SPLAT_ERR_LIMIT}")
    torch.cuda.empty_cache()

    # route A: the host mesher seals at the mask
    field, mesh, launches, lap = route_lap(recon, synthetic_scene, counters,
                                           30.0)
    print_route("phase 8 route A", launches, lap,
                UDF_ROUTE_A_ERR_LIMIT)
    print(f"[phase 8 route A] the seal: {lap['verts']} vertices against "
          f"phase 5's {a_lap['verts']} (UDF off), error mean "
          f"{lap['err_mean']:.5f} against {a_lap['err_mean']:.5f}",
          flush=True)
    if not (recon._last_unet_engine == "sparse"
            and field.lattice_ctx is not None and field.has_udf_mask
            and "host dual mc" in field.phase_times
            and "mc: udf support joins" in field.phase_times):
        raise AssertionError("[phase 8 route A] the 60 m tile did not take "
                             "route A, or its host mesher did not seal at "
                             "the UDF mask")
    check_lattice_launches("phase 8 route A", launches, field)
    print_mc_stages("phase 8 route A", field.phase_times, a_phases,
                    "UDF on / phase 5, UDF off")
    del field, mesh
    torch.cuda.empty_cache()

    # the tile's four central 20 m sub-tiles alone, on route A (the JAX
    # reference's configuration)
    from nksr_tpu_torch.meshing import lattice_mc as LMC
    from nksr_tpu_torch.recon import reconstructor as RC
    xyz, nrm = synthetic_scene(N_POINTS, half_extent=30.0)
    inner = (np.abs(xyz[:, 0]) < 20) & (np.abs(xyz[:, 1]) < 20)

    def sub_tile_lap(field, tr, tm):
        print(f"[phase 8 route A] sub-tile: reconstruct_s {tr:.3f} "
              f"extract_mesh_s {tm:.3f}", flush=True)
        if not (recon._last_unet_engine == "sparse"
                and field.lattice_ctx is not None
                and "mc: udf support joins" in field.phase_times):
            raise AssertionError("[phase 8 route A] a sub-tile left route "
                                 "A or the seal")

    budgets = RC.DENSE_UNET_CELLMAP_BUDGET, LMC.DENSE_CELL_BUDGET
    RC.DENSE_UNET_CELLMAP_BUDGET = LMC.DENSE_CELL_BUDGET = 0
    try:
        q_err = quadrant_error(recon, xyz[inner], nrm[inner], "splat",
                               sub_tile_lap)
    finally:
        RC.DENSE_UNET_CELLMAP_BUDGET, LMC.DENSE_CELL_BUDGET = budgets
    print(f"[phase 8 route A] the four central 20 m sub-tiles alone: "
          f"terrain vertex error on {len(q_err)} interior vertices: mean "
          f"{q_err.mean():.5f} q90 {np.quantile(q_err, 0.9):.5f} max "
          f"{q_err.max():.5f} (the JAX package, CPU: mean "
          f"{JAX_UDF_ROUTE_A_ERR}; limit {UDF_ROUTE_A_ERR_LIMIT:.5f})",
          flush=True)
    if not q_err.mean() <= UDF_ROUTE_A_ERR_LIMIT:
        raise AssertionError(f"[phase 8 route A] sub-tile terrain error "
                             f"mean {q_err.mean()} > {UDF_ROUTE_A_ERR_LIMIT}")
    torch.cuda.empty_cache()
    return udf_launches


def chunked_lap(recon, xyz, sensor, chunk_size, pre):
    """The lidar recipe once: reconstruct(xyz, sensor=, chunk_size=,
    preprocess_fn=) and extract_dual_mesh(mise_iter=1); (t_recon, t_mesh,
    chunked field, mesh)."""
    t0 = time.perf_counter()
    cf = recon.reconstruct(xyz, sensor=sensor, chunk_size=chunk_size,
                           preprocess_fn=pre)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mesh = cf.extract_dual_mesh(mise_iter=1)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, cf, mesh


def chunk_alphas(cf):
    return [a.clone() for ch in cf.chunks for a in ch["field"].alpha]


def check_knn(K, xyz, seed: int):
    """The card's neighbour sets against the same function on CPU
    tensors at KNN_CHECK_QUERIES seeded queries (buckets over every
    point): equal as sets, squared distances bit-equal."""
    q = np.random.default_rng(seed).choice(len(xyz), KNN_CHECK_QUERIES,
                                           replace=False)
    cs = K.estimate_cell_size(xyz, KNN)
    m = max(2 * KNN // 9, 8)
    out = []
    for dev in ("cuda", "cpu"):
        x = torch.as_tensor(xyz, device=dev)
        idx, d2 = K.knn_search(K.build_buckets(x, cs, m), x, x[q], KNN)
        out.append((torch.sort(idx, 1).values.cpu(), d2.cpu()))
    (gi, gd), (ci, cd) = out
    same_sets = torch.equal(gi, ci)
    d2_err = float((gd - cd).abs().max())
    print(f"[phase 9] kNN on the card against CPU tensors at "
          f"{KNN_CHECK_QUERIES} seeded queries (k {KNN}, cell {cs:.4f} m, "
          f"{m} per cell): neighbour sets "
          f"{'equal' if same_sets else 'DIFFER'}, d2 max abs diff "
          f"{d2_err:.3e}", flush=True)
    if not (same_sets and d2_err == 0.0):
        raise AssertionError("[phase 9] the card's kNN differs from its "
                             "CPU run")


def chunked_laps(recon, counters, synthetic_scene):
    """Phase 9.  ``recon`` runs the checkpoint under its own config.yaml
    (UDF on, bf16 convs).  The README's lidar recipe on the 40 m tile
    without its normals, a sensor at (0, 0, SENSOR_Z) for every point:
    (a) the normal estimation on the card (kept share, angle to the
    analytic normals, time by stage; the kNN against its CPU run); (b)
    the four 20 m quadrants alone with chunk_size=10.0 under 1.5x the
    JAX package's error there, one quadrant twice bit-equal; (c) the
    whole tile with chunk_size=20.0: four chunks, parked on the CPU
    after the solve, on the card for the mesh, the dense forward once
    per chunk (the evaluator's tables, built at the mesh), under the
    same gate.  Returns the launches of (c)."""
    from nksr_tpu_torch import get_estimate_normal_preprocess_fn
    from nksr_tpu_torch.ops import knn as K
    from nksr_tpu_torch.utils.scenes import terrain_normals
    xyz, _ = synthetic_scene(N_POINTS)
    sensor = np.zeros_like(xyz)
    sensor[:, 2] = SENSOR_Z
    pre = get_estimate_normal_preprocess_fn(KNN, MAX_ANGLE,
                                            device=recon.device)

    # (a) the preprocess on the whole tile (a warm-up call, then a timed
    # one), and the kNN on the card against its CPU run
    pre(xyz, None, sensor)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xk, nk, _ = pre(xyz, None, sensor)
    pre_s = time.perf_counter() - t0
    dot = np.clip((nk * terrain_normals(xk[:, :2])).sum(1), -1, 1)
    ang = np.degrees(np.arccos(dot))
    print(f"[phase 9] normal estimation (k {KNN}, {MAX_ANGLE} degrees) on "
          f"{N_POINTS} points: {pre_s:.3f} s, by stage "
          + json.dumps({k: round(v, 4) for k, v in pre.phase_times.items()})
          + f"; kept {len(xk)} ({len(xk) / N_POINTS:.4%}); angle to the "
          f"analytic normals mean {ang.mean():.3f} q90 "
          f"{np.quantile(ang, 0.9):.3f} max {ang.max():.3f} degrees, "
          f"{int((dot < 0).sum())} facing away; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    if not (0.5 < len(xk) / N_POINTS <= 1.0 and ang.mean() < 10.0):
        raise AssertionError("[phase 9] the estimated normals are off")
    check_knn(K, xyz, seed=9)
    torch.cuda.empty_cache()

    # (b) the quadrants alone, chunk_size=10.0
    laps = []

    def quadrant_lap(x, s):
        out = chunked_lap(recon, x, s, 10.0, pre)
        if not laps:        # the first quadrant, run again below
            laps.append((out[2], out[3]))
        return out

    def on_lap(cf, tr, tm):
        print(f"[phase 9] quadrant: {len(cf.chunks)} chunks "
              f"{[ch['engine'] for ch in cf.chunks]}, reconstruct_s "
              f"{tr:.3f} extract_mesh_s {tm:.3f}", flush=True)

    q_err = quadrant_error(recon, xyz, sensor, on_lap=on_lap,
                           lap=quadrant_lap)
    print(f"[phase 9] the four 20 m quadrants alone, chunk_size 10: terrain "
          f"vertex error on {len(q_err)} interior vertices: mean "
          f"{q_err.mean():.5f} q90 {np.quantile(q_err, 0.9):.5f} max "
          f"{q_err.max():.5f} (the JAX package, CPU: mean "
          f"{JAX_CHUNKED_QUADRANT_ERR}; limit {CHUNKED_ERR_LIMIT:.5f})",
          flush=True)
    if not q_err.mean() <= CHUNKED_ERR_LIMIT:
        raise AssertionError(f"[phase 9] quadrant terrain error mean "
                             f"{q_err.mean()} > {CHUNKED_ERR_LIMIT}")
    cf, mesh = laps[0]
    first = (chunk_alphas(cf), mesh.v, mesh.f)
    del laps, cf, mesh
    m = (np.sign(xyz[:, 0]) == -1) & (np.sign(xyz[:, 1]) == -1)
    _, _, cf, mesh = chunked_lap(recon, xyz[m], sensor[m], 10.0, pre)
    same = lap_diff(first, (chunk_alphas(cf), mesh.v, mesh.f))
    print("[phase 9] one quadrant twice: " + same, flush=True)
    if "coefficients bit-equal" not in same or "mesh bit-equal" not in same:
        raise AssertionError("[phase 9] one quadrant twice is not "
                             "bit-equal: " + same)
    del first, cf, mesh
    torch.cuda.empty_cache()

    # (c) the whole tile in 20 m chunks
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    t0 = time.perf_counter()
    cf = recon.reconstruct(xyz, sensor=sensor, chunk_size=20.0,
                           preprocess_fn=pre)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solve_launches = read_counts(counters)
    parked = [ch["field"].device.type for ch in cf.chunks]
    mesh = cf.extract_dual_mesh(mise_iter=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    on_card = [(ch["field"].device.type,
                ch["field"].lattice_ctx.tables().av0.device.type)
               for ch in cf.chunks]
    err, n_inner = terrain_error(mesh)
    n = len(cf.chunks)
    iters = [ch["field"].solver_stats.iters for ch in cf.chunks]
    for ch in cf.chunks:
        print(f"[phase 9] chunk {ch['cid'].tolist()}: {ch['n_points']} "
              f"points (halo included), engine {ch['engine']}, "
              f"{ch['seconds']:.3f} s, {ch['field'].solver_stats}, phases "
              + json.dumps({k: round(v, 4)
                            for k, v in ch["field"].phase_times.items()}),
              flush=True)
    pre_s = sum(pre.phase_times.values())
    print(f"[phase 9] the lidar recipe on the 40 m tile, chunk_size 20: "
          f"{n} chunks; preprocess_s {pre_s:.3f} reconstruct_s "
          f"{t1 - t0:.3f} (the preprocess included) extract_mesh_s "
          f"{t2 - t1:.3f}; mesh verts {len(mesh.v)} faces {len(mesh.f)}; "
          f"peak memory {peak:.2f} GiB; stages (chunks: the solves' host "
          f"orchestration; mc: the host mesher) "
          + json.dumps({k: round(v, 4) for k, v in cf.phase_times.items()}),
          flush=True)
    print(f"[phase 9] launches: after reconstruct {solve_launches}, after "
          f"the mesh {launches}; chunks after reconstruct on {parked}, "
          f"after the mesh (field, evaluator table) on {on_card}",
          flush=True)
    print(f"[phase 9] terrain vertex error on {n_inner} interior vertices: "
          f"mean {err.mean():.5f} q90 {np.quantile(err, 0.9):.5f} max "
          f"{err.max():.5f} (limit {CHUNKED_ERR_LIMIT:.5f})", flush=True)
    if n != 4:
        raise AssertionError(f"[phase 9] {n} chunks, not 4")
    if parked != ["cpu"] * n:
        raise AssertionError(f"[phase 9] chunks not parked on the CPU after "
                             f"the solve: {parked}")
    if on_card != [("cuda", "cuda")] * n:
        raise AssertionError(f"[phase 9] chunks not on the card for the "
                             f"mesh: {on_card}")
    want = {"fwd": n, "rows": sum(iters), "adj_rows": sum(iters) + 2 * n,
            "adj": 0}
    if solve_launches["fwd"] != 0 or \
            {k: launches[k] for k in want} != want:
        raise AssertionError(f"[phase 9] launches {launches} (after the "
                             f"solves {solve_launches}): expected {want}, "
                             "the dense forward only at the mesh")
    if not len(mesh.f) or not np.isfinite(mesh.v).all():
        raise AssertionError("[phase 9] empty or non-finite mesh")
    if not err.mean() <= CHUNKED_ERR_LIMIT:
        raise AssertionError(f"[phase 9] terrain error mean {err.mean()} > "
                             f"{CHUNKED_ERR_LIMIT}")
    del cf, mesh
    torch.cuda.empty_cache()
    return launches


def sphere_points(n: int, r: float, seed: int):
    """n points on a sphere of radius r and their normals
    (tests/test_field.py)."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (r * v).astype(np.float32), v.astype(np.float32)


def bf16_ulps(a, b) -> float:
    """Largest |a - b| in units of the bf16 spacing at max(|a|, |b|)
    (2^-7 of its power of two); 0 where both are zero."""
    m = torch.maximum(a.abs(), b.abs())
    spacing = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7),
                          1.0)
    return float(((a - b).abs() / spacing).max())


def compare_gram_middle(spec, cells, kept, gen):
    """The dual matvec's middle C C^T on random f32 slot rows at the
    plan's slot cells ``cells`` (zero, and dropped, where ``kept`` is
    -1): the slot-row middle (``lattice.gram_middle``: the slot-row
    adjoint in f32, then the slot rows in bf16) against the literal one
    of the JAX package's ``_gram_middle`` (the segment sum into the dense
    f32 buffer, the dense adjoint in f32, the dense forward in bf16, the
    rows at the slot cells): within one bf16 ulp, the slot-row middle
    bit-equal from call to call; both timed in turns by CUDA events.  The
    bound adds the slot-row adjoint's (the kept rows and their order
    read, the coefficients written, each value added once) and the slot
    rows' (``rows_bound``)."""
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK
    from nksr_tpu_torch.ops import segment_sum as SEG
    r = cells.numel()
    y = torch.randn((r, spec.lanes), device=cells.device, generator=gen) \
        * (kept >= 0)[:, None]
    tab = LK.adjoint_rows_tables(spec, kept)
    order = SEG.segment_order(kept, spec.n_cells(0))
    bf, cl = torch.bfloat16, cells.long()

    def slot_row():
        return LAT.gram_middle(spec, tab, y, cells, bf)

    def literal():
        xs = LK.av0_adjoint_cascade(spec, SEG.segment_sum(y, order),
                                    torch.float32)
        return LK.av0_cascade(spec, xs, bf).index_select(0, cl).float()

    got, again, lit = slot_row(), slot_row(), literal()
    if not torch.equal(got, again):
        raise AssertionError("[phase 10] the slot-row middle: two calls "
                             "differ")
    out = {"ulps": bf16_ulps(got, lit),
           "bit_equal": torch.equal(got + 0.0, lit + 0.0),
           "err": float((got - lit).abs().max())}
    del got, again, lit
    if not out["ulps"] <= 1.0:
        raise AssertionError(f"[phase 10] the slot-row middle differs from "
                             f"the literal one by {out['ulps']} bf16 ulps")
    l1 = cuda_ms(literal, 3)
    s1 = cuda_ms(slot_row, 10)
    s2 = cuda_ms(slot_row, 10)
    l2 = cuda_ms(literal, 3)
    plain = cuda_ms(lambda: LK.av0_rows_plain(
        spec, LK.av0_adjoint_rows_plain(spec, tab, y, torch.float32),
        cells, bf), 1)
    coef = sum(spec.n_cells(d) for d in range(spec.depth)) * spec.k * 4
    n_kept = tab.perm.numel()
    adj_b, _ = bound_ms(n_kept * spec.lanes * 4 + n_kept * 4 + coef,
                        (n_kept + tab.cells.numel()) * spec.lanes)
    rows_b, _ = rows_bound(spec, cells)
    out.update(ms=min(s1, s2), ms_turns=(s1, s2), literal_ms=min(l1, l2),
               literal_turns=(l1, l2), plain_ms=plain, bound=adj_b + rows_b)
    return out


def converged_parity():
    """Phase 10 (c).  The converged dual on tests/test_torch_dual.py's
    sphere: f32 rows on the card and the same call on CPU tensors, both
    converged, the card's field values at the probes within PARITY_BOUND
    of the largest |f| of the CPU's; the bf16 rows' run on the card
    beside them (printed, not gated)."""
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.models import pipeline as P
    cfg = PipelineConfig(**PARITY_CFG, solver_compute_dtype="float32")
    params = P.init_params(cfg, 0)
    xyz, nrm = sphere_points(1200, 0.5, 3)
    probe = sphere_points(150, 0.45, 4)[0]
    runs = {}
    for tag, dev, c in (("card f32", "cuda", cfg), ("cpu f32", "cpu", cfg),
                        ("card bf16", "cuda", dataclasses.replace(
                            cfg, solver_compute_dtype="bfloat16"))):
        t0 = time.perf_counter()
        f = Reconstructor(device=dev, config=c, params=params).reconstruct(
            xyz, nrm, **PARITY_KW)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[tag] = (f.solver_stats, f.evaluate_f(probe).value,
                     time.perf_counter() - t0)
        print(f"[phase 10] converged parity, {tag}: {f.solver_stats} in "
              f"{runs[tag][2]:.3f} s", flush=True)
    (card, cv, _), (cpu, pv, _), (_, bv, _) = (runs["card f32"],
                                                runs["cpu f32"],
                                                runs["card bf16"])
    scale = float(np.abs(pv).max())
    rel = float(np.abs(cv - pv).max()) / scale
    print(f"[phase 10] converged parity: card f32 against CPU tensors, "
          f"field values at {len(probe)} probes max diff {rel:.3e} of max "
          f"|f| {scale:.4f} (bound {PARITY_BOUND}); card bf16 against them "
          f"{float(np.abs(bv - pv).max()) / scale:.3e}", flush=True)
    if not (card.converged and cpu.converged):
        raise AssertionError(f"[phase 10] the f32 dual did not converge: "
                             f"card {card}, CPU {cpu}")
    if not rel < PARITY_BOUND:
        raise AssertionError(f"[phase 10] card and CPU fields differ by "
                             f"{rel} of max |f|")
    return runs


def dual_laps(params, xyz, nrm, counters, spec, cells, kept, gen,
              primal_mv_ms):
    """Phase 10.  The dual formulation on the card: (a) its middle at the
    40 m plan's slot cells against the literal one; (b) the 40 m splat
    tile (phase 3's checkpoint and bf16 convs, DUAL_KW): a warm-up lap and
    two timed laps, bit-equal, the dual's launches, the terrain error of
    the tile and of its four quadrants alone under DUAL_ERR_LIMIT, and one
    dual matvec under torch.profiler; (c) the converged parity; (d) one
    predicted lap (per-level engine) with the dual; (e) the primal
    against the dual at equal budgets (``scripts.compare_formulations``).
    Returns the launches of (b) and (d) and the middle's record."""
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.scripts import compare_formulations as CF
    mid = compare_gram_middle(spec, cells, kept, gen)
    print(f"[phase 10] (a) the dual's middle C C^T at the main path's "
          f"{cells.numel()} slot cells: slot-row middle (adjoint f32 + slot "
          f"rows bf16) against the literal one (segment sum + dense adjoint "
          f"f32 + dense forward bf16 + row gather): "
          f"{'bit-equal' if mid['bit_equal'] else 'differs'}, max "
          f"{mid['ulps']:.2f} bf16 ulps (abs {mid['err']:.3e}), bit-equal "
          f"call to call; {mid['ms']:.4f} ms (turns {mid['ms_turns'][0]:.4f},"
          f" {mid['ms_turns'][1]:.4f}; bound {mid['bound']:.4f}; plain "
          f"{mid['plain_ms']:.3f}) against "
          f"{mid['literal_ms']:.4f} ms (turns {mid['literal_turns'][0]:.4f}, "
          f"{mid['literal_turns'][1]:.4f}); one primal matvec (phase 3) "
          f"{primal_mv_ms:.4f} ms", flush=True)
    torch.cuda.empty_cache()

    recon = Reconstructor(config=PipelineConfig(
        conv_dtype="bfloat16", solver_formulation="dual"), params=params)
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "splat", DUAL_KW)
    print(f"[phase 10] (b) dual warm-up lap: reconstruct_s {tr:.3f} "
          f"extract_mesh_s {tm:.3f}", flush=True)
    del field, mesh
    laps, lap_out = [], []
    for _ in range(2):
        field = mesh = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "splat", DUAL_KW)
        launches = read_counts(counters)
        laps.append((tr, tm))
        lap_out.append(([a.clone() for a in field.alpha], mesh.v, mesh.f))
        err, n_inner = terrain_error(mesh)
        print_lap("phase 10", field, tr, tm, launches, mesh, err, n_inner,
                  DUAL_ERR_LIMIT)
    tr, tm = min(t[0] for t in laps), min(t[1] for t in laps)
    print(f"[phase 10] (b) dual splat, {N_POINTS} points: reconstruct_s "
          f"{tr:.3f} extract_mesh_s {tm:.3f} pts/s {N_POINTS / (tr + tm):.1f};"
          f" {field.solver_stats}", flush=True)
    same = lap_diff(*lap_out)
    print("[phase 10] (b) the two dual laps on one input: " + same,
          flush=True)
    del lap_out
    if "coefficients bit-equal" not in same or "mesh bit-equal" not in same:
        raise AssertionError("[phase 10] two dual laps on one input are not "
                             "bit-equal: " + same)
    check_dense_lattice("phase 10", field, mesh, err, DUAL_ERR_LIMIT)
    check_lattice_launches("phase 10", launches, field, dual=True)
    dual_launches = launches
    del field, mesh
    torch.cuda.empty_cache()
    q_err = quadrant_error(recon, xyz, nrm, lap=lambda x, n: main_path_lap(
        recon, x, n, "splat", DUAL_KW))
    print(f"[phase 10] (b) dual, the four 20 m quadrants alone: terrain "
          f"vertex error on {len(q_err)} interior vertices: mean "
          f"{q_err.mean():.5f} q90 {np.quantile(q_err, 0.9):.5f} max "
          f"{q_err.max():.5f} (the JAX package, CPU: mean "
          f"{JAX_DUAL_QUADRANT_ERR}; limit {DUAL_ERR_LIMIT:.5f})", flush=True)
    if not q_err.mean() <= DUAL_ERR_LIMIT:
        raise AssertionError(f"[phase 10] dual quadrant terrain error mean "
                             f"{q_err.mean()} > {DUAL_ERR_LIMIT}")
    torch.cuda.empty_cache()
    rows, dev_ms, ev_ms = profile_matvec(LAT, recon, xyz, nrm)
    print(f"[phase 10] (b) profiled dual matvec: device total {dev_ms:.3f} ms"
          f" (CUDA events {ev_ms:.3f} ms a matvec; the primal's "
          f"{primal_mv_ms:.3f}); top ten: "
          + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                      for t, name, n in rows[:10]), flush=True)
    torch.cuda.empty_cache()

    converged_parity()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    tr, tm, field, mesh = main_path_lap(recon, xyz, nrm, "predicted", DUAL_KW)
    pred_launches = read_counts(counters)
    err, n_inner = terrain_error(mesh)
    print(f"[phase 10] (d) one dual predicted lap on the "
          f"{recon._last_pred_engine} engine: reconstruct_s {tr:.3f} "
          f"extract_mesh_s {tm:.3f}; {field.solver_stats}; launches "
          f"{pred_launches}; terrain error mean {err.mean():.5f} on "
          f"{n_inner} interior vertices", flush=True)
    if recon._last_pred_engine != "host-per-level":
        raise AssertionError("[phase 10] the dual predicted lap took the "
                             f"{recon._last_pred_engine!r} engine")
    check_dense_lattice("phase 10 predicted", field, mesh, err, np.inf)
    check_lattice_launches("phase 10 predicted", pred_launches, field,
                           dual=True)
    del field, mesh, recon
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cf_rows = CF.run("cuda", log=lambda m: print("[phase 10] (e) " + m,
                                                 flush=True))
    print(f"[phase 10] (e) compare_formulations: {len(cf_rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not all(r["verts"] > 0 and np.isfinite(r["vert_err"])
               for r in cf_rows):
        raise AssertionError("[phase 10] compare_formulations gave an empty "
                             "or non-finite mesh")
    torch.cuda.empty_cache()
    return dual_launches, pred_launches, mid



# ------------------------------------------------------ phase 11: training
def _grads(net):
    """Each parameter's gradient on the CPU, zeros where no loss reaches
    it."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().cpu() for n, p in net.named_parameters()}


def train_grads(cfg, lcfg, params, batch, samples, device,
                use_gt_structure=True):
    """The port's loss and gradients of one step from the flax-layout
    ``params`` on ``device``, teacher-forced or on the predicted
    structure: (losses, grads, forward output moved to the CPU, (forward,
    backward) solve stats, peak GiB).  With ``samples`` None the draws
    come from a CPU generator seeded TRAIN_PRED_SEED on the forward's
    decoder hierarchy, and the forward output holds them with both
    hierarchies' keys."""
    from nksr_tpu_torch.models import pipeline as P
    from nksr_tpu_torch.models.network import NKSRNetwork
    from nksr_tpu_torch.solver.pcg import solve_spd
    from nksr_tpu_torch.train import loop as T
    from nksr_tpu_torch.train import losses as L
    from nksr_tpu_torch.utils.checkpoint import params_to_torch
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = NKSRNetwork(cfg)
    net.load_state_dict(params_to_torch(params), strict=True)
    net = net.to(device)
    inp = P.prepare_inputs(cfg, batch, device, use_gt_structure)
    gen = torch.Generator().manual_seed(TRAIN_PRED_SEED)
    losses, _, out = T.loss_and_grads(cfg, lcfg, net, inp, samples,
                                      use_gt_structure=use_gt_structure,
                                      gen=gen)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else 0.0
    fwd = {"logits": [x.detach().cpu() for x in out.structure_logits],
           "basis": [x.detach().cpu() for x in out.basis_features]}
    if samples is None:
        fwd["samples"] = L.draw_samples(
            torch.Generator().manual_seed(TRAIN_PRED_SEED), cfg, lcfg, inp,
            out.dec_grids)
        fwd["cand"] = [g.keys for g in out.cand_grids]
        fwd["dec"] = [g.keys for g in out.dec_grids]
    return ({k: float(v.detach()) for k, v in losses.items()}, _grads(net),
            fwd, (getattr(out.field, "cg_stats", None),
                  solve_spd.last_backward_stats), peak)


def compare_train(tag, card, cpu, gate_losses, loss_rtol, leaf_rtol,
                  unet_tol, struct_rtol, whole_rtol=None, phase="phase 11"):
    """Card against CPU for one step: the UNet's structure logits and
    basis features within ``unet_tol`` of their largest magnitude and the
    structure losses within ``struct_rtol`` (always gated); every loss
    term within ``loss_rtol``, each gradient leaf within ``leaf_rtol``
    relative L2 and, where ``whole_rtol`` is given, all leaves at once
    within it; gated when ``gate_losses``.  Returns the worst of each."""
    cl, cg, cf, _, _ = card
    pl, pg, pf, _, _ = cpu
    unet = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for key in ("logits", "basis")
               for a, b in zip(cf[key], pf[key]))
    struct = max(abs(cl[k] - pl[k]) / abs(pl[k]) for k in pl
                 if k.startswith("struct-"))
    loss = max((abs(cl[k] - pl[k]) / max(abs(pl[k]), 1e-30), k) for k in pl)
    grad = max((float(torch.linalg.norm(cg[n] - pg[n]))
                / max(float(torch.linalg.norm(pg[n])), 1e-30), n)
               for n in pg if float(torch.linalg.norm(pg[n])) > 0)
    whole = float(torch.sqrt(sum(((cg[n] - pg[n]) ** 2).sum() for n in pg))
                  / torch.sqrt(sum((pg[n] ** 2).sum() for n in pg)))
    print(f"[{phase}] {tag}: card against CPU: UNet outputs {unet:.3e} of "
          f"max (gate {unet_tol}), structure losses {struct:.3e} rel (gate "
          f"{struct_rtol}), loss terms worst {loss[0]:.3e} ({loss[1]}), "
          f"gradient leaves worst {grad[0]:.3e} rel L2 ({grad[1]}), the "
          f"whole gradient {whole:.3e} rel L2"
          + ((f" (gates: loss terms {loss_rtol}, each leaf {leaf_rtol}"
              + ("" if whole_rtol is None
                 else f", the whole gradient {whole_rtol}") + ")")
             if gate_losses else " (reported, not gated)"), flush=True)
    if not (unet <= unet_tol and struct <= struct_rtol):
        raise AssertionError(f"[{phase}] {tag}: UNet outputs or structure "
                             "losses differ between card and CPU")
    if gate_losses and not (loss[0] <= loss_rtol and grad[0] <= leaf_rtol
                            and (whole_rtol is None
                                 or whole <= whole_rtol)):
        raise AssertionError(f"[{phase}] {tag}: loss terms or gradients "
                             "differ between card and CPU")
    return {"unet": unet, "struct": struct, "loss": loss[0],
            "grad": grad[0], "whole_grad": whole}


def compare_train_backwards(SEG, gs, inp, f_maps: int, gen):
    """Phase 11 (a): the two backwards of the training step on the card
    at its shapes, against their plain versions on CPU copies, bit-equal
    and bit-equal call to call, timed.  The gather's backward (the depth-0
    conv gather: n0 x 27 rows of f_maps onto n0 + 1 rows) is the
    fixed-order segment sum over the order of its index table, sorted on
    the table's first backward and reused after; the segment sum's
    backward (the encoder splat: N x 8 rows of 7 from n0 rows) is a row
    gather."""
    n0 = inp.n_vox[0]
    raw = inp.enc_tables.nbr[0][:n0].reshape(-1)
    idx = torch.where(raw >= 0, raw, n0)
    cot = torch.randn((idx.numel(), f_maps), device="cuda", generator=gen)

    def gather_bwd(dev):
        # as gather_conv calls it: absent neighbours read the zero row n0
        # and drop out of the backward's order
        src = torch.zeros((n0 + 1, f_maps), device=dev, requires_grad=True)
        out = gs.gather_rows(src, idx.to(dev), order_idx=raw.to(dev))
        return torch.autograd.grad(out, src, cot.to(dev))[0][:n0]

    def gather_ref():
        # autograd of CPU index_select: index_add_ in index order
        src = torch.zeros((n0 + 1, f_maps), requires_grad=True)
        out = src.index_select(0, idx.cpu())
        return torch.autograd.grad(out, src, cot.cpu())[0][:n0]

    got, again = gather_bwd("cuda"), gather_bwd("cuda")
    ref = gather_ref()
    if not (torch.equal(got.cpu(), ref) and torch.equal(got, again)):
        raise AssertionError("[phase 11] the gather's backward differs from "
                             "CPU index_add_ or between calls")
    keep = raw >= 0
    kc, kr = cot[keep].contiguous(), raw[keep]
    order = SEG.segment_order(raw, n0 + 1)

    def kernel():
        # the backward's sum as a step runs it, the table sorted already
        return SEG.segment_sum(cot, gs._backward_order(raw, n0 + 1))

    def plain():
        return SEG.segment_sum_plain(cot, order)

    def library():
        return torch.zeros((n0 + 1, f_maps), device="cuda").index_add_(
            0, kr, kc)
    k1, p1, l1 = cuda_ms(kernel, 10), cuda_ms(plain, 10), cuda_ms(library, 10)
    k2, p2, l2 = cuda_ms(kernel, 10), cuda_ms(plain, 10), cuda_ms(library, 10)
    r, rk = idx.numel(), int(keep.sum())
    gather = {"rows": r, "kept": rk, "cols": f_maps, "targets": n0 + 1,
              "ms": min(k1, k2), "plain_ms": min(p1, p2),
              "library_ms": min(l1, l2),
              "order_ms": cuda_ms(lambda: SEG.segment_order(raw, n0 + 1), 10),
              "sum_ms": cuda_ms(lambda: SEG.segment_sum(cot, order), 10),
              "bound": bound_ms(rk * f_maps * 4 + r * 8
                                + (n0 + 1) * f_maps * 4, rk * f_maps)}

    sidx = inp.splat_idx.reshape(-1)
    sorder = SEG.segment_order(sidx, n0)
    corder = SEG.segment_order(sidx.cpu(), n0)
    vals = torch.randn((sidx.numel(), 7), device="cuda", generator=gen)
    scot = torch.randn((n0, 7), device="cuda", generator=gen)

    def seg_bwd(v, o, c):
        v = v.clone().requires_grad_()
        return torch.autograd.grad(SEG.segment_sum(v, o), v, c)[0]
    sgot = seg_bwd(vals, sorder, scot)
    sref = seg_bwd(vals.cpu(), corder, scot.cpu())
    if not (torch.equal(sgot.cpu(), sref)
            and torch.equal(sgot, seg_bwd(vals, sorder, scot))):
        raise AssertionError("[phase 11] the segment sum's backward differs "
                             "from its CPU run or between calls")
    sv = vals.clone().requires_grad_()
    sout = SEG.segment_sum(sv, sorder)

    def seg_backward():
        return torch.autograd.grad(sout, sv, scot, retain_graph=True)[0]
    keep = sidx >= 0

    def seg_library():
        return torch.where(keep[:, None],
                           scot.index_select(0, sidx.clamp(min=0)), 0.0)
    rs = sidx.numel()
    seg = {"rows": rs, "ms": min(cuda_ms(seg_backward, 10),
                                 cuda_ms(seg_backward, 10)),
           "plain_ms": min(cuda_ms(seg_library, 10),
                           cuda_ms(seg_library, 10)),
           "bound": bound_ms(n0 * 7 * 4 + rs * 8 + rs * 7 * 4, 0)}
    print(f"[phase 11] (a) the gather's backward at the depth-0 conv "
          f"({r} rows x {f_maps}, {rk} of them present, onto {n0}): "
          f"bit-equal to CPU index_add_ and call to call; the backward's "
          f"sum over its table's kept order {gather['ms']:.4f} ms (the "
          f"order given {gather['sum_ms']:.4f}; the sort, once a table, "
          f"{gather['order_ms']:.4f}; plain, the order given, "
          f"{gather['plain_ms']:.4f}; index_add_ {gather['library_ms']:.4f}"
          f"; bound {gather['bound'][0]:.4f} by {gather['bound'][1]}); "
          f"the segment sum's backward at the encoder splat ({rs} rows x 7 "
          f"from {n0}): bit-equal to its CPU run and call to call, "
          f"{seg['ms']:.4f} ms (the gather alone {seg['plain_ms']:.4f}; "
          f"bound {seg['bound'][0]:.4f} by {seg['bound'][1]})", flush=True)
    return gather, seg


def solve_spd_parity(ref):
    """Phase 11 (b): the implicit solve's gradient on the card against its
    CPU run.  A small f64 system (x = A(w)^-1 b, gradients of sum(x * r)
    wrt b and w) within 1e-9; then one teacher-forced step on
    tests/test_train.py's sphere and configuration with the solve raised
    to convergence, card against CPU (the port's seeded weights and one
    set of draws; the CPU side from ``ref``, the CPU reference's
    results)."""
    from nksr_tpu_torch.solver.pcg import solve_spd
    g = np.random.default_rng(3)
    c, w, b = g.normal(size=(30, 12)), g.uniform(0.5, 2.0, 30), \
        g.normal(size=12)
    r = g.normal(size=12)
    res = []
    for dev in ("cuda", "cpu"):
        ct = torch.tensor(c, device=dev)
        bt = torch.tensor(b, device=dev, requires_grad=True)
        wt = torch.tensor(w, device=dev, requires_grad=True)
        x = solve_spd(lambda a, ww: (ct.T @ (ww * (ct @ a[0])) + a[0],),
                      (bt,), (wt,), tol=1e-14, max_iters=200)[0]
        (x * torch.tensor(r, device=dev)).sum().backward()
        res.append(torch.cat([bt.grad, wt.grad]).cpu())
    small = float((res[0] - res[1]).abs().max() / res[1].abs().max())
    print(f"[phase 11] (b) solve_spd on an f64 system: card gradients "
          f"within {small:.3e} of the CPU's (gate 1e-9)", flush=True)
    if not small <= 1e-9:
        raise AssertionError("[phase 11] solve_spd's f64 gradients differ")
    cfg, lcfg, params, batch, samples = sphere_train_setup()
    if not all(torch.equal(samples[k], ref["sphere_samples"][k])
               for k in samples):
        raise AssertionError("[phase 11] the sphere's draws differ from "
                             "the CPU reference's")
    runs = {"cuda": train_grads(cfg, lcfg, params, batch, samples, "cuda"),
            "cpu": ref["sphere"]}
    for dev, run in runs.items():
        (fi, fr), (bi, br) = run[3]
        print(f"[phase 11] (b) sphere step on {dev}: forward solve {fi} "
              f"iterations rel_res {fr:.3e}, backward {bi} rel_res "
              f"{br:.3e}", flush=True)
        if not (fr < cfg.solver_tol and br < cfg.solver_tol):
            raise AssertionError(f"[phase 11] the sphere's solves did not "
                                 f"converge on {dev}")
    return compare_train("(b) sphere step, converged", runs["cuda"],
                         runs["cpu"], True, TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL,
                         TRAIN_UNET_TOL, TRAIN_STRUCT_RTOL)


def sphere_train_setup():
    """tests/test_train.py's sphere batch and configuration (the solve
    raised to convergence), the port's seeded weights and one set of
    draws (CPU generator seed 1)."""
    from nksr_tpu_torch.models import pipeline as P
    from nksr_tpu_torch.train import losses as L
    cfg = P.PipelineConfig(**SPHERE_TRAIN_CFG)
    lcfg = L.LossConfig(
        spatial_samplers=(L.SamplerConfig("uniform", 2048, 1, 3),
                          L.SamplerConfig("band", 2048)),
        udf_samplers=(L.SamplerConfig("uniform", 1024, 1, 3),
                      L.SamplerConfig("band", 512)),
        **SPHERE_TRAIN_LOSS)
    xyz, nrm = sphere_points(800, 0.5, 0)
    m = torch.from_numpy(np.arange(1024) < 800)
    pad = lambda a: torch.from_numpy(np.pad(a, ((0, 224), (0, 0))))
    batch = {"xyz": pad(xyz), "normal": pad(nrm), "mask": m,
             "gt_xyz": pad(xyz), "gt_normal": pad(nrm), "gt_mask": m}
    samples = L.draw_samples(torch.Generator().manual_seed(1), cfg, lcfg,
                             P.prepare_inputs(cfg, batch, "cpu"))
    return cfg, lcfg, P.init_params(cfg, 0), batch, samples


def scene_train_setup():
    """runs/scene_big/config.yaml's configurations, the corpus' train and
    val sets, item 0's padded batch and one set of draws for it (CPU
    generator seed 0)."""
    from nksr_tpu_torch.data import (DatasetSpec as DS, ShapeNetDataset,
                                     to_device_batch)
    from nksr_tpu_torch.models import pipeline as P
    from nksr_tpu_torch.train import driver
    from nksr_tpu_torch.train import losses as L
    from nksr_tpu_torch.utils.config import load_config
    yc = load_config(os.path.join(REPO, UDF_CONFIG))
    cfg = driver.pipeline_config_from_yaml(yc)
    lcfg = driver.loss_config_from_yaml(yc)
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    args = dict(yc["train_dataset"]["args"], root=os.path.join(REPO,
                                                                TRAIN_ROOT))
    ds = ShapeNetDataset(spec=spec, **args)
    val_ds = ShapeNetDataset(spec=spec, **dict(args, split="val"))
    batch = to_device_batch(ds[0], yc["point_bucket"], yc["gt_bucket"])
    inp = P.prepare_inputs(cfg, batch, "cpu")
    samples = L.draw_samples(torch.Generator().manual_seed(0), cfg, lcfg,
                             inp)
    return yc, cfg, lcfg, ds, val_ds, batch, samples, inp


def train_cpu_reference(out_path: str) -> int:
    """Phase 11's CPU side, run in its own process (``python3
    chip_smoke.py --train-cpu-reference OUT``): the sphere step, the
    scene step (at 16 iterations and with the solve to convergence) and
    the scene's predicted step at 16 iterations on CPU tensors, and
    phase 13's CPU side (``neural_cpu_reference``), saved to
    ``out_path`` with their draws."""
    from nksr_tpu_torch.utils.checkpoint import load_tree
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > TRAIN_REF_THREADS:
        os.sched_setaffinity(0, cores[-TRAIN_REF_THREADS:])
    torch.set_num_threads(TRAIN_REF_THREADS)
    t0 = time.perf_counter()
    res = {}
    cfg, lcfg, sp, batch, samples = sphere_train_setup()
    res["sphere"] = train_grads(cfg, lcfg, sp, batch, samples, "cpu")
    res["sphere_samples"] = samples
    params = load_tree(os.path.join(REPO, "runs", "scene_big", "best.ckpt"))
    _, cfg, lcfg, _, _, batch, samples, _ = scene_train_setup()
    res["samples"] = samples
    res["at16"] = train_grads(cfg, lcfg, params, batch, samples, "cpu")
    res["converged"] = train_grads(
        dataclasses.replace(cfg, solver_max_iters=TRAIN_CONV_ITERS,
                            solver_tol=TRAIN_CONV_TOL),
        lcfg, params, batch, samples, "cpu")
    res["predicted"] = train_grads(cfg, lcfg, params, batch, None, "cpu",
                                   use_gt_structure=False)
    res["neural"] = neural_cpu_reference(params, batch, samples)
    res["seconds"] = time.perf_counter() - t0
    res["cores"] = sorted(os.sched_getaffinity(0))
    torch.save(res, out_path + ".tmp")
    os.replace(out_path + ".tmp", out_path)
    return 0


def start_train_reference():
    """Write the corpus, then start ``train_cpu_reference`` in its own
    process; it is killed at exit if still running.  Returns (process,
    output path)."""
    import atexit
    root = os.path.join(REPO, TRAIN_ROOT)
    t0 = time.perf_counter()
    make_corpus(root)
    out = os.path.join(root, "cpu_reference.pt")
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--train-cpu-reference", out], cwd=REPO)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    print(f"[phase 11] corpus of {TRAIN_ITEMS} patches under {TRAIN_ROOT} "
          f"in {time.perf_counter() - t0:.1f} s; the CPU reference started "
          f"(pid {proc.pid})", flush=True)
    return proc, out


def finish_train_reference(ref) -> dict:
    proc, out = ref
    t0 = time.perf_counter()
    rc = proc.wait(timeout=TRAIN_REF_TIMEOUT)
    if rc != 0:
        raise AssertionError(f"[phase 11] the CPU reference exited with {rc}")
    res = torch.load(out, weights_only=False)
    print(f"[phase 11] the CPU reference on {TRAIN_REF_THREADS} threads "
          f"(cores {res['cores']}) took {res['seconds']:.1f} s; waited "
          f"{time.perf_counter() - t0:.1f} s for it", flush=True)
    return res


def make_corpus(root: str, n_items: int = TRAIN_ITEMS):
    """scripts/make_synth_scenes.py's corpus (``n_items`` 5 m terrain
    patches of 30,000 points) under ``root`` inside the checkout (a
    gitignored directory)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_synth_scenes", os.path.join(REPO, "scripts",
                                          "make_synth_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(root, n_items, 30000, 5.0)


def training_laps(params, counters, gen, ref):
    """Phase 11: training at runs/scene_big's width (see the module
    docstring); ``ref`` the CPU reference's process.  Returns (launches
    of one warm step, the backwards' records, the step's record)."""
    from nksr_tpu_torch import Reconstructor
    from nksr_tpu_torch.data import to_device_batch
    from nksr_tpu_torch.fields import support as S
    from nksr_tpu_torch.models import pipeline as P
    from nksr_tpu_torch.ops import gather_scatter as gs
    from nksr_tpu_torch.ops import segment_sum as SEG
    from nksr_tpu_torch.ops import window_basis as WB
    from nksr_tpu_torch.solver.pcg import solve_spd
    from nksr_tpu_torch.train import driver
    from nksr_tpu_torch.train import loop as T
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.profiling import PhaseTimer
    from scipy.spatial import cKDTree

    yc, cfg, lcfg, ds, val_ds, batch, samples, inp_cpu = \
        scene_train_setup()
    tc = driver.train_config_from_yaml(yc)
    pb, gb = yc["point_bucket"], yc["gt_bucket"]
    print(f"[phase 11] {UDF_CONFIG}: {cfg}; {lcfg}; {tc}", flush=True)
    print(f"[phase 11] item 0: {int(batch['mask'].sum())} input points in "
          f"{pb}, {int(batch['gt_mask'].sum())} GT points in {gb}; "
          f"hierarchies: encoder {inp_cpu.n_vox}, GT "
          f"{[len(g.keys) for g in inp_cpu.gt_grids]}, candidates "
          f"{[len(lv.cand.keys) for lv in inp_cpu.levels]} voxels; "
          f"samples {({k: tuple(v.shape) for k, v in samples.items()})}",
          flush=True)
    ref = finish_train_reference(ref)
    neural_ref = ref["neural"]
    if not all(torch.equal(samples[k], ref["samples"][k]) for k in samples):
        raise AssertionError("[phase 11] the scene's draws differ from the "
                             "CPU reference's")
    back = compare_train_backwards(SEG, gs, P.prepare_inputs(cfg, batch,
                                                             "cuda"),
                                   cfg.f_maps, gen)
    sphere = solve_spd_parity(ref)

    # (c) one step at the run's 16 iterations, card against CPU
    runs = {"cuda": train_grads(cfg, lcfg, params, batch, samples, "cuda"),
            "cpu": ref["at16"]}
    for dev, run in runs.items():
        print(f"[phase 11] (c) step at {cfg.solver_max_iters} iterations on "
              f"{dev}: losses {json.dumps(run[0])}; solves {run[3]}",
              flush=True)
    at16 = compare_train(f"(c) step at {cfg.solver_max_iters} iterations",
                         runs["cuda"], runs["cpu"], False, TRAIN_LOSS_RTOL,
                         TRAIN_GRAD_RTOL, TRAIN_UNET_TOL, TRAIN_STRUCT_RTOL)
    conv_cfg = dataclasses.replace(cfg, solver_max_iters=TRAIN_CONV_ITERS,
                                   solver_tol=TRAIN_CONV_TOL)
    t1 = time.perf_counter()
    runs = {"cuda": train_grads(conv_cfg, lcfg, params, batch, samples,
                                "cuda"), "cpu": ref["converged"]}
    print(f"[phase 11] (c) step with the solve to tol {TRAIN_CONV_TOL} on "
          f"the card in {time.perf_counter() - t1:.1f} s", flush=True)
    for dev, run in runs.items():
        (fi, fr), (bi, br) = run[3]
        print(f"[phase 11] (c) step with the solve to tol {TRAIN_CONV_TOL} "
              f"on {dev}: forward {fi} iterations rel_res {fr:.3e}, "
              f"backward {bi} rel_res {br:.3e}; losses "
              f"{json.dumps(run[0])}", flush=True)
        if not (fr < TRAIN_CONV_TOL and br < TRAIN_CONV_TOL):
            raise AssertionError(f"[phase 11] the scene step's solves did "
                                 f"not converge on {dev}")
    conv = compare_train(f"(c) step with the solve to tol {TRAIN_CONV_TOL}",
                         runs["cuda"], runs["cpu"], True, TRAIN_LOSS_RTOL,
                         TRAIN_SCENE_LEAF_RTOL, TRAIN_UNET_TOL,
                         TRAIN_STRUCT_RTOL, whole_rtol=TRAIN_GRAD_RTOL)
    pred_ref = ref["predicted"]
    del runs, ref

    # (c) warm steps with the optimizer: seconds, phases, peak, launches;
    # the first (not timed) keeps each input of the window kernel and
    # counts the gathers' backwards and the sorts they make
    state = T.init_state(cfg, tc, params=params, device="cuda")
    step_s, phases = [], {}
    win_in, tally = [], {"gathers": 0, "sorts": 0}
    real_win, real_bo = S.window_and_grad_fused, gs._backward_order
    real_so = SEG.segment_order

    def keep_win(x):
        win_in.append(x.detach().clone())
        return real_win(x)

    def sort(*a):
        tally["sorts"] += 1
        return real_so(*a)

    def backward_order(*a):
        tally["gathers"] += 1
        SEG.segment_order = sort
        try:
            return real_bo(*a)
        finally:
            SEG.segment_order = real_so
    for i in range(3):
        if i == 0:
            S.window_and_grad_fused = keep_win
            gs._backward_order = backward_order
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        times = {}
        tm = PhaseTimer(torch.device("cuda"), times, accumulate=True)
        t1 = time.perf_counter()
        state, losses, _ = T.train_step(cfg, tc, lcfg, state, batch, None,
                                        samples=samples, tm=tm)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        S.window_and_grad_fused, gs._backward_order = real_win, real_bo
        launches = read_counts(counters)
        times["train: forward solve"] = solve_spd.last_seconds
        times["train: backward solve"] = solve_spd.last_backward_seconds
        phases = times
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[phase 11] (c) warm step {min(step_s[1:]):.4f} s (laps "
          + ", ".join(f"{s:.4f}" for s in step_s) + f"); phases "
          + json.dumps({k: round(v, 4) for k, v in phases.items()})
          + f"; peak memory {peak:.2f} GiB; launches {launches}", flush=True)
    if launches["segsum"] <= 0 or launches["window"] <= 0:
        raise AssertionError(f"[phase 11] a training step launched no "
                             f"segment sum or window kernel: {launches}")
    print(f"[phase 11] (c) a step's gathers: {tally['gathers']} backwards, "
          f"{tally['sorts']} sorts of their index tables", flush=True)
    del state
    if len(win_in) != launches["window"]:
        raise AssertionError(f"[phase 11] the step gave the window kernel "
                             f"{len(win_in)} inputs, launched it "
                             f"{launches['window']} times")
    wins = []
    for x in win_in:
        w = compare_window(WB, x, timed=True)
        wins.append(dict(q=x.shape[0], err=w["err"], ms=w["ms"],
                         plain_ms=w["plain_ms"], bound_ms=w["bound"][0],
                         bound_by=w["bound"][1]))
    del win_in
    print("[phase 11] (c) the window kernel at the step's inputs against "
          "its plain version (rtol 1e-5, atol 1e-6): " + "; ".join(
              f"Q {w['q']} err {w['err']:.3e} {w['ms']:.4f} ms (plain "
              f"{w['plain_ms']:.4f}, bound {w['bound_ms']:.4f} by "
              f"{w['bound_by']})" for w in wins), flush=True)

    # (d) an overfit from the port's seeded init on one item
    otc = dataclasses.replace(tc, lr_init=OVERFIT_LR)
    state = T.init_state(cfg, otc, seed=0, device="cuda")
    hist = []
    t1 = time.perf_counter()
    for i in range(OVERFIT_STEPS):
        state, losses, _ = T.train_step(cfg, otc, lcfg, state, batch,
                                        torch.Generator().manual_seed(i))
        hist.append(losses["sum"])
    first, last = float(np.mean(hist[:3])), float(np.mean(hist[-3:]))
    print(f"[phase 11] (d) overfit of item 0 from the seeded init, "
          f"{OVERFIT_STEPS} steps at lr {OVERFIT_LR} in "
          f"{time.perf_counter() - t1:.1f} s: sum "
          + ", ".join(f"{h:.2f}" for h in hist)
          + f"; last 3 / first 3 = {last / first:.3f} (gate 0.85)",
          flush=True)
    if not (np.isfinite(last) and last < 0.85 * first):
        raise AssertionError("[phase 11] the overfit did not converge")
    del state

    # (e) two runs of 5 steps from one state, bit-equal
    finals = []
    for _ in range(2):
        state = T.init_state(cfg, tc, params=params, device="cuda")
        sums = []
        for i in range(5):
            state, losses, _ = T.train_step(
                cfg, tc, lcfg, state, batch, torch.Generator().manual_seed(i))
            sums.append(losses["sum"])
        finals.append(([p.detach().clone() for p in state.net.parameters()],
                       sums))
        del state
    same = all(torch.equal(a, b) for a, b in zip(finals[0][0], finals[1][0]))
    print(f"[phase 11] (e) two runs of 5 steps from one state: params "
          f"{'bit-equal' if same else 'DIFFER'}; sums {finals[0][1]} / "
          f"{finals[1][1]}", flush=True)
    if not (same and finals[0][1] == finals[1][1]):
        raise AssertionError("[phase 11] two 5-step runs from one state "
                             "differ")
    del finals

    # (f) fit with one validation, then best.ckpt meshed by Reconstructor
    run_dir = os.path.join(REPO, TRAIN_ROOT, "run")
    train_batches = [to_device_batch(ds[i], pb, gb) for i in range(4)]
    val_batches = [to_device_batch(val_ds[0], pb, gb)]
    t1 = time.perf_counter()
    st = driver.fit(yc, train_batches, val_batches, run_dir, max_steps=4,
                    val_every=4, seed=0, params=params, device="cuda")
    print(f"[phase 11] (f) fit of 4 steps and one validation in "
          f"{time.perf_counter() - t1:.1f} s: step {st.step}; "
          + open(os.path.join(run_dir, "metrics.csv")).read()
          .strip().splitlines()[-1][:300], flush=True)
    del st
    recon = Reconstructor(config=cfg, params=load_tree(
        os.path.join(run_dir, "best.ckpt")))
    m = batch["mask"].numpy()
    t1 = time.perf_counter()
    field = recon.reconstruct(batch["xyz"].numpy()[m],
                              batch["normal"].numpy()[m], detail_level=None,
                              voxel_size=cfg.voxel_size)
    mesh = field.extract_dual_mesh(mise_iter=1)
    gtm = batch["gt_mask"].numpy()
    d, _ = cKDTree(batch["gt_xyz"].numpy()[gtm]).query(mesh.v)
    print(f"[phase 11] (f) the fit's best.ckpt through Reconstructor on item "
          f"0 ({recon._last_pred_engine} engine): {len(mesh.v)} vertices, "
          f"{len(mesh.f)} faces in {time.perf_counter() - t1:.2f} s; "
          f"vertex distance to the GT cloud mean {d.mean():.5f} q90 "
          f"{np.quantile(d, 0.9):.5f} (gate: mean under "
          f"{FIT_MESH_LIMIT})", flush=True)
    if not (len(mesh.f) and np.isfinite(mesh.v).all()
            and d.mean() < FIT_MESH_LIMIT):
        raise AssertionError("[phase 11] the port-trained checkpoint did "
                             "not mesh the item")
    predicted = predicted_training(cfg, lcfg, tc, yc, params, batch,
                                   train_batches, run_dir, counters,
                                   pred_ref)
    step = {"warm_s": min(step_s[1:]), "peak_gib": peak, "phases": phases,
            "window": wins, "gathers": tally,
            "at16": at16, "converged": conv, "sphere": sphere,
            "overfit_ratio": last / first, "predicted": predicted,
            "neural_ref": neural_ref}
    return launches, back, step


def level_margins(logits):
    """Per level, the smallest top-2 margin of the structure logits and
    the largest |logit| (inf and 0 on an empty level)."""
    out = []
    for lg in logits:
        if lg.shape[0] == 0:
            out.append((float("inf"), 0.0))
            continue
        top = lg.topk(2, -1).values
        out.append((float((top[:, 0] - top[:, 1]).min()),
                    float(lg.abs().max())))
    return out


def check_predicted_hierarchy(card, cpu, tag="[phase 11] (g)") -> bool:
    """Phase 11 (g): the card's candidate and decoder hierarchies against
    the CPU's, from the coarsest level.  Returns True when they are
    equal voxel for voxel; False when the first status that differs is a
    tie (its margin under TRAIN_TIE_FRAC of the level's largest |logit|
    on both sides), from which the finer levels follow; raises
    otherwise."""
    depth = len(card["cand"])
    for d in range(depth - 1, -1, -1):
        if not np.array_equal(card["cand"][d], cpu["cand"][d]):
            raise AssertionError(f"{tag} the candidates of level "
                                 f"{d} differ between card and CPU")
        sc, sp = card["logits"][d].argmax(-1), cpu["logits"][d].argmax(-1)
        diff = torch.nonzero(sc != sp)[:, 0]
        if diff.numel():
            ties = []
            for lg in (card["logits"][d], cpu["logits"][d]):
                top = lg[diff].topk(2, -1).values
                ties.append(float((top[:, 0] - top[:, 1]).max())
                            / float(lg.abs().max()))
            print(f"{tag} level {d}: {diff.numel()} statuses "
                  f"differ between card and CPU, largest margin there "
                  f"{max(ties):.3e} of max |logit| (tie under "
                  f"{TRAIN_TIE_FRAC})", flush=True)
            if max(ties) >= TRAIN_TIE_FRAC:
                raise AssertionError(f"{tag} the predicted "
                                     "hierarchy differs between card and "
                                     "CPU beyond a tie")
            return False
        if not np.array_equal(card["dec"][d], cpu["dec"][d]):
            raise AssertionError(f"{tag} the decoder voxels of "
                                 f"level {d} differ between card and CPU")
    return True


def quadrant_mm(mesh) -> np.ndarray:
    """|v_z - h(v_x, v_y)| over the used vertices 1 m inside the (-x, -y)
    20 m quadrant."""
    v = mesh.v[np.unique(mesh.f)]
    v = v[(v[:, 0] < -1) & (v[:, 0] > -19) & (v[:, 1] < -1)
          & (v[:, 1] > -19)]
    return np.abs(v[:, 2] - _height(v[:, 0], v[:, 1]))


def ingraph_laps(params, counters, WB, S, synthetic_scene):
    """Phase 12: the in-graph route and its mesher (see the module
    docstring and the INGRAPH_* constants).  Returns (the launches of one
    scene lap, a record of the phase's numbers, the window kernel against
    its plain version on the Newton step's own inputs)."""
    import dataclasses as dc

    from nksr_tpu_torch import Reconstructor
    from nksr_tpu_torch.data import DatasetSpec as DS, build_dataset
    from nksr_tpu_torch.models import pipeline as PP
    from nksr_tpu_torch.recon.reconstructor import estimate_capacities
    from nksr_tpu_torch.scripts import time_rows as TR
    from nksr_tpu_torch.train.driver import pipeline_config_from_yaml
    from nksr_tpu_torch.utils.config import load_config
    from nksr_tpu_torch.utils.metrics import MeshEvaluator

    t_phase = time.perf_counter()
    yc = load_config(os.path.join(REPO, UDF_CONFIG))
    cfg = pipeline_config_from_yaml(yc)
    if not cfg.udf_enabled:
        raise AssertionError(f"[phase 12] {UDF_CONFIG} has no UDF head")
    recon = Reconstructor(config=cfg, params=params)
    cpu_recon = Reconstructor(device="cpu", config=cfg, params=params)
    root = os.path.join(REPO, INGRAPH_ROOT)
    if not os.path.exists(os.path.join(root, "terrain", "test.lst")):
        make_corpus(root, INGRAPH_ITEMS)
    spec = [DS.SHAPE_NAME, DS.INPUT_PC, DS.TARGET_NORMAL, DS.GT_DENSE_PC,
            DS.GT_DENSE_NORMAL, DS.GT_ONET_SAMPLE]
    ds = build_dataset("ShapeNet", spec, **dict(
        yc["test_dataset"]["args"], root=root))
    if len(ds) != len(JAX_INGRAPH_SCENES):
        raise AssertionError(f"[phase 12] {len(ds)} held-out scenes, "
                             f"expected {len(JAX_INGRAPH_SCENES)}")
    ev = MeshEvaluator(n_points=MeshEvaluator.N_POINTS_SCENE)
    rec = {"scenes": []}
    win_x = None
    launches = None

    def lap(xyz, nrm, capture=False):
        reset_counts(counters.values())
        t0 = time.perf_counter()
        field = recon.reconstruct(xyz, nrm, **INGRAPH_KW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if capture:
            mesh, (x,) = TR.capture_first(
                S, "window_and_grad_fused",
                lambda: field.extract_dual_mesh(mise_iter=1))
        else:
            mesh, x = field.extract_dual_mesh(mise_iter=1), None
        torch.cuda.synchronize()
        return (t1 - t0, time.perf_counter() - t1, field, mesh,
                read_counts(counters), x)

    # ---- (a) the held-out scenes
    for i in range(len(ds)):
        item = ds[i]
        name = item[DS.SHAPE_NAME]
        xyz = np.asarray(item[DS.INPUT_PC], np.float32)
        nrm = np.asarray(item[DS.TARGET_NORMAL], np.float32)
        torch.cuda.reset_peak_memory_stats()
        tr, tm, field, mesh, ln, x = lap(xyz, nrm, capture=i == 0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if x is not None:
            win_x = x
        if ln["window"] <= 0 or ln["segsum"] <= 0:
            raise AssertionError(f"[phase 12] (a) {name}: the window kernel "
                                 f"or the segment sum did not run: {ln}")
        launches = launches or ln
        tr2, tm2, field2, mesh2, _, _ = lap(xyz, nrm)
        same = lap_diff(([a.clone() for a in field.alpha], mesh.v, mesh.f),
                        (field2.alpha, mesh2.v, mesh2.f))
        if "coefficients bit-equal" not in same or \
                "mesh bit-equal" not in same:
            raise AssertionError(f"[phase 12] (a) {name}: two laps differ: "
                                 + same)
        # the hierarchy against the port's CPU run (the inference forward
        # at the route's estimated capacities, with its logits for ties)
        ecfg = dc.replace(cfg, voxel_size=0.1, solver_tol=1e-4,
                          solver_max_iters=16,
                          capacities=estimate_capacities(xyz, 0.1,
                                                         cfg.tree_depth))
        outs = []
        for r in (recon, cpu_recon):
            o = PP.infer(ecfg, r.network, xyz,
                         torch.as_tensor(nrm, device=r.device))
            outs.append({"cand": [g.coords for g in o.cand_grids],
                         "dec": [g.coords for g in o.dec_grids],
                         "logits": [lg.cpu() for lg in o.structure_logits]})
            del o
        equal = check_predicted_hierarchy(outs[0], outs[1],
                                          tag=f"[phase 12] (a) {name}")
        t_ev = time.perf_counter()
        m = ev.eval_mesh(mesh, item[DS.GT_DENSE_PC], item[DS.GT_DENSE_NORMAL],
                         onet_samples=item.get(DS.GT_ONET_SAMPLE))
        t_ev = time.perf_counter() - t_ev
        jc, jf = JAX_INGRAPH_SCENES[name]
        print(f"[phase 12] (a) {name}: reconstruct_s {min(tr, tr2):.3f} "
              f"extract_mesh_s {min(tm, tm2):.3f} metrics_s {t_ev:.3f} "
              f"capacities {field.capacities} decoder voxels "
              f"{[len(g.keys) for g in field.host_grids]} verts "
              f"{len(mesh.v)} faces {len(mesh.f)} peak {peak:.2f} GiB "
              f"launches {ln}; {same}; hierarchy "
              f"{'equal to the CPU run' if equal else 'a tie (reported)'}; "
              f"chamfer-L1 {m['chamfer-L1']:.6f} f-score {m['f-score']:.6f}"
              f" iou {m.get('iou', float('nan')):.6f} (JAX in-graph "
              f"{jc} / {jf}; gate {INGRAPH_CHAMFER_GATE * jc:.6f}); phases "
              + json.dumps({k: round(v, 4)
                            for k, v in field.phase_times.items()}),
              flush=True)
        rec["scenes"].append({"name": name, "reconstruct_s": min(tr, tr2),
                              "extract_mesh_s": min(tm, tm2),
                              "metrics_s": t_ev, "verts": len(mesh.v),
                              "faces": len(mesh.f), "peak_gib": peak,
                              "chamfer_l1": m["chamfer-L1"],
                              "f_score": m["f-score"]})
        if not (np.isfinite(mesh.v).all() and len(mesh.f)):
            raise AssertionError(f"[phase 12] (a) {name}: empty or "
                                 "non-finite mesh")
        if not m["chamfer-L1"] <= INGRAPH_CHAMFER_GATE * jc:
            raise AssertionError(
                f"[phase 12] (a) {name}: chamfer-L1 {m['chamfer-L1']} > "
                f"{INGRAPH_CHAMFER_GATE} x the JAX package's {jc}")
        del field, field2, mesh, mesh2
    torch.cuda.empty_cache()

    # ---- (b) one 20 m quadrant of the 1M-point tile
    xyz, nrm = synthetic_scene(N_POINTS)
    q = (xyz[:, 0] < 0) & (xyz[:, 1] < 0)
    xq, nq = xyz[q], nrm[q]
    del xyz, nrm
    torch.cuda.reset_peak_memory_stats()
    tr, tm, field, mesh, ln, _ = lap(xq, nq)
    err = quadrant_mm(mesh)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[phase 12] (b) the (-x, -y) quadrant, {len(xq)} points: "
          f"reconstruct_s {tr:.3f} extract_mesh_s {tm:.3f} capacities "
          f"{field.capacities} decoder voxels "
          f"{[len(g.keys) for g in field.host_grids]} {field.cg_stats} "
          f"verts {len(mesh.v)} faces {len(mesh.f)} peak {peak:.2f} GiB "
          f"launches {ln}; terrain error on {len(err)} interior vertices: "
          f"mean {err.mean():.6f} q90 {np.quantile(err, 0.9):.6f} max "
          f"{err.max():.6f} (JAX in-graph {JAX_INGRAPH_QUADRANT_ERR}; "
          f"limit {INGRAPH_ERR_LIMIT:.6f}); phases "
          + json.dumps({k: round(v, 4) for k, v in field.phase_times.items()}),
          flush=True)
    if not err.mean() <= INGRAPH_ERR_LIMIT:
        raise AssertionError(f"[phase 12] (b) quadrant error {err.mean()} "
                             f"> {INGRAPH_ERR_LIMIT}")
    rec["quadrant"] = {"points": int(len(xq)), "reconstruct_s": tr,
                       "extract_mesh_s": tm, "err_mean": float(err.mean()),
                       "peak_gib": peak, "launches": ln}
    del field, mesh
    torch.cuda.empty_cache()

    # ---- (c) the same quadrant in four 10 m chunks, meshed chunk by chunk
    crecon = Reconstructor(config=dc.replace(
        cfg, structure_mode="predicted_ingraph"), params=params)
    reset_counts(counters.values())
    t0 = time.perf_counter()
    cf = crecon.reconstruct(xq, nq, chunk_size=10.0, solver_tol=1e-4)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mesh = cf.extract_dual_mesh(mise_iter=1)
    torch.cuda.synchronize()
    tcm = time.perf_counter() - t1
    lc = read_counts(counters)
    cerr = quadrant_mm(mesh)
    climit = 1.5 * float(err.mean())
    print(f"[phase 12] (c) chunk_size 10: {len(cf.chunks)} chunks "
          f"({[ch['n_points'] for ch in cf.chunks]} points with halos), "
          f"reconstruct_s {t1 - t0:.3f} extract_mesh_s {tcm:.3f} verts "
          f"{len(mesh.v)} faces {len(mesh.f)} launches {lc}; terrain error "
          f"on {len(cerr)} interior vertices: mean {cerr.mean():.6f} q90 "
          f"{np.quantile(cerr, 0.9):.6f} max {cerr.max():.6f} (JAX in-graph "
          f"chunked {JAX_INGRAPH_CHUNKED_ERR}; limit 1.5x (b) "
          f"{climit:.6f}); phases "
          + json.dumps({k: round(v, 4) for k, v in cf.phase_times.items()}),
          flush=True)
    if len(cf.chunks) != 4 or cf._host_chunks():
        raise AssertionError("[phase 12] (c) expected four in-graph chunks")
    if not cerr.mean() <= climit:
        raise AssertionError(f"[phase 12] (c) chunked error {cerr.mean()} "
                             f"> {climit}")
    rec["chunked"] = {"reconstruct_s": t1 - t0, "extract_mesh_s": tcm,
                      "err_mean": float(cerr.mean()), "launches": lc}
    del cf, mesh, crecon
    torch.cuda.empty_cache()

    # ---- (d) the host routes on the first held-out scene
    item = ds[0]
    rec["host_routes"] = {}
    for structure in ("predicted", "splat", "adaptive"):
        field = recon.reconstruct(item[DS.INPUT_PC], item[DS.TARGET_NORMAL],
                                  **dict(INGRAPH_KW, structure=structure))
        mesh = field.extract_dual_mesh(mise_iter=1)
        m = ev.eval_mesh(mesh, item[DS.GT_DENSE_PC], item[DS.GT_DENSE_NORMAL],
                         onet_samples=item.get(DS.GT_ONET_SAMPLE))
        jc, jf = JAX_QUALITY_SCENE[structure]
        print(f"[phase 12] (d) {item[DS.SHAPE_NAME]} {structure}: "
              f"chamfer-L1 {m['chamfer-L1']:.6f} f-score {m['f-score']:.6f}"
              f" (JAX QUALITY.md row, mean of its scenes: {jc} / {jf})",
              flush=True)
        rec["host_routes"][structure] = (m["chamfer-L1"], m["f-score"])
        del field, mesh
    torch.cuda.empty_cache()

    # ---- (e) the window kernel on the Newton step's own inputs
    win = compare_window(WB, win_x.contiguous(), timed=True)
    win["q"] = int(win_x.shape[0])
    print(f"[phase 12] (e) window kernel at the Newton step's Q "
          f"{win_x.shape[0]}: max err {win['err']:.3e}; {win['ms']:.4f} ms "
          f"(plain {win['plain_ms']:.4f}, bound {win['bound'][0]:.4f} by "
          f"{win['bound'][1]})", flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 12] {rec['seconds']:.1f} s", flush=True)
    return launches, rec, win


def predicted_training(cfg, lcfg, tc, yc, params, batch, train_batches,
                       run_dir, counters, cpu_run):
    """Phase 11 (g): training on the predicted structure (see the module
    docstring); ``cpu_run`` the CPU reference's predicted step.  Returns
    the record: warm step seconds and phases, peak GiB, the launches of
    one warm step, the card-against-CPU worsts."""
    from nksr_tpu_torch.solver.pcg import solve_spd
    from nksr_tpu_torch.train import driver
    from nksr_tpu_torch.train import loop as T
    from nksr_tpu_torch.utils.profiling import PhaseTimer

    def predicted_step(state, seed, tm=None):
        return T.train_step(cfg, tc, lcfg, state, batch,
                            torch.Generator().manual_seed(seed),
                            use_gt_structure=False, tm=tm)

    # one step at the run's 16 iterations, card against CPU
    card = train_grads(cfg, lcfg, params, batch, None, "cuda",
                       use_gt_structure=False)
    cf, pf = card[2], cpu_run[2]
    margins = level_margins(cf["logits"])
    print(f"[phase 11] (g) predicted step at {cfg.solver_max_iters} "
          f"iterations: candidates {[len(k) for k in cf['cand']]}, decoder "
          f"{[len(k) for k in cf['dec']]} voxels (CPU: "
          f"{[len(k) for k in pf['cand']]}, {[len(k) for k in pf['dec']]})"
          "; smallest top-2 margin by level (of max |logit|): "
          + ", ".join(f"{m:.3e} ({m / max(x, 1e-30):.3e})"
                      for m, x in margins), flush=True)
    same = check_predicted_hierarchy(cf, pf)
    worst = None
    if same:
        if not all(torch.equal(cf["samples"][k], pf["samples"][k])
                   for k in pf["samples"]):
            raise AssertionError("[phase 11] (g) the predicted step's draws "
                                 "differ between card and CPU")
        worst = compare_train(f"(g) predicted step at "
                              f"{cfg.solver_max_iters} iterations", card,
                              cpu_run, False, TRAIN_LOSS_RTOL,
                              TRAIN_GRAD_RTOL, TRAIN_UNET_TOL,
                              TRAIN_STRUCT_RTOL)
        leaves = {n: float(torch.linalg.norm(card[1][n] - g)
                           / torch.linalg.norm(g))
                  for n, g in cpu_run[1].items()
                  if float(torch.linalg.norm(g)) > 0}
        print("[phase 11] (g) each leaf, card against CPU (rel L2): "
              + json.dumps({n: float(f"{v:.3e}") for n, v in
                            leaves.items()}), flush=True)
    for dev, run in (("cuda", card), ("cpu", cpu_run)):
        print(f"[phase 11] (g) predicted step on {dev}: losses "
              f"{json.dumps(run[0])}; solves {run[3]}", flush=True)
    del card

    # three steps with the optimizer: seconds, phases, peak, launches
    state = T.init_state(cfg, tc, params=params, device="cuda")
    step_s, phases = [], {}
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        times = {}
        tm = PhaseTimer(torch.device("cuda"), times, accumulate=True)
        t1 = time.perf_counter()
        state, losses, _ = predicted_step(state, i, tm)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        launches = read_counts(counters)
        times["train: forward solve"] = solve_spd.last_seconds
        times["train: backward solve"] = solve_spd.last_backward_seconds
        phases = times
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[phase 11] (g) warm predicted step {min(step_s[1:]):.4f} s "
          "(laps " + ", ".join(f"{s:.4f}" for s in step_s) + "); phases "
          + json.dumps({k: round(v, 4) for k, v in phases.items()})
          + f"; peak memory {peak:.2f} GiB; launches {launches}; sums "
          f"{losses['sum']:.4f}", flush=True)
    if launches["segsum"] <= 0 or launches["window"] <= 0:
        raise AssertionError(f"[phase 11] (g) a predicted step launched no "
                             f"segment sum or window kernel: {launches}")
    del state

    # two runs of 5 predicted steps from one state, bit-equal
    finals = []
    for _ in range(2):
        state = T.init_state(cfg, tc, params=params, device="cuda")
        sums = []
        for i in range(5):
            state, losses, _ = predicted_step(state, i)
            sums.append(losses["sum"])
        finals.append(([p.detach().clone() for p in state.net.parameters()],
                       sums))
        del state
    bit_equal = all(torch.equal(a, b)
                    for a, b in zip(finals[0][0], finals[1][0]))
    print(f"[phase 11] (g) two runs of 5 predicted steps from one state: "
          f"params {'bit-equal' if bit_equal else 'DIFFER'}; sums "
          f"{finals[0][1]} / {finals[1][1]}", flush=True)
    if not (bit_equal and finals[0][1] == finals[1][1]):
        raise AssertionError("[phase 11] (g) two 5-step predicted runs "
                             "from one state differ")
    del finals

    # fit past the schedule's start: steps 1-4 predicted
    modes = []
    real_step = T.train_step

    def recording(*a, use_gt_structure=True, **kw):
        modes.append(use_gt_structure)
        return real_step(*a, use_gt_structure=use_gt_structure, **kw)
    fit_cfg = dict(yc, structure_schedule={"start_step": 0, "end_step": 1})
    T.train_step = recording
    t1 = time.perf_counter()
    try:
        st = driver.fit(fit_cfg, train_batches + train_batches[:1], None,
                        run_dir + "_predicted", max_steps=5, seed=0,
                        params=params, device="cuda")
    finally:
        T.train_step = real_step
    print(f"[phase 11] (g) fit of 5 steps from step 0 to 1 of the schedule "
          f"in {time.perf_counter() - t1:.1f} s: step {st.step}, "
          f"teacher-forced {modes}", flush=True)
    if not (st.step == 5 and modes == [True] + [False] * 4
            and all(bool(torch.isfinite(p).all())
                    for p in st.net.parameters())):
        raise AssertionError("[phase 11] (g) the fit did not run 4 "
                             "predicted steps")
    del st
    return {"warm_s": min(step_s[1:]), "peak_gib": peak, "phases": phases,
            "launches": launches, "hierarchy_equal": same,
            "margins": margins, "worst": worst}


def texture_colours(xyz: np.ndarray) -> np.ndarray:
    """Phase 13's colours of points: a fixed smooth function of position
    in [0, 1]^3."""
    return (0.5 + 0.5 * np.sin(xyz * np.float32([0.3, 0.5, 2.0])
                               + np.float32([0.0, 1.0, 2.0]))
            ).astype(np.float32)


def texture_of(xyz: np.ndarray, device):
    """The texture field over a cloud on ``device``, as
    examples/recons_colored_mesh.py builds it (cell 4 voxels)."""
    from nksr_tpu_torch.fields.neural_field import PCNNField
    t = lambda a: torch.as_tensor(a, device=device)
    return PCNNField.build(t(xyz), t(texture_colours(xyz)),
                           torch.ones(len(xyz), dtype=torch.bool,
                                      device=device),
                           4 * float(np.float32(KW["voxel_size"])),
                           TEXTURE_CAPACITY)


def check_colours(tag, plain, coloured, tex, tex_cpu) -> dict:
    """Phase 13: the texture moved no geometry (``v``, ``f`` bit-equal to
    the uncoloured lap's), ``c`` is (Nv, 3) and finite, and equal to the
    same texture's on CPU tensors at the same vertices except at distance
    ties (both picks' squared distances, in f64, within TEXTURE_TIE_RTOL
    of each other).  Returns the vertices, how many differ and the
    colour evaluation's seconds on the card."""
    if not (np.array_equal(plain.v, coloured.v)
            and np.array_equal(plain.f, coloured.f)):
        raise AssertionError(f"[phase 13] {tag}: the texture moved the "
                             "mesh")
    c = coloured.c
    if c is None or c.shape != (len(coloured.v), 3) or \
            not np.isfinite(c).all():
        raise AssertionError(f"[phase 13] {tag}: colours "
                             f"{None if c is None else c.shape}")
    v = torch.from_numpy(coloured.v)
    vc = v.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tex.evaluate_f(vc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diff = np.nonzero((c != tex_cpu.evaluate_f(v).value.numpy()).any(1))[0]
    worst = 0.0
    if len(diff):
        vd = v[diff]
        picks = (tex.nearest(vc[torch.as_tensor(diff, device="cuda")])
                 .cpu(), tex_cpu.nearest(vd))
        if ((picks[0] < 0) != (picks[1] < 0)).any():
            raise AssertionError(f"[phase 13] {tag}: a vertex has a "
                                 "nearest point on one side only")
        x = tex_cpu.xyz.double()
        d2 = [((x[p] - vd.double()) ** 2).sum(1) for p in picks]
        rel = (d2[0] - d2[1]).abs() / torch.maximum(
            torch.maximum(d2[0], d2[1]), torch.tensor(1e-30,
                                                      dtype=torch.float64))
        worst = float(rel.max())
        if worst > TEXTURE_TIE_RTOL:
            raise AssertionError(f"[phase 13] {tag}: {len(diff)} vertices' "
                                 f"colours differ from the CPU run's beyond "
                                 f"a tie ({worst:.3e} relative)")
    return {"verts": int(len(v)), "differ": int(len(diff)),
            "tie_worst": worst, "colour_s": seconds}


def neural_setup(params, bias=None):
    """Phase 13's configuration: runs/scene_big/config.yaml with
    geometry: neural, its loss config, and the checkpoint's parameters
    with the SDF decoder's last bias replaced by ``bias`` (None: as
    stored)."""
    from nksr_tpu_torch.train import driver
    from nksr_tpu_torch.utils.checkpoint import model_params
    from nksr_tpu_torch.utils.config import load_config
    yc = load_config(os.path.join(REPO, UDF_CONFIG))
    cfg = dataclasses.replace(driver.pipeline_config_from_yaml(yc),
                              geometry="neural")
    mp = dict(model_params(params))
    if bias is not None:
        mp["sdf_decoder"] = dict(mp["sdf_decoder"], Dense_2=dict(
            mp["sdf_decoder"]["Dense_2"], bias=bias))
    return cfg, driver.loss_config_from_yaml(yc), {"params": mp}


def neural_scenes():
    """Phase 12's held-out scenes (written if missing): a list of
    (name, points, normals)."""
    from nksr_tpu_torch.data import DatasetSpec as DS, build_dataset
    from nksr_tpu_torch.utils.config import load_config
    root = os.path.join(REPO, INGRAPH_ROOT)
    if not os.path.exists(os.path.join(root, "terrain", "test.lst")):
        make_corpus(root, INGRAPH_ITEMS)
    yc = load_config(os.path.join(REPO, UDF_CONFIG))
    ds = build_dataset("ShapeNet", [DS.SHAPE_NAME, DS.INPUT_PC,
                                    DS.TARGET_NORMAL], **dict(
        yc["test_dataset"]["args"], root=root))
    out = []
    for i in range(len(ds)):
        item = ds[i]
        out.append((item[DS.SHAPE_NAME],
                    np.asarray(item[DS.INPUT_PC], np.float32),
                    np.asarray(item[DS.TARGET_NORMAL], np.float32)))
    return out


def neural_probes(xyz: np.ndarray, i: int) -> np.ndarray:
    """NEURAL_PROBES seeded points near scene ``i``'s cloud."""
    rng = np.random.default_rng(1000 + i)
    pick = rng.choice(len(xyz), NEURAL_PROBES, replace=False)
    return (xyz[pick] + 0.05 * rng.standard_normal((NEURAL_PROBES, 3))
            ).astype(np.float32)


def neural_infer(cfg, net, xyz, nrm, device):
    """The inference forward at the in-graph route's estimated
    capacities: (candidate and decoder coords and logits on the CPU, the
    field)."""
    from nksr_tpu_torch.models import pipeline as PP
    from nksr_tpu_torch.recon.reconstructor import estimate_capacities
    ecfg = dataclasses.replace(
        cfg, voxel_size=0.1, capacities=estimate_capacities(
            xyz, 0.1, cfg.tree_depth))
    with torch.no_grad():
        o = PP.infer(ecfg, net, xyz, torch.as_tensor(nrm, device=device))
    return ({"cand": [g.coords for g in o.cand_grids],
             "dec": [g.coords for g in o.dec_grids],
             "logits": [lg.cpu() for lg in o.structure_logits]}, o.field)


def neural_cpu_reference(params, batch, samples) -> dict:
    """Phase 13's CPU side, in the CPU reference's process: the SDF bias
    offset, the in-graph route's hierarchy and field at the probes on
    each held-out scene, and one neural training step on phase 11's item
    with its draws."""
    from nksr_tpu_torch.models.network import NKSRNetwork
    from nksr_tpu_torch.utils.checkpoint import params_to_torch
    cfg, lcfg, raw = neural_setup(params)
    scenes = neural_scenes()

    def network(p):
        net = NKSRNetwork(cfg)
        net.load_state_dict(params_to_torch(p), strict=True)
        return net.eval().requires_grad_(False)
    _, xyz, nrm = scenes[0]
    _, field = neural_infer(cfg, network(raw), xyz, nrm, "cpu")
    with torch.no_grad():
        med = float(field.evaluate_at(xyz).value.median())
    bias = (raw["params"]["sdf_decoder"]["Dense_2"]["bias"]
            - np.float32(med)).astype(np.float32)
    net = network(neural_setup(params, bias)[2])
    out = {"bias": bias, "median": med, "scenes": []}
    for i, (name, xyz, nrm) in enumerate(scenes):
        hier, field = neural_infer(cfg, net, xyz, nrm, "cpu")
        with torch.no_grad():
            hier["probe_f"] = field.evaluate_at(neural_probes(xyz, i)).value
        out["scenes"].append(hier)
    out["step"] = train_grads(cfg, lcfg, params, batch, samples, "cpu")
    return out


def texture_neural_laps(params, counters, recon, xyz, nrm, neural_ref):
    """Phase 13: texture fields and the neural geometry head (see the
    module docstring and the TEXTURE_* and NEURAL_* constants).  Returns
    (the launches of the coloured splat lap, of the coloured chunked lap,
    of a neural in-graph lap and of a neural training step, the phase's
    record)."""
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch.fields.neural_field import NeuralField
    from nksr_tpu_torch.models.network import NKSRNetwork
    from nksr_tpu_torch.train import loop as T
    from nksr_tpu_torch.utils.checkpoint import params_to_torch

    t_phase = time.perf_counter()
    rec = {}

    # ---- (a) the coloured main path: the splat tile, dense mesher
    laps = {}
    for tag in ("uncoloured", "coloured"):
        reset_counts(counters.values())
        t0 = time.perf_counter()
        field = recon.reconstruct(xyz, nrm, structure="splat", **KW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tag == "coloured":
            tex = texture_of(xyz, "cuda")
            field.set_texture_field(tex)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mesh = field.extract_dual_mesh(mise_iter=1)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        check_lattice_launches(f"phase 13 (a) {tag}", launches, field)
        laps[tag] = {"reconstruct_s": t1 - t0, "texture_build_s": t2 - t1,
                     "extract_mesh_s": time.perf_counter() - t2,
                     "mesh": mesh, "launches": launches,
                     "dual_mc_s": field.phase_times.get("dual mc")}
        del field
    tex_cpu = texture_of(xyz, "cpu")
    col = check_colours("(a)", laps["uncoloured"]["mesh"],
                        laps["coloured"]["mesh"], tex, tex_cpu)
    del tex, tex_cpu
    rec["splat"] = dict(col, **{k: laps["coloured"][k] for k in (
        "reconstruct_s", "texture_build_s", "extract_mesh_s", "dual_mc_s",
        "launches")}, uncoloured_extract_mesh_s=laps["uncoloured"][
            "extract_mesh_s"])
    colored_launches = laps["coloured"]["launches"]
    print(f"[phase 13] (a) the coloured splat tile: {col['verts']} "
          f"vertices, v and f bit-equal to the uncoloured lap's; colours "
          f"equal to the CPU run's but {col['differ']} (ties, worst "
          f"{col['tie_worst']:.3e} relative); colour evaluation "
          f"{col['colour_s']:.4f} s on the card; texture build "
          f"{laps['coloured']['texture_build_s']:.4f} s; extract_mesh_s "
          f"{laps['coloured']['extract_mesh_s']:.3f} (uncoloured "
          f"{laps['uncoloured']['extract_mesh_s']:.3f}); launches "
          f"{colored_launches}", flush=True)
    del laps
    torch.cuda.empty_cache()

    # ---- (b) the coloured host mesher: the (-x, -y) quadrant in 10 m
    # chunks, the union lattice meshed on the host
    q = (xyz[:, 0] < 0) & (xyz[:, 1] < 0)
    xq, nq = xyz[q], nrm[q]
    crecon = Reconstructor(config=PipelineConfig(
        conv_dtype="bfloat16", structure_mode="splat", solver_tol=1e-4,
        solver_max_iters=KW["solver_max_iters"]), params=params)
    tex = texture_of(xq, "cuda")
    laps = {}
    for tag in ("uncoloured", "coloured"):
        reset_counts(counters.values())
        t0 = time.perf_counter()
        cf = crecon.reconstruct(xq, nq, chunk_size=10.0, solver_tol=1e-4)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tag == "coloured":
            for ch in cf.chunks:
                ch["field"].set_texture_field(tex)
        mesh = cf.extract_dual_mesh(mise_iter=1)
        torch.cuda.synchronize()
        if len(cf.chunks) != 4 or len(cf._host_chunks()) != 4:
            raise AssertionError("[phase 13] (b) expected four host chunks")
        laps[tag] = {"reconstruct_s": t1 - t0,
                     "extract_mesh_s": time.perf_counter() - t1,
                     "mesh": mesh, "launches": read_counts(counters),
                     "colours_s": cf.phase_times.get("mc: colours")}
        del cf
    col = check_colours("(b)", laps["uncoloured"]["mesh"],
                        laps["coloured"]["mesh"], tex, texture_of(xq, "cpu"))
    chunked_launches = laps["coloured"]["launches"]
    rec["chunked"] = dict(col, **{k: laps["coloured"][k] for k in (
        "reconstruct_s", "extract_mesh_s", "colours_s", "launches")},
        uncoloured_extract_mesh_s=laps["uncoloured"]["extract_mesh_s"])
    print(f"[phase 13] (b) the coloured quadrant in four 10 m chunks (host "
          f"mesher on the union lattice): {col['verts']} vertices, v and f "
          f"bit-equal to the uncoloured lap's; colours equal to the CPU "
          f"run's but {col['differ']} (ties, worst {col['tie_worst']:.3e}); "
          f"colour evaluation {col['colour_s']:.4f} s on the card "
          f"(\"mc: colours\" {laps['coloured']['colours_s']:.4f} s); "
          f"reconstruct_s {laps['coloured']['reconstruct_s']:.3f} "
          f"extract_mesh_s {laps['coloured']['extract_mesh_s']:.3f} "
          f"(uncoloured {laps['uncoloured']['extract_mesh_s']:.3f}); "
          f"launches {chunked_launches}", flush=True)
    del laps, tex, crecon
    torch.cuda.empty_cache()

    # ---- (c) the neural head on the in-graph route
    cfg, lcfg, nparams = neural_setup(params, neural_ref["bias"])
    nrecon = Reconstructor(config=cfg, params=nparams)
    rec["ingraph"] = []
    ingraph_launches = None
    for i, (name, xs, ns) in enumerate(neural_scenes()):
        runs = []
        for _ in range(2):
            reset_counts(counters.values())
            t0 = time.perf_counter()
            field = nrecon.reconstruct(xs, ns, **INGRAPH_KW)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mesh = field.extract_dual_mesh(mise_iter=1)
            torch.cuda.synchronize()
            with torch.no_grad():
                f = field.evaluate_at(neural_probes(xs, i)).value.cpu()
            runs.append((t1 - t0, time.perf_counter() - t1, mesh, f,
                         read_counts(counters), field))
        (tr, tm, mesh, f, ln, field), second = runs[0], runs[1]
        if not isinstance(field, NeuralField) or "infer: field" not in \
                field.phase_times:
            raise AssertionError(f"[phase 13] (c) {name}: not the neural "
                                 "head's in-graph field")
        if not (np.array_equal(mesh.v, second[2].v)
                and np.array_equal(mesh.f, second[2].f)
                and torch.equal(f, second[3])):
            raise AssertionError(f"[phase 13] (c) {name}: two laps differ")
        if ln["segsum"] <= 0 or any(ln[k] for k in ln if k != "segsum"):
            raise AssertionError(f"[phase 13] (c) {name}: launches {ln} "
                                 "(the segment sum alone must run)")
        ingraph_launches = ingraph_launches or ln
        cpu = neural_ref["scenes"][i]
        card, _ = neural_infer(cfg, nrecon.network, xs, ns, "cuda")
        equal = check_predicted_hierarchy(card, cpu,
                                          tag=f"[phase 13] (c) {name}")
        if equal:
            for d, g in enumerate(field.host_grids):
                if not np.array_equal(g.coords, cpu["dec"][d]):
                    raise AssertionError(f"[phase 13] (c) {name}: the "
                                         "route's decoder grids differ "
                                         "from the CPU run's")
        ref_f = cpu["probe_f"]
        err = float((f - ref_f).abs().max()) / float(ref_f.abs().max())
        if equal and not err <= NEURAL_FIELD_TOL:
            raise AssertionError(f"[phase 13] (c) {name}: the field at the "
                                 f"probes differs from the CPU run's by "
                                 f"{err:.3e} of its largest |f|")
        if not (len(mesh.f) and np.isfinite(mesh.v).all()):
            raise AssertionError(f"[phase 13] (c) {name}: empty or "
                                 "non-finite mesh")
        rec["ingraph"].append({"name": name, "reconstruct_s": min(
            tr, second[0]), "extract_mesh_s": min(tm, second[1]),
            "verts": len(mesh.v), "faces": len(mesh.f), "field_err": err,
            "hierarchy_equal": equal})
        print(f"[phase 13] (c) {name}: reconstruct_s "
              f"{min(tr, second[0]):.3f} extract_mesh_s "
              f"{min(tm, second[1]):.3f} (dual_mc.py, no Newton step) verts "
              f"{len(mesh.v)} faces {len(mesh.f)}; two laps bit-equal; "
              f"hierarchy {'equal to' if equal else 'a tie against'} the CPU "
              f"run; field at {NEURAL_PROBES} probes {err:.3e} of the CPU "
              f"run's largest |f| (gate {NEURAL_FIELD_TOL}"
              f"{'' if equal else ', not gated: a tie'}); launches {ln}; "
              "phases " + json.dumps({k: round(v, 4) for k, v in
                                      field.phase_times.items()}),
              flush=True)
        del runs, field, second
    print(f"[phase 13] (c) SDF decoder bias offset by {-neural_ref['median']:.6f}"
          " (minus the median of the field at the first scene's points, "
          "CPU)", flush=True)
    del nrecon
    torch.cuda.empty_cache()

    # ---- (d) the neural head in training on phase 11's item
    _, _, _, _, _, batch, samples, _ = scene_train_setup()
    card = train_grads(cfg, lcfg, params, batch, samples, "cuda")
    cmp = compare_train("(d) neural step", card, neural_ref["step"], True,
                        TRAIN_LOSS_RTOL, TRAIN_SCENE_LEAF_RTOL,
                        TRAIN_UNET_TOL, TRAIN_STRUCT_RTOL,
                        whole_rtol=TRAIN_GRAD_RTOL, phase="phase 13")
    if "gt-surface-normal" not in card[0]:
        raise AssertionError("[phase 13] (d) no normal loss")
    tc = T.TrainConfig()
    finals, step_s, train_launches = [], [], None
    for _ in range(2):
        state = T.init_state(cfg, tc, params=params, device="cuda")
        sums = []
        for i in range(NEURAL_STEPS):
            reset_counts(counters.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses, _ = T.train_step(
                cfg, tc, lcfg, state, batch, torch.Generator().manual_seed(i))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            train_launches = read_counts(counters)
            sums.append(losses["sum"])
        finals.append(([p.detach().clone() for p in state.net.parameters()],
                       sums))
        del state
    same = all(torch.equal(a, b) for a, b in zip(finals[0][0], finals[1][0]))
    if not (same and finals[0][1] == finals[1][1]):
        raise AssertionError(f"[phase 13] (d) two {NEURAL_STEPS}-step runs "
                             "from one state differ")
    if train_launches["segsum"] <= 0 or train_launches["window"]:
        raise AssertionError(f"[phase 13] (d) a neural step's launches "
                             f"{train_launches}")
    rec["train"] = dict(cmp, step_s=step_s, sums=finals[0][1],
                        launches=train_launches)
    print(f"[phase 13] (d) two runs of {NEURAL_STEPS} neural steps from one "
          f"state: params and sums bit-equal ({finals[0][1]}); steps "
          + ", ".join(f"{t:.4f}" for t in step_s) + f" s; launches a step "
          f"{train_launches}", flush=True)
    del finals
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 13] {rec['seconds']:.1f} s", flush=True)
    return colored_launches, chunked_launches, ingraph_launches, \
        train_launches, rec


def print_mc_stages(tag, phases, before, labels):
    """The host mesher's stages of a lap beside another lap's."""
    mc = sorted(k for k in set(phases) | set(before)
                if k.startswith("mc: ") or k == "host dual mc")
    print(f"[{tag}] host MC stages, s ({labels}): "
          + "; ".join(f"{k} {phases.get(k, 0.0):.3f} / "
                      f"{before.get(k, 0.0):.3f}" for k in mc), flush=True)


def first_sub_tile(xyz, nrm):
    """The first of the tile's central 20 m sub-tiles in quadrant_error's
    order (x, y in (-20, 0)): its (xyz, nrm)."""
    m = (xyz[:, 0] < 0) & (xyz[:, 1] < 0) & (xyz[:, 0] > -20) \
        & (xyz[:, 1] > -20)
    return xyz[m], nrm[m]


def adaptive_unet_heads(cfg, net, xyz, nrm, device):
    """The gather-conv UNet with the adaptive decoder's row tables on
    ``device``: the basis and normal heads per depth, on the CPU."""
    from nksr_tpu_torch.core import host_build as HB
    from nksr_tpu_torch.models import sparse_unet as SU
    from nksr_tpu_torch.ops.gather_scatter import stencil_offsets
    from nksr_tpu_torch.recon.reconstructor import _next_pow2

    def caps_of(grids):
        return tuple(max(_next_pow2(int(len(g.keys) * 1.05)), 512)
                     for g in grids)

    def up(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64),
                               device=device)

    grids, orders = HB.build_splat_grids_ex(xyz, cfg.voxel_size,
                                            cfg.tree_depth)
    dec = HB.build_adaptive_grids(xyz, nrm, cfg.voxel_size, cfg.tree_depth,
                                  tau=cfg.adaptive_tau,
                                  adaptive_depth=cfg.adaptive_depth,
                                  splat=(grids, orders))
    caps, dec_caps = caps_of(grids), caps_of(dec)
    ut = HB.build_unet_tables(grids, caps, stencil_offsets(3))
    ut = HB.UNetTables(*(tuple(up(t) for t in part) for part in ut))
    splat0 = up(HB.support_indices(grids[:1], caps[:1], xyz,
                                   presorted=orders[:1])[0])
    rows = tuple(None if r is None else up(r)
                 for r in SU.decoder_rows(grids, dec))
    basis, normal, _ = SU.sparse_unet_apply(
        cfg, net, ut, [len(g.keys) for g in grids], caps,
        [up(g.coords) for g in grids],
        torch.as_tensor(xyz, device=device),
        torch.as_tensor(nrm, device=device), splat0, rows, dec_caps)
    return [len(g.keys) for g in dec], \
        [t.cpu() for t in basis], [t.cpu() for t in normal]


def adaptive_route_config():
    """Phase 14's configuration (see ADAPTIVE_ROUTE_TAU)."""
    from nksr_tpu_torch import PipelineConfig
    return PipelineConfig(conv_dtype="bfloat16", adaptive_depth=2,
                          adaptive_tau=ADAPTIVE_ROUTE_TAU)


def route_b_tile_lap(out_path: str) -> int:
    """Phase 14 (b)'s tile lap, run in its own process (``python3
    chip_smoke.py --route-b-tile OUT``) on the host's last
    TRAIN_REF_THREADS cores, beside phases 12 to 14 (a): its host mesher
    is the script's longest stage.  Its launches (the counts set to 0
    just before the lap and read just after, in that process) and its
    ``route_lap`` record go to ``out_path`` as JSON."""
    from nksr_tpu_torch import Reconstructor
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.scenes import synthetic_scene
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > TRAIN_REF_THREADS:
        os.sched_setaffinity(0, cores[-TRAIN_REF_THREADS:])
    torch.set_num_threads(TRAIN_REF_THREADS)
    recon = Reconstructor(config=adaptive_route_config(), params=load_tree(
        os.path.join(REPO, "runs", "scene_big", "best.ckpt")))
    _, _, launches, lap = route_lap(recon, synthetic_scene,
                                    kernel_counters(), 50.0, "adaptive",
                                    ADAPTIVE_ROUTE_B_POINTS)
    lap["cores"] = sorted(os.sched_getaffinity(0))
    with open(out_path + ".tmp", "w") as f:
        json.dump({"launches": launches, "lap": lap}, f)
    os.replace(out_path + ".tmp", out_path)
    return 0


def start_route_b_tile():
    """Start ``route_b_tile_lap`` in its own process; it is killed at
    exit if still running.  Returns (process, output path, start)."""
    import atexit
    out = os.path.join(REPO, "data", "chip_smoke_route_b_tile.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--route-b-tile", out], cwd=REPO)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    print(f"[phase 14] (b)'s tile lap started in its own process (pid "
          f"{proc.pid})", flush=True)
    return proc, out, time.perf_counter()


def finish_route_b_tile(ref):
    """Wait for ``route_b_tile_lap``: (launches, lap record)."""
    proc, out, t_start = ref
    t0 = time.perf_counter()
    rc = proc.wait(timeout=ROUTE_B_TILE_TIMEOUT)
    if rc != 0:
        raise AssertionError(f"[phase 14 (b)] the tile lap's process exited "
                             f"with {rc}")
    with open(out) as f:
        res = json.load(f)
    print(f"[phase 14 (b)] the tile lap ran in its own process on cores "
          f"{res['lap']['cores']}, beside phases 12 to 14 (a); waited "
          f"{time.perf_counter() - t0:.1f} s for it, "
          f"{time.perf_counter() - t_start:.1f} s after its start",
          flush=True)
    return res["launches"], res["lap"]


def adaptive_route_laps(params, counters, synthetic_scene, a_phases,
                        a_n0, b_phases, b_n0, b_tile):
    """Phase 14.  The adaptive structure (adaptive depth 2, tau
    ADAPTIVE_ROUTE_TAU) on route A (phase 5's 60 m tile) and route B
    (phase 4's 100 m tile, its lap in the process ``b_tile`` of
    ``start_route_b_tile``), one lap each, their central 20 m sub-tiles
    alone under 1.5x the JAX package's figures, one sub-tile of each
    route twice bit-equal, and the UNet's heads on the adaptive decoder
    card against CPU (see the module docstring).  ``a_phases``, ``a_n0``
    (``b_...``): phase 5's (phase 4's) phases and depth-0 voxels.
    Returns the two tile laps' launches and a record."""
    from nksr_tpu_torch import Reconstructor
    from nksr_tpu_torch.core import host_build as HB
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.meshing import lattice_mc as LMC
    from nksr_tpu_torch.models.network import NKSRNetwork
    from nksr_tpu_torch.recon import reconstructor as RC
    from nksr_tpu_torch.utils.checkpoint import params_to_torch
    t_phase = time.perf_counter()
    cfg = adaptive_route_config()
    ad = cfg.adaptive_depth
    recon = Reconstructor(config=cfg, params=params)
    rec = {"tau": ADAPTIVE_ROUTE_TAU}

    def check_route(tag, field, route):
        if not (recon._last_unet_engine == "sparse"
                and (field.lattice_ctx is not None) == (route == "A")
                and "host dual mc" in field.phase_times):
            raise AssertionError(f"[{tag}] not route {route}: unet "
                                 f"{recon._last_unet_engine}, phases "
                                 f"{sorted(field.phase_times)}")

    def check_decoder(tag, decoder, splat_n0):
        n0 = decoder[0]
        print(f"[{tag}] decoder voxels {decoder}: {n0} at depth 0 against "
              f"the splat hierarchy's {splat_n0}", flush=True)
        if not 0 < n0 < splat_n0:
            raise AssertionError(f"[{tag}] depth-0 decoder voxels {n0} not "
                                 f"above 0 and below the splat's "
                                 f"{splat_n0}")
        return n0

    # the configuration's own tau keeps no depth-0 voxel on this terrain
    xyz, nrm = synthetic_scene(N_POINTS, half_extent=30.0)
    splat = HB.build_splat_grids_ex(xyz, cfg.voxel_size, cfg.tree_depth)
    n0_default = len(HB.build_adaptive_grids(
        xyz, nrm, cfg.voxel_size, cfg.tree_depth, tau=0.1,
        adaptive_depth=ad, splat=splat)[0].keys)
    print(f"[phase 14] the 60 m tile at adaptive_tau 0.1 (host build): "
          f"{n0_default} depth-0 decoder voxels; at "
          f"{ADAPTIVE_ROUTE_TAU}: the laps below", flush=True)
    del splat
    rec["tile_a_n0_tau_0.1"] = n0_default

    # (a) route A, the 60 m tile
    field, mesh, a_launches, lap = route_lap(recon, synthetic_scene,
                                             counters, 30.0, "adaptive")
    print_route("phase 14 (a) route A", a_launches, lap)
    check_route("phase 14 (a)", field, "A")
    rec["tile_a_n0"] = check_decoder("phase 14 (a)", lap["decoder"], a_n0)
    # the segment sum at the encoder's splat and at each gradient
    # depth's normal prior
    check_lattice_launches("phase 14 (a)", a_launches, field, 1 + ad)
    print_mc_stages("phase 14 (a)", field.phase_times, a_phases,
                    "adaptive / phase 5, splat")
    rec["tile_a"] = lap
    del field, mesh
    torch.cuda.empty_cache()

    def sub_tile_laps(tag, xyz, nrm, route, limit, jax_err):
        """The tile's four central 20 m sub-tiles alone, pooled error;
        also the first sub-tile's (coefficients, vertices, faces), the
        first of (c)'s two laps."""
        first, out0 = [], []

        def lap(x, n):
            out = main_path_lap(recon, x, n, "adaptive")
            if not out0:
                out0.append(([a.clone() for a in out[2].alpha], out[3].v,
                             out[3].f))
            return out

        def on_lap(field, tr, tm):
            print(f"[{tag}] sub-tile: reconstruct_s {tr:.3f} extract_mesh_s "
                  f"{tm:.3f}", flush=True)
            check_route(tag, field, route)
            first.append(len(field.host_grids[0].keys))

        inner = (np.abs(xyz[:, 0]) < 20) & (np.abs(xyz[:, 1]) < 20)
        err = quadrant_error(recon, xyz[inner], nrm[inner], on_lap=on_lap,
                             lap=lap)
        print(f"[{tag}] the four central 20 m sub-tiles alone (depth-0 "
              f"decoder voxels {first}): terrain vertex error on {len(err)} "
              f"interior vertices: mean {err.mean():.5f} q90 "
              f"{np.quantile(err, 0.9):.5f} max {err.max():.5f} (the JAX "
              f"package, CPU: mean {jax_err}; limit {limit:.5f})",
              flush=True)
        if not (min(first) > 0 and err.mean() <= limit):
            raise AssertionError(f"[{tag}] sub-tile terrain error mean "
                                 f"{err.mean()} > {limit}, or an empty "
                                 f"depth-0 decoder ({first})")
        return {"err_mean": float(err.mean()),
                "err_q90": float(np.quantile(err, 0.9)),
                "err_max": float(err.max()), "n0": first}, out0[0]

    def twice(tag, before, x, n):
        """(c): the first sub-tile once more, coefficients and mesh
        bit-equal to its lap in ``sub_tile_laps`` (``before``)."""
        _, _, field, mesh = main_path_lap(recon, x, n, "adaptive")
        same = lap_diff(before, ([a.clone() for a in field.alpha], mesh.v,
                                 mesh.f))
        del field
        print(f"[{tag}] one sub-tile twice: " + same, flush=True)
        if "coefficients bit-equal" not in same or "mesh bit-equal" \
                not in same:
            raise AssertionError(f"[{tag}] two laps of one sub-tile are not "
                                 "bit-equal: " + same)
        return same

    first_tile = first_sub_tile(xyz, nrm)
    budgets = RC.DENSE_UNET_CELLMAP_BUDGET, LMC.DENSE_CELL_BUDGET
    RC.DENSE_UNET_CELLMAP_BUDGET = LMC.DENSE_CELL_BUDGET = 0
    try:
        rec["sub_tiles_a"], before = sub_tile_laps(
            "phase 14 (a) route A", xyz, nrm, "A", ADAPTIVE_ROUTE_A_LIMIT,
            JAX_ADAPTIVE_ROUTE_A_ERR)
        rec["repeat_a"] = twice("phase 14 (c) route A", before, *first_tile)
    finally:
        RC.DENSE_UNET_CELLMAP_BUDGET, LMC.DENSE_CELL_BUDGET = budgets
    del xyz, nrm
    torch.cuda.empty_cache()

    # (d) the UNet's heads on the adaptive decoder, card against CPU, on
    # route A's first sub-tile, f32 convs
    f32 = dataclasses.replace(cfg, conv_dtype="float32")
    nets = {}
    for dev in ("cuda", "cpu"):
        net = NKSRNetwork(f32)
        net.load_state_dict(params_to_torch(params), strict=True)
        nets[dev] = net.to(dev).eval().requires_grad_(False)
    t0 = time.perf_counter()
    dec_n, cb, cn = adaptive_unet_heads(f32, nets["cuda"], *first_tile,
                                        "cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, pb, pn = adaptive_unet_heads(f32, nets["cpu"], *first_tile, "cpu")
    t_cpu = time.perf_counter() - t0
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(cb + cn, pb + pn))
    print(f"[phase 14 (d)] gather-conv UNet heads on the adaptive decoder "
          f"(voxels {dec_n}), f32 convs, card against CPU tensors: max "
          f"|diff| over the largest |head| {worst:.3e} (limit "
          f"{ADAPTIVE_CARD_CPU_TOL}); card {t_card:.2f} s, CPU "
          f"{t_cpu:.2f} s", flush=True)
    if not (dec_n[0] > 0 and worst <= ADAPTIVE_CARD_CPU_TOL):
        raise AssertionError(f"[phase 14 (d)] heads differ by {worst} "
                             f"> {ADAPTIVE_CARD_CPU_TOL}, or no depth-0 "
                             "decoder voxel")
    rec["card_cpu_heads"] = worst
    del nets, cb, cn, pb, pn, first_tile
    torch.cuda.empty_cache()

    # (b) route B, the 100 m tile: its lap ran in its own process
    b_launches, lap = finish_route_b_tile(b_tile)
    print_route("phase 14 (b) route B", b_launches, lap)
    if (lap["unet"], lap["solve"], lap["mesher"]) != (
            "sparse", "support-row", "host"):
        raise AssertionError("[phase 14 (b)] the 100 m tile did not take "
                             "route B")
    rec["tile_b_n0"] = check_decoder("phase 14 (b)", lap["decoder"], b_n0)
    if b_launches["window"] <= 0 or b_launches["segsum"] <= 0:
        raise AssertionError(f"[phase 14 (b)] the window kernel or the "
                             f"segment sum did not run: {b_launches}")
    print_mc_stages("phase 14 (b)", lap["phases"], b_phases,
                    "adaptive / phase 4, splat")
    rec["tile_b"] = lap
    xyz, nrm = synthetic_scene(N_POINTS, half_extent=50.0)
    budget = LAT.LATTICE_COEFF_BUDGET
    LAT.LATTICE_COEFF_BUDGET = 0
    try:
        rec["sub_tiles_b"], before = sub_tile_laps(
            "phase 14 (b) route B", xyz, nrm, "B", ADAPTIVE_ROUTE_B_LIMIT,
            JAX_ADAPTIVE_ROUTE_B_ERR)
        rec["repeat_b"] = twice("phase 14 (c) route B", before,
                                *first_sub_tile(xyz, nrm))
    finally:
        LAT.LATTICE_COEFF_BUDGET = budget
    del xyz, nrm
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 14] {rec['seconds']:.1f} s", flush=True)
    return a_launches, b_launches, rec


def wheel_state_dict(net) -> dict:
    """``net``'s weights in a reference-wheel layout: each interpolator
    and decoder MLP as an ``nn.Sequential`` of Linear layers with SiLU
    between (``<family>[.<d>].net.<2i>.weight`` / ``.bias``), the
    encoder's and the UNet's tensors under other module names (the
    wheel's backbone is another architecture)."""
    sd = {}
    depth = len(list(net.interpolators.children()))
    mlps = [(f"interpolators.{d}", net.interpolators.level(d))
            for d in range(depth)]
    mlps += [(fam, getattr(net, fam)) for fam in ("sdf_decoder",
                                                  "udf_decoder")]
    for prefix, mlp in mlps:
        for i, layer in enumerate(mlp.layers()):
            sd[f"{prefix}.net.{2 * i}.weight"] = layer.weight.detach().cpu()
            sd[f"{prefix}.net.{2 * i}.bias"] = layer.bias.detach().cpu()
    for j, (k, v) in enumerate(net.state_dict().items()):
        fam = k.split(".")[0]
        if fam in ("encoder", "unet"):
            sd[f"{fam}.blocks.{j}.{k.rsplit('.', 1)[1]}"] = v.detach().cpu()
    return sd


def api_laps(params, recon, xyz, nrm, counters, splat_launches):
    """Phase 15, the public API (ROADMAP item 1).  (a) the reference
    recipe: scene_big's weights as a wheel-layout ``ks.pth`` in a
    temporary ``NKSR_TPU_CKPT_DIR``, resolved by ``configs.
    load_checkpoint_from_url("ks")`` and loaded into a Reconstructor that
    holds scene_big's backbone with its interpolators and decoders
    scrambled; its lap on phase 3's (-x, -y) 20 m quadrant bit-equal to
    the same lap under the load_tree weights, with phase 3's launches.
    (b) ``svh.SparseFeatureHierarchy`` from the quadrant's points as
    CUDA tensors, built on the host (the builders copy the points there
    and run ``core/host_build``'s, which the JAX package's in-graph
    builds are held to on the CPU) and placed on the card: the splat
    hierarchy equal to the lap's host grids, the adaptive one (adaptive
    depth 2, tau ADAPTIVE_ROUTE_TAU) to the host builder's, and
    ``evaluate_voxel_status``, which runs on the card, equal to the
    host's.  (c) the JAX package's canonical export of scene_big loads
    whole into a seeded network.  Returns the recipe lap's launches and a
    record."""
    import tempfile

    from nksr_tpu_torch import Reconstructor, configs, svh
    from nksr_tpu_torch.core import host_build as HB
    from nksr_tpu_torch.core import svh as CS
    from nksr_tpu_torch.utils import checkpoint as CK

    t_phase = time.perf_counter()
    cfg = recon.config
    m = (xyz[:, 0] < 0) & (xyz[:, 1] < 0)
    xq, nq = xyz[m], nrm[m]
    want = recon.network.state_dict()

    # (a) the recipe
    tree = CK.model_params(params)
    rng = np.random.default_rng(15)
    scrambled = dict(tree)
    for k in ("interpolators", "sdf_decoder", "udf_decoder"):
        scrambled[k] = CK._rebuild(tree[k], {
            n: (rng.normal(size=np.shape(a)) * 0.1).astype(np.float32)
            for n, a in CK._flat_dotted(tree[k]).items()})
    rec = Reconstructor(config=cfg, params={"params": scrambled})
    if all(torch.equal(rec.network.state_dict()[k], want[k])
           for k in want if k.startswith("interpolators")):
        raise AssertionError("[phase 15] the scrambled interpolators equal "
                             "the checkpoint's")
    saved = os.environ.get("NKSR_TPU_CKPT_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"state_dict": wheel_state_dict(recon.network)},
                   os.path.join(tmp, "ks.pth"))
        os.environ["NKSR_TPU_CKPT_DIR"] = tmp
        try:
            ckpt = configs.load_checkpoint_from_url("ks")
        finally:
            if saved is None:
                os.environ.pop("NKSR_TPU_CKPT_DIR")
            else:
                os.environ["NKSR_TPU_CKPT_DIR"] = saved
    print(f"[phase 15] configs.load_checkpoint_from_url('ks'): "
          f"{len(ckpt['state_dict'])} tensors; "
          "reconstructor.network.load_state_dict(ckpt['state_dict']):",
          flush=True)
    if rec.network.load_state_dict(ckpt["state_dict"]) is not rec.network:
        raise AssertionError("[phase 15] the wheel layout was not imported "
                             "by family")
    got = rec.network.state_dict()
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"[phase 15] after the import {len(differ)} "
                             f"tensors differ from load_tree's: {differ[:5]}")
    laps = {}
    for tag, r in (("load_tree", recon), ("recipe", rec)):
        reset_counts(counters.values())
        tr, tm, field, mesh = main_path_lap(r, xq, nq)
        laps[tag] = (read_counts(counters), tr, tm,
                     ([a.clone() for a in field.alpha], mesh.v, mesh.f))
        if tag == "recipe":
            lap_field = field
        del field, mesh
    launches, recipe_s = laps["recipe"][0], laps["recipe"][1:3]
    same = lap_diff(laps["recipe"][3], laps["load_tree"][3])
    print(f"[phase 15] (a) the recipe on the 20 m quadrant ({len(xq)} "
          f"points): reconstruct_s {laps['recipe'][1]:.3f} extract_mesh_s "
          f"{laps['recipe'][2]:.3f}, {lap_field.solver_stats}; against the "
          f"load_tree lap: {same}; launches {launches} (load_tree lap "
          f"{laps['load_tree'][0]}, phase 3's lap {splat_launches})",
          flush=True)
    if "coefficients bit-equal" not in same or "mesh bit-equal" not in same:
        raise AssertionError("[phase 15] the recipe's lap is not bit-equal "
                             "to the load_tree lap: " + same)
    if launches != splat_launches or launches != laps["load_tree"][0]:
        raise AssertionError(f"[phase 15] launches {launches}, phase 3's "
                             f"lap {splat_launches}")
    host = lap_field.host_grids
    del rec, laps
    torch.cuda.empty_cache()

    # (b) the hierarchy built on the host, placed on the card
    t_b = time.perf_counter()
    xt = torch.as_tensor(xq, device="cuda")
    nt = torch.as_tensor(nq, device="cuda")
    ones = torch.ones(len(xq), dtype=torch.bool, device="cuda")
    caps = [8 * len(xq)] * cfg.tree_depth
    vs = KW["voxel_size"]
    splat = svh.SparseFeatureHierarchy.build_point_splatting(
        xt, ones, vs, cfg.tree_depth, caps)
    adaptive = svh.SparseFeatureHierarchy.build_adaptive_normal_variation(
        xt, nt, ones, vs, cfg.tree_depth, caps, tau=ADAPTIVE_ROUTE_TAU,
        adaptive_depth=2)
    torch.cuda.synchronize()
    host_build_s = time.perf_counter() - t_b
    grids, orders = HB.build_splat_grids_ex(xq, vs, cfg.tree_depth)
    host_adaptive = HB.build_adaptive_grids(
        xq, nq, vs, cfg.tree_depth, tau=ADAPTIVE_ROUTE_TAU, adaptive_depth=2,
        splat=(grids, orders))
    n_status = 0
    for tag, h, ref in (("splat", splat, host),
                        ("adaptive", adaptive, host_adaptive)):
        for d, (g, hg) in enumerate(zip(h.grids, ref)):
            if not (g.device.type == "cuda" and g.num_voxels == len(hg.keys)
                    and np.array_equal(g.coords[:g.num_voxels].cpu().numpy(),
                                       hg.coords)):
                raise AssertionError(f"[phase 15] the card's {tag} level {d} "
                                     f"({g.num_voxels} voxels) differs from "
                                     f"the host's ({len(hg.keys)})")
            q = torch.cat([g.coords[:g.num_voxels],
                           g.coords[:g.num_voxels] + 1]).long()
            st = h.evaluate_voxel_status(q, d)
            ref_st = CS.evaluate_voxel_status(ref, q.cpu().numpy(), d)
            if not (st.device.type == "cuda"
                    and np.array_equal(st.cpu().numpy(), ref_st)):
                raise AssertionError(f"[phase 15] {tag} level {d}: the "
                                     "card's voxel status differs from the "
                                     "host's")
            n_status += len(q)
    print(f"[phase 15] (b) svh.SparseFeatureHierarchy from CUDA tensors, "
          f"built on the host and placed on the card in {host_build_s:.3f} "
          f"s (host time): splat levels {[g.num_voxels for g in splat.grids]}"
          f" equal to the lap's host grids, adaptive (depth 2, tau "
          f"{ADAPTIVE_ROUTE_TAU}) {[g.num_voxels for g in adaptive.grids]} "
          f"equal to the host builder's; evaluate_voxel_status on the card "
          f"at {n_status} voxels equal to the host's", flush=True)
    del splat, adaptive, xt, nt
    torch.cuda.empty_cache()

    # (c) the JAX package's canonical export
    export = CK.params_to_torch_state_dict({"params": tree})
    net = Reconstructor(config=cfg, seed=3).network
    res = net.load_state_dict(export)
    got = net.state_dict()
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"[phase 15] (c) the JAX canonical export ({len(export)} tensors, "
          f"3-D conv kernels) into a seeded network: missing "
          f"{res.missing_keys}, unexpected {res.unexpected_keys}, "
          f"{len(want) - len(differ)} of {len(want)} tensors equal to "
          "load_tree's", flush=True)
    if differ or res.missing_keys or res.unexpected_keys:
        raise AssertionError(f"[phase 15] the JAX export did not load whole: "
                             f"{differ[:5]}")
    del net
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    return launches, {"seconds": seconds, "quadrant_points": int(len(xq)),
                      "recipe_reconstruct_s": recipe_s[0],
                      "recipe_extract_mesh_s": recipe_s[1],
                      "svh_host_build_s": host_build_s}


def kernel_counters() -> dict:
    """The main path's counted kernel wrappers, by key."""
    from nksr_tpu_torch.fields import lattice_kernels as LK
    from nksr_tpu_torch.ops import segment_sum as SEG
    from nksr_tpu_torch.ops import window_basis as WB
    return {"fwd": LK.av0_cascade, "adj": LK.av0_adjoint_cascade,
            "window": WB.window_and_grad_fused, "rows": LK.av0_rows,
            "adj_rows": LK.av0_adjoint_rows, "segsum": SEG.segment_sum}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nksr_tpu_torch import PipelineConfig, Reconstructor
    from nksr_tpu_torch import cuda_build as CB
    from nksr_tpu_torch.fields import lattice as LAT
    from nksr_tpu_torch.fields import lattice_kernels as LK
    from nksr_tpu_torch.fields import support as S
    from nksr_tpu_torch.ops import probes as P
    from nksr_tpu_torch.ops import segment_sum as SEG
    from nksr_tpu_torch.ops import sorted_scatter as SS
    from nksr_tpu_torch.ops import window_basis as WB
    from nksr_tpu_torch.recon import solve_tail as ST
    from nksr_tpu_torch.scripts import microbench_scatter as MB
    from nksr_tpu_torch.scripts import probe_kernels as PK
    from nksr_tpu_torch.scripts import time_adjoint as TA
    from nksr_tpu_torch.scripts import time_rows as TR
    from nksr_tpu_torch.train.driver import pipeline_config_from_yaml
    from nksr_tpu_torch.utils.checkpoint import load_tree
    from nksr_tpu_torch.utils.config import load_config
    from nksr_tpu_torch.utils.scenes import synthetic_scene
    counters = kernel_counters()
    scatter_counters = (SS.scatter_rate_write, SS.scatter_rate_read,
                        SS.blocked_sorted_scatter)

    # ---- phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[phase 0] {kind}  torch {torch.__version__}  CUDA "
          f"{torch.version.cuda}  devices {torch.cuda.device_count()}",
          flush=True)

    # ---- phase 1: build
    for name, (lib, build_s, ptxas) in CB.build_kernels().items():
        print(f"[phase 1] nvcc sm_90a build of csrc/{name}.cu -> "
              f"{os.path.relpath(lib, REPO)} in {build_s:.2f} s", flush=True)
        for line in ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())

    # ---- phase 11's CPU reference, in its own process from here on
    train_ref = start_train_reference()

    # ---- phase 1: the probe run (its own path), then each probe kernel
    # against its plain version
    t_phase = time.perf_counter()
    reset_counts(P.PROBES)
    reset_counts(counters.values())
    probe_res = PK.run_probes(
        "cuda", log=lambda m: print("[phase 1] probe " + m, flush=True))
    probe_launches = {p.key: p.launches for p in P.PROBES}
    # the dense adjoint's own path since the solve reads slot rows: the
    # probe run's cascade checks at the bisect's depth-2 spec
    probe_adj_launches = LK.av0_adjoint_cascade.launches
    failed = [r["name"] for r in probe_res if not r["ok"]]
    if failed:
        raise AssertionError(f"[phase 1] probes failed: {failed}")
    if min(probe_launches.values()) <= 0:
        raise AssertionError(f"[phase 1] a probe kernel did not run: "
                             f"{probe_launches}")
    probe_cmp = compare_probes(P, seed=1)
    probe_err = {r["name"]: r["max_abs_err"] for r in probe_res}
    # the launch floor: an empty kernel timed as the kernels beside it are
    # (the probes and the rate kernels in one CUDA graph, the rest by
    # CUDA events over back-to-back launches)
    floor_graph = graph_ms(lambda: P.launch_floor("cuda"), 100)
    floor_events = cuda_ms(lambda: P.launch_floor("cuda"), 20)
    print(f"[phase 1] launch floor (an empty kernel): "
          f"{floor_graph * 1e3:.2f} us a launch in one CUDA graph of 100, "
          f"{floor_events * 1e3:.2f} us by CUDA events over 20 "
          "back-to-back launches", flush=True)
    print(f"[phase 1] {len(P.PROBES)} probe kernels against their plain "
          "versions: " + ", ".join(f"{k} {v['ms'] * 1e3:.1f} us"
                                   for k, v in probe_cmp.items())
          + f"; probes and checks {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 2: kernels vs plain versions (the bisect's and the test's
    # specs, then the plan spec of the main path, taken from a warm-up lap
    # of phase 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dims in (BISECT_DIMS, SMALL_DIMS):
        small = LAT.LatticeSpec(dims=dims, k=4, depth=len(dims),
                                adaptive_depth=1, s_pt=64, p_rows=4, s_gr=32,
                                n_pts_cap=256)
        res_small = compare_kernels(LK, small, gen, timed=False)
        xs_small = [torch.randn((small.n_cells(d), small.k), device="cuda",
                                generator=gen) for d in range(small.depth)]
        cells_small = row_cells(small, gen)
        compare_rows(LK, small, xs_small, cells_small, timed=False)
        adj_cells, adj_kept = random_slot_cells(small, gen, 3000)
        adj_small = compare_adjoint_rows(LK, TA, small, adj_cells, adj_kept,
                                         adj_cells.numel() // 2, gen,
                                         timed=False)
        print(f"[phase 2] spec {dims}: forward exact (f32, bf16), adjoint "
              f"max err {res_small['adj_err']:.3e}, pair rel "
              f"{res_small['pair_rel']:.2e}; slot rows exact (f32, bf16) "
              f"at {len(cells_small)} unsorted cells with edge planes and "
              f"repeats; slot-row adjoint at {adj_cells.numel()} slots on "
              f"{adj_small['distinct']} cells: the dense kernel's result "
              "(bf16, f32), two calls bit-equal", flush=True)
    for r, c, t in ((20000, 7, 3000), (4096, 128, 900), (50000, 3, 400)):
        idx, vals = seg_inputs(gen, r, c, t)
        seg_small = compare_segment_sum(SEG, vals, idx, t, timed=False)
        print(f"[phase 2] segment sum at {r} rows x {c} onto {t} targets "
              f"({seg_small['segments']} segments, longest "
              f"{seg_small['longest']}): bit-equal to the plain version "
              "(dense, compact), two calls bit-equal", flush=True)
    win_small = compare_window(WB, window_offsets(1000, gen), timed=False)
    print(f"[phase 2] window kernel at Q 1000: max err "
          f"{win_small['err']:.3e}", flush=True)

    xyz, nrm = synthetic_scene(N_POINTS)
    params = load_tree(os.path.join(REPO, "runs", "scene_big", "best.ckpt"))
    recon = Reconstructor(config=PipelineConfig(conv_dtype="bfloat16"),
                          params=params)
    # warm-up lap, capturing the slot cells and the first matvec's
    # coefficients
    (((tr, tm, field, mesh), _, slot_cells, xs_mv), (_, adj_kept)), \
        splat_args = TR.capture_first(
            SEG, "index_sum", lambda: TR.capture_first(
                LK, "adjoint_rows_tables", lambda: TR.capture_rows(
                    LK, lambda: main_path_lap(recon, xyz, nrm))))
    print(f"[phase 3] warm-up lap: reconstruct_s {tr:.3f} extract_mesh_s "
          f"{tm:.3f}", flush=True)
    spec = field.lattice_ctx.spec
    del field, mesh
    torch.cuda.empty_cache()
    rows_res = compare_rows(LK, spec, xs_mv, slot_cells, timed=True)
    rb, rby = rows_res["bound"]
    n_distinct = int(torch.unique(slot_cells).numel())
    print(f"[phase 2] slot rows at the main path: {len(slot_cells)} slot "
          f"cells ({n_distinct} distinct), the first matvec's "
          "coefficients: exact (f32, bf16; against the plain version and "
          "the dense plain forward's rows); bf16 kernel "
          f"{rows_res['ms']:.4f} ms (turns {rows_res['ms_turns'][0]:.4f}, "
          f"{rows_res['ms_turns'][1]:.4f}; plain {rows_res['plain_ms']:.3f}"
          f", bound {rb:.4f} by {rby}); the chain it replaces (dense bf16 "
          f"forward + 2 row gathers + casts) {rows_res['chain_ms']:.4f} ms "
          f"(turns {rows_res['chain_turns'][0]:.4f}, "
          f"{rows_res['chain_turns'][1]:.4f})", flush=True)
    del xs_mv
    torch.cuda.empty_cache()
    adj_res = compare_adjoint_rows(LK, TA, spec, slot_cells, adj_kept,
                                   spec.s_pt, gen, timed=True)
    ajb, ajby = adj_res["bound"]
    stages = "; ".join(f"{name} {ms:.4f}" for name, ms in
                       adj_res["stage_ms"].items()) or "not measured"
    print(f"[phase 2] slot-row adjoint at the main path: {len(slot_cells)} "
          f"slot rows on {adj_res['distinct']} cells in "
          f"{adj_res['bricks']} of {adj_res['of_bricks']} bricks, "
          f"{adj_res['live_tiles']} of {adj_res['tiles']} coefficient tiles "
          "live: the dense kernel's result on the CPU-built buffer (bf16, "
          f"f32; a + 0.0), two calls bit-equal, max err against plain "
          f"{adj_res['err']:.3e}; bf16 {adj_res['ms']:.4f} ms (turns "
          f"{adj_res['ms_turns'][0]:.4f}, {adj_res['ms_turns'][1]:.4f}; "
          f"f32 {adj_res['f32_ms']:.4f}; plain {adj_res['plain_ms']:.3f}; "
          f"bound {ajb:.4f} by {ajby}); its kernels (profiler, device ms a "
          f"call): {stages}; the chain it replaces (zeros + 2 "
          f"index_add_ + dense adjoint) {adj_res['chain_ms']:.4f} ms (turns "
          f"{adj_res['chain_turns'][0]:.4f}, "
          f"{adj_res['chain_turns'][1]:.4f}); its tables, once a solve, "
          f"{adj_res['tables_ms']:.3f} ms", flush=True)
    torch.cuda.empty_cache()
    sv, si, sn = splat_args
    seg_res = compare_segment_sum(SEG, sv, si, sn, timed=True)
    sgb, sgby = seg_res["bound"]
    print(f"[phase 2] segment sum at the encoder splat: {sv.shape[0]} rows "
          f"x {sv.shape[1]} onto {sn} cells ({seg_res['segments']} "
          f"segments, longest {seg_res['longest']}): bit-equal to the plain"
          f" version, two calls bit-equal; {seg_res['ms']:.4f} ms (turns "
          f"{seg_res['ms_turns'][0]:.4f}, {seg_res['ms_turns'][1]:.4f}; "
          f"plain {seg_res['plain_ms']:.4f}; bound {sgb:.4f} by {sgby}); "
          f"zeros + index_add_ {seg_res['library_ms']:.4f} ms; its order "
          f"{seg_res['order_ms']:.4f} ms", flush=True)
    del sv, si, splat_args
    torch.cuda.empty_cache()
    res = compare_kernels(LK, spec, gen, timed=True)
    (fb, fby), (ab, aby), (ab16, _) = av0_bounds(spec)
    print(f"[phase 2] main-path spec {spec.dims} lanes {spec.lanes}: "
          f"forward exact (f32, bf16), adjoint max err {res['adj_err']:.3e} "
          "in its three forms, bit-equal from call to call, pair rel "
          f"{res['pair_rel']:.2e}", flush=True)
    print(f"[phase 2] adjoint on a bf16 buffer {res['adj_bf16_ms']:.3f} ms "
          f"(bound {ab16:.3f} ms)", flush=True)
    print(f"[phase 2] bf16 forward {res['fwd_ms']:.4f} ms (turns "
          f"{res['fwd_turns'][0]:.4f}, {res['fwd_turns'][1]:.4f}; bound "
          f"{fb:.4f} by {fby}, {fb / res['fwd_ms']:.0%} of it; plain "
          f"{res['fwd_plain_ms']:.3f}; write ceiling, empty_like(out)"
          f".zero_() of the same bytes, {res['fwd_ceiling_ms']:.4f}); "
          f"adjoint on the solve's f32 buffer read in bf16 "
          f"{res['adj_ms']:.3f} ms (plain {res['adj_plain_ms']:.3f}, bound "
          f"{ab:.3f} by {aby})", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at the bench's size, two timed laps
    laps, lap_out = [], []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        tr, tm, field, mesh = main_path_lap(recon, xyz, nrm)
        launches = read_counts(counters)
        laps.append((tr, tm))
        lap_out.append(([a.clone() for a in field.alpha], mesh.v, mesh.f))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[phase 3] lap: reconstruct_s {tr:.3f} extract_mesh_s "
              f"{tm:.3f} phases "
              + json.dumps({k: round(v, 4)
                            for k, v in field.phase_times.items()}),
              flush=True)
    tr, tm = min(t[0] for t in laps), min(t[1] for t in laps)
    splat_lap = (tr, tm)
    err, n_inner = terrain_error(mesh)
    print(f"[phase 3] {N_POINTS} points: reconstruct_s {tr:.3f} "
          f"extract_mesh_s {tm:.3f} pts/s {N_POINTS / (tr + tm):.1f} "
          f"mesh verts {len(mesh.v)} faces {len(mesh.f)}", flush=True)
    print(f"[phase 3] {field.solver_stats}  launches {launches}  peak "
          f"memory {peak:.2f} GiB", flush=True)
    same = lap_diff(*lap_out)
    print("[phase 3] the two laps on one input: " + same, flush=True)
    del lap_out
    if "coefficients bit-equal" not in same or "mesh bit-equal" not in same:
        raise AssertionError("[phase 3] two splat laps on one input are not "
                             "bit-equal: " + same)
    print(f"[phase 3] terrain vertex error on {n_inner} interior vertices: "
          f"mean {err.mean():.5f} q90 {np.quantile(err, 0.9):.5f} max "
          f"{err.max():.5f} (limit {ERR_LIMIT})", flush=True)
    check_lattice_launches("phase 3", launches, field)
    if not len(mesh.f) or not np.isfinite(mesh.v).all():
        raise AssertionError("empty or non-finite mesh")
    if not err.mean() <= ERR_LIMIT:
        raise AssertionError(f"terrain error mean {err.mean()} > {ERR_LIMIT}")
    splat_launches = launches
    splat_n0 = len(field.host_grids[0].keys)
    del field, mesh
    torch.cuda.empty_cache()
    q_err = quadrant_error(recon, xyz, nrm)
    print(f"[phase 3] the four 20 m quadrants alone: terrain vertex error on "
          f"{len(q_err)} interior vertices: mean {q_err.mean():.5f} q90 "
          f"{np.quantile(q_err, 0.9):.5f} max {q_err.max():.5f} (the JAX "
          f"package, CPU: mean {JAX_QUADRANT_ERR}; limit {ERR_LIMIT:.5f})",
          flush=True)
    if not q_err.mean() <= ERR_LIMIT:
        raise AssertionError(f"quadrant terrain error mean {q_err.mean()} > "
                             f"{ERR_LIMIT}")
    torch.cuda.empty_cache()
    rows, dev_ms, primal_mv_ms = profile_matvec(LAT, recon, xyz, nrm)
    if rows:
        print(f"[phase 3] profiled matvec: device total {dev_ms:.3f} ms "
              f"(CUDA events {primal_mv_ms:.3f} ms a matvec); top ten: "
              + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                          for t, name, n in rows[:10]), flush=True)
    else:
        print("[phase 3] profiled matvec: the profiler saw no device time; "
              f"CUDA events {primal_mv_ms:.3f} ms a matvec", flush=True)
    torch.cuda.empty_cache()
    split = profile_solve(ST, recon, xyz, nrm)
    print("[phase 3] profiled lattice solve, host ms / device ms: "
          + "; ".join(f"{name} {h:.3f} / {dv:.3f}" for name, h, dv in split),
          flush=True)
    torch.cuda.empty_cache()

    # ---- phase 4: route B (plan over the lattice budget)
    field, mesh, b_launches, lap = route_lap(recon, synthetic_scene, counters,
                                             50.0)
    print_route("phase 4", b_launches, lap)
    if not (recon._last_unet_engine == "sparse" and field.lattice_ctx is None
            and "host dual mc" in field.phase_times):
        raise AssertionError("[phase 4] the 100 m tile did not take route B")
    if b_launches["window"] <= 0 or b_launches["segsum"] <= 0:
        raise AssertionError(f"[phase 4] the window kernel or the segment "
                             f"sum did not run on route B: {b_launches}")
    cfg = recon.config
    q_b = min(S._MLP_CHUNK, sum(len(g.keys) for g in
                                field.host_grids[:cfg.adaptive_depth]))
    b_phases, b_n0 = dict(field.phase_times), len(field.host_grids[0].keys)
    del field, mesh
    torch.cuda.empty_cache()
    win = compare_window(WB, window_offsets(q_b, gen), timed=True)
    print(f"[phase 2] window kernel at route B's Q {q_b}: max err "
          f"{win['err']:.3e}; {win['ms']:.4f} ms (plain {win['plain_ms']:.4f}"
          f", bound {win['bound'][0]:.4f} by {win['bound'][1]})", flush=True)

    # ---- phase 5: route A (feature lattices over the dense UNet budget)
    field, mesh, a_launches, lap = route_lap(recon, synthetic_scene, counters,
                                             30.0)
    print_route("phase 5", a_launches, lap)
    if not (recon._last_unet_engine == "sparse"
            and field.lattice_ctx is not None
            and "host dual mc" in field.phase_times):
        raise AssertionError("[phase 5] the 60 m tile did not take route A")
    check_lattice_launches("phase 5", a_launches, field)
    a_phases, a_lap = dict(field.phase_times), lap
    a_n0 = len(field.host_grids[0].keys)
    del field, mesh
    torch.cuda.empty_cache()

    # ---- phase 7: the predicted structure (the default route) and the
    # adaptive one on the 40 m tile, and the predicted one on its
    # quadrants alone
    pred_launches, pred_lap = structure_laps(
        recon, xyz, nrm, counters, splat_n0,
        Reconstructor(config=PipelineConfig(conv_dtype="bfloat16",
                                            adaptive_depth=2), params=params))
    torch.cuda.empty_cache()

    # ---- phase 8: the checkpoint under its own config.yaml (UDF mask head
    # on), bf16 convs: predicted, splat and route A
    udf_cfg = dataclasses.replace(pipeline_config_from_yaml(load_config(
        os.path.join(REPO, UDF_CONFIG))), conv_dtype="bfloat16")
    if not udf_cfg.udf_enabled:
        raise AssertionError(f"[phase 8] {UDF_CONFIG} has no UDF head")
    print(f"[phase 8] {UDF_CONFIG}: {udf_cfg}", flush=True)
    udf_recon = Reconstructor(config=udf_cfg, params=params)
    udf_launches = udf_laps(udf_recon, xyz, nrm, counters, synthetic_scene,
                            a_phases, a_lap)
    torch.cuda.empty_cache()

    # ---- phase 9: the README's lidar recipe (normals from the sensor,
    # chunked reconstruction, the stitched mesh) under the same
    # configuration
    t_phase = time.perf_counter()
    chunked_launches = chunked_laps(udf_recon, counters, synthetic_scene)
    print(f"[phase 9] {time.perf_counter() - t_phase:.1f} s", flush=True)
    del udf_recon
    torch.cuda.empty_cache()

    # ---- phase 10: the dual (row-space) formulation
    t_phase = time.perf_counter()
    dual_launches, dual_pred_launches, mid = dual_laps(
        params, xyz, nrm, counters, spec, slot_cells, adj_kept, gen,
        primal_mv_ms)
    print(f"[phase 10] {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 11: training at runs/scene_big's width
    t_phase = time.perf_counter()
    train_launches, (train_gather, train_segbwd), train_rec = \
        training_laps(params, counters, gen, train_ref)
    # the host laps that ran beside the CPU reference, again after it
    for structure, before in (("splat", splat_lap), ("predicted", pred_lap)):
        laps = [main_path_lap(recon, xyz, nrm, structure)[:2]
                for _ in range(2)]
        print(f"[phase 11] {structure} lap after the CPU reference (the faster of "
              f"two): reconstruct_s {min(t[0] for t in laps):.3f} "
              f"extract_mesh_s {min(t[1] for t in laps):.3f} (beside it: "
              f"{before[0]:.3f} + {before[1]:.3f})", flush=True)
    print(f"[phase 11] {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    # phase 14 (b)'s tile lap, beside phases 12 to 14 (a) on the cores
    # the CPU reference used
    b_tile = start_route_b_tile()

    # ---- phase 12: the in-graph route, its mesher and per-chunk meshing
    ingraph_launches, ingraph_rec, ingraph_win = ingraph_laps(
        params, counters, WB, S, synthetic_scene)
    print("[phase 12] record " + json.dumps(ingraph_rec), flush=True)
    torch.cuda.empty_cache()

    # ---- phase 13: texture fields on every mesher, the neural head on
    # the in-graph route and in training
    (tex_launches, tex_chunked_launches, neural_launches,
     neural_train_launches, tn_rec) = texture_neural_laps(
        params, counters, recon, xyz, nrm, train_rec.pop("neural_ref"))
    print("[phase 13] record " + json.dumps(tn_rec), flush=True)
    torch.cuda.empty_cache()

    # ---- phase 14: the adaptive structure on routes A and B
    ad_a_launches, ad_b_launches, ad_rec = adaptive_route_laps(
        params, counters, synthetic_scene, a_phases, a_n0, b_phases, b_n0,
        b_tile)
    print("[phase 14] record " + json.dumps(ad_rec), flush=True)
    torch.cuda.empty_cache()

    # ---- phase 15: the public API: the reference recipe's checkpoint
    # load, the hierarchy classes on the card, the JAX canonical export
    api_launches, api_rec = api_laps(params, recon, xyz, nrm, counters,
                                     splat_launches)
    print(f"[phase 15] {api_rec['seconds']:.1f} s; record "
          + json.dumps(api_rec), flush=True)
    print(smi, flush=True)
    if api_rec["seconds"] > API_PHASE_LIMIT_S:
        raise AssertionError(f"[phase 15] took {api_rec['seconds']:.1f} s, "
                             f"over {API_PHASE_LIMIT_S} s")
    torch.cuda.empty_cache()

    # ---- phase 6: the row-stage scatter microbenchmark (its own path)
    t_phase = time.perf_counter()
    reset_counts(scatter_counters)
    bench_res = MB.run("cuda", log=lambda m: print("[phase 6] " + m,
                                                   flush=True))
    scatter_launches = [fn.launches for fn in scatter_counters]
    print(f"[phase 6] launches {scatter_launches} in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if min(scatter_launches) <= 0:
        raise AssertionError(f"[phase 6] a scatter kernel did not run: "
                             f"{scatter_launches}")

    kernels = [
        {"name": "av0_cascade", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:189",
         "launches": splat_launches["fwd"], "max_abs_err": res["fwd_err"],
         "ms": res["fwd_ms"], "plain_ms": res["fwd_plain_ms"],
         "bound_ms": fb, "bound_by": fby, "library_ms": None,
         "write_ceiling_ms": res["fwd_ceiling_ms"]},
        {"name": "av0_rows", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:189 + "
                     "nksr_tpu/fields/lattice.py:874",
         "launches": splat_launches["rows"],
         "max_abs_err": rows_res["err"],
         "ms": rows_res["ms"], "plain_ms": rows_res["plain_ms"],
         "bound_ms": rb, "bound_by": rby, "library_ms": None},
        # the dense adjoint: 0 launches on the lattice laps (checked), its
        # launches are the probe run's
        {"name": "av0_adjoint_cascade", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:279",
         "launches": probe_adj_launches, "max_abs_err": res["adj_err"],
         "ms": res["adj_ms"], "plain_ms": res["adj_plain_ms"],
         "bound_ms": ab, "bound_by": aby, "library_ms": None},
        # library: the chain it replaces, timed in the same call
        {"name": "av0_adjoint_rows", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/av0_cascade.cu",
         "replaces": "nksr_tpu/fields/lattice_pallas.py:279 + "
                     "nksr_tpu/fields/lattice.py:1231",
         "launches": splat_launches["adj_rows"],
         "max_abs_err": adj_res["err"], "ms": adj_res["ms"],
         "plain_ms": adj_res["plain_ms"], "bound_ms": ajb, "bound_by": ajby,
         "library_ms": adj_res["chain_ms"]},
        # no TPU kernel: XLA's ordered scatter-add; bit-equal to plain
        {"name": "segment_sum", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/segment_sum.cu",
         "replaces": "nksr_tpu/fields/lattice.py:1231",
         "launches": splat_launches["segsum"],
         "max_abs_err": seg_res["err"],
         "ms": seg_res["ms"], "plain_ms": seg_res["plain_ms"],
         "bound_ms": sgb, "bound_by": sgby,
         "library_ms": seg_res["library_ms"]},
        {"name": "window_and_grad_fused", "route": "cuda",
         "source": "nksr_tpu_torch/csrc/window_basis.cu",
         "replaces": "nksr_tpu/ops/pallas/window_basis.py:53",
         "launches": b_launches["window"], "max_abs_err": win["err"],
         "ms": win["ms"], "plain_ms": win["plain_ms"],
         "bound_ms": win["bound"][0], "bound_by": win["bound"][1],
         "library_ms": None},
    ]
    for rec, key in zip(kernels, ("fwd", "rows", "adj", "adj_rows",
                                  "segsum", "window")):
        rec["floor_ms"] = floor_events      # each timed by CUDA events
        rec["launches_predicted"] = pred_launches[key]
        rec["launches_udf"] = udf_launches[key]
        rec["launches_chunked"] = chunked_launches[key]
        rec["launches_dual"] = dual_launches[key]
        rec["launches_dual_predicted"] = dual_pred_launches[key]
        rec["launches_train"] = train_launches[key]
        rec["launches_train_predicted"] = \
            train_rec["predicted"]["launches"][key]
        rec["launches_ingraph"] = ingraph_launches[key]
        rec["launches_colored"] = tex_launches[key]
        rec["launches_colored_chunked"] = tex_chunked_launches[key]
        rec["launches_neural_ingraph"] = neural_launches[key]
        rec["launches_neural_train"] = neural_train_launches[key]
        rec["launches_adaptive_a"] = ad_a_launches[key]
        rec["launches_adaptive_b"] = ad_b_launches[key]
        rec["launches_api"] = api_launches[key]
    # the training step's backwards at its shapes: the gather's (the
    # segment sum over an order built in the backward) and the segment
    # sum's own (a row gather, no kernel)
    gb_, gby = train_gather["bound"]
    sb_, sby = train_segbwd["bound"]
    kernels[4].update(
        train_gather_backward_ms=train_gather["ms"],
        train_gather_backward_plain_ms=train_gather["plain_ms"],
        train_gather_backward_library_ms=train_gather["library_ms"],
        train_gather_backward_bound_ms=gb_,
        train_gather_backward_bound_by=gby,
        train_segment_sum_backward_ms=train_segbwd["ms"],
        train_segment_sum_backward_gather_ms=train_segbwd["plain_ms"],
        train_segment_sum_backward_bound_ms=sb_,
        train_segment_sum_backward_bound_by=sby,
        train_step_s=train_rec["warm_s"],
        train_step_peak_gib=train_rec["peak_gib"],
        train_predicted_step_s=train_rec["predicted"]["warm_s"],
        train_predicted_step_peak_gib=train_rec["predicted"]["peak_gib"],
        train_gather_backwards=train_rec["gathers"]["gathers"],
        train_gather_sorts=train_rec["gathers"]["sorts"])
    # the window kernel at each input of one training step
    kernels[5].update(
        max_abs_err=max([win["err"], ingraph_win["err"]]
                        + [w["err"] for w in train_rec["window"]]),
        ingraph_newton={"q": ingraph_win["q"],
                        "ms": ingraph_win["ms"],
                        "plain_ms": ingraph_win["plain_ms"],
                        "bound_ms": ingraph_win["bound"][0],
                        "bound_by": ingraph_win["bound"][1],
                        "max_abs_err": ingraph_win["err"]},
        train=[{k: w[k] for k in ("q", "ms", "plain_ms", "bound_ms",
                                  "bound_by")} | {"max_abs_err": w["err"]}
               for w in train_rec["window"]])
    # the dual's middle: the slot-row adjoint (f32) then the slot rows,
    # and the literal chain it stands for, at the main path's slot cells
    kernels[3].update(gram_middle_ms=mid["ms"],
                      gram_middle_literal_ms=mid["literal_ms"],
                      gram_middle_plain_ms=mid["plain_ms"],
                      gram_middle_bound_ms=mid["bound"])
    # the scatter kernels at w = 32 (the study's width; phase 6 prints
    # w = 128 too): the blocked one on unique indices, by CUDA events; the
    # rate kernels at the study's shape, as device time in one CUDA graph
    # (their events figures and their row stage's records beside it);
    # max_abs_err over every check of the run
    for fn, body in zip(scatter_counters, (":69", ":78", ":129")):
        rec = bench_res[fn.__name__]
        kb, kby = bound_ms(rec["bytes"], rec["ops"])
        kernels.append(
            {"name": fn.__name__, "route": "cuda",
             "source": "nksr_tpu_torch/csrc/sorted_scatter.cu",
             "replaces": "scripts/microbench_scatter.py" + body,
             "launches": fn.launches, "max_abs_err": rec["max_abs_err"],
             "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": kb,
             "bound_by": kby, "library_ms": rec["library_ms"],
             "floor_ms": rec["floor_ms"],
             **{k: rec[k] for k in ("events_ms", "plain_events_ms",
                                    "library_events_ms", "row_stage")
                if k in rec}})
    for p in P.PROBES:
        rec = probe_cmp[p.key]
        kernels.append(
            {"name": f"probe_{p.key}", "route": "cuda",
             "source": "nksr_tpu_torch/csrc/probes.cu",
             "replaces": p.replaces, "launches": probe_launches[p.key],
             "max_abs_err": max(rec["err"], probe_err[p.name]),
             "ms": rec["ms"], "plain_ms": rec["plain_ms"],
             "bound_ms": rec["bound"][0], "bound_by": rec["bound"][1],
             "library_ms": None, "floor_ms": floor_graph})
    print(smi, flush=True)      # again, where a tail of the output keeps it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--train-cpu-reference":
        sys.exit(train_cpu_reference(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--route-b-tile":
        sys.exit(route_b_tile_lap(sys.argv[2]))
    sys.exit(main())
