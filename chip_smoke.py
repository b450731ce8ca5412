#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. Setup: print the card's name and power limit (nvidia-smi) and build
   every CUDA kernel of the port from `structure_slam_pointline_tpu_torch/csrc`
   (one nvcc per source, in parallel), printing the build seconds.
2. End to end on the bench scene of bench.py (640x480, make_room_scene(350,
   40, seed=0), a 610-frame circular_trajectory of radius 0.5, noise 2.0)
   at the full default configuration (1024 keypoints, 2048 at init, 8
   levels, 64 lines from 2 octaves with 256 anchors and 48 walk steps,
   256 KF / 32768 points / 2048 lines, local caps 2048 / 256):
   a. the main path, `SLAMConfig()` with lines on: bootstrap through
      `SLAMSystem.track()` (must initialize within 90 frames), then 200
      frames through `track_sequence()`. Every kernel's launch counter is
      zeroed just before and read just after; kernels 1-7 and 9-12, the
      keyframe path's entries of kernels 22-24 (`fuse_match_points`,
      `fuse_match_lines`, `fuse_merge`, `fuse_finish`, `covis_row`), the
      per-frame glue's kernels 25 (`pyramid`) and 26 (`lsd_merge`,
      `lsd_octave_merge`) and kernel 22's tracking entries
      (`track_match_points`, `track_match_lines`) must be nonzero (kernel
      8's atan2f runs inline in kernels 22 and 26; its entry is driven in
      phase 3).
      ATE-Sim3 over the tracked frames must be <= 0.05, and map lines must
      have been made and be live at the end;
   b. the points-only path, `use_lines=False`: bootstrap, then 60 frames,
      its counters read on their own (the four point kernels and kernels
      9-12 nonzero), ATE-Sim3 <= 0.05;
   c. the relocalization path, `SLAMConfig()` again, on a 48-frame circle
      of radius 0.8 through the same scene (`relocalization_scenario`):
      bootstrap and 30 frames (>= 6 keyframes), a sudden 0.17 rad yaw held
      for 6 frames, 3 pure-noise frames, then a teleport back to poses
      4-21 re-rendered with other noise seeds. Counters zeroed just before,
      read just after: kernels 13-15 must have launched, the
      reference-keyframe rung must have recovered a frame and BoW + PnP
      another, the noise frames must be lost, 5 of the last 6 frames
      tracked, ATE-Sim3 over the tracked frames <= 0.08. Prints the rung
      counters, the vocabulary training seconds (host numpy) and the wall
      time of every `_attempt_relocalization`. Kernels 1-12 are required
      on path a only; 13-15 run only when a frame is lost;
   d. the loop-closing path, the reference's own loop test
      (tests/test_loop_scenarios.py:65-100): `make_cylinder_scene(700, 48,
      seed=0)`, `loop_trajectory(200, laps=1.3)`, noise 2.0, the default
      configuration; bootstrap through `track()` within 12 frames, the
      rest through one `track_sequence()`; once with loop closing off,
      then on (counters zeroed just before the second run, read just
      after). Both runs must track >= 90% of their frames with ATE-Sim3
      <= 0.06; the second must correct a loop, end with >= 100 map lines,
      launch kernels 16-18 and the loop path's entries of kernels 22-24
      (`pool_match`, `sim3_widen_match`, `loop_merge`, `covis_matrix`) and
      run kernel 12 at 64 keyframes (global BA).
      The ATE difference and the loop counters are printed beside the
      reference's, not judged; so is the wall time of every correcting
      `_run_loop_closing` and its split into detect, verify, correct and
      global BA;
   e. the dataset path: two TUM-layout PNG directories (`rgb/NNNN.png`,
      `rgb.txt` at 30 fps) under the git-ignored `out_chip_smoke/`, each
      run through the port's driver (`run_slam.run`: the native
      prefetching loader, which must be the native one, and one `track()`
      per frame). Run A is the whole bench sequence (610 frames) at the
      default pools: bootstrap within 90 frames, at most 10 frames lost
      after it, ATE-Sim3 < 0.05 read back from the written
      MonoTrajectory.txt, and as many KeyFrameTrajectory.txt rows as live
      keyframes. Run B is the reference's long-run test
      (tests/test_compaction.py:96-128: pools of 16 keyframes, 2048
      points, 128 lines, a keyframe every <= 3 frames, `make_room_scene(300,
      12, seed=3)`, 60 frames of a circle of radius 0.5): >= 50 frames
      tracked, ATE-Sim3 < 0.05, `compact_keyframes` >= 1, cursors within
      the pools. Counters are zeroed before run A and read after run B:
      kernels 1-12 and kernel 19 must have launched. Prints the fps through
      the loader beside 2a's in-memory fps, the cursors, how often each
      compaction pass fired and each pass's caller ms; then run A's map
      goes through `save_map` / `load_map` on the card (every field
      bit-equal, cursors equal);
   f. the half-resolution line-support configuration,
      `SLAMConfig(frontend=FrontendConfig(line_support_downsample=2))`:
      bootstrap within 90 frames, then 200 frames through
      `track_sequence()` on the bench scene, the counters zeroed just
      before and read just after (kernels 1-12 nonzero), ATE-Sim3 <= 0.05,
      map lines made and live. Prints tracked / lost, ATE-Sim3, fps and the
      lines; phase 3 prints kernel 5's device time per frame at the half
      shape beside phase 2a's at full shape;
   g. the sharded path (parallel/): the script joins a process group of
      one rank on the card (`initialize_multihost("localhost:<free port>",
      1, 0)`: NCCL) and builds `global_edge_mesh(4)`, four landmark shards
      on cuda:0; the psum of ones (the mesh's sum, then one NCCL
      all_reduce) must be 4. Then `SLAMSystem(cfg, mesh=...)` at phase
      2a's configuration: bootstrap through `track()`, 60 frames through
      `track_sequence()`, counters zeroed just before and read just after:
      kernel 12's sharded form (`local_ba_shard`) and kernels 1-12 must
      have launched, ATE-Sim3 <= 0.05, and against phase 2a's unsharded
      run over the same frames (its trajectory up to the same frame; the
      path is causal) the reference test's bounds: ATE-Sim3 within 1e-3,
      camera centres on common frames within 5e-2. Global BA on phase 2d's
      final map (loop closing on), sharded on the mesh against unsharded:
      poses, points and line endpoints within 1e-3 (kernel 12's bound
      against its plain version), kernel 12's sharded form launched; both
      calls timed (device, caller) beside the 64-keyframe BA's bound. The
      data-parallel frontend, `make_batch_extractor(frame_mesh(4),
      with_lines=True)` on 8 bench frames: every keypoint, descriptor,
      line and LBD word equal to the single-frame frontend's on the card,
      the batch entries of kernels 1, 11 and 2 and kernels 25 and 26
      launched (counters zeroed just before, read just after).
3. Kernels against plain: the first call of every distinct shape each
   wrapper saw in phase 2a is replayed on the card through the kernel and
   through its plain PyTorch version: FAST/NMS maps, Hamming best / second
   / columns and the LSD support maps (score, packed ridge plane) must be
   equal; ORB descriptors equal on >= 99.5% of keypoints with angles within
   1e-4 rad; pose within 1e-4 (rotation and translation entries) with
   inlier masks equal on >= 99.5% of edges and n_inliers equal to the
   kernel's masks' sum; the LSD refinement's outputs bit-equal on every
   valid anchor; LBD words equal on >= 99% of
   segments and float descriptors within 1e-5; atan2 bit-exact; keypoint
   selection (ORB levels and LSD anchors) `valid` equal and `resp`, `xy`
   equal on valid slots; observer bits and votes equal; null vectors
   within 1e-6; local BA poses and landmarks within 1e-3 with point and
   line inlier masks equal on >= 99.5% of edges, two launches
   bit-identical, and one call under torch.cuda.set_sync_debug_mode
   ("error"), which raises on any host synchronization; BoW words and
   vectors equal; database scores equal (or within 1e-6 with the same
   candidate list); RANSAC PnP with the same chosen hypothesis and count
   per candidate, poses within 1e-4 on live candidates and per-hypothesis
   counts equal on >= 99%. Phase 2c's shapes of every wrapper are checked
   too (the batched [16, 1024, 1024] Hamming call, the pose LM with
   1024 points and one masked line), and phase 2d's: Sim(3) RANSAC with
   the same chosen hypothesis and count, S12 within 1e-4 and
   per-hypothesis counts equal on >= 99%; the Sim(3) pair refinement with
   S12 within 1e-4 and inlier masks equal on >= 99.5%; the pose graph
   with every valid vertex within 1e-4, two launches bit-identical and
   one call under set_sync_debug_mode("error"); local BA at 64
   keyframes within 1e-3 (masks >= 99.5%); detect's database scores
   within 1e-6. Kernels 22-24 on every call recorded in phases 2a and 2d
   (every keyframe's fuse matches in phase 2a and in both runs of 2d,
   phase 2a's first 24 merge walks and every one of 2d's, each finish
   shape, phase 2a's first covisibility rows; verify's and the loop
   fuse's pool matches, the Sim(3) widenings, the loop merges, every
   covisibility matrix of 2d, its last one timed):
   kernels 23 and 24 bit-equal; kernel 22's idx, dist and valid equal on
   >= 99.9% of the rows with a candidate and on every
   row without, each differing row printed (`[kernel 22]`) with the gate
   nearest its threshold (`match_margins`), which must lie within 1e-5
   relative of it, or with a column such a row claims. Each is timed
   beside its bound, kernel 22's counted from the plain version's own
   window tests and in-window pairs (`Spy`); covisibility beside the
   indicator `torch.matmul` products (library_ms), its bound the valid
   keyframes' rows of both grids read and the output written. Kernel 19's three
   passes are bit-equal on every field (live counts and `perm` too) on
   run B's first input of each pass (run B must call all three) and on
   phase 2a's final map with a seeded half of
   its live slots culled, where each pass is timed beside its bound
   (bytes: the live rows of each field read, every row written, the edge
   grid or the stamps read and written, the observer bits written). One
   bench frame is also built on the card and on the CPU (plain versions):
   every pyramid level and blurred level must be equal, and so must the
   valid keypoints, their descriptors and the line descriptors, with line
   endpoints within 1e-3 px; the first level or op that differs is
   printed. Kernels 25, 26 and kernel 22's tracking entries on every call
   of phase 2a's first frames and every 25th call after (`glue_kernels`):
   kernel 25 bit-equal on every level and blurred plane (timed beside the
   plain version's two torch.matmul calls per level, the resizes without
   the blur); kernel 26's valid flags and octaves bit-equal, its floats
   bit-equal or printed with their largest difference, within 1e-5; the
   tracking entries' idx, dist, valid and visible mask exactly equal, each
   differing row printed with its nearest gate. Kernel 8's entry runs on
   the recorded merges' segment directions, bit-exact. Each kernel is
   timed on the device (torch.profiler's device events per call, host
   launch gaps left out) and from the caller (median of CUDA events around
   one call, gaps included); the null vector also against
   torch.linalg.eigh on the same Gram matrices, the database query against
   torch.cdist(p=1), RANSAC PnP against torch.linalg.svd of its DLT batch
   (the ratio and phase 2c's launches per call printed, `[kernel 15]`),
   Sim(3) RANSAC against torch.linalg.eigh of its Horn matrices, the pose
   graph against torch.linalg.solve of its assembled system
   (library_ms), local BA (16 and 64 keyframes, and its sharded form)
   against torch.linalg.solve of its first iteration's reduced camera
   system over the free cameras' rows (the solve alone). The dense solver
   that kernels 12 and 18 share (csrc/dense_lu.cuh) is also driven alone
   through its `dense_solve` entry on those three systems (the window's,
   64 keyframes', the pose graph's at its capacity's panel width; counters
   zeroed around the three calls): the same pivot rows as its plain
   version, x within 1e-5 of the largest |x|, the backward error within
   10x of torch.linalg.solve's, each timed beside torch.linalg.solve; the
   device time of kernel 12's solve launches is split out at the window
   and at 64 keyframes (`split`). Phase 2g's shapes:
   kernel 12's sharded form against its sharded plain version (poses and
   landmarks within 1e-3, masks >= 99.5%, two launches bit-identical, one
   call under set_sync_debug_mode("error")) at the main path's window and
   global BA's 64 keyframes, and on the window with its landmark columns in
   a seeded random order (`spread_columns`, so that every shard's span
   holds edges; its live landmarks otherwise sit in shard 0) against the
   sharded plain version and the unsharded kernel, within the same
   bounds; its plain version is timed from the caller only (one call of
   ~4 x 10^4 small torch ops); the batch entries of kernels 1, 11 and 2 at
   the frontend's stacks against their plain versions (FAST maps and
   selections equal, ORB as kernel 2 on one frame). Phase 2f's shapes: kernel 5 at the half shape (the
   support on the 2x2 box half image, the ridge plane at full resolution)
   equal, timed as its own row; kernel 6 on its half-pixel anchors
   bit-equal on every valid anchor; kernel 11 at 8 px cells and a 2 px
   border as above. The functions no path calls, each driven once through
   its entry point with the counters zeroed just before and read just
   after, then held to its plain version: kernels 20 and 21
   (`fuse_duplicate_points_3d` / `fuse_duplicate_lines_3d`) on phase 2a's
   final map with seeded duplicates, `best` and `has` equal and merges
   found; kernel 10's eigensolver entry (`jacobi_eigh_4x4`) on the null
   vector's Gram matrices, within 1e-6 (vectors, and values relative to
   max(|v|, 1)), beside torch.linalg.eigh. `relocalize(wide=True)` runs
   once on phase 2c's final map and a teleport frame, and must recover it
   (reported beside the 0.75-cut call). The functions around kernels
   22-24 (`fuse_projected_points`, `fuse_projected_lines`, `_loop_fuse`)
   are timed from the caller and on the device, and one recorded keyframe
   pipeline call is replayed with each stage timed from the caller
   (`keyframe_split`).
4. Where the time goes: 20 further frames of the main path under
   torch.profiler; prints the wall time, the device-busy time and device
   kernels per frame and the top device kernels; then one more frame with
   every torch call labelled by its line (`pageable_copies`): its pageable
   host-to-device copies grouped by the line of the port that issued them.

Output: a JSON line of the end-to-end, function and profile numbers, the JSON line
{"kernels": [...]}, the nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_TRACK = 200         # the main path (lines on)
N_TRACK_POINTS = 60   # the points-only path
N_MESH = 60           # phase 2g: the main path on a mesh
MESH_SHARDS = 4
BATCH_FRAMES = range(40, 48)   # phase 2g: the data-parallel frontend's bench frames
INIT_MAX = 90
ATE_MAX = 0.05
# H100 SXM peaks (NVIDIA data sheet) used for the per-kernel floor
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # float32 outside the tensor cores
# operation counts of the line kernels, from the work the function needs:
# per pixel of the LSD dense pass one bf16 Scharr gradient and its magnitude
# (each op with its bf16 rounding: 41), one atan2 (OPS_ATAN2), the bin and
# the NMS test (13), the ridge snap and packing (33); per weak pixel
# (magnitude > 0.5 x the threshold; the mask is zero elsewhere) 16 angle
# gates (134); per scored pixel of its support pass (at least one
# direction: 48 mask reads, 15 pair gates, the sum), per sample of an LSD
# refinement pass (nearest sample, unpack, gates, the weighted sums), per
# LBD sample (Scharr at the pixel, quantize, frame projection, the band
# sums) and per LBD segment (band statistics, norms, 256 comparisons)
OPS_ATAN2 = 60        # glibc atan2f: one division, the polynomial, the fix-ups
OPS_GRAD_PX = 41
OPS_NMS_PX = 13
OPS_RIDGE_PX = 33
OPS_GATES_WEAK = 134
OPS_SUPPORT_PX = OPS_GRAD_PX + OPS_ATAN2 + OPS_NMS_PX + OPS_RIDGE_PX
OPS_SUPPORT_SCORED = 150
OPS_REFINE_SAMPLE = 60
OPS_LBD_SAMPLE = 60
OPS_LBD_SEGMENT = 4000
# per 4x4 null-vector system: the Gram (r x 10 multiply-adds), 30 Jacobi
# rotations (~60 operations each with one atan2f, cosf and sinf)
OPS_NULL_SYSTEM = 2000
# per active BA residual row per iteration: projection, Jacobians, the
# 6x6 / 6x3 / 3x3 block terms and the Schur product (~300 operations)
OPS_BA_ROW = 300
# kernel 5 at line_support_downsample = 2: per full-resolution pixel the
# packed ridge plane alone (OPS_SUPPORT_PX); per half-resolution pixel the
# box average (4) and the gradient; per weak half-resolution pixel the
# angle, the bin and NMS and the 16 angle gates (the angle is needed for
# the mask and the peaks alone, and both are zero below the weak line)
OPS_HALF_PX = 4 + OPS_GRAD_PX
OPS_HALF_WEAK = OPS_ATAN2 + OPS_NMS_PX + OPS_GATES_WEAK
# per 4x4 eigensolver system: 30 Jacobi rotations (~60 operations each)
OPS_EIGH_SYSTEM = 1800
# kernels 20 / 21 per pair that passes the age gate: the squared distance
# (~14 operations); a line's segment frame, direction test and the two
# perpendicular distances (~60); per pair, the two gate reads (2)
OPS_FUSE_PT_PAIR = 14
OPS_FUSE_LN_PAIR = 60
# kernel 22 per (row, feature) pair of a visible row the window test (two
# differences and compares, the valid flag and, for points, the octave
# test: ~8 operations); per pair inside the window the 8-word distance (27,
# kernel 3's count); per row the projection and gates (points ~150 with
# logf, lines ~200 with two projections and an atan2, the pool ~40, the
# Sim(3) widening ~80 with two transforms)
OPS_WINDOW_PAIR = 8
OPS_DIST_PAIR = 27
OPS_MATCH_ROW = {"fuse_match_points": 150, "fuse_match_lines": 200, "pool_match": 40,
                 "sim3_widen_match": 80, "track_match_points": 170, "track_match_lines": 200}
# kernel 25 per pixel: the resize's taps (~3 x 3 products and sums, two
# roundings) and the blur's 2 x 7 taps (a product, an add, two roundings
# each); kernel 26 per candidate pair: the link test (~45 operations), the
# suppression test (~40), the argmax and extents (~25), plus the closure's
# word ORs; its octave step ~40 a pair
OPS_PYR_RESIZE_PX = 24
OPS_PYR_BLUR_PX = 56
OPS_MERGE_PAIR = 110
OPS_OCTAVE_PAIR = 40
MATCH_AGREE_MIN = 0.999   # kernel 22 against its plain version, rows agreeing
MATCH_MARGIN_MAX = 1e-5   # a differing row's flipped gate, relative to its threshold

# kernel -> (JAX function it replaces, CUDA source)
KERNELS = {
    "fast_nms": ("structure_slam_pointline_tpu/ops/fast.py:39",
                 "structure_slam_pointline_tpu_torch/csrc/fast.cu"),
    "orb_describe": ("structure_slam_pointline_tpu/ops/orb.py:227",
                     "structure_slam_pointline_tpu_torch/csrc/orb.cu"),
    "hamming_best2": ("structure_slam_pointline_tpu/ops/hamming.py:32",
                      "structure_slam_pointline_tpu_torch/csrc/hamming.cu"),
    "pose_lm": ("structure_slam_pointline_tpu/optim/pose_opt.py:114",
                "structure_slam_pointline_tpu_torch/csrc/pose_lm.cu"),
    "lsd_support": ("structure_slam_pointline_tpu/ops/lsd.py:201",
                    "structure_slam_pointline_tpu_torch/csrc/lsd_support.cu"),
    "lsd_refine": ("structure_slam_pointline_tpu/ops/lsd.py:367",
                   "structure_slam_pointline_tpu_torch/csrc/lsd_refine.cu"),
    "lbd_describe": ("structure_slam_pointline_tpu/ops/lbd.py:76",
                     "structure_slam_pointline_tpu_torch/csrc/lbd.cu"),
    "atan2_glibc": ("structure_slam_pointline_tpu/ops/lsd.py:448",
                    "structure_slam_pointline_tpu_torch/csrc/atan2.cu"),
    "obs_bits": ("structure_slam_pointline_tpu/world/map_store.py:235",
                 "structure_slam_pointline_tpu_torch/csrc/obs_bits.cu"),
    "null_vector4": ("structure_slam_pointline_tpu/utils/linalg.py:108",
                     "structure_slam_pointline_tpu_torch/csrc/null_vector4.cu"),
    "kp_select": ("structure_slam_pointline_tpu/ops/fast.py:197",
                  "structure_slam_pointline_tpu_torch/csrc/kp_select.cu"),
    "local_ba": ("structure_slam_pointline_tpu/optim/local_ba.py:226",
                 "structure_slam_pointline_tpu_torch/csrc/local_ba.cu"),
    "bow_transform": ("structure_slam_pointline_tpu/ops/bow.py:104",
                      "structure_slam_pointline_tpu_torch/csrc/bow.cu"),
    "bow_query": ("structure_slam_pointline_tpu/ops/bow.py:134",
                  "structure_slam_pointline_tpu_torch/csrc/bow.cu"),
    "ransac_pnp": ("structure_slam_pointline_tpu/ops/pnp.py:34",
                   "structure_slam_pointline_tpu_torch/csrc/pnp.cu"),
    "ransac_sim3": ("structure_slam_pointline_tpu/optim/sim3_solver.py:81",
                    "structure_slam_pointline_tpu_torch/csrc/sim3_ransac.cu"),
    "sim3_pair": ("structure_slam_pointline_tpu/optim/pose_graph.py:134",
                  "structure_slam_pointline_tpu_torch/csrc/sim3_pair.cu"),
    "pose_graph": ("structure_slam_pointline_tpu/optim/pose_graph.py:50",
                   "structure_slam_pointline_tpu_torch/csrc/pose_graph.cu"),
    "compact": ("structure_slam_pointline_tpu/world/compact.py:33",
                "structure_slam_pointline_tpu_torch/csrc/compact.cu"),
    "fuse_points_3d": ("structure_slam_pointline_tpu/models/local_mapping.py:593",
                       "structure_slam_pointline_tpu_torch/csrc/fuse3d.cu"),
    "fuse_lines_3d": ("structure_slam_pointline_tpu/models/local_mapping.py:639",
                      "structure_slam_pointline_tpu_torch/csrc/fuse3d.cu"),
    "jacobi_eigh4": ("structure_slam_pointline_tpu/utils/linalg.py:89",
                     "structure_slam_pointline_tpu_torch/csrc/null_vector4.cu"),
    "local_ba_shard": ("structure_slam_pointline_tpu/parallel/dist_ba.py:66",
                       "structure_slam_pointline_tpu_torch/csrc/local_ba.cu"),
    "fast_nms_batch": ("structure_slam_pointline_tpu/parallel/batch_frontend.py:36",
                       "structure_slam_pointline_tpu_torch/csrc/fast.cu"),
    "kp_select_batch": ("structure_slam_pointline_tpu/parallel/batch_frontend.py:36",
                        "structure_slam_pointline_tpu_torch/csrc/kp_select.cu"),
    "orb_describe_batch": ("structure_slam_pointline_tpu/parallel/batch_frontend.py:36",
                           "structure_slam_pointline_tpu_torch/csrc/orb.cu"),
    # the solver of kernels 12 and 18 alone (local_ba.cu's `dense_solve`
    # entry): the reference's jnp.linalg.solve there (and pose_graph.py:111)
    "dense_solve": ("structure_slam_pointline_tpu/optim/local_ba.py:477",
                    "structure_slam_pointline_tpu_torch/csrc/dense_lu.cuh"),
    # kernel 22's entries, kernel 23's and kernel 24's
    "fuse_match_points": ("structure_slam_pointline_tpu/models/local_mapping.py:793",
                          "structure_slam_pointline_tpu_torch/csrc/fuse_match.cu"),
    "fuse_match_lines": ("structure_slam_pointline_tpu/models/local_mapping.py:911",
                         "structure_slam_pointline_tpu_torch/csrc/fuse_match.cu"),
    "pool_match": ("structure_slam_pointline_tpu/models/loop_closing.py:104",
                   "structure_slam_pointline_tpu_torch/csrc/fuse_match.cu"),
    "sim3_widen_match": ("structure_slam_pointline_tpu/models/loop_closing.py:55",
                         "structure_slam_pointline_tpu_torch/csrc/fuse_match.cu"),
    "fuse_merge": ("structure_slam_pointline_tpu/models/local_mapping.py:842",
                   "structure_slam_pointline_tpu_torch/csrc/fuse_merge.cu"),
    "loop_merge": ("structure_slam_pointline_tpu/models/loop_closing.py:160",
                   "structure_slam_pointline_tpu_torch/csrc/fuse_merge.cu"),
    "fuse_finish": ("structure_slam_pointline_tpu/models/local_mapping.py:710",
                    "structure_slam_pointline_tpu_torch/csrc/fuse_merge.cu"),
    "covis_row": ("structure_slam_pointline_tpu/world/map_store.py:189",
                  "structure_slam_pointline_tpu_torch/csrc/covis.cu"),
    "covis_matrix": ("structure_slam_pointline_tpu/world/map_store.py:210",
                     "structure_slam_pointline_tpu_torch/csrc/covis.cu"),
    # the per-frame glue: kernel 25, kernel 26's two entries, kernel 22's
    # tracking entries
    "pyramid": ("structure_slam_pointline_tpu/ops/pyramid.py:41",
                "structure_slam_pointline_tpu_torch/csrc/pyramid.cu"),
    "lsd_merge": ("structure_slam_pointline_tpu/ops/lsd.py:442",
                  "structure_slam_pointline_tpu_torch/csrc/lsd_merge.cu"),
    "lsd_octave_merge": ("structure_slam_pointline_tpu/ops/lsd.py:551",
                         "structure_slam_pointline_tpu_torch/csrc/lsd_merge.cu"),
    "track_match_points": ("structure_slam_pointline_tpu/models/tracking.py:187",
                           "structure_slam_pointline_tpu_torch/csrc/fuse_match.cu"),
    "track_match_lines": ("structure_slam_pointline_tpu/models/tracking.py:243",
                          "structure_slam_pointline_tpu_torch/csrc/fuse_match.cu"),
}
# table rows that time one kernel at another path's shape: row -> (kernel,
# the JAX lines that shape replaces)
ROW_KERNEL = {"lsd_support_half": ("lsd_support", "structure_slam_pointline_tpu/ops/lsd.py:219")}
# kernels that run only when a frame is lost (phase 2c), and only with loop
# closing on (phase 2d)
RELOC_KERNELS = ("bow_transform", "bow_query", "ransac_pnp")
LOOP_KERNELS = ("ransac_sim3", "sim3_pair", "pose_graph", "pool_match", "sim3_widen_match",
                "loop_merge", "covis_matrix")
DATASET_KERNELS = ("compact",)   # runs only when a pool passes its trigger (phase 2e)
# no path of the port calls these (kernel 8's atan2f runs inline in kernels
# 22 and 26 since the glue was ported): phase 3 drives their entry points
UNCALLED_KERNELS = ("fuse_points_3d", "fuse_lines_3d", "jacobi_eigh4", "atan2_glibc")
# the paths reach the dense solver through kernels 12 and 18; its own entry
# is driven on their systems in phase 3
SOLVER_KERNELS = ("dense_solve",)
# the sharded path's kernels (phase 2g): on a mesh, and in the batched frontend
MESH_KERNELS = ("local_ba_shard",)
BATCH_KERNELS = ("fast_nms_batch", "kp_select_batch", "orb_describe_batch")
OFF_MAIN_PATH = (RELOC_KERNELS + LOOP_KERNELS + DATASET_KERNELS + UNCALLED_KERNELS + SOLVER_KERNELS
                 + MESH_KERNELS + BATCH_KERNELS)
FP64_OPS_PER_S = 34e12   # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
# per RANSAC PnP hypothesis, a floor for its float64 work: the least a
# 12x12 null vector needs, Gaussian elimination (2/3 n^3) and the back
# substitution (n^2); per point the float32 reprojection test (~30
# operations), once for every hypothesis' count and once more for the
# winner's inlier row of each candidate
OPS_PNP_HYP_FP64 = 2 * 12 ** 3 // 3 + 12 ** 2
OPS_PNP_POINT = 30
# floors of the loop-closing kernels' work: per Sim(3) hypothesis the float64
# Horn alignment (centroids and the 3x3 covariance, ~80; Horn's N, ~20; one
# Jacobi sweep over the six pairs of a 4x4, ~300); per pair and hypothesis the
# two float32 reprojection tests (~60); per pair and LM iteration of the pair
# refinement the two projections, the 4x7 Jacobian, the 35 normal-equation
# terms and the two cost passes (~400); per edge and tangent lane of the pose
# graph one dual-number pass through exp, two products, the inverse and the
# log (~1500), and per edge the two cost evaluations (~500 each)
OPS_SIM3_HYP_FP64 = 400
OPS_SIM3_PAIR_TEST = 60
OPS_SIM3_PAIR_ITER = 400
OPS_PG_LANE = 1500
OPS_PG_COST = 500
POINT_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "obs_bits",
                 "null_vector4", "kp_select", "local_ba", "fuse_match_points", "fuse_merge",
                 "fuse_finish", "covis_row", "pyramid", "track_match_points",
                 "track_match_lines")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


L2_FLUSH_BYTES = 2 * 50 * 2 ** 20   # twice the H100's 50 MB L2


def l2_flush():
    """A call that evicts the L2 cache: one pass of bitwise_not over a
    buffer twice its size. `device_ms` leaves its kernel out by name."""
    import torch

    buf = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    return lambda: buf.bitwise_not_()


def time_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median milliseconds of one call, CUDA events around each call: the
    caller's view, host launch gaps included. With `flush` (l2_flush()),
    the L2 is evicted before each call, outside the events, and the host
    waits for it, so the enqueue is not hidden behind the flush."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
            torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, flush=None, expect: str | None = None,
              warmup: bool = True) -> float:
    """Device milliseconds of one call: the device-side events (kernels,
    copies) that torch.profiler records over `reps` calls, summed, per
    call. Launch gaps on the host are left out. With `flush`, the L2 is
    evicted before each call and the flush's own kernel (bitwise_not) is
    left out of the sum. The profiler on the card has returned no device
    events at all for a session now and then (the same call measured in
    the run before), and once only the small events around a kernel that
    it missed: such a session (no device time, or no event whose name
    holds `expect`) is repeated, up to three times, and then the call is
    timed with CUDA events instead (launch gaps included), with a note on
    stderr. `warmup=False` leaves out the first, unprofiled call (for a
    costly plain version whose caller has just run it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not (flush is not None and "bitwise_not" in e.key)]
        us = sum(e.self_device_time_total for e in evs)
        if us > 0 and (expect is None or any(expect in e.key for e in evs)):
            return us / 1e3 / reps
    print(f"[note] torch.profiler recorded no device time for {getattr(fn, '__name__', fn)};"
          " timed with CUDA events instead", file=sys.stderr, flush=True)
    return time_ms(fn, reps=reps, flush=flush)


def by_kernel(fn, reps: int = 3) -> dict:
    """Device milliseconds of one call by kernel name (torch.profiler over
    `reps` calls after one warm-up; a name without its namespace and
    arguments, memsets and copies under their own names); {} when the
    profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.key.replace("(anonymous namespace)::", "")
            m = re.search(r"([A-Za-z_][A-Za-z0-9_]*)\s*(<[^()]*>)?\s*\(", key)
            name = m.group(1) if m else key
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def shard_split(fn, reps: int = 3) -> dict:
    """Where kernel 12's sharded form spends device time in one call:
    the per-shard launches (grid, classify, landmarks, reduce, backsub,
    edges), the replicated solve, and the torch ops between them (the
    ordered sums of the shards' partials, the input copies and fills, the
    ORed flags): device ms per call, `by_kernel` grouped; None when the
    profiler records no device events."""
    out = {"shard_ms": 0.0, "solve_ms": 0.0, "torch_ops_ms": 0.0}
    shard = ("grid_kernel", "classify_kernel", "landmarks_kernel", "reduce_kernel",
             "backsub_kernel", "edges_kernel")
    for name, ms in by_kernel(fn, reps).items():
        key = ("solve_ms" if "solve_kernel" in name else
               "shard_ms" if name in shard else "torch_ops_ms")
        out[key] += ms
    return out if sum(out.values()) > 0 else None


def reps_for(fn, budget_ms: float = 250.0) -> int:
    """Repetitions for timing `fn`: 20, fewer (down to 3) when one call
    takes more than budget_ms / 20 from the caller. The plain versions
    are thousands of small torch ops, and the profiler's cost per op made
    their 20 profiled repetitions most of the script's run time."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    return int(max(3, min(20, budget_ms / max(one_ms, 1e-3))))


def timings(kernel_fn, plain_fn, flush=None, expect: str | None = None) -> dict:
    """Device and caller-side milliseconds of the kernel and its plain version."""
    rk, rp = reps_for(kernel_fn), reps_for(plain_fn)
    return {"ms": device_ms(kernel_fn, reps=rk, flush=flush, expect=expect),
            "plain_ms": device_ms(plain_fn, reps=rp, flush=flush),
            "wall_ms": time_ms(kernel_fn, reps=rk, flush=flush),
            "plain_wall_ms": time_ms(plain_fn, reps=rp, flush=flush)}


def clone_arg(a):
    """A tensor cloned, a named tuple of tensors (a map state) cloned field
    by field, anything else as it is."""
    if hasattr(a, "clone"):
        return a.clone()
    if hasattr(a, "_fields"):
        return type(a)(*map(clone_arg, a))
    return a


class Recorder:
    """Wraps a module-level wrapper function: records (clones of) the
    inputs of the first call of each distinct shape signature and passes
    every call through unchanged (no extra launches). Later calls of a
    known shape cost one dictionary lookup, so the timed run carries a few
    dozen copies in all, made in its first frames and first keyframe.
    With `sync` (a device synchronize), every call is also timed from the
    caller, synchronized before and after, into `ms`."""

    def __init__(self, module, attr, key_fn, sync=None):
        self.module, self.attr, self.key_fn, self.sync = module, attr, key_fn, sync
        self.fn = getattr(module, attr)
        self.calls = {}
        self.n = {}   # calls per key
        self.ms = []  # caller ms per call, with `sync`

    def __enter__(self):
        def wrapped(*args, **kw):
            key = self.key_fn(*args, **kw)
            self.n[key] = self.n.get(key, 0) + 1
            if key not in self.calls:
                self.calls[key] = (tuple(map(clone_arg, args)), dict(kw))
            if self.sync is None:
                return self.fn(*args, **kw)
            self.sync()
            t = time.perf_counter()
            out = self.fn(*args, **kw)
            self.sync()
            self.ms.append((time.perf_counter() - t) * 1e3)
            return out

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


def pageable_copies(slam, img, idx: int) -> dict:
    """One more frame of the main path under torch.profiler: its pageable
    host-to-device copies, grouped by the line of the port that issued
    them, and the frame's device kernels linked to ops. The profiler on
    the card records no Python frames, so a TorchFunctionMode wraps every
    torch call made from the package in a `record_function` range named
    after the innermost package frame ("file(line): function"), and a
    copy takes the name of the nearest such range above it."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile, record_function

    pkg = "structure_slam_pointline_tpu_torch" + os.sep

    class Sites(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and pkg not in f.f_code.co_filename:
                f = f.f_back
            if f is None:
                return func(*args, **(kwargs or {}))
            site = (f"{f.f_code.co_filename.split(pkg)[-1]}({f.f_lineno}): "
                    f"{f.f_code.co_name}")
            with record_function("site " + site):
                return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with Sites():
            slam.track_sequence(img[None], idx)
        torch.cuda.synchronize()
    by_line, n_copies, n_kernels = {}, 0, 0
    for e in prof.events():
        for k in getattr(e, "kernels", []) or []:
            n_kernels += 1
            if "HtoD" not in k.name or "Pageable" not in k.name:
                continue
            n_copies += 1
            p = e
            while p is not None and not p.name.startswith("site "):
                p = p.cpu_parent
            site = p.name[5:] if p is not None else "(no frame of the package)"
            by_line[site] = by_line.get(site, 0) + 1
    out = {"pageable_htod_per_frame": n_copies, "device_kernels_linked": n_kernels,
           "by_line": dict(sorted(by_line.items(), key=lambda kv: -kv[1]))}
    print(f"[profile] one frame with each torch call labelled by its line: {n_copies} "
          f"pageable host-to-device copies, {n_kernels} device kernels linked to ops; "
          f"copies by line: {out['by_line']}", flush=True)
    return out


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def first_solve(fn):
    """(A, b) of the first torch.linalg.solve that `fn()` makes (a plain
    BA version solves its reduced camera system so, once per iteration)."""
    import torch

    real, seen = torch.linalg.solve, []

    def spy(A, B, *a, **k):
        if not seen:
            seen.append((A.detach().clone(), B.detach().clone()))
        return real(A, B, *a, **k)

    torch.linalg.solve = spy
    try:
        fn()
    finally:
        torch.linalg.solve = real
    return seen[0]


def ba_solve_alone(plain_fn, prob, lines):
    """The library yardstick of kernel 12: one torch.linalg.solve of the
    first iteration's reduced camera system over the free cameras' rows
    (the plain version keeps the valid keyframes' rows, and the rows of
    invalid ones that hold a line edge). Returns (A, b)."""
    import torch

    A, b = first_solve(plain_fn)
    keep = prob.kf_valid
    if lines is not None:
        keep = keep | (lines.edge_valid & (lines.edge_ln >= 0)).any(1)
    fm = (prob.kf_free & prob.kf_valid)[torch.nonzero(keep)[:, 0]]
    free = (6 * torch.nonzero(fm)[:, 0][:, None]
            + torch.arange(6, device=fm.device)).reshape(-1)
    return A[free][:, free].contiguous(), b[free].contiguous()


def spread_columns(prob, lines, seed: int = 0):
    """A BA problem with its landmark columns (points, and lines alike) in a
    seeded random order and the edge ids remapped to it: the same problem,
    but a window's live landmarks, which sit in its first columns, land in
    every shard of a sharded run."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def permute(n, edges, *cols):
        perm = torch.randperm(n, generator=g).to(edges.device)   # new j holds old perm[j]
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=edges.device)
        ok = (edges >= 0) & (edges < n)
        new = torch.where(ok, inv[edges.clamp(0, n - 1).long()].to(edges.dtype), edges)
        return new, [c[perm] for c in cols]

    edge_mp, (xyz, valid) = permute(prob.mp_xyz.shape[0], prob.edge_mp, prob.mp_xyz,
                                    prob.mp_valid)
    prob = prob._replace(edge_mp=edge_mp, mp_xyz=xyz, mp_valid=valid)
    if lines is not None:
        edge_ln, (a, b, v) = permute(lines.ln_start.shape[0], lines.edge_ln, lines.ln_start,
                                     lines.ln_end, lines.ln_valid)
        lines = lines._replace(edge_ln=edge_ln, ln_start=a, ln_end=b, ln_valid=v)
    return prob, lines


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def lsd_weak_px(img, grad_thresh, angle_tol, min_length, ds=1) -> int:
    """Pixels of kernel 5's scanned grid (the half image at ds = 2) whose
    bf16 gradient magnitude passes the weak line, 0.5 x the support pass's
    threshold: the only pixels whose direction mask the function needs."""
    from structure_slam_pointline_tpu_torch.ops import lsd

    grid = lsd.half_octave(img) if ds == 2 else img
    mag = lsd.gradients(grid)[2].float()
    return int((mag > 0.5 * lsd.support_threshold(grad_thresh, ds)).sum())


def first_calls(tag: str, n: int):
    """A Recorder key function: a key of its own for each of the first n
    calls (each recorded), one shared key after them."""
    seen = [0]

    def key(*a, **kw):
        seen[0] += 1
        return (tag, seen[0] if seen[0] <= n else 0)
    return key


def sampled_calls(tag: str, first: int, every: int):
    """A Recorder key function: a key of its own for each of the first
    `first` calls and for every `every`-th call after them (each
    recorded), one shared key for the rest."""
    seen = [0]

    def key(*a, **kw):
        seen[0] += 1
        n = seen[0]
        return (tag, n if n <= first or n % every == 0 else 0)
    return key


def every_call(tag: str):
    """A Recorder key function: a key of its own for every call (each
    recorded)."""
    return first_calls(tag, sys.maxsize)


class Spy:
    """Counts the work of kernel 22's plain versions: every (visible row,
    feature) window test of `window_mask` (rows with pred_ok times the
    features; the lines' angle gate follows it on the same pairs), every
    in-window pair and every distinct in-window feature of `masked_match`."""

    def __init__(self):
        self.tests = self.pairs = self.cols = 0

    def __enter__(self):
        from structure_slam_pointline_tpu_torch.ops import matching

        self.win, self.mm = matching.window_mask, matching.masked_match

        def window_mask(pred_uv, pred_ok, kp_xy, *a, **kw):
            self.tests += int(pred_ok.sum()) * kp_xy.shape[-2]
            return self.win(pred_uv, pred_ok, kp_xy, *a, **kw)

        def masked_match(da, db, allow, *a, **kw):
            self.pairs += int(allow.sum())
            self.cols += int(allow.any(-2).sum())
            return self.mm(da, db, allow, *a, **kw)

        matching.window_mask, matching.masked_match = window_mask, masked_match
        return self

    def __exit__(self, *exc):
        from structure_slam_pointline_tpu_torch.ops import matching

        matching.window_mask, matching.masked_match = self.win, self.mm


def drive(cfg, n_track: int, frame, poses, label: str, mesh=None):
    """Bootstrap a fresh SLAMSystem (on `mesh`, if given) within INIT_MAX
    frames, then track `n_track` frames; the launch counters are zeroed
    just before and read just after. Returns (system, end-to-end numbers,
    launch counts)."""
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.models.system import SLAMSystem

    slam = SLAMSystem(cfg, mesh=mesh)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t_init = time.time()
    i = 0
    while slam.carry is None and i < INIT_MAX:
        slam.track(frame(i), i)
        i += 1
    torch.cuda.synchronize()
    t_init = time.time() - t_init
    if slam.carry is None:
        fail(f"{label}: no initialization within {INIT_MAX} frames")
    print(f"[e2e {label}] initialized at frame {i - 1} ({t_init:.1f} s incl. render)",
          flush=True)
    seq = np.stack([frame(j) for j in range(i, i + n_track)])
    torch.cuda.synchronize()
    t0 = time.time()
    T, ok, inl, iskf = slam.track_sequence(seq, i)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = dict(kernels.COUNTS)
    traj = slam.trajectory()
    ids = sorted(traj)
    est = np.stack([np.linalg.inv(traj[k]) for k in ids])
    if not np.isfinite(est).all():
        fail(f"{label}: non-finite poses in the trajectory")
    ate = synthetic.ate_rmse(est, poses[ids])
    e2e = {"fps": n_track / dt, "ate_sim3": ate, "tracked": int(ok.sum()),
           "lost": int((~ok).sum()), "keyframes": slam.cur.n_kf, "points": slam.cur.n_mp,
           "live_points": int(slam.map.mp_valid.sum()), "lines": slam.cur.n_ml,
           "live_lines": int(slam.map.ml_valid.sum()), "init_frame": i - 1,
           "frames": n_track}
    print(f"[e2e {label}] fps {e2e['fps']:.2f} | ATE-Sim3 {ate:.5f} | tracked "
          f"{e2e['tracked']}/{n_track} lost {e2e['lost']} | keyframes {e2e['keyframes']} | "
          f"points {e2e['points']} (live {e2e['live_points']}) | lines {e2e['lines']} "
          f"(live {e2e['live_lines']}) | launches {counts}", flush=True)
    if ate > ATE_MAX:
        fail(f"{label}: ATE-Sim3 {ate:.5f} above {ATE_MAX}")
    return slam, e2e, counts


# phase 2c: the relocalization scenario (a 48-frame circle of radius 0.8 on
# the bench scene, so a teleport is a jump of up to a metre)
RELOC_CIRCLE, RELOC_RADIUS = 48, 0.8
RELOC_NORMAL = 30          # frames before the yaw (bootstrap included)
RELOC_YAW, RELOC_YAW_FRAMES = 0.17, 6
RELOC_NOISE = 3
RELOC_TELEPORT = range(4, 22)   # mapped poses the camera jumps back to
RELOC_MIN_KF = 6
RELOC_ATE_MAX = 0.08       # the reference's own recovery bound (tests/test_scan_recovery.py)


def relocalization_scenario(cam):
    """(images [n, H, W], ground truth T_wc [n, 4, 4], segments): frames
    0..29 of the circle; then a sudden in-place yaw of 0.17 rad (~80 px)
    held for 6 frames (the reference-keyframe rung's case,
    tests/test_track_ref_kf.py); 3 pure-noise frames (ground truth: the
    last pose, never scored since they must be lost); then a teleport back
    to poses 4..21, mapped long before the newest keyframe, re-rendered
    with other noise seeds (BoW + PnP's case, tests/test_scan_recovery.py)."""
    from structure_slam_pointline_tpu_torch.io import synthetic

    scene = synthetic.make_room_scene(n_points=350, n_lines=40, seed=0)
    poses = synthetic.circular_trajectory(RELOC_CIRCLE, radius=RELOC_RADIUS)
    c, s_ = np.cos(RELOC_YAW), np.sin(RELOC_YAW)
    yaw = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
    gt, imgs = [], []
    for j in range(RELOC_NORMAL + RELOC_YAW_FRAMES):
        T = poses[j].copy()
        if j >= RELOC_NORMAL:
            T[:3, :3] = T[:3, :3] @ yaw
        gt.append(T)
        imgs.append(synthetic.render(scene, T, cam, noise=2.0, seed=j))
    g = np.random.default_rng(0)
    for _ in range(RELOC_NOISE):
        gt.append(gt[-1])
        imgs.append(g.uniform(0, 255, imgs[0].shape).astype(np.float32))
    for k in RELOC_TELEPORT:
        gt.append(poses[k])
        imgs.append(synthetic.render(scene, poses[k], cam, noise=2.0, seed=1000 + k))
    a = RELOC_NORMAL + RELOC_YAW_FRAMES
    seg = {"yaw": (RELOC_NORMAL, a), "noise": (a, a + RELOC_NOISE),
           "teleport": (a + RELOC_NOISE, len(imgs))}
    return np.stack(imgs), np.stack(gt), seg


def run_relocalization(slam, cam, sync=lambda: None, one_call: bool = False) -> dict:
    """Phase 2c's drive: bootstrap through `track()`, frames up to the yaw
    through one `track_sequence()` call, then the yaw, noise and teleport
    frames through a second one. Returns the run's numbers; the caller
    judges them. Times every `_attempt_relocalization` and every
    vocabulary training (host numpy) from the caller's side.

    The split at the yaw is deliberate. The reference-keyframe rung starts
    from `SLAMSystem.last_T`, which `track_sequence` sets only at the end
    of a call (as the reference does; ROADMAP queue 3), so within one call
    it is the previous call's last pose. Splitting at the yaw makes that
    the pose just before the lost stretch, as a caller that hands frames
    over in short batches sees it; that is the case the rung is checked
    on. `one_call=True` runs every frame after the bootstrap through one
    call instead (no keyframe count before the yaw is taken then): the
    rung then starts from the bootstrap's pose, and the caller only
    reports what it does."""
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import bow

    imgs, gt, seg = relocalization_scenario(cam)
    attempt_ms, train_s = [], []
    attempt, train = slam._attempt_relocalization, bow.train_vocabulary

    def timed_attempt(*a, **k):
        sync()
        t = time.time()
        out = attempt(*a, **k)
        sync()
        attempt_ms.append((time.time() - t) * 1e3)
        return out

    def timed_train(*a, **k):
        t = time.time()
        out = train(*a, **k)
        train_s.append(time.time() - t)
        return out

    slam._attempt_relocalization = timed_attempt
    bow.train_vocabulary = timed_train
    try:
        i = 0
        while slam.carry is None and i < 12:
            slam.track(imgs[i], i)
            i += 1
        if slam.carry is None:
            return {"error": "no bootstrap within 12 frames"}
        parts, n_kf_before = [], None
        a = i if one_call else RELOC_NORMAL
        if a > i:
            parts.append(slam.track_sequence(imgs[i:a], i))
            n_kf_before = slam.cur.n_kf
        parts.append(slam.track_sequence(imgs[a:], a))
    finally:
        slam._attempt_relocalization = attempt
        bow.train_vocabulary = train
    T = np.concatenate([p[0] for p in parts])
    ok = np.concatenate([p[1] for p in parts])
    c = dict(slam.metrics.counters)
    ids = np.nonzero(ok)[0]
    res = {"init_frame": i - 1, "frames": len(ok), "tracked": int(ok.sum()),
           "lost": int((~ok).sum()), "frames_lost_to_tracking": c.get("frames_lost", 0),
           "reloc_attempts": c.get("reloc_attempts", 0),
           "reloc_success": c.get("reloc_success", 0), "reloc_ref_kf": c.get("reloc_ref_kf", 0),
           "keyframes_before_yaw": n_kf_before, "keyframes": slam.cur.n_kf,
           "noise_tracked": int(ok[seg["noise"][0] - i:seg["noise"][1] - i].sum()),
           "last6_tracked": int(ok[-6:].sum()),
           "ate_sim3": synthetic.ate_rmse(np.linalg.inv(T[ids]), gt[i:][ids]),
           "vocabulary_train_s": train_s, "attempt_ms": attempt_ms,
           "ok_flags": "".join("1" if v else "0" for v in ok)}
    print(f"[reloc{' one call' if one_call else ''}] bootstrap at frame {res['init_frame']}, {res['keyframes_before_yaw']} "
          f"keyframes before the yaw | tracked {res['tracked']}/{res['frames']} (lost "
          f"{res['lost']}; {res['frames_lost_to_tracking']} lost to tracking, "
          f"{res['reloc_success']} of them recovered) | reloc_ref_kf {res['reloc_ref_kf']}, "
          f"PnP rung {res['reloc_success'] - res['reloc_ref_kf']} | noise frames tracked "
          f"{res['noise_tracked']}/3 | last 6 tracked {res['last6_tracked']} | ATE-Sim3 "
          f"{res['ate_sim3']:.5f} | vocabulary training s {train_s} | attempt ms "
          f"{[round(v, 1) for v in attempt_ms]} | flags {res['ok_flags']}", flush=True)
    return res


# phase 2d: the loop scenario of the reference's own loop test
# (tests/test_loop_scenarios.py:65-100) at full width
LOOP_FRAMES, LOOP_LAPS = 200, 1.3
LOOP_INIT_MAX = 12
LOOP_ATE_MAX = 0.06         # the reference test's bound
LOOP_MIN_TRACKED = 0.9      # share of frames tracked, both runs
LOOP_MIN_LINES = 100        # map lines made by the end of the loop-closing run
# the JAX reference on its per-frame path (the path track_sequence mirrors),
# run on XLA:CPU: reported beside the port's numbers, not judged
LOOP_REFERENCE = {"ate_sim3_off": 0.02825, "ate_sim3_on": 0.02886, "loop_candidates": 223,
                  "loop_verified": 1, "loop_corrected": 1, "vocab_retrained": 3,
                  "gba_windows": 1, "n_kf_on": 57, "n_kf_off": 69}
LOOP_COUNTERS = ("loop_candidates", "loop_verified", "loop_corrected", "vocab_retrained",
                 "gba_windows", "landmarks_clipped")


def loop_scenario(cam):
    """(images [200, H, W], ground truth T_wc): 1.3 laps of a camera on a
    circle of radius 2 looking out at a textured cylinder of radius 4 (700
    point patches, 48 lines), noise 2.0."""
    from structure_slam_pointline_tpu_torch.io import synthetic

    scene = synthetic.make_cylinder_scene(n_points=700, n_lines=48, seed=0)
    poses = synthetic.loop_trajectory(LOOP_FRAMES, laps=LOOP_LAPS)
    return synthetic.render_sequence(scene, poses, cam, noise=2.0), poses


def run_loop(cam, imgs, poses, enable: bool, device=None, sync=lambda: None) -> dict:
    """Phase 2d's drive: a fresh `SLAMSystem(SLAMConfig(camera=cam,
    enable_loop_closing=enable))`, bootstrap through `track()` within
    LOOP_INIT_MAX frames, the rest through one `track_sequence()` call.
    Returns the run's numbers (the caller judges them), with the wall time
    of every `_run_loop_closing` call that corrected and where it went:
    detect, verify, correct, global BA."""
    from structure_slam_pointline_tpu_torch.config import SLAMConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.models.system import SLAMSystem
    from structure_slam_pointline_tpu_torch.optim import global_ba

    slam = SLAMSystem(SLAMConfig(camera=cam, enable_loop_closing=enable), device=device)
    lc = slam._get_loop_closer()
    spans, corrections = {}, []

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            sync()
            t = time.time()
            out = fn(*a, **k)
            sync()
            spans[key] = spans.get(key, 0.0) + (time.time() - t) * 1e3
            return out
        setattr(obj, name, wrapped)
        return fn

    for name in ("detect", "verify", "correct"):
        timed(lc, name, f"{name}_ms")
    gba = timed(global_ba, "global_bundle_adjust", "global_ba_ms")
    run_lc = slam._run_loop_closing

    def timed_reaction(*a, **k):
        spans.clear()
        before = slam.metrics.counters.get("loop_corrected", 0)
        sync()
        t = time.time()
        run_lc(*a, **k)
        sync()
        if slam.metrics.counters.get("loop_corrected", 0) > before:
            corrections.append({"keyframe": slam.cur.n_kf - 1 if not a else a[0],
                                "wall_ms": (time.time() - t) * 1e3, **spans})

    slam._run_loop_closing = timed_reaction
    t0 = time.time()
    try:
        i = 0
        while slam.carry is None and i < LOOP_INIT_MAX:
            slam.track(imgs[i], i)
            i += 1
        if slam.carry is None:
            return {"error": f"no bootstrap within {LOOP_INIT_MAX} frames"}
        _, ok, _, _ = slam.track_sequence(imgs[i:], i)
    finally:
        global_ba.global_bundle_adjust = gba
    sync()
    traj = slam.trajectory()
    ids = sorted(traj)
    est = np.stack([np.linalg.inv(traj[k]) for k in ids])
    c = slam.metrics.counters
    slam.sync_cursors()
    res = {"loop_closing": enable, "init_frame": i - 1, "frames": len(ok),
           "tracked": int(ok.sum()), "ate_sim3": synthetic.ate_rmse(est, poses[ids])
           if np.isfinite(est).all() else float("nan"), "n_kf": slam.cur.n_kf,
           "n_ml": slam.cur.n_ml, "n_mp": slam.cur.n_mp, "seconds": time.time() - t0,
           **{k: int(c.get(k, 0)) for k in LOOP_COUNTERS}, "corrections": corrections,
           "slam": slam}
    print(f"[loop {'on' if enable else 'off'}] bootstrap at frame {res['init_frame']} | "
          f"tracked {res['tracked']}/{res['frames']} | ATE-Sim3 {res['ate_sim3']:.5f} | "
          f"n_kf {res['n_kf']} n_mp {res['n_mp']} n_ml {res['n_ml']} | "
          + " ".join(f"{k} {res[k]}" for k in LOOP_COUNTERS)
          + f" | {res['seconds']:.1f} s | corrections {corrections}", flush=True)
    return res


def match_margins(entry: str, args, b: int, m: int, cols) -> dict:
    """The gates of row m of batch b of one kernel-22 call, recomputed from
    its inputs: {gate: (value, threshold)}, the row's own gates and, for
    each feature in `cols`, the pair's. A row on which the kernel and its
    plain version differ flips at the gate whose value lies nearest its
    threshold."""
    import torch

    from structure_slam_pointline_tpu_torch.utils import lie

    st, intr = args[0], None
    g = {}

    def proj(T, X):
        p = T[:3, :3] @ X + T[:3, 3]
        z = p[2] if abs(float(p[2])) >= 1e-6 else torch.tensor(1e-6, device=p.device)
        return float(p[0] / z * intr.fx + intr.cx), float(p[1] / z * intr.fy + intr.cy), p

    def window(tag, u, v, x, y, r):
        g[f"{tag} |du|"] = (abs(u - x), r)
        g[f"{tag} |dv|"] = (abs(v - y), r)

    def point_gates(T, X, s_, cfg):
        """The point gates of kernel 22's points entries: (u, v, predicted
        octave)."""
        u, v, p = proj(T, X)
        dist = float(torch.linalg.norm(p))
        dmin, dmax = float(st.mp_dist_min[s_]), float(st.mp_dist_max[s_])
        g["depth"] = (float(p[2]), 0.1)
        if 0.0 < dmax < 1e8:
            g["band lo"] = (dist, dmin * 0.8)
            g["band hi"] = (dist, dmax * 1.2)
        maxd = dist if not 0.0 < dmax < 1e8 else dmax
        q = float(np.log(max(maxd / max(dist, 1e-6), 1.0)) / np.log(np.float32(
            cfg.frontend.scale_factor)))
        g["octave"] = (q, float(np.round(q)))
        c = -(T[:3, :3].T @ T[:3, 3])
        ray = (X - c) / torch.linalg.norm(X - c).clamp(min=1e-9)
        n = st.mp_normal[s_]
        g["normal"] = (float(torch.linalg.norm(n)), 0.5)
        g["view"] = (float(ray @ n), 0.5)
        return u, v, int(np.clip(np.ceil(q), 0, cfg.frontend.n_levels - 1))

    if entry in ("track_match_points", "track_match_lines"):
        _, fr, T, ids, intr, cfg, radius = args[:7]
        W, H = cfg.camera.width, cfg.camera.height
        if entry == "track_match_points":
            s_ = int(ids[m].clamp(0, st.mp_valid.shape[0] - 1))
            u, v, lv = point_gates(T, st.mp_xyz[s_], s_, cfg)
            for j in cols:
                x, y = (float(w) for w in fr.xy[j])
                window(f"feature {j}", u, v, x, y, radius * cfg.frontend.scale_factor ** lv)
        else:
            s_ = int(ids[m].clamp(0, st.ml_valid.shape[0] - 1))
            ep = st.ml_endpoints[s_]
            us, vs, ps = proj(T, ep[:3])
            ue, ve, pe = proj(T, ep[3:])
            u, v = 0.5 * (us + ue), 0.5 * (vs + ve)
            g["depth start"] = (float(ps[2]), 0.1)
            g["depth end"] = (float(pe[2]), 0.1)
            ang = float(np.arctan2(ve - vs, ue - us))
            for j in cols:
                e = fr.line_ep[j].tolist()
                window(f"line {j}", u, v, 0.5 * (e[0] + e[2]), 0.5 * (e[1] + e[3]), radius)
                d = (ang - np.arctan2(e[3] - e[1], e[2] - e[0]) + np.pi / 2) % np.pi - np.pi / 2
                g[f"line {j} angle"] = (abs(d), 0.26)
        g["u lo"], g["u hi"] = (u, 4.0), (u, W - 4.0)
        g["v lo"], g["v hi"] = (v, 4.0), (v, H - 4.0)
    elif entry in ("fuse_match_points", "fuse_match_lines"):
        _, a_ids, b_ids, present, intr, cfg = args
        a, t = int(a_ids[b]), int(b_ids[b])
        T = st.kf_T_cw[t]
        W, H = cfg.camera.width, cfg.camera.height
        if entry == "fuse_match_points":
            s_ = int(st.kf_kp_mp[a, m].clamp(0, st.mp_valid.shape[0] - 1))
            u, v, lv = point_gates(T, st.mp_xyz[s_], s_, cfg)
            r = 3.0 * cfg.frontend.scale_factor ** lv
            for j in cols:
                x, y = (float(w) for w in st.kf_xy[t, j])
                window(f"feature {j}", u, v, x, y, r)
                sig2 = cfg.frontend.scale_factor ** (2.0 * int(st.kf_octave[t, j]))
                g[f"feature {j} chi2"] = ((u - x) ** 2 + (v - y) ** 2, 5.991 * sig2)
        else:
            s_ = int(st.kf_line_ml[a, m].clamp(0, st.ml_valid.shape[0] - 1))
            ep = st.ml_endpoints[s_]
            us, vs, ps = proj(T, ep[:3])
            ue, ve, pe = proj(T, ep[3:])
            u, v = 0.5 * (us + ue), 0.5 * (vs + ve)
            g["depth start"] = (float(ps[2]), 0.1)
            g["depth end"] = (float(pe[2]), 0.1)
            ang = float(np.arctan2(ve - vs, ue - us))
            for j in cols:
                e = st.kf_line_ep[t, j].tolist()
                window(f"line {j}", u, v, 0.5 * (e[0] + e[2]), 0.5 * (e[1] + e[3]), 8.0)
                d = (ang - np.arctan2(e[3] - e[1], e[2] - e[0]) + np.pi / 2) % np.pi - np.pi / 2
                g[f"line {j} angle"] = (abs(d), 0.26)
        g["u lo"], g["u hi"] = (u, 2.0), (u, W - 2.0)
        g["v lo"], g["v hi"] = (v, 2.0), (v, H - 2.0)
    elif entry == "pool_match":
        _, kf_id, M_cw, pool_ids, intr, radius = args[:6]
        Mb = M_cw.reshape(-1, 4, 4)[b]
        t = int(torch.as_tensor(kf_id).reshape(-1)[b])
        s_ = int(pool_ids[m].clamp(0, st.mp_valid.shape[0] - 1))
        u, v, p = proj(Mb, st.mp_xyz[s_])
        g["depth"] = (float(p[2]), 0.1)
        for j in cols:
            x, y = (float(w) for w in st.kf_xy[t, j])
            window(f"feature {j}", u, v, x, y, float(radius))
    else:
        _, k, cand, S12, intr = args[:5]
        S21 = lie.sim3_inverse(S12)
        P = st.mp_valid.shape[0]
        X1 = st.kf_T_cw[k, :3, :3] @ st.mp_xyz[int(st.kf_kp_mp[k, m].clamp(0, P - 1))] \
            + st.kf_T_cw[k, :3, 3]
        u, v, p = proj(S21, X1)
        g["depth k in cand"] = (float(p[2]), 0.1)
        xk, yk = (float(w) for w in st.kf_xy[k, m])
        for j in cols:
            X2 = st.kf_T_cw[cand, :3, :3] @ st.mp_xyz[int(st.kf_kp_mp[cand, j].clamp(0, P - 1))] \
                + st.kf_T_cw[cand, :3, 3]
            u2, v2, p2 = proj(S12, X2)
            g[f"feature {j} depth in k"] = (float(p2[2]), 0.1)
            x, y = (float(w) for w in st.kf_xy[cand, j])
            window(f"feature {j} in cand", u, v, x, y, 7.5)
            window(f"feature {j} in k", u2, v2, xk, yk, 7.5)
    return g


def keyframe_split(args, kw) -> dict:
    """One recorded keyframe pipeline call replayed (after one warm call)
    with each stage timed from the caller, a synchronize before and after
    each: ms by stage, `rest` (the host glue between them) and `total`."""
    import torch

    from structure_slam_pointline_tpu_torch.models import local_mapping as lm
    from structure_slam_pointline_tpu_torch.models import pipeline, tracking
    from structure_slam_pointline_tpu_torch.optim import local_ba
    from structure_slam_pointline_tpu_torch.world import map_store

    stages = [(lm, "insert_keyframe"), (map_store, "covisibility_weights"),
              (lm, "create_new_points"), (lm, "create_new_lines"),
              (lm, "fuse_projected_points"), (lm, "fuse_projected_lines"),
              (pipeline, "_gather_ba_problem_device"), (local_ba, "bundle_adjust"),
              (lm, "apply_ba_result"), (map_store, "point_obs_counts"), (lm, "cull_points"),
              (lm, "cull_lines"), (lm, "cull_keyframes"), (map_store, "compute_obs_bits"),
              (tracking, "compute_local_sets")]
    ms = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return run

    pipeline._keyframe_pipeline(*args, **kw)
    real = [(mod, name, getattr(mod, name)) for mod, name in stages]
    for mod, name, fn in real:
        setattr(mod, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline._keyframe_pipeline(*args, **kw)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    ms["rest"] = total - sum(ms.values())
    ms["total"] = total
    return ms


def nearest_gate(g: dict):
    """(gate, relative margin) of the gate nearest its threshold."""
    rel = {k: abs(v - t) / max(abs(t), 1e-6) for k, (v, t) in g.items()}
    k = min(rel, key=rel.get)
    return k, rel[k]


# phase 2e: the dataset path (run A: the bench sequence at the default pools;
# run B: the reference's long-run test, tests/test_compaction.py:96-128)
DATASET_DIR = os.path.join(ROOT, "out_chip_smoke")   # git-ignored (out*/)
LOST_AFTER_INIT_MAX = 10
RUN_B_FRAMES = 60
RUN_B_MIN_TRACKED = RUN_B_FRAMES - 10
COMPACT_PASSES = ("compact_points", "compact_lines", "compact_keyframes")


def write_tum_dir(path: str, frame, n: int) -> None:
    """A TUM-layout sequence: rgb/NNNN.png (8-bit, clipped) and rgb.txt at
    30 fps timestamps."""
    from PIL import Image

    os.makedirs(os.path.join(path, "rgb"), exist_ok=True)
    rows = ["# timestamp filename"]
    for i in range(n):
        rel = f"rgb/{i:04d}.png"
        Image.fromarray(np.clip(frame(i), 0, 255).astype(np.uint8), "L").save(
            os.path.join(path, rel), compress_level=1)
        rows.append(f"{i / 30.0:.6f} {rel}")
    with open(os.path.join(path, "rgb.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def run_dataset(cfg, seq_dir: str, poses, label: str, sync=lambda: None, device=None) -> dict:
    """Phase 2e's drive: the port's dataset driver (`run_slam.run`, one
    `track()` per frame through the native prefetching loader) on a TUM
    directory; every compaction pass it calls is timed from the caller
    (synchronized) and its first input kept. Returns the run's numbers,
    with ATE-Sim3 read back from the written MonoTrajectory.txt; the
    caller judges them."""
    from structure_slam_pointline_tpu_torch import run_slam
    from structure_slam_pointline_tpu_torch.io import datasets, synthetic
    from structure_slam_pointline_tpu_torch.world import compact

    out_dir = os.path.join(seq_dir, "out")
    recs = {p: Recorder(compact, p, lambda st: ("first",), sync=sync) for p in COMPACT_PASSES}
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        res = run_slam.run(cfg, seq_dir, out_dir=out_dir, device=device)
    slam = res["slam"]
    ts, T_wc = datasets.read_trajectory_tum(os.path.join(out_dir, "MonoTrajectory.txt"))
    ids = np.rint(ts * 30.0).astype(int)
    kf_rows = np.loadtxt(os.path.join(out_dir, "KeyFrameTrajectory.txt"), ndmin=2)
    tracked = [e.frame_id for e in slam.log if e.T_cw is not None]
    init = tracked[0] if tracked else None
    n = res["frames"]
    lost_after = sum(1 for e in slam.log if init is not None and e.frame_id > init
                     and e.T_cw is None)
    live_kf = int(slam.map.kf_valid[:slam.cur.n_kf].sum())
    steady = res["track_s"][init + 1:] if init is not None else []
    c = slam.metrics.counters
    out = {"frames": n, "decoder": res["decoder"], "init_frame": init,
           "tracked": len(tracked), "lost_after_init": lost_after,
           "ate_sim3": synthetic.ate_rmse(T_wc, poses[ids]) if len(ids) > 2 else float("nan"),
           "trajectory_rows": len(ts), "keyframe_rows": len(kf_rows), "live_keyframes": live_kf,
           "fps_wall": n / res["wall_s"],
           "fps_track": len(steady) / sum(steady) if steady else float("nan"),
           "median_track_ms": float(np.median(steady)) * 1e3 if steady else float("nan"),
           "n_kf": slam.cur.n_kf, "n_mp": slam.cur.n_mp, "n_ml": slam.cur.n_ml,
           **{p: int(c.get(p, 0)) for p in COMPACT_PASSES},
           "pass_caller_ms": {p: r.ms for p, r in recs.items() if r.ms}}
    print(f"[dataset {label}] {n} frames via the {res['decoder']} loader | bootstrap at frame "
          f"{init} | tracked {out['tracked']}/{n}, lost after the bootstrap {lost_after} | "
          f"ATE-Sim3 {out['ate_sim3']:.5f} (from MonoTrajectory.txt, {len(ts)} rows) | "
          f"keyframe rows {len(kf_rows)} (live {live_kf}) | fps wall {out['fps_wall']:.2f}, "
          f"track() {out['fps_track']:.2f} | cursors n_kf {out['n_kf']} n_mp {out['n_mp']} "
          f"n_ml {out['n_ml']} | compactions "
          + " ".join(f"{p} {out[p]}" for p in COMPACT_PASSES)
          + f" | pass caller ms {out['pass_caller_ms']}", flush=True)
    return {"e2e": out, "slam": slam,
            "first_inputs": {p: r.calls[("first",)][0][0] for p, r in recs.items() if r.calls}}


def compact_bytes(st, name: str) -> int:
    """Bytes a compaction pass must move on this input: the valid mask
    read; of each pool field the live rows read and every row written (a
    dead row is a fill pattern, read from no field); `perm` written; the
    edge grid (points, lines) or the four landmark stamp arrays
    (keyframes) read and written whole; for keyframes the rebuilt
    observer bits written (world/compact.py)."""
    from structure_slam_pointline_tpu_torch.world import compact

    fields, valid, remapped = {
        "compact_points": (compact.POINT_FIELDS, st.mp_valid, ["kf_kp_mp"]),
        "compact_lines": (compact.LINE_FIELDS, st.ml_valid, ["kf_line_ml"]),
        "compact_keyframes": (compact.KEYFRAME_FIELDS, st.kf_valid, list(compact.STAMPS)),
    }[name]
    N, n_live = valid.shape[0], int(valid.sum())
    row = sum(nbytes(getattr(st, f)) for f, _ in fields) // N
    b = row * (n_live + N) + nbytes(valid) + 4 * N
    b += 2 * nbytes(*(getattr(st, f) for f in remapped))
    if name == "compact_keyframes":
        b += nbytes(st.mp_obs_bits)
    return b


def check_compact(st, label: str) -> None:
    """Kernel 19 against its plain version on the card: every field, the
    live count and `perm` bit-equal (floats compared as their bits)."""
    import torch

    from structure_slam_pointline_tpu_torch.world import compact

    for name in COMPACT_PASSES:
        out_k = getattr(compact, name)(st)
        out_p = getattr(compact, name + "_plain")(st)
        for f in st._fields:
            a, b = getattr(out_k[0], f), getattr(out_p[0], f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                fail(f"compact ({name}, {label}): field {f} differs in {int((a != b).sum())}")
        if int(out_k[1]) != int(out_p[1]):
            fail(f"compact ({name}, {label}): live count {int(out_k[1])} != {int(out_p[1])}")
        if name == "compact_keyframes" and not torch.equal(out_k[2], out_p[2]):
            fail(f"compact ({name}, {label}): perm differs")
    print(f"[check] compact on {label}: all three passes bit-equal", flush=True)


def seed_duplicates(st, cur, g, n_points: int = 300, n_lines: int = 40):
    """A map state with duplicates of live landmarks seeded as first seen
    at keyframe cur.n_kf, in the free slots past the cursors: each moved by
    0.2% of its distance, its descriptor 3% of its bits apart, every fifth
    80% apart (fuse_duplicate_*_3d's case, run with n_kf = cur.n_kf + 2)."""
    import torch

    seeded = {}
    for pre, n_cur, n_seed in (("mp", cur.n_mp, n_points), ("ml", cur.n_ml, n_lines)):
        valid = getattr(st, f"{pre}_valid").clone()
        first = getattr(st, f"{pre}_first_kf").clone()
        desc = getattr(st, f"{pre}_desc").clone()
        geo_name = "mp_xyz" if pre == "mp" else "ml_endpoints"
        geo = getattr(st, geo_name).clone()
        dev = geo.device
        live = torch.nonzero(valid).flatten().cpu().numpy()
        src = torch.as_tensor(g.choice(live, min(n_seed, len(live)), replace=False),
                              device=dev)
        dst = torch.arange(n_cur, n_cur + len(src), device=dev)
        if len(src) == 0 or dst[-1] >= valid.shape[0]:
            fail(f"seed_duplicates: no live {pre} landmarks or no free slots")
        x = geo[src]
        scale = torch.linalg.norm(x[:, :3], dim=1, keepdim=True)
        step = torch.from_numpy(g.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)
        geo[dst] = x + 0.002 * scale * step / torch.linalg.norm(step, dim=1, keepdim=True)
        flips = g.uniform(size=(len(src), 256)) < 0.03
        flips[::5] = g.uniform(size=(flips[::5].shape[0], 256)) < 0.8
        words = np.packbits(flips, axis=1, bitorder="little").view(np.uint32).view(np.int32)
        desc[dst] = desc[src] ^ torch.from_numpy(words.copy()).to(dev)
        valid[dst] = True
        first[dst] = cur.n_kf
        seeded.update({f"{pre}_valid": valid, f"{pre}_first_kf": first, f"{pre}_desc": desc,
                       geo_name: geo})
    return st._replace(**seeded)


def frontend_card_vs_cpu(img: np.ndarray, cfg) -> dict:
    """One bench frame built by the port on the card (kernels) and on the
    CPU (plain versions): per pyramid level, the pixels of the card's
    level and blurred level that differ from the CPU's, and of one card
    op applied to the CPU's own input (resize from the CPU's previous
    level, blur of the CPU's level), which isolates the op; then the
    shares of keypoints, descriptors and lines that are equal. Fails
    unless everything is equal (line endpoints within 1e-3 px)."""
    import torch

    from structure_slam_pointline_tpu_torch.models import pipeline
    from structure_slam_pointline_tpu_torch.ops import pyramid
    from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

    fe = cfg.frontend
    cpu = torch.from_numpy(img)
    lv_c, bl_c = pyramid.build_blurred_pyramid(cpu.to(torch.bfloat16), fe.n_levels,
                                               fe.scale_factor, fe.blur_sigma)
    lv_g, bl_g = pyramid.build_blurred_pyramid(cpu.cuda().to(torch.bfloat16), fe.n_levels,
                                               fe.scale_factor, fe.blur_sigma)
    diff = lambda a, b: int((a.cpu().float() != b.float()).sum())  # noqa: E731
    levels, first = [], None
    for lv in range(len(lv_c)):
        row = {"level": lv, "level_px": diff(lv_g[lv], lv_c[lv]),
               "blurred_px": diff(bl_g[lv], bl_c[lv]),
               "resize_alone_px": diff(pyramid.resize_bilinear(
                   lv_c[lv - 1].cuda(), tuple(lv_c[lv].shape)), lv_c[lv]) if lv else 0,
               "blur_alone_px": diff(pyramid.blur(lv_c[lv].cuda(), fe.blur_sigma), bl_c[lv])}
        levels.append(row)
        if first is None:
            for op in ("resize_alone_px", "blur_alone_px"):
                if row[op]:
                    first = f"level {lv}: {op[:-9]}"
                    break
    intr = Intrinsics.from_config(cfg.camera)
    f_c = pipeline.build_frame_device(cpu, intr, cfg)
    f_g = pipeline.build_frame_device(cpu.cuda(), intr, cfg)
    f_g = type(f_g)(*[t.cpu() for t in f_g])
    kv = f_c.kp_valid & f_g.kp_valid
    same_kp = kv & (f_c.xy == f_g.xy).all(1) & (f_c.octave == f_g.octave)
    same_desc = same_kp & (f_c.desc == f_g.desc).all(1)
    lv_ = f_c.line_valid & f_g.line_valid
    same_ln = lv_ & ((f_c.line_ep - f_g.line_ep).abs().amax(1) <= 1e-3)
    n_kp, n_ln = max(int(f_c.kp_valid.sum()), 1), max(int(f_c.line_valid.sum()), 1)
    out = {"first_differing_op": first, "levels": levels,
           "keypoints_valid": [int(f_c.kp_valid.sum()), int(f_g.kp_valid.sum())],
           "keypoints_equal_share": int(same_kp.sum()) / n_kp,
           "descriptors_equal_share": int(same_desc.sum()) / n_kp,
           "lines_valid": [int(f_c.line_valid.sum()), int(f_g.line_valid.sum())],
           "lines_equal_share": int(same_ln.sum()) / n_ln,
           "line_descriptors_equal_share": int((same_ln & (f_c.ldesc == f_g.ldesc).all(1))
                                               .sum()) / n_ln}
    print(f"[frontend card vs cpu] first differing op: {first} | per level (level px, blurred "
          f"px, resize alone, blur alone): "
          + "; ".join(f"{r['level']}: {r['level_px']} {r['blurred_px']} "
                      f"{r['resize_alone_px']} {r['blur_alone_px']}" for r in levels)
          + f" | keypoints equal {out['keypoints_equal_share']:.4f}, descriptors "
          f"{out['descriptors_equal_share']:.4f}, lines {out['lines_equal_share']:.4f}, line "
          f"descriptors {out['line_descriptors_equal_share']:.4f}", flush=True)
    bad = [f"level {r['level']}: {k}" for r in levels for k in ("level_px", "blurred_px")
           if r[k]]
    bad += [k for k in ("keypoints_valid", "lines_valid") if out[k][0] != out[k][1]]
    bad += [k for k in out if k.endswith("_share") and out[k] != 1.0]
    if first is not None or bad:
        fail(f"frontend card vs cpu: the card's frame differs from the CPU's ({first}; {bad})")
    return out


def glue_kernels(rec12: dict, frames: int) -> list:
    """Kernels 25, 26 and kernel 22's tracking entries against their plain
    versions on every call recorded in phase 2a (each of the first frames'
    calls and a sample of later ones, `sampled_calls`); `frames` the
    phase's frames. Kernel 25 bit-equal on every level and blurred plane;
    kernel 26's integer outputs (valid, octave) bit-equal, its floats
    bit-equal or printed with their largest difference, which must stay
    within 1e-5; the tracking entries' idx, dist, valid and visible
    exactly equal, each differing row printed with its nearest gate
    (`match_margins`). Returns the table rows, each with its launches per
    frame."""
    import torch

    from structure_slam_pointline_tpu_torch.ops import lsd, matching, pyramid

    rows = []

    def calls_of(name):
        calls = rec12[name].calls
        if not calls:
            fail(f"{name}: no call recorded in phase 2a")
        return calls

    # kernel 25: every recorded frame's levels and blurred planes
    calls = calls_of("pyramid")
    for key, (args, kw) in calls.items():
        (lk, bk), (lp, bp) = (pyramid.build_blurred_pyramid(*args, **kw),
                              pyramid.build_blurred_pyramid_plain(*args, **kw))
        for lv, (a, b, c, d) in enumerate(zip(lk, lp, bk, bp)):
            if not (torch.equal(a, b) and torch.equal(c, d)):
                fail(f"pyramid disagrees at {key} level {lv}: level {int((a != b).sum())} px, "
                     f"blurred {int((c != d).sum())} px")
    args, kw = calls[min(calls)]
    lp, _ = pyramid.build_blurred_pyramid_plain(*args, **kw)
    px = [t.numel() for t in lp]
    mats = []
    for lv in range(1, len(lp)):
        (h, w), (h2, w2) = lp[lv - 1].shape, lp[lv].shape
        wr = pyramid._bf16_weights(h, h2, lp[lv].device)
        wc = pyramid._bf16_weights(w, w2, lp[lv].device)
        x = lp[lv - 1].float()
        mats.append((wr.T, x, (wr.T @ x).to(torch.bfloat16).float(), wc))

    def library():   # the plain version's two torch.matmul calls per level
        return [(a @ b, c @ d) for a, b, c, d in mats]

    rows.append(dict(
        name="pyramid", max_abs_err=0.0,
        **timings(lambda: pyramid.build_blurred_pyramid(*args, **kw),
                  lambda: pyramid.build_blurred_pyramid_plain(*args, **kw)),
        library_ms=device_ms(library), library_wall_ms=time_ms(library),
        library_shape="the plain version's 2 torch.matmul calls per level (the resizes "
                      "alone, no blur)",
        bytes=2 * (sum(px[:-1]) + sum(px[1:]) + sum(px)),
        ops=sum(px) * OPS_PYR_BLUR_PX + sum(px[1:]) * OPS_PYR_RESIZE_PX,
        shape=f"{len(lp)} levels of {tuple(lp[0].shape)} ({sum(px)} px), 8 launches a call "
              f"({len(calls)} calls checked)"))

    # kernel 26: integer outputs bit-equal, floats bit-equal or within 1e-5
    def check_lines(name, fn, plain):
        calls = calls_of(name)
        err = 0.0
        for key, (args, kw) in calls.items():
            ok_, op = fn(*args, **kw), plain(*args, **kw)
            for f in ("valid", "octave"):
                if not torch.equal(getattr(ok_, f), getattr(op, f)):
                    fail(f"{name} disagrees at {key}: {f}")
            for f in ("endpoints", "line2d", "response", "angle"):
                a, b = getattr(ok_, f), getattr(op, f)
                if not torch.equal(a, b):
                    e = (a - b).abs().max().item()
                    print(f"[kernel 26] {name} at {key}: {f} not bit-equal, largest "
                          f"difference {e:.3e}", flush=True)
                    err = max(err, e)
        if err > 1e-5:
            fail(f"{name}: float outputs differ by {err:.3e} (> 1e-5)")
        return calls, err

    calls, err = check_lines("lsd_merge", lsd.lsd_merge, lsd.lsd_merge_plain)
    # a frame's two octaves: every recorded call (the first 20 frames' and
    # every 25th after; key 0 is the shared key of unsampled calls), timed
    # together and counted per frame, as phase 4's profile counts it; the
    # first frame's two calls beside it
    rec_calls = [calls[k] for k in sorted(k for k in calls if k[1] > 0)]
    per_frame = 2 / len(rec_calls)
    first_ms = device_ms(lambda: [lsd.lsd_merge(*a, **k) for a, k in rec_calls[:2]])
    t = timings(lambda: [lsd.lsd_merge(*a, **k) for a, k in rec_calls],
                lambda: [lsd.lsd_merge_plain(*a, **k) for a, k in rec_calls])
    Ks = [a[0].shape[0] for a, _ in rec_calls]
    print(f"[kernel 26] lsd_merge a frame: {t['ms'] * per_frame:.4f} ms on the device, the "
          f"mean of {len(rec_calls)} recorded calls; the first frame's two calls "
          f"{first_ms:.4f} ms", flush=True)
    rows.append(dict(
        name="lsd_merge", max_abs_err=err, library_ms=None,
        **{k: v * per_frame for k, v in t.items()},
        bytes=per_frame * sum(K * 29 + a[2] * 41 for K, (a, _) in zip(Ks, rec_calls)),
        ops=per_frame * sum(K * K * OPS_MERGE_PAIR + 4 * K ** 3 // 32 for K in Ks),
        shape=f"a frame's 2 octaves (K = {sorted(set(Ks))} candidates), the mean of "
              f"{len(rec_calls)} recorded calls; the first frame {first_ms:.4f} ms "
              f"({len(calls)} calls checked)"))
    calls, err = check_lines("lsd_octave_merge", lsd.lsd_octave_merge,
                             lsd.lsd_octave_merge_plain)
    args, kw = calls[min(calls)]
    L = args[0].valid.shape[0]
    rows.append(dict(
        name="lsd_octave_merge", max_abs_err=err, library_ms=None,
        **timings(lambda: lsd.lsd_octave_merge(*args, **kw),
                  lambda: lsd.lsd_octave_merge_plain(*args, **kw)),
        bytes=2 * L * 25 + L * 41, ops=(2 * L) ** 2 * OPS_OCTAVE_PAIR,
        shape=f"2 x {L} candidates ({len(calls)} calls checked)"))

    # kernel 22's tracking entries: exactly equal on every recorded call
    for entry, fn, plain in (
            ("track_match_points", matching.track_match_points,
             matching.track_match_points_plain),
            ("track_match_lines", matching.track_match_lines,
             matching.track_match_lines_plain)):
        calls = calls_of(entry)
        n_rows, diffs = 0, []
        for key, (args, kw) in calls.items():
            (mk, vk), (mp, vp) = fn(*args, **kw), plain(*args, **kw)
            same = ((mk.idx == mp.idx) & (mk.dist == mp.dist) & (mk.valid == mp.valid)
                    & (vk == vp))
            n_rows += same.numel()
            for m_ in torch.nonzero(~same).flatten().tolist()[:50]:
                cols = sorted({int(mk.idx[m_]), int(mp.idx[m_])})
                gate, rel = nearest_gate(match_margins(entry, args, 0, m_, cols))
                diffs.append(m_)
                print(f"[kernel 22] {entry} differs at {key} row {m_}: plain "
                      f"({int(mp.idx[m_])}, {int(mp.dist[m_])}, {bool(mp.valid[m_])}, visible "
                      f"{bool(vp[m_])}) kernel ({int(mk.idx[m_])}, {int(mk.dist[m_])}, "
                      f"{bool(mk.valid[m_])}, visible {bool(vk[m_])}) | nearest gate {gate} "
                      f"at {rel:.3e} relative", flush=True)
        print(f"[kernel 22] {entry}: {len(calls)} calls, {n_rows} rows, {len(diffs)} differ",
              flush=True)
        if diffs:
            fail(f"{entry}: {len(diffs)} rows differ from the plain version")
        args, kw = calls[max(calls, key=lambda k: k[1])]
        with Spy() as spy:
            mp, vp = plain(*args, **kw)
        st, fr, ids = args[0], args[1], args[3]
        M = ids.shape[0]
        if entry == "track_match_points":
            N = fr.xy.shape[0]
            b_ = M * (4 + 12 + 8 + 12 + 32 + 4) + N * (8 + 1 + 4 + 32 + 4) + M * 14
            extra = M * 10
        else:
            N = fr.line_ep.shape[0]
            nv = int(mp.valid.sum())
            b_ = M * (4 + 24 + 32) + N * (16 + 1 + 32) + M * 14
            extra = 4 * M * max(nv, 1)   # the two medians' rank counts
        rows.append(dict(
            name=entry, max_abs_err=0.0, library_ms=None,
            **timings(lambda: fn(*args, **kw), lambda: plain(*args, **kw)),
            bytes=b_, ops=spy.tests * OPS_WINDOW_PAIR + spy.pairs * OPS_DIST_PAIR
            + M * OPS_MATCH_ROW[entry] + extra,
            shape=f"{M} rows ({int(vp.sum())} visible) x {N} features, {spy.tests} window "
                  f"tests, {spy.pairs} in-window pairs ({len(calls)} calls checked)"))
    for r in rows:
        r["frames"] = frames
    return rows


def kernels_22_24(fuse_rec: dict, glue_rec: dict, kf_shape) -> tuple:
    """Kernels 22-24 against their plain versions on the calls recorded in
    phase 2a (fuse_rec) and 2d (glue_rec), `kf_shape` the points grid's
    [K, F]: (kernel-table rows, the functions around them timed from the
    caller with the keyframe pipeline's split)."""
    import torch

    from structure_slam_pointline_tpu_torch.models import local_mapping as lm
    from structure_slam_pointline_tpu_torch.models import loop_closing
    from structure_slam_pointline_tpu_torch.ops import matching
    from structure_slam_pointline_tpu_torch.world import map_store

    rows = []
    t0 = time.time()

    def calls_of(recorder, what):
        if not recorder.calls:
            fail(f"{what}: no call recorded")
        return recorder.calls

    def match_rows(entry, args, out):
        """(idx, dist, valid) of one kernel-22 call as [B, M], and the rows
        that have a candidate."""
        m, st = out, args[0]
        if entry in ("fuse_match_points", "fuse_match_lines"):
            tab = st.kf_kp_mp if entry == "fuse_match_points" else st.kf_line_ml
            cand = (tab[args[1]] >= 0) & args[3][:, None]
        elif entry == "pool_match":
            cand = (args[3] >= 0)[None, :]
        else:
            cand = (st.kf_kp_mp[args[1]] >= 0)[None, :]
        M = m.idx.shape[-1]
        flat = [t.reshape(-1, M) for t in (m.idx, m.dist, m.valid)]
        return flat, cand.expand_as(flat[0])

    def check_match(entry, fn, plain, calls):
        """Replay kernel 22's recorded calls through the kernel and its
        plain version: rows equal (idx, dist and valid) on >=
        MATCH_AGREE_MIN of the candidate rows and on every row without a
        candidate; each differing row printed with its nearest gate, which
        must lie within MATCH_MARGIN_MAX of its threshold, or share a
        column with such a row (a claim the flip moved)."""
        n_rows = n_same = 0
        diffs = []
        for key, (args, kw) in calls.items():
            (ik, dk, vk), cand = match_rows(entry, args, fn(*args, **kw))
            (ip, dp, vp), _ = match_rows(entry, args, plain(*args, **kw))
            same = (ik == ip) & (dk == dp) & (vk == vp)
            if not bool(same[~cand].all()):
                fail(f"{entry} disagrees on a row without a candidate at {key}")
            n_rows += int(cand.sum())
            n_same += int((same & cand).sum())
            bad = torch.nonzero(~same).tolist()
            if len(bad) > 200:
                fail(f"{entry}: {len(bad)} rows differ at {key}")
            found = []
            for b_, m_ in bad:
                cols = sorted({int(ik[b_, m_]), int(ip[b_, m_])})
                gate, rel = nearest_gate(match_margins(entry, args, b_, m_, cols))
                found.append(dict(call=str(key), batch=b_, row=m_, cols=cols, gate=gate,
                                  margin=rel, plain=(int(ip[b_, m_]), bool(vp[b_, m_])),
                                  kernel=(int(ik[b_, m_]), bool(vk[b_, m_]))))
            flipped = {(d["batch"], c) for d in found if d["margin"] <= MATCH_MARGIN_MAX
                       for c in d["cols"]}
            for d in found:
                d["explained"] = (d["margin"] <= MATCH_MARGIN_MAX
                                  or any((d["batch"], c) in flipped for c in d["cols"]))
                print(f"[kernel 22] {entry} differs at {d['call']} batch {d['batch']} row "
                      f"{d['row']}: plain {d['plain']} kernel {d['kernel']} | nearest gate "
                      f"{d['gate']} at {d['margin']:.3e} relative"
                      + ("" if d["margin"] <= MATCH_MARGIN_MAX else
                         " (a column a flipped row claims)" if d["explained"] else ""),
                      flush=True)
            diffs += found
        agree = n_same / max(n_rows, 1)
        if agree < MATCH_AGREE_MIN or not all(d["explained"] for d in diffs):
            fail(f"{entry}: rows agree {agree:.5f} over {n_rows} candidate rows, "
                 f"{sum(not d['explained'] for d in diffs)} differences not at a gate")
        print(f"[kernel 22] {entry}: {len(calls)} calls, {n_rows} candidate rows, "
              f"agree {agree:.6f}, {len(diffs)} differ", flush=True)
        return agree, diffs

    def match_row(entry, fn, plain, calls, key):
        """Kernel 22's table row: every recorded call checked, the call at
        `key` timed, its bound from the plain version's own counts (window
        tests, in-window pairs and features: Spy)."""
        agree, diffs = check_match(entry, fn, plain, calls)
        args, kw = calls[key]
        with Spy() as spy:
            out = plain(*args, **kw)
        (ik, _, _), cand = match_rows(entry, args, out)
        B, M = ik.shape
        N = args[0].kf_xy.shape[1] if entry != "fuse_match_lines" else args[0].kf_line_ep.shape[1]
        rc = int(cand.sum())
        per_row = {"fuse_match_points": 64, "fuse_match_lines": 56, "pool_match": 44,
                   "sim3_widen_match": 88}[entry]
        per_col = {"fuse_match_lines": 17, "pool_match": 9}.get(entry, 13)
        return dict(
            name=entry, max_abs_err=0.0, agree=agree, diffs=diffs, library_ms=None,
            **timings(lambda: fn(*args, **kw), lambda: plain(*args, **kw)),
            bytes=B * M * (4 + 9) + rc * per_row + B * N * per_col + spy.cols * 32 + B * 64,
            ops=spy.tests * OPS_WINDOW_PAIR + spy.pairs * OPS_DIST_PAIR
            + B * M * OPS_MATCH_ROW[entry],
            shape=f"{B} x {M} rows ({rc} with a candidate) x {N} features, {spy.tests} "
                  f"window tests, {spy.pairs} in-window pairs ({len(calls)} calls checked)")

    last = lambda calls: max(calls, key=lambda k: k[1])  # noqa: E731
    for entry, fn, plain in (
            ("fuse_match_points", lm.fuse_match_points, lm.fuse_match_points_plain),
            ("fuse_match_lines", lm.fuse_match_lines, lm.fuse_match_lines_plain)):
        # phase 2a's calls, the last one timed, and phase 2d's, loop
        # closing on and off
        calls = dict(calls_of(fuse_rec[entry], f"{entry} (phase 2a)"))
        key = last(calls)
        for run in ("on", "off"):
            calls.update({(f"2d {run}",) + k: v for k, v in calls_of(
                glue_rec[f"{entry} {run}"], f"{entry} (phase 2d, loop closing {run})").items()})
        rows.append(match_row(entry, fn, plain, calls, key))
    pool_calls = calls_of(glue_rec["pool_match"], "pool_match (phase 2d)")
    if ("pool", (8, 4, 4)) not in pool_calls or ("pool", (4, 4)) not in pool_calls:
        fail(f"pool_match: verify's and the loop fuse's calls not both recorded: "
             f"{sorted(pool_calls)}")
    rows.append(match_row("pool_match", loop_closing._project_pool_matches,
                          loop_closing._project_pool_matches_plain, pool_calls,
                          ("pool", (8, 4, 4))))
    widen_calls = calls_of(glue_rec["sim3_widen_match"], "sim3_widen_match (phase 2d)")
    rows.append(match_row("sim3_widen_match", loop_closing._sim3_widen_matches,
                          loop_closing._sim3_widen_matches_plain, widen_calls,
                          last(widen_calls)))
    print(f"[time] kernel 22 checked and timed in {time.time() - t0:.0f} s", flush=True)

    # kernel 23: every recorded merge walk and finish bit-equal
    def check_equal(name, fn, plain, calls):
        for key, (args, kw) in calls.items():
            out_k, out_p = fn(*args, **kw), plain(*args, **kw)
            for a, b in zip(out_k if isinstance(out_k, tuple) else (out_k,),
                            out_p if isinstance(out_p, tuple) else (out_p,)):
                if not torch.equal(a, b):
                    fail(f"{name} disagrees at {key}: {int((a != b).sum())} entries")

    def merge_row(name, fn, plain, calls, key):
        check_equal(name, fn, plain, calls)
        args, kw = calls[key]
        table, valid, redirect = plain(*args, **kw)
        K, F = table.shape
        P = valid.shape[0]
        D, M = args[-1].shape
        n_red = int((redirect != torch.arange(P, device=redirect.device)).sum())
        n_add = int(((args[0] < 0) & (table >= 0)).sum())
        return dict(name=name, max_abs_err=0.0, library_ms=None,
                    **timings(lambda: fn(*args, **kw), lambda: plain(*args, **kw)),
                    bytes=2 * K * F * 4 + P * (1 + 1 + 4 + 4) + D * M * 5, ops=0,
                    merges=dict(redirects=n_red, adds=n_add),
                    shape=f"{D} directions x {M} rows, [{K}, {F}] table, {P} landmarks, "
                          f"{n_red} redirects, {n_add} adds ({len(calls)} calls checked)")

    # phase 2a's merges (the last points walk timed) and every one of phase 2d's
    merge_calls = calls_of(fuse_rec["fuse_merge"], "fuse_merge (phase 2a)")
    pt_merges = {k: v for k, v in merge_calls.items()
                 if v[0][0].shape[1] == kf_shape[1]}
    merge_calls = {**merge_calls, **{("2d",) + k: v for k, v in calls_of(
        glue_rec["fuse_merge"], "fuse_merge (phase 2d)").items()}}
    rows.append(merge_row("fuse_merge", lm.fuse_merge, lm.fuse_merge_plain, merge_calls,
                          max(pt_merges, key=lambda k: k[1])))
    loop_calls = calls_of(glue_rec["loop_merge"], "loop_merge (phase 2d)")
    rows.append(merge_row("loop_merge", loop_closing.loop_merge, loop_closing.loop_merge_plain,
                          loop_calls, last(loop_calls)))
    fin_calls = {**calls_of(fuse_rec["fuse_finish"], "fuse_finish (phase 2a)"),
                 **{("loop",) + k: v for k, v in calls_of(glue_rec["fuse_finish"],
                                                          "fuse_finish (phase 2d)").items()}}
    check_equal("fuse_finish", matching.fuse_finish, matching.fuse_finish_plain, fin_calls)
    fkey = next(k for k in fin_calls if k[0] == "finish" and k[2]
                and k[1] == tuple(kf_shape))
    fargs, fkw = fin_calls[fkey]
    Kf, Ff = fargs[0].shape
    Pf = fargs[1].shape[0]
    rows.append(dict(name="fuse_finish", max_abs_err=0.0, library_ms=None,
                     **timings(lambda: matching.fuse_finish(*fargs, **fkw),
                               lambda: matching.fuse_finish_plain(*fargs, **fkw)),
                     bytes=2 * Kf * Ff * 4 + Pf * (4 + 1), ops=0,
                     shape=f"[{Kf}, {Ff}] table, {Pf} landmarks ({len(fin_calls)} shapes "
                           f"checked: {sorted(map(str, fin_calls))})"))

    # kernel 24: bit-equal; library yardstick the indicator products
    def indicators(st):
        Kc = st.kf_valid.shape[0]
        out = []
        for table, cap in ((st.kf_kp_mp, st.mp_valid.shape[0]),
                           (st.kf_line_ml, st.ml_valid.shape[0])):
            Mi = torch.zeros((Kc, cap + 1), dtype=torch.float32, device=table.device)
            Mi[torch.arange(Kc, device=table.device)[:, None].expand_as(table),
               torch.where(table >= 0, table, cap).long()] = 1.0
            out.append(Mi[:, :cap].contiguous())
        return out

    row_calls = calls_of(fuse_rec["covis_row"], "covis_row (phase 2a)")
    check_equal("covis_row", map_store.covisibility_weights, map_store.covisibility_weights_plain,
                row_calls)
    def live_bytes(st):
        """kf_valid and the valid keyframes' rows of both grids: what
        either function reads (a row of an invalid keyframe counts
        nothing)."""
        n_live = int(st.kf_valid.sum())
        return nbytes(st.kf_valid) + n_live * (st.kf_kp_mp.shape[1] + st.kf_line_ml.shape[1]) * 4

    (st_r, k_r), _ = row_calls[last(row_calls)]
    Mp, Ml = indicators(st_r)
    Kc = st_r.kf_valid.shape[0]
    rows.append(dict(
        name="covis_row", max_abs_err=0.0,
        **timings(lambda: map_store.covisibility_weights(st_r, k_r),
                  lambda: map_store.covisibility_weights_plain(st_r, k_r)),
        library_ms=device_ms(lambda: Mp @ Mp[k_r] + Ml @ Ml[k_r]),
        library_wall_ms=time_ms(lambda: Mp @ Mp[k_r] + Ml @ Ml[k_r]),
        library_shape="torch.matmul of the indicator matrices by keyframe k's row (equal "
                      "where no row repeats an id)",
        bytes=live_bytes(st_r) + Kc * 4, ops=0,
        shape=f"{tuple(st_r.kf_kp_mp.shape)} + {tuple(st_r.kf_line_ml.shape)} grids, keyframe "
              f"{k_r}, {int(st_r.kf_valid.sum())} valid keyframes ({len(row_calls)} calls "
              f"checked)"))
    # every phase 2d call checked, the last (the fullest map) timed
    mat_calls = calls_of(glue_rec["covis_matrix"], "covis_matrix (phase 2d)")
    check_equal("covis_matrix", map_store.covisibility_matrix,
                map_store.covisibility_matrix_plain, mat_calls)
    (st_cv,), _ = mat_calls[last(mat_calls)]
    Mp, Ml = indicators(st_cv)
    Kc = st_cv.kf_valid.shape[0]
    rows.append(dict(
        name="covis_matrix", max_abs_err=0.0,
        **timings(lambda: map_store.covisibility_matrix(st_cv),
                  lambda: map_store.covisibility_matrix_plain(st_cv)),
        library_ms=device_ms(lambda: Mp @ Mp.T + Ml @ Ml.T),
        library_wall_ms=time_ms(lambda: Mp @ Mp.T + Ml @ Ml.T),
        library_shape="torch.matmul of the [K, P] and [K, L] indicator matrices",
        bytes=live_bytes(st_cv) + Kc * Kc * 4, ops=0,
        shape=f"{tuple(st_cv.kf_kp_mp.shape)} + {tuple(st_cv.kf_line_ml.shape)} grids, "
              f"{int(st_cv.kf_valid.sum())} valid keyframes, call {last(mat_calls)[1]} of "
              f"{len(mat_calls)} (all checked)"))
    print(f"[time] kernels 23-24 checked and timed in {time.time() - t0:.0f} s", flush=True)

    # the functions around kernels 22-24, from the caller (CUDA events) and
    # on the device: the fuses, the loop fuse; the keyframe pipeline's
    # stages from the caller, each synchronized (keyframe_split)
    functions = {}
    for name, (mod, r) in {"fuse_projected_points": (lm, fuse_rec["fuse_projected_points"]),
                           "fuse_projected_lines": (lm, fuse_rec["fuse_projected_lines"]),
                           "_loop_fuse": (loop_closing, glue_rec["_loop_fuse"])}.items():
        key = max(calls_of(r, name), key=lambda k: k[-1] if isinstance(k[-1], int) else 0)
        args, kw = r.calls[key]
        fn = getattr(mod, name)
        functions[name] = {"calls": sum(r.n.values()), "timed_call": str(key),
                           "ms": device_ms(lambda: fn(*args, **kw), reps=5),
                           "wall_ms": time_ms(lambda: fn(*args, **kw), reps=5)}
        print(f"[function] {name}: {functions[name]}", flush=True)
    kfp = calls_of(fuse_rec["keyframe_pipeline"], "_keyframe_pipeline (phase 2a)")
    functions["keyframe_pipeline"] = keyframe_split(*kfp[last(kfp)])
    print(f"[function] keyframe pipeline split (ms from the caller): "
          f"{functions['keyframe_pipeline']}", flush=True)
    return rows, functions


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.config import CameraConfig, SLAMConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import (bow, extract, fast, hamming, lbd, lsd,
                                                       orb, pnp)
    from structure_slam_pointline_tpu_torch.optim import local_ba, pose_opt
    from structure_slam_pointline_tpu_torch.utils import fmath, linalg
    from structure_slam_pointline_tpu_torch.world import map_store
    from structure_slam_pointline_tpu_torch.models.system import SLAMSystem

    t_start = time.time()
    smi = smi_line()
    print(f"[setup] {smi}", flush=True)
    t0 = time.time()
    reports = kernels.build_all()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    print(f"[setup] kernel build seconds {time.time() - t0:.1f}", flush=True)
    for name in kernels.SOURCES:
        kernels.lib(name)

    # ---- phase 2: end to end on the bench scene ----
    cam = CameraConfig(fy=480.0)
    cfg = SLAMConfig(camera=cam)
    scene = synthetic.make_room_scene(n_points=350, n_lines=40, seed=0)
    poses = synthetic.circular_trajectory(10 + 6 * 100, radius=0.5)
    imgs = {}

    def frame(i):
        if i not in imgs:
            imgs[i] = synthetic.render(scene, poses[i], cam, noise=2.0, seed=i)
        return imgs[i]

    def support_key(img, *a):
        return ("lsd_support", tuple(img.shape), a[3] if len(a) > 3 else 1)

    def refine_key(img, packed, ax, ay, steps, *a):
        return ("lsd_refine", tuple(img.shape), ax.shape[0], steps)

    def select_key(score_raw, ks, **kw):
        return ("sel", tuple(ks), kw.get("cell"), kw.get("cell_cap"))

    rec = {
        "fast_nms": Recorder(fast, "fast_score_nms",
                             lambda img: ("fast", tuple(img.shape))),
        "orb_describe": Recorder(orb, "orient_and_describe",
                                 lambda im, xy: ("orb", tuple(im.shape), xy.shape[0])),
        "hamming_best2": Recorder(
            hamming, "masked_best2",
            lambda a, b, m: ("ham", tuple(a.shape), tuple(b.shape), tuple(m.shape))),
        "pose_lm": Recorder(pose_opt, "pose_optimize",
                            lambda *a: ("pose", a[1].shape[0], a[5].shape[0],
                                        a[11].pose_rounds, a[11].pose_iters)),
        "lsd_support": Recorder(lsd, "lsd_support", support_key),
        "lsd_refine": Recorder(lsd, "lsd_refine", refine_key),
        "lbd_describe": Recorder(lbd, "describe_lines",
                                 lambda img, ep, valid: ("lbd", tuple(img.shape), ep.shape[0])),
        "kp_select": Recorder(fast, "select_keypoints_levels", select_key),
        "null_vector4": Recorder(linalg, "null_vector_4",
                                 lambda A, **kw: ("null", tuple(A.shape))),
        "local_ba": Recorder(local_ba, "bundle_adjust",
                             lambda prob, *a, **kw: ("ba", int(prob.kf_valid.sum()))),
        "obs_bits": Recorder(map_store, "compute_obs_bits", lambda st: ("bits",)),
        "votes": Recorder(map_store, "votes_from_bits",
                          lambda rows, *a: ("votes", tuple(rows.shape))),
        "bow_transform": Recorder(bow, "transform",
                                  lambda voc, d, v: ("bow", tuple(d.shape))),
        "bow_query": Recorder(bow, "query_database",
                              lambda q, kb, *a, **kw: ("query", tuple(kb.shape))),
        "ransac_pnp": Recorder(pnp, "ransac_pnp",
                               lambda p3, uv, m, sets, *a, **kw: ("pnp", tuple(sets.shape),
                                                                  p3.shape[-2])),
    }
    from structure_slam_pointline_tpu_torch.models import local_mapping as lm
    from structure_slam_pointline_tpu_torch.models import pipeline
    from structure_slam_pointline_tpu_torch.ops import matching

    def finish_key(table, valid, redirect, clear_invalid):
        return ("finish", tuple(table.shape), clear_invalid)

    # kernels 22-24 on the keyframe path: every keyframe's fuse matches
    # recorded (kernel 22's agreement is counted over all of them), the
    # first merges, each finish shape, one covisibility row; the fuse
    # functions and the keyframe pipeline for their caller split
    fuse_rec = {
        "fuse_match_points": Recorder(lm, "fuse_match_points", first_calls("pts", 12)),
        "fuse_match_lines": Recorder(lm, "fuse_match_lines", first_calls("lns", 12)),
        "fuse_merge": Recorder(lm, "fuse_merge", first_calls("merge", 24)),
        "fuse_finish": Recorder(matching, "fuse_finish", finish_key),
        "covis_row": Recorder(map_store, "covisibility_weights", first_calls("row", 12)),
        "fuse_projected_points": Recorder(lm, "fuse_projected_points", first_calls("fuse", 12)),
        "fuse_projected_lines": Recorder(lm, "fuse_projected_lines", first_calls("fuse", 12)),
        "keyframe_pipeline": Recorder(pipeline, "_keyframe_pipeline", first_calls("kfp", 12)),
    }
    # kernels 25, 26 and kernel 22's tracking entries: each call of the
    # first frames recorded, then a sample
    from structure_slam_pointline_tpu_torch.ops import pyramid

    rec12 = {
        "pyramid": Recorder(pyramid, "build_blurred_pyramid", sampled_calls("pyr", 20, 25)),
        "lsd_merge": Recorder(lsd, "lsd_merge", sampled_calls("merge", 40, 25)),
        "lsd_octave_merge": Recorder(lsd, "lsd_octave_merge", sampled_calls("oct", 20, 25)),
        "track_match_points": Recorder(matching, "track_match_points",
                                       sampled_calls("pts", 40, 25)),
        "track_match_lines": Recorder(matching, "track_match_lines",
                                      sampled_calls("lns", 40, 25)),
    }
    # 2a: the main path, lines on, every wrapper's first call of each shape recorded
    for r in (*rec.values(), *fuse_rec.values(), *rec12.values()):
        r.__enter__()
    slam, e2e, counts = drive(cfg, N_TRACK, frame, poses, "lines")
    for r in (*rec.values(), *fuse_rec.values(), *rec12.values()):
        r.__exit__()
    zero = [k for k, v in counts.items() if v == 0 and k not in OFF_MAIN_PATH]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")
    if e2e["lines"] == 0 or e2e["live_lines"] == 0:
        fail(f"the line map stayed empty: {e2e['lines']} made, {e2e['live_lines']} live")
    # 2b: the points-only path, counted on its own
    _, e2e_points, counts_points = drive(SLAMConfig(camera=cam, use_lines=False),
                                         N_TRACK_POINTS, frame, poses, "points")
    zero = [k for k in POINT_KERNELS if counts_points[k] == 0]
    if zero:
        fail(f"kernels never launched on the points-only path: {zero}")
    # 2c: lost frames on the default configuration; kernels 13-15 recorded,
    # and the relocalization path's new Hamming and pose-LM shapes
    reloc_rec = [rec[k] for k in ("hamming_best2", "pose_lm", *RELOC_KERNELS)]
    for r in reloc_rec:
        r.__enter__()
    reloc_slam = SLAMSystem(cfg)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    e2e_reloc = run_relocalization(reloc_slam, cam, sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    counts_reloc = dict(kernels.COUNTS)
    for r in reloc_rec:
        r.__exit__()
    e2e_reloc["seconds"] = time.time() - t0
    print(f"[e2e relocalization] {e2e_reloc.get('seconds', 0):.1f} s | launches {counts_reloc}",
          flush=True)
    if "error" in e2e_reloc:
        fail(f"relocalization scenario: {e2e_reloc['error']}")
    checks = {
        f">= {RELOC_MIN_KF} keyframes before the yaw":
            e2e_reloc["keyframes_before_yaw"] >= RELOC_MIN_KF,
        "reference-keyframe rung fired": e2e_reloc["reloc_ref_kf"] >= 1,
        "PnP rung recovered a frame": e2e_reloc["reloc_success"] - e2e_reloc["reloc_ref_kf"] >= 1,
        "kernels 13-15 launched": all(counts_reloc[k] > 0 for k in RELOC_KERNELS),
        "noise frames lost": e2e_reloc["noise_tracked"] == 0,
        ">= 5 of the last 6 frames tracked": e2e_reloc["last6_tracked"] >= 5,
        f"ATE-Sim3 <= {RELOC_ATE_MAX}": e2e_reloc["ate_sim3"] <= RELOC_ATE_MAX,
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"relocalization scenario failed: {bad}")
    # relocalize(wide=True) once: phase 2c's final map, the first teleport
    # frame; it must recover the frame (the 0.75-cut call beside it)
    from structure_slam_pointline_tpu_torch.models import relocalization

    r_imgs, _, r_seg = relocalization_scenario(cam)
    r_frame = reloc_slam.build_frame(r_imgs[r_seg["teleport"][0]])
    wide_out = {}
    for wide in (False, True):
        torch.cuda.synchronize()
        t0 = time.time()
        T_w = relocalization.relocalize(reloc_slam.map, reloc_slam.cur.n_kf, r_frame,
                                        reloc_slam._get_loop_closer(), reloc_slam.intr, cfg,
                                        np.random.default_rng(7), wide=wide)
        torch.cuda.synchronize()
        wide_out["wide" if wide else "cut"] = {"recovered": T_w is not None,
                                               "ms": (time.time() - t0) * 1e3, "T": T_w}
    Tw, Tc = wide_out["wide"].pop("T"), wide_out["cut"].pop("T")
    if Tw is None:
        fail("relocalize(wide=True) did not recover the teleport frame")
    wide_out["pose_diff_wide_vs_cut"] = (None if Tc is None else
                                         float(np.abs(np.asarray(Tw) - np.asarray(Tc)).max()))
    e2e_reloc["wide"] = wide_out
    print(f"[reloc] relocalize on the first teleport frame: {wide_out}", flush=True)
    # the same frames through one track_sequence call after the bootstrap:
    # reported, not judged (the reference-keyframe rung then starts from
    # the bootstrap's pose; see run_relocalization)
    one = run_relocalization(SLAMSystem(cfg), cam, one_call=True)
    e2e_reloc["one_call"] = {k: one.get(k) for k in (
        "tracked", "frames", "reloc_ref_kf", "reloc_success", "noise_tracked",
        "last6_tracked", "ate_sim3", "ok_flags", "error")}
    # 2d: the loop scenario, loop closing off, then on (the counters zeroed
    # just before and read just after; the first call of every new shape
    # recorded for phase 3)
    from structure_slam_pointline_tpu_torch.models import loop_closing
    from structure_slam_pointline_tpu_torch.optim import pose_graph, sim3_solver

    loop_imgs, loop_poses = loop_scenario(cam)
    # kernel 22's fuse matches of both runs recorded, each call
    match_rec = {f"{entry} {run}": Recorder(lm, entry, every_call(f"{entry[11:]} {run}"))
                 for run in ("off", "on") for entry in ("fuse_match_points", "fuse_match_lines")}
    for r in (match_rec["fuse_match_points off"], match_rec["fuse_match_lines off"]):
        r.__enter__()
    loop_off = run_loop(cam, loop_imgs, loop_poses, False, sync=torch.cuda.synchronize)
    for r in (match_rec["fuse_match_points off"], match_rec["fuse_match_lines off"]):
        r.__exit__()
    loop_rec = {
        "ransac_sim3": Recorder(sim3_solver, "ransac_sim3",
                                lambda p1, p2, m, sets, *a, **k: ("sim3", tuple(sets.shape),
                                                                  p1.shape[0])),
        "sim3_pair": Recorder(pose_graph, "optimize_sim3_pair",
                              lambda S, X1, *a, **k: ("pair", X1.shape[0])),
        "pose_graph": Recorder(pose_graph, "optimize_pose_graph",
                               lambda prob, *a, **k: ("pg", prob.S_cw.shape[0],
                                                      prob.edge_i.shape[0])),
        "local_ba": Recorder(local_ba, "bundle_adjust",
                             lambda prob, *a, **k: ("ba", prob.edge_mp.shape[0])),
        "bow_query": Recorder(bow, "query_database",
                              lambda q, kb, *a, **kw: ("query", tuple(kb.shape))),
    }
    # kernels 22-24 on the loop-closing path: verify's pool match (B = 1)
    # and the loop fuse's (B = 8), the Sim(3) widenings, the loop merges,
    # the loop fuse's finish, every covisibility matrix; every local merge
    # walk and fuse match; the loop fuse for its caller time
    glue_rec = {
        "pool_match": Recorder(loop_closing, "_project_pool_matches",
                               lambda st, kf, M, *a, **k: ("pool", tuple(M.shape))),
        "sim3_widen_match": Recorder(loop_closing, "_sim3_widen_matches",
                                     first_calls("widen", 4)),
        "loop_merge": Recorder(loop_closing, "loop_merge", first_calls("loop", 4)),
        "fuse_finish": Recorder(matching, "fuse_finish", finish_key),
        "covis_matrix": Recorder(map_store, "covisibility_matrix", every_call("covis")),
        "_loop_fuse": Recorder(loop_closing, "_loop_fuse", lambda *a, **k: ("fuse",)),
        "fuse_merge": Recorder(lm, "fuse_merge", every_call("merge")),
        "fuse_match_points on": match_rec["fuse_match_points on"],
        "fuse_match_lines on": match_rec["fuse_match_lines on"],
    }
    for r in (*loop_rec.values(), *glue_rec.values()):
        r.__enter__()
    torch.cuda.synchronize()
    kernels.reset_counts()
    loop_on = run_loop(cam, loop_imgs, loop_poses, True, sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    counts_loop = dict(kernels.COUNTS)
    for r in (*loop_rec.values(), *glue_rec.values()):
        r.__exit__()
    glue_rec.update({k: r for k, r in match_rec.items() if k.endswith(" off")})
    print(f"[e2e loop] launches {counts_loop}", flush=True)
    loop_slam = loop_on.pop("slam", None)
    loop_off.pop("slam", None)
    for run in (loop_off, loop_on):
        if "error" in run:
            fail(f"loop scenario (loop closing {run.get('loop_closing')}): {run['error']}")
    checks = {
        f">= {LOOP_MIN_TRACKED:.0%} of the frames tracked, both runs":
            all(r["tracked"] >= LOOP_MIN_TRACKED * r["frames"] for r in (loop_off, loop_on)),
        "a loop corrected": loop_on["loop_corrected"] >= 1,
        f"ATE-Sim3 <= {LOOP_ATE_MAX}, both runs":
            all(r["ate_sim3"] <= LOOP_ATE_MAX for r in (loop_off, loop_on)),
        f">= {LOOP_MIN_LINES} map lines": loop_on["n_ml"] >= LOOP_MIN_LINES,
        "kernels 16-18 and 22-24 launched": all(counts_loop[k] > 0 for k in LOOP_KERNELS),
        "kernel 12 ran at 64 keyframes": loop_on["gba_windows"] >= 1
        and ("ba", 64) in loop_rec["local_ba"].calls,
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"loop scenario failed: {bad}")
    e2e_loop = {"off": loop_off, "on": loop_on,
                "ate_on_minus_off": loop_on["ate_sim3"] - loop_off["ate_sim3"],
                "reference": LOOP_REFERENCE}
    print(f"[loop] ATE-Sim3 on - off {e2e_loop['ate_on_minus_off']:+.5f} (reported, not "
          f"judged) | the reference's per-frame path: {LOOP_REFERENCE}", flush=True)
    print(f"[time] phase 2d done at {time.time() - t_start:.0f} s", flush=True)
    # 2e: the dataset path, runs A and B through the port's driver and the
    # native loader; the counters zeroed just before run A, read after run B
    from structure_slam_pointline_tpu_torch.config import KeyframeConfig, MapConfig
    from structure_slam_pointline_tpu_torch.io import native_loader
    from structure_slam_pointline_tpu_torch.world import compact, serialize

    if native_loader.get_lib() is None:
        fail("the native loader (native/libsspl_io.so, make -C native) is not available")
    n_a = len(poses)
    t0 = time.time()
    write_tum_dir(os.path.join(DATASET_DIR, "bench"), frame, n_a)
    cfg_b = SLAMConfig(camera=cam, map=MapConfig(max_keyframes=16, max_points=2048,
                                                 max_lines=128),
                       keyframe=KeyframeConfig(max_frames=3))
    scene_b = synthetic.make_room_scene(n_points=300, n_lines=12, seed=3)
    poses_b = synthetic.circular_trajectory(RUN_B_FRAMES, radius=0.5)
    imgs_b = synthetic.render_sequence(scene_b, poses_b, cam, noise=2.0)
    write_tum_dir(os.path.join(DATASET_DIR, "tiny"), lambda j: imgs_b[j], RUN_B_FRAMES)
    print(f"[dataset] {n_a} + {RUN_B_FRAMES} frames rendered and written as PNG in "
          f"{time.time() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    kernels.reset_counts()
    run_a = run_dataset(cfg, os.path.join(DATASET_DIR, "bench"), poses, "A",
                        sync=torch.cuda.synchronize)
    run_b = run_dataset(cfg_b, os.path.join(DATASET_DIR, "tiny"), poses_b, "B",
                        sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    counts_2e = dict(kernels.COUNTS)
    print(f"[e2e dataset] launches {counts_2e}", flush=True)
    ea, eb = run_a["e2e"], run_b["e2e"]
    checks = {
        "native decoder in both runs": ea["decoder"] == eb["decoder"] == "native",
        f"run A: bootstrap within {INIT_MAX} frames":
            ea["init_frame"] is not None and ea["init_frame"] < INIT_MAX,
        f"run A: at most {LOST_AFTER_INIT_MAX} frames lost after it":
            ea["lost_after_init"] <= LOST_AFTER_INIT_MAX,
        f"run A: ATE-Sim3 < {ATE_MAX} from MonoTrajectory.txt": ea["ate_sim3"] < ATE_MAX,
        "run A: keyframe rows = live keyframes": ea["keyframe_rows"] == ea["live_keyframes"],
        f"run B: >= {RUN_B_MIN_TRACKED} frames tracked": eb["tracked"] >= RUN_B_MIN_TRACKED,
        f"run B: ATE-Sim3 < {ATE_MAX}": eb["ate_sim3"] < ATE_MAX,
        "run B: compact_keyframes >= 1": eb["compact_keyframes"] >= 1,
        "run B: cursors within the pools": eb["n_kf"] <= 16 and eb["n_mp"] <= 2048
        and eb["n_ml"] <= 128,
        "kernel 19 launched": counts_2e["compact"] > 0,
        "kernels 1-12 launched": all(counts_2e[k] > 0 for k in KERNELS if k not in
                                     OFF_MAIN_PATH),
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"dataset path failed: {bad}")
    # the map through save_map / load_map on the card: bit-equal, cursors equal
    slam_a = run_a["slam"]
    t0 = time.time()
    path = os.path.join(DATASET_DIR, "map.npz")
    serialize.save_map(path, slam_a.map, slam_a.cur)
    st2, cur2 = serialize.load_map(path, "cuda")
    for f in st2._fields:
        a, b = getattr(slam_a.map, f), getattr(st2, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.device != b.device or not torch.equal(a, b):
            fail(f"save_map / load_map: field {f} differs")
    if (cur2.n_kf, cur2.n_mp, cur2.n_ml) != (slam_a.cur.n_kf, slam_a.cur.n_mp, slam_a.cur.n_ml):
        fail(f"save_map / load_map: cursors {cur2} != {slam_a.cur}")
    e2e_dataset = {"A": ea, "B": eb, "fps_in_memory_2a": e2e["fps"],
                   "save_load_s": time.time() - t0,
                   "map_npz_bytes": os.path.getsize(path)}
    print(f"[dataset] run A through the loader: {ea['fps_track']:.2f} fps in track() "
          f"({ea['fps_wall']:.2f} wall, bootstrap included) against phase 2a's in-memory "
          f"{e2e['fps']:.2f} | save / load of run A's map: bit-equal, "
          f"{e2e_dataset['map_npz_bytes']} bytes, {e2e_dataset['save_load_s']:.1f} s", flush=True)
    # 2f: the half-resolution line-support configuration; kernels 5, 6 and
    # 11's new shapes recorded for phase 3
    from structure_slam_pointline_tpu_torch.config import FrontendConfig

    cfg_ds2 = SLAMConfig(camera=cam, frontend=FrontendConfig(line_support_downsample=2))
    rec_ds2 = {"lsd_support": Recorder(lsd, "lsd_support", support_key),
               "lsd_refine": Recorder(lsd, "lsd_refine", refine_key),
               "kp_select": Recorder(fast, "select_keypoints_levels", select_key)}
    for r in rec_ds2.values():
        r.__enter__()
    _, e2e_ds2, counts_ds2 = drive(cfg_ds2, N_TRACK, frame, poses, "lines ds=2")
    for r in rec_ds2.values():
        r.__exit__()
    zero = [k for k, v in counts_ds2.items() if v == 0 and k not in OFF_MAIN_PATH]
    if zero:
        fail(f"kernels never launched at line_support_downsample = 2: {zero}")
    if e2e_ds2["lines"] == 0 or e2e_ds2["live_lines"] == 0:
        fail(f"ds = 2: the line map stayed empty: {e2e_ds2['lines']} made, "
             f"{e2e_ds2['live_lines']} live")
    print(f"[time] phase 2f done at {time.time() - t_start:.0f} s", flush=True)
    # 2g: the sharded path. One process joins an NCCL group of one rank;
    # the main path's BA runs over 4 landmark shards of the card
    import torch.distributed as tdist

    from structure_slam_pointline_tpu_torch.optim import global_ba
    from structure_slam_pointline_tpu_torch.parallel import batch_frontend, distributed

    rank = distributed.initialize_multihost(f"localhost:{free_port()}", 1, 0)
    mesh = distributed.global_edge_mesh(MESH_SHARDS)
    ones = mesh.psum([torch.ones(1, device=mesh.device) for _ in mesh.local_shards])
    tdist.all_reduce(ones, group=mesh.group)
    print(f"[mesh] rank {rank}, {mesh}, backend {tdist.get_backend()}, psum of ones "
          f"{float(ones)}", flush=True)
    if rank != 0 or mesh.size != MESH_SHARDS or float(ones) != MESH_SHARDS:
        fail(f"the mesh: rank {rank}, size {mesh.size}, psum of ones {float(ones)}")
    shard_rec = Recorder(local_ba, "bundle_adjust_sharded",
                         lambda prob, *a, **k: ("shard", prob.edge_mp.shape[0],
                                                int(prob.kf_valid.sum())))
    shard_rec.__enter__()
    slam_mesh, e2e_mesh, counts_mesh = drive(cfg, N_MESH, frame, poses, "mesh", mesh=mesh)
    shard_rec.__exit__()
    last = e2e_mesh["init_frame"] + N_MESH
    traj_m, traj_a = slam_mesh.trajectory(), slam.trajectory()
    ids_m, ids_a = sorted(traj_m), sorted(k for k in traj_a if k <= last)
    est_m = np.stack([np.linalg.inv(traj_m[k]) for k in ids_m])
    est_a = np.stack([np.linalg.inv(traj_a[k]) for k in ids_a])
    ate_a = synthetic.ate_rmse(est_a, poses[ids_a])
    common = sorted(set(ids_m) & set(ids_a))
    dc = np.linalg.norm(est_m[[ids_m.index(k) for k in common]][:, :3, 3]
                        - est_a[[ids_a.index(k) for k in common]][:, :3, 3], axis=1)
    e2e_mesh.update(shards=MESH_SHARDS, ate_sim3_unsharded=ate_a,
                    ate_diff=abs(e2e_mesh["ate_sim3"] - ate_a), common_frames=len(common),
                    max_centre_diff=float(dc.max()) if len(dc) else None,
                    sharded_ba_calls=sum(shard_rec.n.values()))
    print(f"[mesh] the main path on {MESH_SHARDS} shards: ATE-Sim3 {e2e_mesh['ate_sim3']:.5f} "
          f"against {ate_a:.5f} unsharded (phase 2a, frames <= {last}), {len(common)} common "
          f"frames, camera centres within {e2e_mesh['max_centre_diff']:.3e}, "
          f"{e2e_mesh['sharded_ba_calls']} sharded BA calls", flush=True)
    checks = {
        "kernel 12's sharded form launched": counts_mesh["local_ba_shard"] > 0,
        "kernels 1-12 launched": all(counts_mesh[k] > 0 for k in KERNELS
                                     if k not in OFF_MAIN_PATH),
        f"ATE-Sim3 <= {ATE_MAX}": e2e_mesh["ate_sim3"] <= ATE_MAX,
        "ATE-Sim3 within 1e-3 of the unsharded run": e2e_mesh["ate_diff"] < 1e-3,
        ">= 90% of the frames in common": len(common) >= 0.9 * len(ids_a),
        "camera centres within 5e-2": len(dc) > 0 and dc.max() < 5e-2,
    }
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"the main path on a mesh failed: {bad}")
    # global BA on phase 2d's final map, sharded against unsharded
    if loop_slam is None:
        fail("phase 2d left no map")
    loop_slam.sync_cursors()
    st_l, nkf_l = loop_slam.map, loop_slam.cur.n_kf

    def gba(m):
        return global_ba.global_bundle_adjust(st_l, nkf_l, loop_slam.intr, loop_slam.cfg,
                                              mesh=m)

    g_one = gba(None)
    shard_rec.__enter__()
    torch.cuda.synchronize()
    kernels.reset_counts()
    g_four = gba(mesh)
    torch.cuda.synchronize()
    counts_gba = dict(kernels.COUNTS)
    shard_rec.__exit__()
    kv, mv = st_l.kf_valid, st_l.mp_valid
    gba_err = max((g_one.kf_T_cw[kv] - g_four.kf_T_cw[kv]).abs().max().item(),
                  (g_one.mp_xyz[mv] - g_four.mp_xyz[mv]).abs().max().item(),
                  (g_one.ml_endpoints[st_l.ml_valid]
                   - g_four.ml_endpoints[st_l.ml_valid]).abs().max().item())
    moved = (g_one.kf_T_cw[kv] - st_l.kf_T_cw[kv]).abs().max().item()
    gba_mesh = {"keyframes": nkf_l, "max_abs_err": gba_err, "moved": moved,
                "launches_sharded": counts_gba["local_ba_shard"],
                "unsharded": {"ms": device_ms(lambda: gba(None), reps=3, expect="solve_kernel"),
                              "wall_ms": time_ms(lambda: gba(None), reps=3, warmup=1)},
                "sharded": {"ms": device_ms(lambda: gba(mesh), reps=3, expect="solve_kernel"),
                            "wall_ms": time_ms(lambda: gba(mesh), reps=3, warmup=1)}}
    print(f"[mesh] global BA on phase 2d's map ({nkf_l} keyframes): sharded against unsharded "
          f"within {gba_err:.3e} (moved {moved:.3e}) | device {gba_mesh['sharded']['ms']:.2f} "
          f"/ {gba_mesh['unsharded']['ms']:.2f} ms, caller {gba_mesh['sharded']['wall_ms']:.2f} "
          f"/ {gba_mesh['unsharded']['wall_ms']:.2f} ms (sharded / unsharded)", flush=True)
    if counts_gba["local_ba_shard"] == 0 or gba_err > 1e-3:
        fail(f"sharded global BA: launches {counts_gba['local_ba_shard']}, err {gba_err:.2e}")
    # the data-parallel frontend: 8 bench frames over 4 frame shards, equal
    # to the single-frame frontend on the card
    from structure_slam_pointline_tpu_torch.parallel.batch_frontend import make_batch_extractor

    fe = cfg.frontend
    bimgs = torch.from_numpy(np.stack([frame(j) for j in BATCH_FRAMES])).cuda()
    extractor = make_batch_extractor(batch_frontend.frame_mesh(MESH_SHARDS), fe)
    batch_rec = {
        "fast_nms_batch": Recorder(fast, "fast_score_nms",
                                   lambda im: ("fast", tuple(im.shape))),
        "kp_select_batch": Recorder(fast, "select_keypoints_levels",
                                    lambda sr, ks, **kw: ("sel", tuple(sr[0][0].shape),
                                                          tuple(ks))),
        "orb_describe_batch": Recorder(orb, "orient_and_describe",
                                       lambda im, xy: ("orb", tuple(im.shape), xy.shape[1])),
    }
    for r in batch_rec.values():
        r.__enter__()
    torch.cuda.synchronize()
    kernels.reset_counts()
    kb, lb, wb = extractor(bimgs)
    torch.cuda.synchronize()
    counts_batch = dict(kernels.COUNTS)
    for r in batch_rec.values():
        r.__exit__()

    def single(img):
        ln = lsd.detect_lines(img, fe)
        return extract.extract_orb(img, fe), ln, lbd.describe_lines(
            img, ln.endpoints.contiguous(), ln.valid)[0]

    for b in range(len(BATCH_FRAMES)):
        k1, l1, w1 = single(bimgs[b])
        bad = [f for f in k1._fields if not torch.equal(getattr(kb, f)[b], getattr(k1, f))]
        bad += [f"line {f}" for f in l1._fields if not torch.equal(getattr(lb, f)[b],
                                                                   getattr(l1, f))]
        if not torch.equal(wb[b], w1):
            bad.append("LBD words")
        if bad:
            fail(f"the batched frontend differs from the single-frame one on frame "
                 f"{BATCH_FRAMES[b]}: {bad}")
    batch_out = {
        "frames": len(BATCH_FRAMES), "shards": MESH_SHARDS,
        "keypoints": int(kb.valid.sum()), "lines": int(lb.valid.sum()),
        "wall_ms": time_ms(lambda: extractor(bimgs), reps=5),
        "single_frame_wall_ms": time_ms(lambda: [single(im) for im in bimgs], reps=5)}
    print(f"[batch] {batch_out['frames']} frames on {MESH_SHARDS} frame shards equal to the "
          f"single-frame frontend ({batch_out['keypoints']} keypoints, {batch_out['lines']} "
          f"lines) | caller {batch_out['wall_ms']:.2f} ms against "
          f"{batch_out['single_frame_wall_ms']:.2f} ms frame by frame | launches "
          f"{ {k: counts_batch[k] for k in BATCH_KERNELS + ('pyramid', 'lsd_merge')} }",
          flush=True)
    if not all(counts_batch[k] > 0 for k in BATCH_KERNELS + ("pyramid", "lsd_merge")):
        fail(f"the batch entries, kernel 25 or kernel 26 never launched: {counts_batch}")
    print(f"[time] phase 2 done at {time.time() - t_start:.0f} s", flush=True)
    i = e2e["init_frame"] + 1

    # ---- phase 3: kernels against their plain versions ----
    rows = []
    # FAST: all levels of one frame
    fast_calls = [v[0] for k, v in rec["fast_nms"].calls.items()]
    fast_err = 0.0
    for (img,) in fast_calls:
        raw_k, nms_k = fast.fast_score_nms(img)
        raw_p, nms_p = fast.fast_score_nms_plain(img)
        if not (torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)):
            fail(f"fast_nms disagrees at {tuple(img.shape)}: raw "
                 f"{int((raw_k != raw_p).sum())} nms {int((nms_k != nms_p).sum())}")
        fast_err = max(fast_err, (raw_k - raw_p).abs().max().item(),
                       (nms_k - nms_p).abs().max().item())
    px = sum(im.numel() for (im,) in fast_calls)
    rows.append(dict(
        name="fast_nms", max_abs_err=fast_err,
        **timings(lambda: [fast.fast_score_nms(im) for (im,) in fast_calls],
                  lambda: [fast.fast_score_nms_plain(im) for (im,) in fast_calls]),
        bytes=px * (2 + 4 + 4), ops=px * 320, library_ms=None,
        shape=f"{len(fast_calls)} levels, {px} px"))

    orb_calls = [v[0] for k, v in sorted(rec["orb_describe"].calls.items(),
                                         key=lambda kv: kv[0][2])]
    worst_desc, worst_ang = 1.0, 0.0
    for im, xy in orb_calls:
        ak, dk = orb.orient_and_describe(im, xy)
        ap, dp = orb.orient_and_describe_plain(im, xy)
        eq = (dk == dp).all(1).float().mean().item() if xy.shape[0] else 1.0
        worst_desc = min(worst_desc, eq)
        worst_ang = max(worst_ang, (ak - ap).abs().max().item() if xy.shape[0] else 0.0)
    if worst_desc < 0.995 or worst_ang > 1e-4:
        fail(f"orb_describe disagrees: descriptors equal {worst_desc:.4f}, "
             f"angle err {worst_ang:.2e}")
    run_orb = [c for c in orb_calls if c[1].shape[0] in
               set(extract.level_budgets(cfg.frontend.n_keypoints, 8, 1.2))]
    nkp = sum(c[1].shape[0] for c in run_orb)
    rows.append(dict(
        name="orb_describe", max_abs_err=worst_ang,
        **timings(lambda: [orb.orient_and_describe(im, xy) for im, xy in run_orb],
                  lambda: [orb.orient_and_describe_plain(im, xy) for im, xy in run_orb]),
        bytes=sum(im.numel() * 2 + xy.shape[0] * (8 + 4 + 32) for im, xy in run_orb)
        + 64 * 256 * 4, ops=nkp * 11000, library_ms=None,
        shape=f"{len(run_orb)} levels, {nkp} keypoints"))

    ham_calls = rec["hamming_best2"].calls
    ham_err = 0
    for key, (args, _) in ham_calls.items():
        out_k = hamming.masked_best2(*args)
        out_p = hamming.masked_best2_plain(*args)
        for a, b in zip(out_k, out_p):
            if not torch.equal(a, b):
                fail(f"hamming_best2 disagrees at {key}: {int((a != b).sum())} rows")
            if a.numel():
                ham_err = max(ham_err, int((a - b).abs().max()))
    # the largest call (the keyframe searches; tracking runs kernel 22's
    # entries since the glue was ported)
    a, b, m = ham_calls[max(ham_calls, key=lambda k: int(np.prod(k[3])))][0]
    M, N = m.shape[-2:]
    M *= int(np.prod(m.shape[:-2]))
    rows.append(dict(
        name="hamming_best2", max_abs_err=float(ham_err),
        **timings(lambda: hamming.masked_best2(a, b, m),
                  lambda: hamming.masked_best2_plain(a, b, m)),
        bytes=M * 32 + N * 32 + M * N + 16 * M, ops=27 * M * N, library_ms=None,
        shape=f"{M}x{N} (+{len(ham_calls) - 1} other shapes checked)"))

    pose_calls = rec["pose_lm"].calls
    worst_t, worst_in = 0.0, 1.0
    for key, (args, _) in pose_calls.items():
        rk = pose_opt.pose_optimize(*args)
        rp = pose_opt.pose_optimize_plain(*args)
        worst_t = max(worst_t, (rk.T_cw - rp.T_cw).abs().max().item())
        inl = torch.cat([rk.point_inliers == rp.point_inliers,
                         rk.line_inliers == rp.line_inliers]).float().mean().item()
        worst_in = min(worst_in, inl)
        n_masks = int(rk.point_inliers.sum()) + int(rk.line_inliers.sum())
        if rk.n_inliers.dtype != torch.int32 or int(rk.n_inliers) != n_masks:
            fail(f"pose_lm at {key}: n_inliers {int(rk.n_inliers)}, the masks sum to {n_masks}")
    print(f"[check] pose_lm: {len(pose_calls)} calls, pose err {worst_t:.2e}, inliers equal "
          f"{worst_in:.4f}, n_inliers = the masks' sum on every call", flush=True)
    if worst_t > 1e-4 or worst_in < 0.995:
        fail(f"pose_lm disagrees: pose err {worst_t:.2e}, inliers equal {worst_in:.4f}")
    key = max(pose_calls, key=lambda k: k[3] * k[4])
    args = pose_calls[key][0]
    n_pt, n_ln, rounds, iters = key[1], key[2], key[3], key[4]
    active = int(args[3].sum()) + 2 * int(args[8].sum())
    passes = rounds * (iters + 1) + 1
    rows.append(dict(
        name="pose_lm", max_abs_err=worst_t,
        **timings(lambda: pose_opt.pose_optimize(*args),
                  lambda: pose_opt.pose_optimize_plain(*args)),
        bytes=(n_pt + 2 * n_ln) * 12 + n_pt * (8 + 1 + 4) + n_ln * (12 + 1 + 4) + 64,
        ops=passes * active * 170, library_ms=None,
        shape=f"N={n_pt} M={n_ln} {rounds}x{iters}, {active} active rows"))

    # LSD dense pass: both octaves of one frame, exactly equal
    sup_calls = [v[0] for _, v in sorted(rec["lsd_support"].calls.items(),
                                         key=lambda kv: -kv[0][1][0])]
    px = weak = scored = 0
    for args in sup_calls:
        bk, pk = lsd.lsd_support(*args)
        bp, pp = lsd.lsd_support_plain(*args)
        if not (torch.equal(bk, bp) and torch.equal(pk, pp)):
            fail(f"lsd_support disagrees at {tuple(args[0].shape)}: score "
                 f"{int((bk != bp).sum())} px, plane {int((pk != pp).sum())} px")
        px += args[0].numel()
        weak += lsd_weak_px(*args)
        scored += int((bp > 0).sum())
    rows.append(dict(
        name="lsd_support", max_abs_err=0.0,
        **timings(lambda: [lsd.lsd_support(*a) for a in sup_calls],
                  lambda: [lsd.lsd_support_plain(*a) for a in sup_calls]),
        bytes=px * (4 + 4 + 4),
        ops=px * OPS_SUPPORT_PX + weak * OPS_GATES_WEAK + scored * OPS_SUPPORT_SCORED,
        library_ms=None,
        shape=f"{len(sup_calls)} octaves, {px} px, {weak} weak, {scored} scored"))

    # LSD refinement: every octave's valid anchors (the selection redone on
    # the same frame's score map), all seven outputs bit-equal
    ref_calls = [v[0] for _, v in sorted(rec["lsd_refine"].calls.items(),
                                         key=lambda kv: -kv[0][1][0])]
    ref_differ, ref_err = 0, 0.0
    samples = 0
    for args, sup_args in zip(ref_calls, sup_calls):
        K, steps, iters = args[2].shape[0], args[4], args[5]
        axy, _, avalid = fast.select_keypoints(lsd.lsd_support_plain(*sup_args)[0], k=K,
                                               cell=16, cell_cap=1, threshold=1.0,
                                               min_threshold=1.0, border=4)
        if not (torch.equal(axy[:, 0], args[2]) and torch.equal(axy[:, 1], args[3])):
            fail(f"lsd_refine: recorded anchors at {tuple(args[0].shape)} are not the "
                 "recorded support call's")
        out_k = lsd.lsd_refine(*args)[avalid]
        out_p = lsd.lsd_refine_plain(*args)[avalid]
        ref_differ += int((out_k != out_p).any(1).sum())
        ref_err = max(ref_err, (out_k - out_p).abs().max().item())
        samples += K * (iters * steps + 2 * steps)
    print(f"[check] lsd_refine: {len(ref_calls)} calls, {ref_differ} valid anchors not "
          f"bit-equal, max err {ref_err:.3e}", flush=True)
    if ref_differ:
        fail(f"lsd_refine disagrees on {ref_differ} valid anchors (max err {ref_err:.3e})")
    n_anchor = sum(a[2].shape[0] for a in ref_calls)
    rows.append(dict(
        name="lsd_refine", max_abs_err=ref_err,
        **timings(lambda: [lsd.lsd_refine(*a) for a in ref_calls],
                  lambda: [lsd.lsd_refine_plain(*a) for a in ref_calls]),
        bytes=samples * 4 + n_anchor * (8 + 16 * 4 + 7 * 4),
        ops=samples * OPS_REFINE_SAMPLE, library_ms=None,
        shape=f"{len(ref_calls)} octaves, {n_anchor} anchors, {samples} samples"))

    # phase 2f's shapes: kernel 5 at the half shape (both octaves of one
    # frame, exactly equal, timed as its own row), kernel 6 on half-pixel
    # anchors, kernel 11 at 8 px cells
    sup2_calls = [v[0] for k, v in sorted(rec_ds2["lsd_support"].calls.items(),
                                          key=lambda kv: -kv[0][1][0]) if k[2] == 2]
    if len(sup2_calls) != 2:
        fail(f"phase 2f: support shapes {sorted(rec_ds2['lsd_support'].calls)}")
    px_full = px_half = weak = scored = 0
    for args in sup2_calls:
        bk, pk = lsd.lsd_support(*args)
        bp, pp = lsd.lsd_support_plain(*args)
        if not (torch.equal(bk, bp) and torch.equal(pk, pp)):
            fail(f"lsd_support (ds = 2) disagrees at {tuple(args[0].shape)}: score "
                 f"{int((bk != bp).sum())} px, plane {int((pk != pp).sum())} px")
        px_full += args[0].numel()
        px_half += bp.numel()
        weak += lsd_weak_px(*args)
        scored += int((bp > 0).sum())
    rows.append(dict(
        name="lsd_support_half", max_abs_err=0.0,
        **timings(lambda: [lsd.lsd_support(*a) for a in sup2_calls],
                  lambda: [lsd.lsd_support_plain(*a) for a in sup2_calls]),
        bytes=px_full * (4 + 4) + px_half * 4,
        ops=(px_full * OPS_SUPPORT_PX + px_half * OPS_HALF_PX + weak * OPS_HALF_WEAK
             + scored * OPS_SUPPORT_SCORED),
        library_ms=None, shape=f"ds = 2: {len(sup2_calls)} octaves, {px_full} px, support on "
                               f"{px_half} half-resolution px, {weak} weak, {scored} scored"))
    k5 = next(r for r in rows if r["name"] == "lsd_support")
    print(f"[kernel 5] per frame (both octaves): device {k5['ms']:.4f} ms at full shape "
          f"(phase 2a), {rows[-1]['ms']:.4f} ms at the half shape (phase 2f); caller "
          f"{k5['wall_ms']:.4f} / {rows[-1]['wall_ms']:.4f} ms", flush=True)
    ref2_calls = [v[0] for _, v in sorted(rec_ds2["lsd_refine"].calls.items(),
                                          key=lambda kv: -kv[0][1][0])]
    differ2, err2 = 0, 0.0
    for args, sup_args in zip(ref2_calls, sup2_calls):
        axy, _, avalid = fast.select_keypoints(lsd.lsd_support_plain(*sup_args)[0],
                                               k=args[2].shape[0], cell=8, cell_cap=1,
                                               threshold=1.0, min_threshold=1.0, border=2)
        axy = axy * 2 + 0.5
        if not (torch.equal(axy[:, 0], args[2]) and torch.equal(axy[:, 1], args[3])):
            fail(f"lsd_refine (ds = 2): recorded anchors at {tuple(args[0].shape)} are not "
                 "the recorded support call's")
        if not torch.equal(torch.frac(args[2]), torch.full_like(args[2], 0.5)):
            fail("lsd_refine (ds = 2): anchors off the half-pixel centres")
        out_k = lsd.lsd_refine(*args)[avalid]
        out_p = lsd.lsd_refine_plain(*args)[avalid]
        differ2 += int((out_k != out_p).any(1).sum())
        err2 = max(err2, (out_k - out_p).abs().max().item())
    print(f"[check] lsd_refine on half-pixel anchors (ds = 2): {len(ref2_calls)} calls, "
          f"{differ2} valid anchors not bit-equal, max err {err2:.3e}", flush=True)
    if differ2:
        fail(f"lsd_refine (ds = 2) disagrees on {differ2} valid anchors (max err {err2:.3e})")
    sel2 = {k: v for k, v in rec_ds2["kp_select"].calls.items() if k[2] == 8}
    if len(sel2) != 2:
        fail(f"phase 2f: 8 px cell selections {sorted(rec_ds2['kp_select'].calls)}")
    for key, (args, kw) in sel2.items():
        out_k = fast.select_keypoints_levels(*args, **kw)
        out_p = fast.select_keypoints_levels_plain(*args, **kw)
        for (xk, rk_, vk), (xp, rp_, vp) in zip(out_k, out_p):
            if not (torch.equal(vk, vp) and torch.equal(rk_[vk], rp_[vp])
                    and torch.equal(xk[vk], xp[vp])):
                fail(f"kp_select disagrees at {key} (cell 8, border 2)")
    print(f"[check] kp_select at 8 px cells, border 2: {sorted(sel2)} equal", flush=True)

    # LBD: the frame's segments, words equal on >= 99%, floats within 1e-5
    lbd_calls = [v[0] for v in rec["lbd_describe"].calls.values()]
    worst_eq, desc_err = 1.0, 0.0
    for im, ep, vl in lbd_calls:
        wk, dk = lbd.describe_lines(im, ep, vl)
        wp, dp = lbd.describe_lines_plain(im, ep, vl)
        worst_eq = min(worst_eq, (wk == wp).all(1).float().mean().item())
        desc_err = max(desc_err, (dk - dp).abs().max().item())
    print(f"[check] lbd_describe: words equal on {worst_eq:.4f} of segments, "
          f"descriptor err {desc_err:.3e}", flush=True)
    if worst_eq < 0.99 or desc_err > 1e-5:
        fail(f"lbd_describe disagrees: words equal {worst_eq:.4f}, err {desc_err:.2e}")
    im, ep, vl = lbd_calls[0]
    L = ep.shape[0]
    rows.append(dict(
        name="lbd_describe", max_abs_err=desc_err,
        **timings(lambda: lbd.describe_lines(im, ep, vl),
                  lambda: lbd.describe_lines_plain(im, ep, vl)),
        bytes=min(im.numel(), L * lbd.N_SAMPLES * lbd.N_BANDS) * 4 + L * (16 + 1)
        + L * (8 * 4 + lbd.DESC_FLOATS * 4),
        ops=L * (lbd.N_SAMPLES * lbd.N_BANDS * OPS_LBD_SAMPLE + OPS_LBD_SEGMENT),
        library_ms=None, shape=f"{L} segments at {tuple(im.shape)}"))
    # atan2 (kernel 8's entry; no path of the port calls it since kernels 22
    # and 26 compute it inline): the segment directions of every recorded
    # lsd_merge call, bit-exact; its launches are read in the uncalled block
    at_calls = []
    for (ref_, *_), _ in rec12["lsd_merge"].calls.values():
        at_calls.append(((ref_[:, 3] - ref_[:, 1]).contiguous(),
                         (ref_[:, 2] - ref_[:, 0]).contiguous()))
    for y, x in at_calls:
        if not torch.equal(fmath.atan2(y, x).view(torch.int32),
                           fmath.atan2_plain(y, x).view(torch.int32)):
            fail(f"atan2_glibc disagrees at {tuple(y.shape)}")
    y, x = max(at_calls, key=lambda a: a[0].numel())
    n_at = max(y.numel(), x.numel())
    rows.append(dict(
        name="atan2_glibc", max_abs_err=0.0,
        **timings(lambda: fmath.atan2(y, x), lambda: fmath.atan2_plain(y, x)),
        bytes=n_at * 12, ops=n_at * OPS_ATAN2, library_ms=None,
        shape=f"{n_at} elements (+{len(at_calls) - 1} other shapes checked)"))

    # keypoint selection: every call shape (ORB levels at 1024 and 2048
    # keypoints, the LSD anchors of both octaves), valid equal, resp and xy
    # equal on valid slots
    sel_calls = rec["kp_select"].calls
    for key, (args, kw) in sel_calls.items():
        out_k = fast.select_keypoints_levels(*args, **kw)
        out_p = fast.select_keypoints_levels_plain(*args, **kw)
        for li, ((xk, rk_, vk), (xp, rp_, vp)) in enumerate(zip(out_k, out_p)):
            if not (torch.equal(vk, vp) and torch.equal(rk_[vk], rp_[vp])
                    and torch.equal(xk[vk], xp[vp])):
                fail(f"kp_select disagrees at {key} level {li}: valid "
                     f"{int((vk != vp).sum())} slots")
    orb_key = next((k for k in sel_calls if sum(k[1]) == cfg.frontend.n_keypoints), None)
    if orb_key is None or len(sel_calls) < 3:
        fail(f"keypoint selection shapes missing: {sorted(sel_calls)}")
    sel_args, sel_kw = sel_calls[orb_key]
    lsd_sel = [v for k, v in sel_calls.items() if k[3] == 1]
    px = sum(sc.numel() for sc, _ in sel_args[0])
    nsel = sum(orb_key[1])

    def frame_selection(fn):
        # one frame's selections: the ORB levels and both LSD octaves' anchors
        return lambda: [fn(*a, **k) for a, k in [(sel_args, sel_kw)] + lsd_sel]

    rows.append(dict(
        name="kp_select", max_abs_err=0.0,
        **timings(lambda: fast.select_keypoints_levels(*sel_args, **sel_kw),
                  lambda: fast.select_keypoints_levels_plain(*sel_args, **sel_kw)),
        frame_wall_ms=time_ms(frame_selection(fast.select_keypoints_levels)),
        frame_plain_wall_ms=time_ms(frame_selection(fast.select_keypoints_levels_plain)),
        bytes=px * 4 + nsel * (5 * 4 + 8 + 4 + 1), ops=px * 6, library_ms=None,
        shape=f"{len(sel_args[0])} levels, {px} px, {nsel} keypoints "
              f"(+{len(sel_calls) - 1} other shapes checked)"))

    # observer bits and votes: exactly equal
    (st_bits,), _ = rec["obs_bits"].calls[("bits",)]
    if not torch.equal(map_store.compute_obs_bits(st_bits),
                       map_store.compute_obs_bits_plain(st_bits)):
        fail("obs_bits disagrees with its plain version")
    vote_calls = rec["votes"].calls
    for key, (args, _) in vote_calls.items():
        if not torch.equal(map_store.votes_from_bits(*args),
                           map_store.votes_from_bits_plain(*args)):
            fail(f"votes_from_bits disagrees at {key}")
    vargs = vote_calls[max(rec["votes"].n, key=rec["votes"].n.get)][0]
    Kb, Fb = st_bits.kf_kp_mp.shape
    Pb = st_bits.mp_valid.shape[0]
    vt = timings(lambda: map_store.votes_from_bits(*vargs),
                 lambda: map_store.votes_from_bits_plain(*vargs))
    v_bytes = nbytes(*vargs) + vargs[2].shape[0] * 4
    v_ops = 2 * vargs[0].shape[0] * vargs[2].shape[0]
    rows.append(dict(
        name="obs_bits", max_abs_err=0.0,
        **timings(lambda: map_store.compute_obs_bits(st_bits),
                  lambda: map_store.compute_obs_bits_plain(st_bits)),
        bytes=Kb * Fb * 4 + Pb * ((Kb + 31) // 32) * 4, ops=4 * Kb * Fb, library_ms=None,
        votes=dict(vt, bound_ms=max(v_bytes / HBM_BYTES_PER_S, v_ops / CUDA_CORE_OPS_PER_S)
                   * 1e3, calls=sum(rec["votes"].n.values()),
                   shape=f"{tuple(vargs[0].shape)} rows, {vargs[2].shape[0]} keyframes"),
        shape=f"[{Kb}, {Fb}] grid, {Pb} rows"))

    # null vectors: every shape within 1e-6; the library yardstick is
    # torch.linalg.eigh on the same Gram matrices
    null_calls = rec["null_vector4"].calls
    null_err = 0.0
    for key, (args, kw) in null_calls.items():
        null_err = max(null_err, (linalg.null_vector_4(*args, **kw)
                                  - linalg.null_vector_4_plain(*args, **kw)).abs().max().item())
    print(f"[check] null_vector4: max err {null_err:.3e} over {len(null_calls)} shapes",
          flush=True)
    if null_err > 1e-6:
        fail(f"null_vector4 disagrees: max err {null_err:.3e}")
    (A_nv,), _ = null_calls[max(null_calls, key=lambda k: int(np.prod(k[1][:-2])))]
    n_sys = int(np.prod(A_nv.shape[:-2]))
    gram = (A_nv.transpose(-1, -2) @ A_nv).reshape(n_sys, 4, 4).contiguous()
    rows.append(dict(
        name="null_vector4", max_abs_err=null_err,
        **timings(lambda: linalg.null_vector_4(A_nv), lambda: linalg.null_vector_4_plain(A_nv)),
        library_ms=device_ms(lambda: torch.linalg.eigh(gram)),
        library_wall_ms=time_ms(lambda: torch.linalg.eigh(gram)),
        bytes=A_nv.numel() * 4 + n_sys * 16, ops=n_sys * OPS_NULL_SYSTEM,
        shape=f"{tuple(A_nv.shape[:-2])} systems of {tuple(A_nv.shape[-2:])}"))

    # the functions no path calls: each entry point driven once with the
    # counters zeroed just before and read just after, then each kernel held
    # to its plain version and timed. Kernels 20 / 21 on phase 2a's final
    # map with duplicates seeded as keyframe n_kf's (copies of live
    # landmarks moved by 0.2% of their distance, descriptors 0-10 bits
    # apart, every fifth 200 bits apart)
    from structure_slam_pointline_tpu_torch.models import local_mapping

    n_kf_f = slam.cur.n_kf
    st_seed = seed_duplicates(slam.map, slam.cur, np.random.default_rng(23))
    gram_eigh = gram.reshape(-1, 4, 4).contiguous()
    torch.cuda.synchronize()
    kernels.reset_counts()
    st_p = local_mapping.fuse_duplicate_points_3d(st_seed, n_kf_f, n_kf_f + 2, slam.intr, cfg)
    st_l = local_mapping.fuse_duplicate_lines_3d(st_seed, n_kf_f, n_kf_f + 2, slam.intr, cfg)
    linalg.jacobi_eigh_4x4(gram_eigh)
    fmath.atan2(*at_calls[0])
    torch.cuda.synchronize()
    counts_uncalled = dict(kernels.COUNTS)
    merged = {"points": int(st_seed.mp_valid.sum() - st_p.mp_valid.sum()),
              "lines": int(st_seed.ml_valid.sum() - st_l.ml_valid.sum())}
    print(f"[fuse3d] merged {merged} of the seeded duplicates | launches "
          f"{ {k: counts_uncalled[k] for k in UNCALLED_KERNELS} }", flush=True)
    if merged["points"] < 100 or merged["lines"] < 5:
        fail(f"fuse3d: too few seeded duplicates merged: {merged}")
    for name, fn, plain, recent, pool, th, R, per_pair in (
            ("fuse_points_3d", local_mapping.fuse3d_points_match,
             local_mapping.fuse3d_points_match_plain, "mp",
             (st_seed.mp_xyz, st_seed.mp_desc, st_seed.mp_valid, st_seed.mp_first_kf),
             cfg.matching.th_low, local_mapping.FUSE3D_RECENT_MP, OPS_FUSE_PT_PAIR),
            ("fuse_lines_3d", local_mapping.fuse3d_lines_match,
             local_mapping.fuse3d_lines_match_plain, "ml",
             (st_seed.ml_endpoints, st_seed.ml_desc, st_seed.ml_valid, st_seed.ml_first_kf),
             cfg.matching.th_high, local_mapping.FUSE3D_RECENT_ML, OPS_FUSE_LN_PAIR)):
        valid, first = pool[2], pool[3]
        idx = torch.nonzero(valid & (first >= n_kf_f)).flatten()[:R]
        bk, hk = fn(*pool, idx, th)
        bp, hp = plain(*pool, idx, th)
        if not (torch.equal(hk, hp) and torch.equal(bk, bp)):
            fail(f"{name} disagrees: has {int((hk != hp).sum())}, best "
                 f"{int((bk != bp).sum())} of {idx.numel()} rows")
        older = int((valid[None, :] & (first[None, :] < first[idx][:, None])).sum())
        n_pool = valid.shape[0]
        row_b = sum(t[0].numel() * t.element_size() for t in pool)
        rows.append(dict(
            name=name, max_abs_err=0.0, library_ms=None,
            **timings(lambda: fn(*pool, idx, th), lambda: plain(*pool, idx, th)),
            # the pool's geometry, validity and ages read once, the rows'
            # descriptors and the matched ones' (one per row at most), out
            bytes=n_pool * (row_b - 32) + idx.numel() * (4 + 2 * 32 + 8 + 1),
            ops=older * per_pair + 2 * idx.numel() * n_pool,
            shape=f"{idx.numel()} recent x {n_pool} pool, {older} older pairs, "
                  f"{int(hk.sum())} duplicates"))
    vk, Vk = linalg.jacobi_eigh_4x4(gram_eigh)
    vp, Vp = linalg.jacobi_eigh_4x4_plain(gram_eigh)
    eigh_err = max((Vk - Vp).abs().max().item(),
                   ((vk - vp).abs() / vp.abs().clamp(min=1.0)).max().item())
    print(f"[check] jacobi_eigh4: max err {eigh_err:.3e} on {gram_eigh.shape[0]} systems",
          flush=True)
    if eigh_err > 1e-6:
        fail(f"jacobi_eigh4 disagrees: max err {eigh_err:.3e}")
    n_eig = gram_eigh.shape[0]
    rows.append(dict(
        name="jacobi_eigh4", max_abs_err=eigh_err,
        **timings(lambda: linalg.jacobi_eigh_4x4(gram_eigh),
                  lambda: linalg.jacobi_eigh_4x4_plain(gram_eigh)),
        library_ms=device_ms(lambda: torch.linalg.eigh(gram_eigh)),
        library_wall_ms=time_ms(lambda: torch.linalg.eigh(gram_eigh)),
        bytes=n_eig * (64 + 16 + 64), ops=n_eig * OPS_EIGH_SYSTEM,
        shape=f"{n_eig} symmetric 4x4 (the null vector's Gram matrices)"))

    # local BA: every recorded window size, poses and landmarks within 1e-3,
    # inlier masks on >= 99.5% of edges; the largest twice (bit-identical)
    # and once with host synchronization made an error
    ba_calls = rec["local_ba"].calls
    worst_pose = worst_lm = 0.0
    worst_in = 1.0
    for key, (args, kw) in sorted(ba_calls.items()):
        rk = local_ba.bundle_adjust(*args, **kw)
        rp = local_ba.bundle_adjust_plain(*args, **kw)
        worst_pose = max(worst_pose, (rk.kf_T_cw - rp.kf_T_cw).abs().max().item())
        for a, b in ((rk.mp_xyz, rp.mp_xyz), (rk.ln_start, rp.ln_start),
                     (rk.ln_end, rp.ln_end)):
            if a is not None:
                worst_lm = max(worst_lm, (a - b).abs().max().item())
        worst_in = min(worst_in, (rk.edge_inlier == rp.edge_inlier).float().mean().item())
        if rk.line_inlier is not None:
            worst_in = min(worst_in,
                           (rk.line_inlier == rp.line_inlier).float().mean().item())
    print(f"[check] local_ba: {len(ba_calls)} window sizes, pose err {worst_pose:.3e}, "
          f"landmark err {worst_lm:.3e}, inlier masks equal {worst_in:.4f}", flush=True)
    if worst_pose > 1e-3 or worst_lm > 1e-3 or worst_in < 0.995:
        fail(f"local_ba disagrees: pose {worst_pose:.2e}, landmarks {worst_lm:.2e}, "
             f"inliers {worst_in:.4f}")
    ba_key = max(ba_calls, key=lambda k: k[1])
    ba_args, ba_kw = ba_calls[ba_key]
    r1 = local_ba.bundle_adjust(*ba_args, **ba_kw)
    r2 = local_ba.bundle_adjust(*ba_args, **ba_kw)
    if not all(torch.equal(a, b) for a, b in zip(r1, r2) if a is not None):
        fail("local_ba: two launches on the same input differ")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    local_ba.bundle_adjust(*ba_args, **ba_kw)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    prob, ocfg, ln = ba_args[0], ba_args[2], ba_kw.get("lines")
    ba_rows = int(prob.edge_valid.sum()) + (2 * int(ln.edge_valid.sum()) if ln else 0)
    ba_iters = ocfg.local_ba_iters_first + ocfg.local_ba_iters_second
    ba_free = 6 * int(prob.kf_free.sum())
    # the library yardstick: the solve alone (first iteration's system, free rows)
    lib_A, lib_b = ba_solve_alone(lambda: local_ba.bundle_adjust_plain(*ba_args, **ba_kw),
                                  prob, ln)
    rows.append(dict(
        name="local_ba", max_abs_err=max(worst_pose, worst_lm),
        library_ms=device_ms(lambda: torch.linalg.solve(lib_A, lib_b)),
        library_wall_ms=time_ms(lambda: torch.linalg.solve(lib_A, lib_b)),
        library_shape=f"torch.linalg.solve of the [{lib_A.shape[0]}, {lib_A.shape[0]}] "
                      "system (the solve alone)",
        split=shard_split(lambda: local_ba.bundle_adjust(*ba_args, **ba_kw)),
        ms=device_ms(lambda: local_ba.bundle_adjust(*ba_args, **ba_kw), reps=5),
        wall_ms=time_ms(lambda: local_ba.bundle_adjust(*ba_args, **ba_kw), reps=5),
        # few repetitions: the plain version is ~10^4 small torch ops
        plain_ms=device_ms(lambda: local_ba.bundle_adjust_plain(*ba_args, **ba_kw), reps=3),
        plain_wall_ms=time_ms(lambda: local_ba.bundle_adjust_plain(*ba_args, **ba_kw),
                              reps=3, warmup=1),
        bytes=nbytes(*prob, *(ln or ()), *(t for t in r1 if isinstance(t, torch.Tensor))),
        ops=ba_iters * (ba_rows * OPS_BA_ROW + ba_free ** 3 // 3),
        shape=f"{ba_key[1]} keyframes, {ba_rows} residual rows"
              f"{', lines on' if ln else ''} (+{len(ba_calls) - 1} window sizes checked)"))
    # BoW transform (kernel 13): every shape of phase 2c (the query frame,
    # the batched keyframe index), words and vectors bit for bit
    bow_calls = rec["bow_transform"].calls
    for key, (args, _) in bow_calls.items():
        voc, d, v = args
        wk, bk = bow.transform(voc, d, v)
        wp, bp = bow.transform_plain(voc.nodes(d.device), d, v, voc.branching, voc.depth)
        if not (torch.equal(wk, wp) and torch.equal(bk.view(torch.int32), bp.view(torch.int32))):
            fail(f"bow_transform disagrees at {key}: {int((wk != wp).sum())} words, "
                 f"{int((bk != bp).sum())} vector entries")
    voc, bd, bv = bow_calls[max(bow_calls, key=lambda k: int(np.prod(k[1])))][0]
    n_desc = bv.numel()
    bow_plain = lambda: bow.transform_plain(voc.nodes(bd.device), bd, bv,  # noqa: E731
                                            voc.branching, voc.depth)
    rows.append(dict(
        name="bow_transform", max_abs_err=0.0,
        **timings(lambda: bow.transform(voc, bd, bv), bow_plain),
        bytes=n_desc * (32 + 1 + 4) + voc.nodes(bd.device).numel() * 4
        + (n_desc // bd.shape[-2]) * voc.n_words * 4,
        ops=n_desc * voc.depth * voc.branching * 24, library_ms=None,
        shape=f"{tuple(bd.shape[:-1])} descriptors, {voc.n_words} words "
              f"(+{len(bow_calls) - 1} other shapes checked)"))

    # database query (kernel 14): scores equal, or within 1e-6 with the same
    # candidate list; the library yardstick is torch.cdist's L1 distance.
    # Timed with the L2 flushed before each call, as the caller finds it
    # (one query per lost frame, the index written long before), so the
    # kernel, cdist and the HBM bound are read under the same conditions
    def policy(sc):
        return [int(c) for c in np.argsort(sc)[::-1] if sc[c] >= 0.75 * sc.max()][:16]

    q_calls = rec["bow_query"].calls
    q_err = 0.0
    for key, (args, kw) in q_calls.items():
        sk = bow.query_database(*args, **kw)
        sp = bow.query_database_plain(*args, **kw)
        q_err = max(q_err, (sk - sp).abs().max().item())
        if not (torch.equal(sk, sp) or (q_err <= 1e-6 and policy(sk.cpu().numpy())
                                        == policy(sp.cpu().numpy()))):
            fail(f"bow_query disagrees at {key}: max err {q_err:.3e}")
    (bq, kb, kv), qkw = q_calls[max(q_calls, key=lambda k: k[1][0])]
    K, Wq = kb.shape
    flush = l2_flush()
    rows.append(dict(
        name="bow_query", max_abs_err=q_err,
        **timings(lambda: bow.query_database(bq, kb, kv, **qkw),
                  lambda: bow.query_database_plain(bq, kb, kv, **qkw), flush=flush),
        library_ms=device_ms(lambda: torch.cdist(bq[None], kb, p=1), flush=flush),
        library_wall_ms=time_ms(lambda: torch.cdist(bq[None], kb, p=1), flush=flush),
        bytes=K * Wq * 4 + Wq * 4 + K * (1 + 1 + 4), ops=3 * K * Wq,
        shape=f"[{K}, {Wq}] index, L2 flushed before each call"))
    del flush

    # RANSAC PnP (kernel 15): per candidate the same chosen hypothesis and
    # count; poses within 1e-4 on the live candidates (a candidate with no
    # matches keeps all-zero sample sets, a degenerate DLT); per-hypothesis
    # counts equal on >= 99%; the library yardstick is torch.linalg.svd on
    # the same [C * I, 12, 12] DLT batch
    pnp_calls = rec["ransac_pnp"].calls
    pnp_err, worst_cnt = 0.0, 1.0
    for key, (args, kw) in pnp_calls.items():
        rk = pnp.ransac_pnp(*args, **kw)
        rp = pnp.ransac_pnp_plain(*args, **kw)
        live = args[2].sum(-1) >= 6
        if not (torch.equal(torch.argmax(rk.counts, -1), torch.argmax(rp.counts, -1))
                and torch.equal(rk.n_inliers, rp.n_inliers)):
            fail(f"ransac_pnp chose other hypotheses at {key}: kernel "
                 f"{rk.n_inliers.tolist()} plain {rp.n_inliers.tolist()}")
        if live.any():
            pnp_err = max(pnp_err, (rk.T_cw - rp.T_cw)[live].abs().max().item())
        worst_cnt = min(worst_cnt, (rk.counts == rp.counts).float().mean().item())
    print(f"[check] ransac_pnp: pose err {pnp_err:.3e} on live candidates, per-hypothesis "
          f"counts equal on {worst_cnt:.4f}", flush=True)
    if pnp_err > 1e-4 or worst_cnt < 0.99:
        fail(f"ransac_pnp disagrees: pose err {pnp_err:.2e}, counts equal {worst_cnt:.4f}")
    pargs, pkw = pnp_calls[max(pnp_calls, key=lambda k: int(np.prod(k[1])))]
    Cp, Ip, Np = pargs[3].shape[0], pargs[3].shape[1], pargs[0].shape[-2]
    dlt = pnp.dlt_systems(pargs[0], pargs[1], pargs[3], pargs[4])[0].reshape(-1, 12, 12)
    rows.append(dict(
        name="ransac_pnp", max_abs_err=pnp_err,
        **timings(lambda: pnp.ransac_pnp(*pargs, **pkw),
                  lambda: pnp.ransac_pnp_plain(*pargs, **pkw)),
        library_ms=device_ms(lambda: torch.linalg.svd(dlt)),
        library_wall_ms=time_ms(lambda: torch.linalg.svd(dlt)),
        bytes=Cp * Np * (12 + 1 + 1) + Np * 8 + Cp * Ip * (24 + 4 + 48) + Cp * (64 + 4),
        ops=(Cp * Ip + Cp) * Np * OPS_PNP_POINT, ops_fp64=Cp * Ip * OPS_PNP_HYP_FP64,
        shape=f"{Cp} candidates x {Ip} hypotheses x {Np} points, counts equal on "
              f"{worst_cnt:.4f}"))
    k15 = rows[-1]
    print(f"[kernel 15] {Cp} x {Ip} x {Np}: device {k15['ms']:.4f} ms against "
          f"torch.linalg.svd of the same [{Cp * Ip}, 12, 12] DLT batch {k15['library_ms']:.4f} "
          f"ms in this run ({k15['library_ms'] / k15['ms']:.2f}x); phase 2c "
          f"{counts_reloc['ransac_pnp']} launches in {sum(rec['ransac_pnp'].n.values())} calls",
          flush=True)
    print(f"[time] main-path and relocalization checks done at {time.time() - t_start:.0f} s",
          flush=True)
    # ---- the loop-closing path's shapes (phase 2d) ----
    # Sim(3) RANSAC (kernel 16): per call the same chosen hypothesis and
    # count, S12 within 1e-4, per-hypothesis counts equal on >= 99%; the
    # library yardstick is torch.linalg.eigh on the same Horn matrices
    s3_calls = loop_rec["ransac_sim3"].calls
    if not s3_calls:
        fail("ransac_sim3: no call recorded in phase 2d")
    s3_err, s3_cnt = 0.0, 1.0
    for key, (args, kw) in s3_calls.items():
        rk = sim3_solver.ransac_sim3(*args, **kw)
        rp = sim3_solver.ransac_sim3_plain(*args, **kw)
        if not (int(torch.argmax(rk.counts)) == int(torch.argmax(rp.counts))
                and int(rk.n_inliers) == int(rp.n_inliers)):
            fail(f"ransac_sim3 chose another hypothesis at {key}: kernel "
                 f"{int(rk.n_inliers)} plain {int(rp.n_inliers)}")
        s3_err = max(s3_err, (rk.S12 - rp.S12).abs().max().item())
        s3_cnt = min(s3_cnt, (rk.counts == rp.counts).float().mean().item())
    print(f"[check] ransac_sim3: {len(s3_calls)} shapes, S12 err {s3_err:.3e}, "
          f"per-hypothesis counts equal on {s3_cnt:.4f}", flush=True)
    if s3_err > 1e-4 or s3_cnt < 0.99:
        fail(f"ransac_sim3 disagrees: S12 err {s3_err:.2e}, counts equal {s3_cnt:.4f}")
    sargs, skw = next(iter(s3_calls.values()))
    I_s, N_s = sargs[3].shape[0], sargs[0].shape[0]
    ps1, ps2 = sargs[0][sargs[3].long()], sargs[1][sargs[3].long()]
    horn_N = sim3_solver.horn_matrix(ps1 - ps1.mean(-2, keepdim=True),
                                     ps2 - ps2.mean(-2, keepdim=True)).contiguous()
    rows.append(dict(
        name="ransac_sim3", max_abs_err=s3_err,
        **timings(lambda: sim3_solver.ransac_sim3(*sargs, **skw),
                  lambda: sim3_solver.ransac_sim3_plain(*sargs, **skw), expect="count_kernel"),
        library_ms=device_ms(lambda: torch.linalg.eigh(horn_N)),
        library_wall_ms=time_ms(lambda: torch.linalg.eigh(horn_N)),
        bytes=N_s * (12 + 12 + 1 + 1) + I_s * (12 + 4 + 48 + 4) + 64 + 4,
        ops=(I_s + 1) * N_s * OPS_SIM3_PAIR_TEST, ops_fp64=I_s * OPS_SIM3_HYP_FP64,
        shape=f"{I_s} hypotheses x {N_s} pairs, counts equal on {s3_cnt:.4f}"))

    # the Sim(3) pair refinement (kernel 17): S12 within 1e-4, inlier masks
    # equal on >= 99.5%
    pair_calls = loop_rec["sim3_pair"].calls
    if not pair_calls:
        fail("sim3_pair: no call recorded in phase 2d")
    pr_err, pr_in = 0.0, 1.0
    for key, (args, kw) in pair_calls.items():
        rk = pose_graph.optimize_sim3_pair(*args, **kw)
        rp = pose_graph.optimize_sim3_pair_plain(*args, **kw)
        pr_err = max(pr_err, (rk.S12 - rp.S12).abs().max().item())
        pr_in = min(pr_in, (rk.inliers == rp.inliers).float().mean().item())
    print(f"[check] sim3_pair: S12 err {pr_err:.3e}, inliers equal {pr_in:.4f}", flush=True)
    if pr_err > 1e-4 or pr_in < 0.995:
        fail(f"sim3_pair disagrees: S12 err {pr_err:.2e}, inliers equal {pr_in:.4f}")
    pargs, pkw = next(iter(pair_calls.values()))
    N_p = pargs[1].shape[0]
    rk = pose_graph.optimize_sim3_pair(*pargs, **pkw)
    n_pair_rows = 5 * int(pargs[5].sum()) + 10 * int(rk.n_inliers)
    print(f"[time] ransac_sim3 done at {time.time() - t_start:.0f} s", flush=True)
    rows.append(dict(
        name="sim3_pair", max_abs_err=pr_err,
        ms=device_ms(lambda: pose_graph.optimize_sim3_pair(*pargs, **pkw),
                     expect="sim3_pair_kernel"),
        wall_ms=time_ms(lambda: pose_graph.optimize_sim3_pair(*pargs, **pkw)),
        # one repetition: the plain version is ~10^4 small torch ops
        plain_ms=device_ms(lambda: pose_graph.optimize_sim3_pair_plain(*pargs, **pkw), reps=1),
        plain_wall_ms=time_ms(lambda: pose_graph.optimize_sim3_pair_plain(*pargs, **pkw),
                              reps=2, warmup=1),
        library_ms=None, bytes=N_p * (12 + 12 + 8 + 8 + 1 + 4 + 4 + 1) + 64 + 64 + 4,
        ops=n_pair_rows * OPS_SIM3_PAIR_ITER,
        shape=f"{N_p} pairs ({int(pargs[5].sum())} valid), 5 + 10 iterations"))

    print(f"[time] sim3_pair done at {time.time() - t_start:.0f} s", flush=True)
    # the pose graph (kernel 18): vertices within 1e-4 on every valid one,
    # two launches bit-identical, one call with host synchronization made an
    # error; the library yardstick is torch.linalg.solve on the first
    # iteration's assembled system over the free vertices (the solve alone)
    pg_calls = loop_rec["pose_graph"].calls
    if not pg_calls:
        fail("pose_graph: no call recorded in phase 2d")
    pg_err = 0.0
    for key, (args, kw) in pg_calls.items():
        sk = pose_graph.optimize_pose_graph(*args, **kw)
        sp = pose_graph.optimize_pose_graph_plain(*args, **kw)
        pg_err = max(pg_err, (sk - sp)[args[0].kf_valid].abs().max().item())
    print(f"[check] pose_graph: {len(pg_calls)} shapes, vertex err {pg_err:.3e}", flush=True)
    if pg_err > 1e-4:
        fail(f"pose_graph disagrees: vertex err {pg_err:.2e}")
    gargs, gkw = pg_calls[max(pg_calls, key=lambda k: k[2])]
    if not torch.equal(pose_graph.optimize_pose_graph(*gargs, **gkw),
                       pose_graph.optimize_pose_graph(*gargs, **gkw)):
        fail("pose_graph: two launches on the same input differ")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    pose_graph.optimize_pose_graph(*gargs, **gkw)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    gprob = gargs[0]
    g_iters = gkw.get("n_iters", gargs[1] if len(gargs) > 1 else 20)
    g_lam = gkw.get("lam_init", 1e-6)
    free_v = torch.nonzero(gprob.kf_valid & ~gprob.kf_fixed)[:, 0]
    free_rows = (7 * free_v[:, None] + torch.arange(7, device=free_v.device)).reshape(-1)
    Hd, bd = pose_graph.normal_equations(gprob, gprob.S_cw, torch.tensor(g_lam, device="cuda"))
    Hf, bf = Hd[free_rows][:, free_rows].contiguous(), bd[free_rows].contiguous()
    n_sys, K_g, E_g = free_rows.shape[0], gprob.S_cw.shape[0], gprob.edge_i.shape[0]
    rows.append(dict(
        name="pose_graph", max_abs_err=pg_err,
        ms=device_ms(lambda: pose_graph.optimize_pose_graph(*gargs, **gkw), reps=5,
                     expect="pg_solve_kernel"),
        wall_ms=time_ms(lambda: pose_graph.optimize_pose_graph(*gargs, **gkw), reps=5),
        # one repetition: the plain version is ~10^5 small torch ops
        plain_ms=device_ms(lambda: pose_graph.optimize_pose_graph_plain(*gargs, **gkw),
                           reps=1),
        plain_wall_ms=time_ms(lambda: pose_graph.optimize_pose_graph_plain(*gargs, **gkw),
                              reps=1, warmup=0),
        library_ms=device_ms(lambda: torch.linalg.solve(Hf, bf)),
        library_wall_ms=time_ms(lambda: torch.linalg.solve(Hf, bf)),
        bytes=2 * K_g * 64 + 2 * K_g + E_g * (64 + 4 + 4 + 4 + 1),
        ops=g_iters * (2 * n_sys ** 3 // 3 + E_g * (14 * OPS_PG_LANE + 2 * OPS_PG_COST)),
        shape=f"{K_g} vertices ({free_v.shape[0]} free), {E_g} edges, {g_iters} iterations, "
              f"library: solve of the [{n_sys}, {n_sys}] system"))

    print(f"[time] pose_graph done at {time.time() - t_start:.0f} s", flush=True)
    # local BA at global BA's 64 keyframes (kernel 12): poses and landmarks
    # within 1e-3, inlier masks equal on >= 99.5% of edges
    ba64 = {k: v for k, v in loop_rec["local_ba"].calls.items() if k[1] > 32}
    if not ba64:
        fail("no 64-keyframe BA call recorded in phase 2d")
    b64_pose = b64_lm = 0.0
    b64_in = 1.0
    for key, (args, kw) in ba64.items():
        rk = local_ba.bundle_adjust(*args, **kw)
        rp = local_ba.bundle_adjust_plain(*args, **kw)
        b64_pose = max(b64_pose, (rk.kf_T_cw - rp.kf_T_cw).abs().max().item())
        for a, b in ((rk.mp_xyz, rp.mp_xyz), (rk.ln_start, rp.ln_start), (rk.ln_end, rp.ln_end)):
            if a is not None:
                b64_lm = max(b64_lm, (a - b).abs().max().item())
        b64_in = min(b64_in, (rk.edge_inlier == rp.edge_inlier).float().mean().item())
        if rk.line_inlier is not None:
            b64_in = min(b64_in, (rk.line_inlier == rp.line_inlier).float().mean().item())
    print(f"[check] local_ba at 64 keyframes: pose err {b64_pose:.3e}, landmark err "
          f"{b64_lm:.3e}, inlier masks equal {b64_in:.4f}", flush=True)
    if b64_pose > 1e-3 or b64_lm > 1e-3 or b64_in < 0.995:
        fail(f"local_ba at 64 keyframes disagrees: pose {b64_pose:.2e}, landmarks "
             f"{b64_lm:.2e}, inliers {b64_in:.4f}")
    (bprob, bintr, bocfg), bkw = next(iter(ba64.values()))
    bln = bkw.get("lines")
    b_rows = int(bprob.edge_valid.sum()) + (2 * int(bln.edge_valid.sum()) if bln else 0)
    b_free = 6 * int((bprob.kf_free & bprob.kf_valid).sum())
    b_iters = bocfg.local_ba_iters_first + bocfg.local_ba_iters_second
    r64 = local_ba.bundle_adjust(bprob, bintr, bocfg, **bkw)
    b64_bytes = nbytes(*bprob, *(bln or ()), *(t for t in r64 if isinstance(t, torch.Tensor)))
    b64_ops = b_iters * (b_rows * OPS_BA_ROW + b_free ** 3 // 3)
    ba_row = next(r for r in rows if r["name"] == "local_ba")
    l64_A, l64_b = ba_solve_alone(
        lambda: local_ba.bundle_adjust_plain(bprob, bintr, bocfg, **bkw), bprob, bln)
    ba_row["kl64"] = dict(
        library_ms=device_ms(lambda: torch.linalg.solve(l64_A, l64_b)),
        library_wall_ms=time_ms(lambda: torch.linalg.solve(l64_A, l64_b)),
        library_shape=f"torch.linalg.solve of the [{l64_A.shape[0]}, {l64_A.shape[0]}] "
                      "system (the solve alone)",
        ms=device_ms(lambda: local_ba.bundle_adjust(bprob, bintr, bocfg, **bkw), reps=3,
                     expect="solve_kernel"),
        wall_ms=time_ms(lambda: local_ba.bundle_adjust(bprob, bintr, bocfg, **bkw), reps=3),
        plain_ms=device_ms(lambda: local_ba.bundle_adjust_plain(bprob, bintr, bocfg, **bkw),
                           reps=1),
        plain_wall_ms=time_ms(lambda: local_ba.bundle_adjust_plain(bprob, bintr, bocfg, **bkw),
                              reps=1, warmup=1),
        bound_ms=max(b64_bytes / HBM_BYTES_PER_S, b64_ops / CUDA_CORE_OPS_PER_S) * 1e3,
        launches=counts_loop["local_ba"], max_abs_err=max(b64_pose, b64_lm),
        shape=f"{bprob.edge_mp.shape[0]} keyframes ({int(bprob.kf_valid.sum())} valid, "
              f"{b_free // 6} free), "
              f"{bprob.mp_xyz.shape[0]} points, {bln.ln_start.shape[0] if bln else 0} lines, "
              f"{b_rows} residual rows")

    print(f"[time] local_ba at 64 keyframes done at {time.time() - t_start:.0f} s", flush=True)
    # the dense solver of kernels 12 and 18 alone (csrc/dense_lu.cuh, local_ba.cu's
    # `dense_solve` entry) on the three systems above: the window's and 64
    # keyframes' first reduced camera systems over the free cameras, and the
    # pose graph's first normal equations over the free vertices at its
    # capacity's panel width; the entry driven once on each with the counters
    # zeroed around the three calls. Each against its plain version (the same
    # pivot rows, x within 1e-5 of the largest |x|) and torch.linalg.solve
    # (the backward error |Ax - b| / (|A| |x| + |b|), infinity norms, within
    # 10x of the library's); timed beside both
    dense_sys = {"window": (lib_A, lib_b, lib_A.shape[0]),
                 "kl64": (l64_A, l64_b, l64_A.shape[0]),
                 "pose_graph": (Hf, bf, 7 * K_g)}
    dense_ab = {k: (torch.cat([A_, b_[:, None]], 1).contiguous(), cap)
                for k, (A_, b_, cap) in dense_sys.items()}
    torch.cuda.synchronize()
    kernels.reset_counts()
    dense_out = {k: linalg.dense_solve(ab, cap) for k, (ab, cap) in dense_ab.items()}
    torch.cuda.synchronize()
    counts_dense = dict(kernels.COUNTS)
    if counts_dense["dense_solve"] != len(dense_sys):
        fail(f"dense_solve: {counts_dense['dense_solve']} launches for {len(dense_sys)} systems")

    def backward_error(A_, b_, x_):
        A_, b_, x_ = A_.double(), b_.double(), x_.double()
        return ((A_ @ x_ - b_).abs().max() / (A_.abs().sum(1).max() * x_.abs().max()
                                              + b_.abs().max())).item()

    dense_rows = {}
    for key, (A_, b_, cap) in dense_sys.items():
        ab, _ = dense_ab[key]
        n_ = A_.shape[0]
        xk, pk = dense_out[key]
        nb_ = linalg.dense_panel_width(cap)
        xp, pp = linalg.lu_solve_blocked_plain(ab, n_, nb_)
        xl = torch.linalg.solve(A_, b_)
        err = (xk - xp).abs().max().item()
        be, be_lib = backward_error(A_, b_, xk), backward_error(A_, b_, xl)
        print(f"[check] dense_solve {key}: n {n_}, panels of {nb_}, pivots equal "
              f"{torch.equal(pk, pp)}, x err {err:.3e} (bit-equal {torch.equal(xk, xp)}), "
              f"backward error {be:.3e} vs torch.linalg.solve {be_lib:.3e}", flush=True)
        if not torch.equal(pk, pp) or err > 1e-5 * xp.abs().max().item() or be > 10 * be_lib:
            fail(f"dense_solve disagrees on the {key} system: pivots equal "
                 f"{torch.equal(pk, pp)}, x err {err:.2e}, backward error {be:.2e} vs {be_lib:.2e}")
        dense_rows[key] = dict(
            n=n_, panel=nb_, max_abs_err=err, bit_equal=torch.equal(xk, xp),
            backward_error=be, library_backward_error=be_lib,
            **timings(lambda: linalg.dense_solve(ab, cap),
                      lambda: linalg.lu_solve_blocked_plain(ab, n_, nb_),
                      expect="dense_solve_kernel"),
            library_ms=device_ms(lambda: torch.linalg.solve(A_, b_)),
            library_wall_ms=time_ms(lambda: torch.linalg.solve(A_, b_)),
            bytes=(n_ * (n_ + 1) + 2 * n_) * 4, ops=2 * n_ ** 3 // 3 + 2 * n_ ** 2)
        d = dense_rows[key]
        print(f"[solve] {key} [{n_}, {n_ + 1}]: device dense_solve {d['ms']:.4f} ms, "
              f"torch.linalg.solve {d['library_ms']:.4f} ms | caller {d['wall_ms']:.4f} ms, "
              f"{d['library_wall_ms']:.4f} ms", flush=True)
    head = dense_rows["kl64"]
    rows.append(dict(
        name="dense_solve", **{k: head[k] for k in ("ms", "plain_ms", "wall_ms", "plain_wall_ms",
                                                  "library_ms", "library_wall_ms", "bytes", "ops")},
        max_abs_err=max(r["max_abs_err"] for r in dense_rows.values()),
        library_shape=f"torch.linalg.solve of the same [{head['n']}, {head['n']}] system",
        systems={k: {q: v for q, v in r.items() if q not in ("bytes", "ops")}
                 | {"bound_ms": max(r["bytes"] / HBM_BYTES_PER_S,
                                    r["ops"] / CUDA_CORE_OPS_PER_S) * 1e3}
                 for k, r in dense_rows.items()},
        shape=f"[{head['n']}, {head['n'] + 1}] (64 keyframes' reduced camera system); the "
              f"window's [{dense_rows['window']['n']}] and the pose graph's "
              f"[{dense_rows['pose_graph']['n']}] in `systems`"))
    ba_row["kl64"]["split"] = shard_split(
        lambda: local_ba.bundle_adjust(bprob, bintr, bocfg, **bkw))
    print(f"[split] local_ba window {ba_row['split']} | 64 keyframes {ba_row['kl64']['split']}",
          flush=True)
    print(f"[time] dense_solve done at {time.time() - t_start:.0f} s", flush=True)
    # kernel 12's sharded form (phase 2g's shapes: the main path's window on
    # the mesh, global BA's 64 keyframes): poses and landmarks within 1e-3 of
    # the sharded plain version, masks on >= 99.5% of edges; the window
    # twice (bit-identical) and once with host synchronization made an error
    sh_calls = shard_rec.calls
    if not any(k[1] <= 32 for k in sh_calls) or not any(k[1] > 32 for k in sh_calls):
        fail(f"sharded BA shapes missing: {sorted(sh_calls)}")
    sh_err, sh_solve = {}, {}
    for key, (args, kw) in sorted(sh_calls.items()):
        rk = local_ba.bundle_adjust_sharded(*args, **kw)
        out_p = []
        # the plain call also gives the library yardstick's system
        sh_solve[key] = ba_solve_alone(
            lambda: out_p.append(local_ba.bundle_adjust_sharded_plain(*args, **kw)),
            args[0], args[3])
        rp = out_p[0]
        err = max((a - b).abs().max().item() for a, b in zip(
            (rk.kf_T_cw, rk.mp_xyz, rk.ln_start, rk.ln_end),
            (rp.kf_T_cw, rp.mp_xyz, rp.ln_start, rp.ln_end)) if a is not None)
        same = min((a == b).float().mean().item() for a, b in (
            (rk.edge_inlier, rp.edge_inlier), (rk.line_inlier, rp.line_inlier))
            if a is not None)
        sh_err[key] = (err, same)
        if err > 1e-3 or same < 0.995:
            fail(f"local_ba_shard disagrees at {key}: err {err:.2e}, masks equal {same:.4f}")
    # the fullest window with its landmark columns spread over every shard
    # (its live landmarks otherwise sit in shard 0 alone): the same bounds
    # against the sharded plain version and the unsharded kernel, and every
    # shard's span holding edges
    sh_key = max(k for k in sh_calls if k[1] <= 32)
    (sp, si, so, sl, sm), _ = sh_calls[sh_key]
    xp, xl = spread_columns(sp, sl)
    spans = local_ba.shard_spans(sm, xp.mp_xyz.shape[0], xl.ln_start.shape[0] if xl else 0)
    held = [int(((xp.edge_mp >= lo) & (xp.edge_mp < hi) & xp.edge_valid).sum())
            + (int(((xl.edge_ln >= llo) & (xl.edge_ln < lhi) & xl.edge_valid).sum())
               if xl else 0) for lo, hi, llo, lhi in spans]
    rk = local_ba.bundle_adjust_sharded(xp, si, so, xl, sm)
    for ref, what in ((local_ba.bundle_adjust_sharded_plain(xp, si, so, xl, sm), "plain"),
                      (local_ba.bundle_adjust(xp, si, so, lines=xl), "unsharded kernel")):
        err = max((a - b).abs().max().item() for a, b in zip(
            (rk.kf_T_cw, rk.mp_xyz, rk.ln_start, rk.ln_end),
            (ref.kf_T_cw, ref.mp_xyz, ref.ln_start, ref.ln_end)) if a is not None)
        same = min((a == b).float().mean().item() for a, b in (
            (rk.edge_inlier, ref.edge_inlier), (rk.line_inlier, ref.line_inlier))
            if a is not None)
        sh_err[("spread", what)] = (err, same)
        if err > 1e-3 or same < 0.995 or min(held) == 0:
            fail(f"local_ba_shard disagrees with the {what} version on the spread window: "
                 f"err {err:.2e}, masks equal {same:.4f}, edges per shard {held}")
    print(f"[check] local_ba_shard: {sh_err}; spread window's edges per shard {held}",
          flush=True)
    print(f"[time] local_ba_shard checks done at {time.time() - t_start:.0f} s", flush=True)

    def shard_row(key):
        (sp, si, so, sl, sm), skw = sh_calls[key]
        n_rows = int(sp.edge_valid.sum()) + (2 * int(sl.edge_valid.sum()) if sl else 0)
        free = 6 * int((sp.kf_free & sp.kf_valid).sum())
        out = local_ba.bundle_adjust_sharded(sp, si, so, sl, sm)
        A_, b_ = sh_solve[key]
        # the plain version is ~4 x 10^4 small torch ops: one repetition,
        # timed from the caller (CUDA events) only, since a profiled session
        # of it costs ~50 s of the script's time
        plain_ms = time_ms(lambda: local_ba.bundle_adjust_sharded_plain(sp, si, so, sl, sm),
                           reps=1, warmup=0)
        return dict(
            ms=device_ms(lambda: local_ba.bundle_adjust_sharded(sp, si, so, sl, sm), reps=3,
                         expect="solve_kernel"),
            wall_ms=time_ms(lambda: local_ba.bundle_adjust_sharded(sp, si, so, sl, sm), reps=3),
            plain_ms=plain_ms, plain_wall_ms=plain_ms, plain_timed="caller",
            library_ms=device_ms(lambda: torch.linalg.solve(A_, b_)),
            library_wall_ms=time_ms(lambda: torch.linalg.solve(A_, b_)),
            library_shape=f"torch.linalg.solve of the [{A_.shape[0]}, {A_.shape[0]}] system "
                          "(the solve alone)",
            split=shard_split(lambda: local_ba.bundle_adjust_sharded(sp, si, so, sl, sm)),
            max_abs_err=sh_err[key][0],
            bytes=nbytes(*sp, *(sl or ()), *(t for t in out if isinstance(t, torch.Tensor))),
            ops=ba_iters * (n_rows * OPS_BA_ROW + free ** 3 // 3),
            shape=f"{sm.size} shards: {key[1]} keyframes ({int(sp.kf_valid.sum())} valid, "
                  f"{free // 6} free), {sp.mp_xyz.shape[0]} points, "
                  f"{sl.ln_start.shape[0] if sl else 0} lines, {n_rows} residual rows")

    r1 = local_ba.bundle_adjust_sharded(sp, si, so, sl, sm)
    r2 = local_ba.bundle_adjust_sharded(sp, si, so, sl, sm)
    if not all(torch.equal(a, b) for a, b in zip(r1, r2) if a is not None):
        fail("local_ba_shard: two launches on the same input differ")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    local_ba.bundle_adjust_sharded(sp, si, so, sl, sm)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    row = shard_row(sh_key)
    print(f"[time] local_ba_shard window timed at {time.time() - t_start:.0f} s", flush=True)
    row.update(name="local_ba_shard", kl64=shard_row(max(sh_calls)))
    b64 = row["kl64"]
    b64["bound_ms"] = max(b64.pop("bytes") / HBM_BYTES_PER_S,
                          b64.pop("ops") / CUDA_CORE_OPS_PER_S) * 1e3
    b64["launches"] = counts_gba["local_ba_shard"]
    gba_mesh["bound_ms"] = b64["bound_ms"]
    rows.append(row)
    print(f"[time] local_ba_shard done at {time.time() - t_start:.0f} s", flush=True)
    # the batch entries of kernels 1, 11 and 2 at the data-parallel
    # frontend's stacks (one shard's frames per call): FAST maps and
    # selections equal, ORB descriptors on >= 99.5% of keypoints with
    # angles within 1e-4 (kernel 2's bounds)
    def stacked(name):   # the recorded calls on [B, H, W] stacks (LSD's anchor
        # selection calls `select_keypoints_levels` on single maps meanwhile)
        return [v for k, v in batch_rec[name].calls.items() if len(k[1]) == 3]

    fb_calls = [v[0][0] for v in stacked("fast_nms_batch")]
    for im in fb_calls:
        (rk_, nk), (rp_, np_) = fast.fast_score_nms(im), fast.fast_score_nms_plain(im)
        if not (torch.equal(rk_, rp_) and torch.equal(nk, np_)):
            fail(f"fast_nms_batch disagrees at {tuple(im.shape)}")
    px = sum(im.numel() for im in fb_calls)
    rows.append(dict(
        name="fast_nms_batch", max_abs_err=0.0,
        **timings(lambda: [fast.fast_score_nms(im) for im in fb_calls],
                  lambda: [fast.fast_score_nms_plain(im) for im in fb_calls]),
        bytes=px * (2 + 4 + 4), ops=px * 320, library_ms=None,
        shape=f"{len(fb_calls)} levels x {fb_calls[0].shape[0]} frames, {px} px"))
    (sb_args, sb_kw), = stacked("kp_select_batch")
    sb_maps, sb_ks = sb_args[0], sb_kw["ks"]   # extract_orb passes ks by name
    out_k = fast.select_keypoints_levels(*sb_args, **sb_kw)
    out_p = fast.select_keypoints_levels_plain(*sb_args, **sb_kw)
    for (xk, rk_, vk), (xp, rp_, vp) in zip(out_k, out_p):
        if not (torch.equal(vk, vp) and torch.equal(rk_[vk], rp_[vp])
                and torch.equal(xk[vk], xp[vp])):
            fail("kp_select_batch disagrees")
    px = sum(sc.numel() for sc, _ in sb_maps)
    nsel = sum(sb_ks) * sb_maps[0][0].shape[0]
    rows.append(dict(
        name="kp_select_batch", max_abs_err=0.0,
        **timings(lambda: fast.select_keypoints_levels(*sb_args, **sb_kw),
                  lambda: fast.select_keypoints_levels_plain(*sb_args, **sb_kw)),
        bytes=px * 4 + nsel * (5 * 4 + 8 + 4 + 1), ops=px * 6, library_ms=None,
        shape=f"{len(sb_maps)} levels x {sb_maps[0][0].shape[0]} frames, {px} px, "
              f"{nsel} keypoints"))
    ob_calls = [v[0] for v in stacked("orb_describe_batch")]
    ob_desc, ob_ang = 1.0, 0.0
    for im, xy in ob_calls:
        ak, dk = orb.orient_and_describe(im, xy)
        ap, dp = orb.orient_and_describe_plain(im, xy)
        ob_desc = min(ob_desc, (dk == dp).all(-1).float().mean().item())
        ob_ang = max(ob_ang, (ak - ap).abs().max().item())
    if ob_desc < 0.995 or ob_ang > 1e-4:
        fail(f"orb_describe_batch disagrees: descriptors equal {ob_desc:.4f}, "
             f"angle err {ob_ang:.2e}")
    nkp = sum(xy.shape[0] * xy.shape[1] for _, xy in ob_calls)
    rows.append(dict(
        name="orb_describe_batch", max_abs_err=ob_ang,
        **timings(lambda: [orb.orient_and_describe(im, xy) for im, xy in ob_calls],
                  lambda: [orb.orient_and_describe_plain(im, xy) for im, xy in ob_calls]),
        bytes=sum(im.numel() * 2 + xy.shape[0] * xy.shape[1] * (8 + 4 + 32)
                  for im, xy in ob_calls) + 64 * 256 * 4,
        ops=nkp * 11000, library_ms=None,
        shape=f"{len(ob_calls)} levels x {ob_calls[0][0].shape[0]} frames, {nkp} keypoints"))
    print(f"[time] batch entries done at {time.time() - t_start:.0f} s", flush=True)
    # kernel 14 as detect's scorer (nothing masked): equal, or within 1e-6
    dq_err = 0.0
    for key, (args, kw) in loop_rec["bow_query"].calls.items():
        dq_err = max(dq_err, (bow.query_database(*args, **kw)
                              - bow.query_database_plain(*args, **kw)).abs().max().item())
    if dq_err > 1e-6:
        fail(f"bow_query as detect's scorer disagrees: max err {dq_err:.3e}")
    print(f"[check] loop shapes: detect scores err {dq_err:.3e}", flush=True)
    # kernel 19: bit-equal on run B's first input of each pass, then at full
    # capacity on phase 2a's final map with a seeded half of its live slots
    # culled, where each pass is timed (no single PyTorch call computes a
    # pass: library_ms is null)
    for name in COMPACT_PASSES:
        if name not in run_b["first_inputs"]:
            fail(f"compact: run B never called {name}, so it has no input to hold the kernel on")
        check_compact(run_b["first_inputs"][name], f"run B's first {name} input")
    g = np.random.default_rng(19)
    culled = {}
    for f in ("kf_valid", "mp_valid", "ml_valid"):
        v = getattr(slam.map, f).clone()
        live = torch.nonzero(v).flatten().cpu().numpy()
        v[torch.as_tensor(g.choice(live, len(live) // 2, replace=False), device=v.device,
                          dtype=torch.long)] = False
        culled[f] = v
    st_half = slam.map._replace(**culled)
    check_compact(st_half, "phase 2a's map, half culled")
    passes = {}
    for name in COMPACT_PASSES:
        fn, plain = getattr(compact, name), getattr(compact, name + "_plain")
        t = timings(lambda: fn(st_half), lambda: plain(st_half), expect="gather_kernel")
        b = compact_bytes(st_half, name)
        v = culled[{"compact_points": "mp_valid", "compact_lines": "ml_valid",
                    "compact_keyframes": "kf_valid"}[name]]
        passes[name] = dict(t, bytes=b, bound_ms=b / HBM_BYTES_PER_S * 1e3,
                            live=int(v.sum()), slots=v.shape[0], calls_2e=ea[name] + eb[name])
        print(f"[kernel] compact {name}: device {t['ms']:.4f} ms, caller {t['wall_ms']:.4f} ms"
              f" | plain {t['plain_ms']:.4f} ({t['plain_wall_ms']:.4f}) ms | {int(v.sum())} of "
              f"{v.shape[0]} slots live | {b} bytes, bound {passes[name]['bound_ms']:.5f} ms",
              flush=True)
    K, F = slam.map.kf_kp_mp.shape
    rows.append(dict(
        name="compact", max_abs_err=0.0, library_ms=None,
        **{k: sum(p[k] for p in passes.values())
           for k in ("ms", "plain_ms", "wall_ms", "plain_wall_ms", "bytes")}, ops=0,
        passes=passes,
        shape=f"one pass of each pool (times and bytes summed): {K} keyframes x {F} features,"
              f" {slam.map.mp_valid.shape[0]} points, {slam.map.ml_valid.shape[0]} lines, "
              f"half of phase 2a's live slots culled"))
    frontend = frontend_card_vs_cpu(frame(i), cfg)
    rows += glue_kernels(rec12, e2e["init_frame"] + 1 + N_TRACK)
    print(f"[time] glue kernels checked at {time.time() - t_start:.0f} s", flush=True)
    print(f"[time] kernel checks done at {time.time() - t_start:.0f} s", flush=True)

    # ---- kernels 22-24 against their plain versions (phases 2a and 2d) ----
    k22_rows, functions = kernels_22_24(fuse_rec, glue_rec, tuple(slam.map.kf_kp_mp.shape))
    rows += k22_rows
    print(f"[time] function rows done at {time.time() - t_start:.0f} s", flush=True)

    # ---- phase 4: where the time goes, 20 more frames under torch.profiler ----
    from torch.profiler import ProfilerActivity, profile

    n_prof, j0 = 20, i + N_TRACK
    prof_seq = np.stack([frame(j) for j in range(j0, j0 + n_prof)])
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam.track_sequence(prof_seq, j0)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / n_prof
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same device time and would count it twice
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in evs) / 1e3 / n_prof
    top = [{"name": e.key[:70], "calls_per_frame": e.count / n_prof,
            "ms_per_frame": dev_us(e) / 1e3 / n_prof} for e in evs[:12]]
    profile_out = {"frames": n_prof, "wall_ms_per_frame": wall_ms,
                   "device_busy_ms_per_frame": busy_ms if evs else None,
                   "device_kernels_per_frame": sum(e.count for e in evs) / n_prof,
                   "top": top}
    print(f"[profile] {n_prof} frames under the profiler: wall {wall_ms:.2f} ms/frame, "
          f"device busy {busy_ms:.2f} ms/frame"
          if evs else "[profile] device time not measured by the profiler", flush=True)
    for t in top:
        print(f"[profile]   {t['ms_per_frame']:.4f} ms/frame  {t['calls_per_frame']:.1f}"
              f" calls/frame  {t['name']}", flush=True)
    profile_out["pageable_copies"] = pageable_copies(slam, frame(j0 + n_prof), j0 + n_prof)

    table = []
    for r in rows:
        b_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        # float32 and float64 work run on separate units, so the floor is
        # the larger of the two times, not their sum
        o_ms = max(r["ops"] / CUDA_CORE_OPS_PER_S, r.get("ops_fp64", 0) / FP64_OPS_PER_S) * 1e3
        kernel, replaces = ROW_KERNEL.get(r["name"], (r["name"], None))
        replaces = replaces or KERNELS[kernel][0]
        source = KERNELS[kernel][1]
        launches = (counts_ds2 if r["name"] in ROW_KERNEL else
                    counts_mesh if kernel in MESH_KERNELS else
                    counts_batch if kernel in BATCH_KERNELS else
                    counts_reloc if kernel in RELOC_KERNELS else
                    counts_loop if kernel in LOOP_KERNELS else
                    counts_2e if kernel in DATASET_KERNELS else
                    counts_uncalled if kernel in UNCALLED_KERNELS else
                    counts_dense if kernel in SOLVER_KERNELS else counts)[kernel]
        table.append({
            "name": r["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"],
            **({"launches_per_frame": launches / r["frames"]} if "frames" in r else {}),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": r["library_ms"], "wall_ms": r["wall_ms"],
            "plain_wall_ms": r["plain_wall_ms"], "shape": r["shape"],
            **{k: r[k] for k in ("frame_wall_ms", "frame_plain_wall_ms", "library_wall_ms",
                                 "library_shape", "split", "votes", "kl64", "agree", "diffs",
                                 "merges",
                                 "passes", "plain_timed", "systems")
               if k in r}})
        print(f"[kernel] {r['name']}: {r['shape']} | device: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms | caller: kernel {r['wall_ms']:.4f} ms, "
              f"plain {r['plain_wall_ms']:.4f} ms | bound {max(b_ms, o_ms):.5f} ms",
              flush=True)
    print(json.dumps({"e2e": e2e, "e2e_points_only": e2e_points, "launches_points_only":
                      counts_points, "e2e_relocalization": e2e_reloc,
                      "launches_relocalization": counts_reloc, "e2e_loop": e2e_loop,
                      "launches_loop": counts_loop, "e2e_dataset": e2e_dataset,
                      "launches_dataset": counts_2e, "e2e_ds2": e2e_ds2,
                      "launches_ds2": counts_ds2, "e2e_mesh": e2e_mesh,
                      "launches_mesh": counts_mesh, "global_ba_mesh": gba_mesh,
                      "batch_frontend": batch_out, "launches_batch": counts_batch,
                      "fuse3d_merged": merged,
                      "frontend_card_vs_cpu": frontend,
                      "profile": profile_out, "functions": functions}), flush=True)
    distributed.shutdown_multihost()
    print(f"[done] all phases passed in {time.time() - t_start:.0f} s", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
