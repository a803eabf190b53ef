"""Smoke test of the PyTorch/CUDA port (``xivo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit; check that TF32 is off;
2. build every CUDA source of ``xivo_tpu_torch/csrc`` (one nvcc process
   per source, all started together, sm_90a);
PCW path (slice 1):
3. drive a few frames of the PCW main path at full width and keep the
   inputs its Cholesky kernels (B1-B3) saw; hold each kernel against its
   plain PyTorch version on those real matrices and on random PSD
   matrices with planted zero rows, and time kernel, plain version and
   the library call (``cholesky_ex``, ``solve_triangular``; on the same
   input with its dead rows made unit; beside B2, which no one call
   matches, the two calls ``cholesky_ex`` then ``solve_triangular``);
   all three are kernels of ``csrc/chol_blocked.cu``: B1 the blocked
   Cholesky, which also serves B7 and is timed under both names beside
   ``cholesky_ex`` with the ratio printed, B2 the same factorization
   followed by the blocked inversion stage, B3 a load followed by it;
4. check the CUDA path against the port's CPU path (plain versions) at
   full width on a small batch (B = 2, 10 frames);
5. run the PCW main path: float32, default Dims (D = 228), B = 256
   sequences of the 5 s stream (T = 100 frames), every launch counter set
   to 0 just before and PyTorch's sync debug mode set to raise on any host
   sync in the frame loop; require finite poses, ATE-RMSE of sequence 0
   below 0.10 m and one launch of each Cholesky kernel per frame;
image path (slice 2):
6. drive a few frames of the image main path at full width (B = 16,
   512 x 512, 128-row track table) and keep the inputs the LK kernels (B4
   template windows, B5 Gauss-Newton loop) saw at every pyramid level;
   hold each against its plain version on those inputs and on the inputs
   of an LK call on random textures (B4 also on random patches), and
   time kernel, plain version and, for B4, ``grid_sample``; time B5 on
   each level of the last recorded frame and print the four launches'
   sum, and the longest chain (the most iterations a track runs, from
   the plain version a step at a time) beside its bound;
7. check the CUDA image path against the port's CPU image path at full
   width (B = 2): 10 frames of the bench config and 20 with the default
   admission gate (features in the state from frame ~3 on); poses within
   1e-3 m, equal track and in-state feature counts;
8. run the image main path: B = 16 sequences of the 120-frame 512 x 512
   stream from fresh states, counters at 0 and the sync debug mode on;
   require finite poses, the reference's accuracy bounds on sequence 0
   (``tests/test_image_vio.py``: final error below 5 m, median below 3 m,
   at least 20 tracks from frame 10 on), 4 launches of B4 and B5 per
   frame and one of B1-B3;
9. (no phase: where the time goes is the benchmark's, ``portbench/``,
   read from the program's own spans, ``xivo_tpu_torch/tracing.py``);
mapped path (slice 3):
10. hold the Hamming nearest-neighbour kernel (B6) against its plain
   version, exactly, on the queries, map tables and query-row masks of the
   three searches of frame 130 of the mapped main path (taken in a run of
   its own, before phase 12; the two retirement searches also without
   their mask) and on random descriptors with planted copies, duplicate
   map rows (ties), an invalid tail and an all-invalid sequence at
   M = 20000, without a mask, with a random one and with every row masked
   (masked rows at (10000, 0)); print how many rows each recorded call
   left unmasked; time kernel and plain version beside the bound on the
   retirement search with its mask and without (256 rows), the closure
   search (30 in-state slots) and random descriptors with every entry
   valid (F = 256, bound by the population counts);
11. check the CUDA mapped path against the port's CPU mapped path at full
   width as configured (B = 2, 60 frames, closures eligible after 20
   frames, 2048-entry maps, fusion on retirement on, the same RANSAC draws
   on both): poses within 1e-3 m, closures from the same frame on and
   totals within 2 %, every retired row fused or inserted alike (map count
   + fusions equal) and at most 10 % of the fusion decisions flipped (see
   MAP_FLIP_SHARE); then ``retire_features`` with fusion from that run's
   state on both devices: tables equal, positions within 1e-2 m in
   float32 and 1e-9 m in float64;
12. run the mapped PCW path: B = 64 sequences of the first MAP_FRAMES
   (200) frames of the 20 s "loop" stream in two calls (frames 0-129,
   where phase 10's inputs and phase 34's state are taken, and the rest),
   20000-entry maps,
   ``scripts/diag_kidnap_pcw.py``'s mapper settings without the kick,
   counters at 0 and the sync debug mode on;
   require finite poses, ATE-RMSE of sequence 0 below 0.15 m, more than
   100 closure rows in sequence 0, a map count above 0, three B6 launches
   a frame, one of B1 and two of B2 and B3;
13. one ``refine_map`` job at ``scripts/run_longhorizon_mapped.py``'s
   sizes (4096 landmarks, 8 observations, 256 keyframes) on a synthetic
   map: a finite chi2 history that never rises and falls;
14. a few frames of the image mapped path (B = 2, 512 x 512) with the
   launches of B1-B6 counted;
slice 4 (B7 and the accuracy config; phases 15-16 run first, 17-19
right after phase 5, whose ATE they use):
15. hold the blocked Cholesky kernel (B7) against its plain version and
   against B1 (the same kernel under its other name), row by row as phase
   3 does, at (256, 228, 228) and (256, 60, 60) on random PSD matrices
   with planted zero rows and on the same with the dead rows made unit;
   time it under both names, its plain version and ``cholesky_ex``, print
   the ratios and B7's bound;
16. the linear-algebra profile (``xivo_tpu_torch.tools.profile_linalg``,
   B7's entry point) at B = 256, PROFILE_ITERS chained calls a line,
   B7's launches counted, the kernel's ratio to ``cholesky_ex`` under both
   names printed;
17. check the recommended accuracy config's CUDA path (OOS updates, pose
   cloning, pose-only FEJ) against its CPU path at full width on B = 2
   for ACC_CMP_FRAMES frames: poses within 1e-3 m, and the OOS rows
   applied, in-state groups and features and OOS drops equal frame by
   frame;
18. run the accuracy path: default Dims, B = 256, T = 100, counters at 0
   and the sync debug mode on; require finite poses, OOS rows applied in
   sequence 0, an ATE-RMSE of sequence 0 below max(1.25 x phase 5's,
   0.015 m) (``tests/test_e2e_pcw.py:223``), and B1, B2, B3 launched 1, 3
   and 3 times a frame (the 60-row instate update and the two 120-row
   blocks of the 240-row OOS stack), B7 never;
19. the kernels at the OOS shapes: B2 and B3 on the 120-row blocks of
   the first 20 frames, and B1 at (D + 1)^2 = 229^2 over 20 frames with
   compression forced (``compression_trigger_ratio=0.5``, counted: B1
   twice a frame), each held against its plain version on the inputs of
   the frames where OOS rows were applied (from frame 8 on; B1 by its
   backward error, see BACKWARD_TOL) and timed (B1 also as B7, beside
   ``cholesky_ex``);
slice 10, the reference's default filter (reference Prince-Dormand
propagation through capped, masked substep loops; dense covariance with
Joseph updates; phases 20-22 run right after phase 19):
20. check the CUDA path of ``config_from_json(PCW_CFG)`` with nothing
   overridden (float32, default Dims) against its CPU path on B = 2 for
   FULL_CMP_FRAMES frames: poses within 1e-3 m, counts equal;
21. run it at full width: B = 256 sequences of the 5 s stream's first
   FULL_FRAMES (40) frames, the depths initialized from the simulation as
   the reference's bound test does (``tests/test_e2e_pcw.py:34-44``), the
   substep cap sized to
   the stream (``runner.fit_substeps``), counters at 0 and the sync debug
   mode on; require finite poses, ATE-RMSE of sequence 0 below 0.10 m, no
   interval left unfinished by the cap (read after the run) and no
   launch of B1-B3 or B7; print the throughput, peak memory and the most
   substeps an interval took;
22. the accuracy config in the full form with compression forced
   (``compression_trigger_ratio=0.5``), B = 256, FULL_COMPRESS_FRAMES
   frames, counted: B1 once a frame (the bordered Gram at 229; B2, B3
   never), held against its plain version by its backward error on the
   inputs of the frames with OOS rows, as phase 19 does.
slice 11, the shipped TUM-VI configs (the equidistant lens, homography
outlier rejection; phases 23-26 run right after phase 8):
23. check the CUDA image path of ``cfg/tumvi_cam0.json`` with nothing
   overridden (float32, 512 x 512, Dims(nf_rows=256, ng_rows=128), D =
   228, reference propagation, full covariance) against its CPU path on
   the stream rendered through its lens at B = 2, with the same
   homography draws on both: 6 frames of the config as shipped, 6
   with the default admission gate (features in the state from frame ~3
   on), and 8 of the config as shipped with outliers planted (the
   image's left 80 columns moved 8 px down in frames 5 and 6, so that the
   tracks there leave the homography of the rest in frame 5 and come back
   in frame 7); each CUDA run under the sync debug mode, the first after
   a two-frame run that fills the port's cache of device constants (the
   other two configs make the same ones); poses within
   1e-3 m, equal track, in-state feature and rejection counts, and with
   the planted outliers rejections in frame 5 on both devices;
24. run it at full width: B = 16 sequences of the stream's first
   TUMVI_FRAMES (45) frames, in two calls as phase 21, counters at 0 and
   the sync debug mode on; require finite poses, the
   image path's accuracy bounds on sequence 0 (phase 8's), 4 launches of
   B4 and B5 a frame and none of B1-B3, B6, B7; print the throughput,
   peak memory and the rejection totals; then hold B4 and B5 against
   their plain versions on the inputs of its first frames (256-row track
   tables) and time them;
25. the equidistant image bench variant (``bench.py``'s, IMG_BENCH_CFG
   through ``EQUIDISTANT_512_CAM``, fast propagation, the square-root
   form) at B = 16 over the first EQUI_FRAMES (60) frames of the stream
   rendered through that lens,
   counted: finite poses, 1 launch of B1-B3 and 4 of B4 and B5 a frame;
26. check the CUDA path of ``cfg/tumvi_cam0_accuracy.json`` (OOS updates,
   pose cloning, FEJ, in the full form) against its CPU path at B = 2 for
   TUMVI_ACC_FRAMES frames, as shipped, the same draws on both (the
   CUDA run as in phase 23): poses
   within 1e-3 m, OOS rows applied, and the OOS rows, in-state groups
   and features, OOS drops and rejections equal frame by frame (phase
   17's rule); B4 and B5 4 launches a frame, B2, B3, B6 and B7 none, B1
   at most one (at 229, when compression fires).
slice 12, the host side (the pyxivo ``Estimator`` and the replay app;
phases 27-29 run last, each printing its time):
27. the first API_RUN_T (1 s) of ``tests/test_api.py::run_short``'s
   stream (the gentle trajectory, 300 random points, 100 Hz IMU, 20 Hz
   frames, 2 s; the port's simulator)
   through ``xivo_tpu_torch.api.Estimator`` at the default Dims (D = 228,
   float32) of ``config_from_json(PCW_CFG, sim_initialize_depths=True)``,
   once as the default filter and once with ``propagation_mode="fast",
   covariance_form="sqrt"``: on CUDA (after a first run of the stream's
   first API_WARM_T s, which fills the cache of device constants) with
   every ``VisualMeasPointCloud`` and ``InertialMeas`` call from the
   second frame after vision init under the sync debug mode "error"
   (accessors outside it), and on the CPU (the default filter's first
   API_FULL_CMP_FRAMES frames after vision init, the square-root form's
   all); poses within 1e-3 m at every frame compared, equal counts;
   B1-B3 once a frame in the square-root run, no kernel in the default
   filter's; prints frames/s of the sequence;
28. the synthetic ASL dataset of ``tests/test_io.py::build_synthetic_asl``
   (``sim/asl.write_dots_dataset``: IMG_CFG's 320 x 240 camera, 20 frames,
   ``.npy`` images) replayed by ``python -m xivo_tpu_torch.apps.vio`` in a
   subprocess on the card; the trajectory read back with
   ``eval.estimator_data.load_trajectory``: 20 finite poses, the final
   position within 1.0 m of the truth (``tests/test_io.py:95``), B4 and
   B5 ``klt_max_level`` (3) times a frame as the app reports them, no
   other kernel;
29. ``cfg/tumvi_cam0.json`` as shipped through the Estimator: 40 frames of
   phase 24's world and motion through its lens after 0.6 s of rest, with
   mocap, written as a TUM-VI directory (``sim/asl.write_tumvi_dataset``)
   and read with ``io.load_dataset``; CUDA against the CPU over the first
   10 frames (poses within 1e-3 m, equal counts), all 40 on CUDA (finite
   poses, B4 and B5 4 times a frame, no other kernel); prints the ATE-RMSE
   against the mocap (``eval.metrics.ate_rmse``), the pairs associated
   and frames/s, with no bound on them.
slice 13, the other filter options (phases 30-31 run after phase 29):
30. ``sim/configs.options_config()``: PCW_CFG with initial intrinsics
   stds at the default Dims (D = 228), float32, the square-root form,
   fast propagation, with OOS updates, FEJ, the correlated init, Huber,
   1-point RANSAC, OC-EKF on both sides, depth refinement and online
   camera calibration on; the bench stream with outliers planted from
   frame 10 on (10 % of the measurements moved 8-20 px,
   ``sim/stream.corrupt_measurements``, the same on both devices).
   (a) The CUDA path against the CPU path on B = 2 for OPT_CMP_FRAMES
   frames: poses within 1e-3 m, every count of StepOutputs equal frame by
   frame (the 1-point RANSAC and MH rejects included), 1-point RANSAC
   rejects > 0. (b) The main run: B = 256, OPT_FRAMES frames, counters
   at 0 and the sync debug mode on; finite poses, sequence 0's ATE-RMSE
   below 0.15 m (``tests/test_sqrt_form.py:223``), the 1-point RANSAC
   rejects summed > 0, ``validate_state`` of sequence 0's final state
   empty, B1 once and B2, B3 four times a frame (the instate downdate and
   1-point RANSAC's partial one at 60, OOS's two 120-row blocks); prints
   the throughput and peak memory. (c) B1-B3 held against their plain
   versions (``hold``) on the inputs of frames 10-13 of the main path;
31. batched propagation, ``config_from_json(PCW_CFG,
   propagation_mode="batched")`` (the full form, float32), which
   ``runner.fit_substeps`` leaves as it is: CUDA against CPU on B = 2 for
   BAT_CMP_FRAMES frames (poses 1e-3 m, counts equal); the main run at
   B = 64 for BAT_FRAMES frames with the depths from the simulation,
   counted, no sync: ATE-RMSE of sequence 0 below 0.10 m, no kernel
   launched; then ``filter/vi_init.vi_bootstrap`` on the stream's first
   VI_WINDOW frames, depth-aided and visual-only, on both devices:
   ``cond_ok`` and v0, g within 1e-3 of the CPU's.
slice 14, the rest of image mode (phases 32-33 run last):
32. the MATCH tracker with the ORB detector and words on phase 8's
   workload (IMG_BENCH_CFG, fast propagation, the square-root form, the
   120-frame stream at B = 16): first the CUDA path against the CPU path
   on B = 2 for MATCH_CMP_FRAMES frames (poses within 1e-3 m; tracked,
   in-state and rejection counts and the tracks spawned equal frame by
   frame), which also fills the config's device constants; then the main
   run, counted, under the sync debug mode: finite poses, phase 8's
   bounds on sequence 0, B1-B3 once a frame and no LK kernel;
33. (a) the five new detector scores (AGAST, Shi-Tomasi, Harris, oFAST,
   BRISK), their non-maximum suppression and top-128 picks, and the four
   descriptors at the CPU's oFAST picks, on 16 frames of phase 32's
   stream and 16 of the textured stream, on the card against the CPU:
   scores within 1e-4 of each map's largest, picks equal, at most 0.5 %
   of the words' bits apart; (b) the LK tracker with GFTT, BRISK words
   and the dropped-track rescue on TEX_FRAMES (40) frames of a
   ``sim/texture.TexturedBoxWorld`` room through ``EQUIDISTANT_512_CAM``
   along the image stream's trajectory (rendered once, broadcast to B =
   16), compared and counted as phase 32: ATE-RMSE of sequence 0 below
   TEX_ATE_BOUND, TEX_MIN_TRACKED tracks from frame 10 on, B1-B3 once and
   B4/B5 4 times a frame.
slice 15, distribution (phase 34 runs last, on a one-rank NCCL group of
cuda:0 brought up, with its communicator, before any sync check, and
taken down at the end; each path counted under the sync debug mode):
34. (a) ``runner.make_sharded_runner`` on DIST_FRAMES frames of phase 5's
   workload (B = 256, default Dims) against ``run_batch`` on the same
   inputs: outputs and final states equal, B1-B3 once a frame in both;
   (b) ``dist/retrieval.make_sharded_matcher`` against ``hamming_nn`` on
   phase 10's recorded searches (without their query-row masks) and the
   random (64, 256, 8) x (64, 20000, 8) case, exactly, B6 once a call,
   and ``detect_loop_closures(matcher=)`` on the mapped main run's state
   at frame 131 against the call without it; (c) ``refine_map(mesh=)``
   on phase 13's map against ``refine_map()``: each chi2 within
   DIST_CHI2_RTOL of the single run's plus DIST_CHI2_ATOL of its first,
   both timed; (d) ``dist/segments.run_segment_parallel`` over four
   segments of phase 5's stream length on the orbit, with the sharded
   runner against the default (``run_batch``), each runner's frame loop
   under the sync check: fused trajectory and outputs equal, launches
   equal.
fast propagation's IMU chain (phase 35 runs right after phase 5):
35. the kernel of ``csrc/imu_chain.cu`` against its plain version
   (``ops/imu_chain.chain_plain``) on random inputs in float32 and
   float64 (each output within ``CHAIN_TOL`` of the plain version, see
   ``chain_errors``), then timed with the plain version at the two
   benchmark cells' shapes, B = 4096 rows of KI = 5 slots of 10 ms and
   KI = 10 of 5 ms, S = 4, dt_eff = 0 (each output within the float32
   ``CHAIN_TOL`` there too), beside its bound. Every counted run checks
   the chain's launches: one a frame step on fast propagation's static
   grid, none on every other path (``chain_launches``).
Each kernel's entry in the JSON line carries its launches on every
path (B7's ``launches`` are the profile's; 0 on the filter paths). The
last lines are the kernels' JSON line, the card line, and
``{"ok": true, "device": {...}}``. Without CUDA it prints no result and
exits 1.
"""
import contextlib
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 256
TOTAL_TIME = 5.0        # bench.py's stage_pcw stream: T = 100 frames
CAPTURE_FRAMES = 12
ATE_BOUND = 0.10        # tests/test_e2e_pcw.py's bound
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12       # H100 SXM float32 peak outside the tensor cores
# kernel vs plain version, per row: the row's largest |difference| over
# its largest |entry| in the plain version, so that rows of small entries
# (biases, small-std states) are held as tightly as large ones. Two
# float32 factorizations may fairly differ by as much as either differs
# from float64, and that depends on the input: the innovation matrices of
# later frames give the plain version's L^-1 a row error of 1.1e-4 against
# float64, the random inputs 5e-7. So the limit on each input is
# ROW_TOL + ROW_TOL_SCALE x the plain float32 version's own row error
# there, and never above ROW_TOL_CAP.
ROW_TOL, ROW_TOL_SCALE, ROW_TOL_CAP = 1e-5, 4.0, 1e-3
# B1 at 229 factors OOS measurement compression's bordered Gram of a stack
# of rank ~27 plus a 1e-6 relative jitter: its rows past the rank are set
# by the jitter, and a float32 factorization gets them to a few percent
# (the plain float32 version's rows there differ from float64 by ~1e-2).
# The update reads only L L^T, so there the kernel is held by its backward
# error max|L L^T - G| / max|G|: within BACKWARD_TOL + ROW_TOL_SCALE x the
# plain float32 version's own; its row error is printed, not held.
BACKWARD_TOL = 1e-6

IMG_B = 16              # bench.py's IMG_BATCH default
IMG_CAPTURE_FRAMES = 3
# tests/test_image_vio.py:79,90-91: tracks from frame 10 on, final and
# median position error
IMG_MIN_TRACKED, IMG_FINAL_BOUND, IMG_MEDIAN_BOUND = 20, 5.0, 3.0
# B4: the same four taps, weights and order as the plain version; per
# track, the largest |difference| over the largest |entry|
TMPL_TOL = 1e-5
# B5: the warp sums the 225 window products in another order than the
# plain version, so a step within rounding of eps may stop a track one
# iteration earlier or later: the flags agree on at least this share of
# the live tracks, and a track that converged in both ends within 2 eps.
# A track still unconverged after the budget keeps moving by steps of at
# least eps, so where it stops depends on rounding. On the H100 the
# largest such difference read 0.034 px (1294 tracks unconverged in both
# of 15,100 live ones, on the inputs below); the limit is 10 eps, about
# 3 x that reading. These tracks are not escaped, so their positions go
# on to the filter.
GN_FLAG_SHARE = 0.995
GN_UNCONV_TOL = 0.1
IMG_PATH_TOL = 1e-3     # CUDA vs CPU image path, m
IMG_CMP_FRAMES, IMG_CMP_OPEN_FRAMES = 10, 20
TUMVI_SPLIT_FRAME = 30  # phase 24's two calls: frames before it, the rest

DEV = "cuda"            # the card every phase runs on
REPLACES = {"chol_lanes": "xivo_tpu/ops/lanes_chol.py:103",
            "chol_blocked": "xivo_tpu/ops/chol_pallas.py:37",
            "chol_inv_lanes": "xivo_tpu/ops/lanes_chol.py:108",
            "tri_inv_lanes": "xivo_tpu/ops/lanes_chol.py:133",
            "lk_sample_templates": "xivo_tpu/ops/lk_pallas.py:107",
            "lk_gn_tracks": "xivo_tpu/ops/lk_pallas.py:60",
            "hamming_nn": "xivo_tpu/ops/hamming_pallas.py:34"}

MAP_B = 64
MAP_TOTAL_TIME = 20.0   # the "loop" stream of diag_kidnap_pcw: T = 400
MAP_FRAMES = 200        # the main run: its first 200 frames
MAP_ATE_BOUND = 0.15    # tests/test_mapped_vio.py:42
MAP_MIN_CLOSURES = 100  # tests/test_headline_micro.py:50
MAP_CAPTURE_FRAME = 130
MAP_CMP_FRAMES, MAP_CMP_CAPACITY, MAP_CMP_AGE = 60, 2048, 20
MAP_PATH_TOL, MAP_CLOSURE_SHARE = 1e-3, 0.02
MAP_POSE_EPS = 1e-5     # poses this far apart count as parted (report)
# Fusion on retirement intersects covariances that may be nearly singular
# (a gauge feature's is rank 1): in float32 a rounding difference between
# the card and the CPU moves a fused position by up to ~1e-3 m (0.0012 m
# read on the H100 from the state after 12 frames, in
# tests/test_torch_cuda.py), and a position near the 0.5 m merge radius
# may then fuse on one device and insert on the other (7 of ~175 fusions
# in 60 frames, read on the H100). So over the 60 frames the fusion
# decisions that flip stay within 10 % of the fusions, with every retired
# row fused or inserted on both (count + fusions equal); from one state,
# the tables agree exactly and the fused positions within 1e-2 m (1/50 of
# the radius) in float32 and 1e-9 m in float64, where rounding is too
# small to grow that far.
MAP_FLIP_SHARE = 0.1
MAP_FUSE_TOL32, MAP_FUSE_TOL64 = 1e-2, 1e-9
IMG_MAP_FRAMES = 8
# slice 4: B7's widths (the linear-algebra profile's), the profile's chain
# length, and the accuracy config's phases: CUDA against CPU on B = 2 for
# ACC_CMP_FRAMES frames, compression forced for ACC_COMPRESS_FRAMES at
# full width; its ATE bound is tests/test_e2e_pcw.py:223's
CHOL_WIDTHS = (228, 60)
PROFILE_ITERS = 10
# (OOS first fires at frame 8 of the bench stream)
ACC_CMP_FRAMES, ACC_COMPRESS_FRAMES, ACC_CAPTURE_FRAMES = 40, 20, 20
ACC_PATH_TOL = 1e-3
ACC_ATE_FACTOR, ACC_ATE_FLOOR = 1.25, 0.015
# slice 10, the reference's default filter (reference Prince-Dormand
# propagation, full covariance, Joseph updates): the unmodified PCW config's
# CUDA path against its CPU path on B = 2 for FULL_CMP_FRAMES frames; the
# main run on the bench stream with the depths initialized from the
# simulation, as the reference's bound test runs the config
# (tests/test_e2e_pcw.py:34-44); the accuracy config in the full form with
# compression forced for FULL_COMPRESS_FRAMES frames
FULL_CMP_FRAMES, FULL_COMPRESS_FRAMES = 10, 20
FULL_FRAMES = 40        # the main run: the bench stream's first 40 frames
FULL_PATH_TOL = 1e-3
COUNT_FIELDS = ("num_instate_features", "num_instate_groups", "num_tracked",
                "num_mh_rejected", "num_oos_dropped")
# slice 11: the shipped TUM-VI configs on the image stream rendered through
# their lens; CUDA against CPU on B = 2 (the config as shipped for
# TUMVI_CMP_FRAMES, the default admission gate for TUMVI_CMP_OPEN_FRAMES,
# the planted outliers for TUMVI_PLANT_CMP_FRAMES),
# the main run at IMG_B over TUMVI_FRAMES; the planted outliers: the
# left TUMVI_PLANT_COLS columns moved TUMVI_PLANT_PX px down in frames
# TUMVI_PLANT_FRAMES. The accuracy comparison runs to its first OOS rows,
# in frame 14
TUMVI_PLANT_COLS, TUMVI_PLANT_PX, TUMVI_PLANT_FRAMES = 80, 8, (5, 6)
TUMVI_CFGS = ("cfg/tumvi_cam0.json", "cfg/tumvi_cam0_accuracy.json")
TUMVI_CMP_FRAMES, TUMVI_CMP_OPEN_FRAMES, TUMVI_ACC_FRAMES = 6, 6, 15
TUMVI_PLANT_CMP_FRAMES = 8  # the planted case: to the tracks' return
TUMVI_FRAMES = 45       # the main run: the stream's first 45 frames
EQUI_FRAMES = 60        # phase 25: the stream's first 60 frames
TUMVI_CAPTURE_FRAMES = 3
TUMVI_COUNTS = ("num_tracked", "num_instate_features", "num_instate_groups",
                "num_oos_dropped", "num_tracker_outlier_rejected")
# slice 13, the other filter options (phase 30: sim/configs.OPTIONS on
# the square-root path; CUDA against CPU on B = 2 for OPT_CMP_FRAMES
# frames, the main run at B for OPT_FRAMES, B1-B3 held on the inputs of
# its first OPT_CAPTURE_FRAMES) and batched propagation (phase 31, the
# full form; CUDA against CPU on B = 2 for BAT_CMP_FRAMES, the main run at
# BAT_B for BAT_FRAMES, vi_bootstrap on a VI_WINDOW-frame window). The
# options' stream has outliers planted: from frame 10 on, 10 % of the
# measurements moved 8-20 px (sim/stream.corrupt_measurements), so that
# Huber, 1-point RANSAC and the MH gate have work; the comparison runs 5
# frames past that start. Their ATE bound is tests/test_sqrt_form.py:223's
OPT_FRAMES, OPT_CMP_FRAMES, OPT_CAPTURE_FRAMES = 40, 15, 14
OPT_ATE_BOUND, OPT_PATH_TOL = 0.15, 1e-3
OPT_CORRUPT = dict(seed=13, share=0.1, px=(8.0, 20.0), start=10)
OPT_COUNTS = COUNT_FIELDS + ("num_oneptransac_rejected",
                             "num_tracker_outlier_rejected")
BAT_B, BAT_FRAMES, BAT_CMP_FRAMES = 64, 20, 10
BAT_ATE_BOUND, BAT_PATH_TOL, VI_WINDOW, VI_TOL = 0.10, 1e-3, 16, 1e-3
# slice 14, the rest of image mode (phases 32-33). Phase 32: phase 8's
# workload with the MATCH tracker and the ORB detector and descriptor,
# held to phase 8's bounds, CUDA against CPU on B = 2 for
# MATCH_CMP_FRAMES. Phase 33: the five new detector scores and the four
# descriptors on DET_B frames each of phase 32's stream and of the
# textured stream, DET_K picks an image (scores within DET_SCORE_RTOL of
# each map's largest, picks equal, at most DESC_BIT_SHARE of the words'
# bits differing); the LK tracker with GFTT, BRISK words and the
# dropped-track rescue on TEX_FRAMES frames of a TexturedBoxWorld
# (sim/texture.py) through EQUIDISTANT_512_CAM at IMG_B, with its own
# bounds (TEX_*), and CUDA against CPU on B = 2 for TEX_CMP_FRAMES.
MATCH_CMP_FRAMES = 10
DET_B, DET_K, DET_SCORE_RTOL, DESC_BIT_SHARE = 16, 128, 1e-4, 0.005
TEX_FRAMES, TEX_CMP_FRAMES = 40, 10
TEX_ATE_BOUND, TEX_MIN_TRACKED = 0.5, 20
FRONT_COUNTS = ("num_tracked", "num_instate_features", "num_instate_groups",
                "num_tracker_outlier_rejected")
DET_SCORES = ("agast_score", "shi_tomasi_score", "harris_score",
              "ofast_score", "brisk_score")
# slice 15, distribution (phase 34): the sharded runner on DIST_FRAMES
# frames of phase 5's workload (features enter the state by frame 4);
# refine_map(mesh=) against refine_map() on phase 13's map: each chi2
# within DIST_CHI2_RTOL of the single run's plus DIST_CHI2_ATOL of its
# first (float32 sums in another order may part by a few ulp of the
# largest term; at one rank the two run the same operations); segments
# over the orbit of phase 5's length
DIST_FRAMES = 20
DIST_CHI2_RTOL, DIST_CHI2_ATOL = 1e-5, 1e-7
DIST_SEG = dict(n_segments=4, overlap=10, boot_frames=12)
# B6's bound by operations: the least work a (query, entry) pair's
# distance needs, whatever the kernel does. 8 XORs; carry-save adders
# (a sum and a carry, one 3-input logic operation each) over seven of the
# 8 words, and one over the three carries, leave words of weight 1, 1, 2
# and 4: 16 logic operations at 64 results a clock per SM and 4
# population counts at 16 (the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table, compute capability 9.0), 0.25
# clock a pair either way; the weighting adds and the running minimum are
# not counted. On 132 SMs at the card's maximum SM clock
LOGIC_PER_PAIR, LOGIC_PER_CLK_SM = 16, 64
POPC_PER_PAIR, POPC_PER_CLK_SM, N_SMS = 4, 16, 132


def build_kernels():
    """Build every CUDA source of the package at once, one nvcc process
    per source; returns {source: library path}."""
    from concurrent.futures import ThreadPoolExecutor
    from xivo_tpu_torch.ops import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_build.build, names)))


def stamp(what, t_start, sep=" done:"):
    """The time since t_start, on the standard output and, so that a run
    stopped at its time limit shows how far it got, on the standard
    error."""
    line = f"{what}{sep} {time.time() - t_start:.1f} s"
    print(line, flush=True)
    print(f"chip_smoke: {line}", file=sys.stderr, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_run(cfg, torch, device, batch, frames=None, edit=None):
    """(states, inputs, gt) for `batch` copies of the PCW bench stream
    (`edit` maps the packed stream, e.g. to plant outliers)."""
    from xivo_tpu_torch.runner import inputs_to_device
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    fi, gt = build_pcw_stream(cfg, total_time=TOTAL_TIME, noise_px=0.25)
    if edit is not None:
        fi = edit(fi)
    if frames is not None:
        fi = type(fi)(*(a[:frames] for a in fi))
    fib = inputs_to_device(type(fi)(*(
        np.broadcast_to(a, (batch,) + a.shape) for a in fi)), device)
    return seeded_states(cfg, torch, device, batch, gt), fib, gt


def seeded_states(cfg, torch, device, batch, gt):
    """`batch` fresh filter states with the stream's first IMU reading."""
    from xivo_tpu_torch.runner import batch_states
    s = batch_states(cfg, batch, device)
    dt = s.P.dtype
    return s._replace(
        last_gyro=torch.tensor(gt["gyro0"], dtype=dt,
                               device=device).expand(batch, 3).clone(),
        last_accel=torch.tensor(gt["accel0"], dtype=dt,
                                device=device).expand(batch, 3).clone())


def make_image_run(cfg, torch, device, batch, stream, frames=None):
    """(states, front-end states, inputs) for `batch` sequences of the
    image stream, the images on the device once, broadcast to the batch."""
    from xivo_tpu_torch.runner import (batch_frontend_states,
                                       image_inputs_to_device)
    fi, gt = stream
    if frames is not None:
        fi = type(fi)(*(a[:frames] for a in fi))
    return (seeded_states(cfg, torch, device, batch, gt),
            batch_frontend_states(cfg, batch, device),
            image_inputs_to_device(fi, device, batch=batch))


def cuda_ms(torch, fn, reps=20):
    """Mean device time of fn() over reps calls, after a warm-up. A call's
    host side (Python, argument checks, the launch) can take longer than
    a small kernel, so the card is held by a sleep kernel while the host
    enqueues all reps, and the events then time the device alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most 2 GHz: the sleep lasts at least 2 x the host's enqueue time
    torch.cuda._sleep(int(2e9 * (2 * host_s + 0.005)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Replace module functions by wrappers that keep a copy of their
    tensor arguments, while the `with` block runs: each call's arguments
    in the function's order, keyword arguments in their places (B6's
    ``qmask``). The LK kernels' tests use it too."""

    def __init__(self, torch, module, names):
        self.torch, self.module, self.names = torch, module, names
        self.seen = {n: [] for n in names}

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            setattr(self.module, n, self._wrap(n))
        return self.seen

    def _wrap(self, name):
        sig = inspect.signature(self.orig[name])

        def fn(*args, **kw):
            self.seen[name].append(tuple(
                a.detach().clone() if self.torch.is_tensor(a) else a
                for a in sig.bind(*args, **kw).args))
            return self.orig[name](*args, **kw)
        return fn

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def random_psd(torch, batch, m, seed):
    """Well-conditioned PSD (B, m, m) float32 with planted zero rows/cols."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    dead = rng.choice(m, size=max(1, m // 10), replace=False)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return torch.tensor(G, dtype=torch.float32, device=DEV), dead


def unit_dead(torch, X):
    """X with every dead-pivot row and column replaced by the identity's:
    the input on which one library call computes the kernel's function
    (the kernels zero those rows, the library call would fail on them)."""
    keep = torch.diagonal(X, dim1=-2, dim2=-1) > 1e-30
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return torch.where(keep[..., :, None] & keep[..., None, :], X,
                       eye).contiguous()


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def row_rel_err(torch, got, ref):
    """Largest per-row error relative to the row's scale in `ref`; a row
    that `ref` leaves exactly zero must come out exactly zero."""
    diff = (got - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    rel = torch.where(scale > 0, diff / scale,
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(rel.max())


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def hold(torch, kernel, plain, cases, rival=None):
    """Hold a Cholesky-family kernel against its plain version on the
    inputs [(kind, X)], row by row: the limit on each input is ROW_TOL +
    ROW_TOL_SCALE x the plain float32 version's own row error against
    float64 there, at most ROW_TOL_CAP. `rival`, another kernel under the
    same contract, is held to the same limit. Returns (largest
    |difference| from the plain version, worst row error by kind, the
    plain version's own worst row error, worst error / limit, worst
    error / limit of the rival)."""
    err, rel, rel_plain, use, use_rival = 0.0, {}, 0.0, 0.0, 0.0
    for kind, X in cases:
        got, ref = as_tuple(kernel(X)), as_tuple(plain(X))
        ref64 = as_tuple(plain(X.double()))
        riv = as_tuple(rival(X)) if rival else (None,) * len(got)
        torch.cuda.synchronize()
        for g, r, r64, v in zip(got, ref, ref64, riv):
            if not torch.isfinite(g).all():
                raise AssertionError("non-finite kernel output")
            err = max(err, float((g - r).abs().max()))
            e = row_rel_err(torch, g, r)
            e_plain = row_rel_err(torch, r.double(), r64)
            limit = min(ROW_TOL + ROW_TOL_SCALE * e_plain, ROW_TOL_CAP)
            rel[kind] = max(rel.get(kind, 0.0), e)
            rel_plain = max(rel_plain, e_plain)
            use = max(use, e / limit)
            if v is not None:
                use_rival = max(use_rival, row_rel_err(torch, g, v) / limit)
    return err, rel, rel_plain, use, use_rival


def zero_rows_kept(X, dead):
    """Rows and columns `dead` of every output exactly zero."""
    for g in as_tuple(X):
        if g[:, dead, :].abs().max() != 0 or g[:, :, dead].abs().max() != 0:
            return False
    return True


# outputs of each Cholesky-family kernel; the library call that computes
# the same function on the input with its dead rows made unit
N_OUT = {"chol_lanes": 1, "chol_inv_lanes": 2, "tri_inv_lanes": 1,
         "chol_blocked": 1}


# B1 and B7 are one kernel (csrc/chol_blocked.cu) under two names: each
# name's timing also times the other on the same input
TWIN = {"chol_lanes": "chol_blocked", "chol_blocked": "chol_lanes"}


def chol_named(name):
    from xivo_tpu_torch.ops import chol, lanes_chol
    return {"chol_lanes": lanes_chol.chol_lanes,
            "chol_blocked": chol.cholesky_batched}[name]


def library_call(torch, name):
    if name in ("chol_lanes", "chol_blocked"):
        return lambda G: torch.linalg.cholesky_ex(G)[0]
    if name == "tri_inv_lanes":
        return lambda L: torch.linalg.solve_triangular(
            L, torch.eye(L.shape[-1], device=L.device).expand(L.shape),
            upper=False)
    return None     # no one call gives L and L^-1


def library_two_calls(torch):
    """B2's pair from the library: cholesky_ex, then solve_triangular on
    its factor (two calls, so not B2's library_ms)."""
    def pair(G):
        L = torch.linalg.cholesky_ex(G)[0]
        return L, torch.linalg.solve_triangular(
            L, torch.eye(L.shape[-1], device=L.device).expand(L.shape),
            upper=False)
    return pair


def chol_times(torch, name, kernel, plain, X):
    """Device ms of kernel, plain version and library call on X (the
    library on X with its dead rows made unit), and the bound: each
    kernel reads the lower triangle of its input and writes whole (m, m)
    outputs, and does n_out x m^3 / 3 flops a matrix."""
    batch, m, _ = X.shape
    library = library_call(torch, name)
    Xu = unit_dead(torch, X)
    n = N_OUT[name]
    bound_ms, bound_by = bound(batch * (m * (m + 1) // 2 + n * m * m) * 4,
                               n * batch * m ** 3 / 3.0)
    t = dict(ms=cuda_ms(torch, lambda: kernel(X)),
             plain_ms=cuda_ms(torch, lambda: plain(X)),
             library_ms=(cuda_ms(torch, lambda: library(Xu))
                         if library else None),
             bound_ms=bound_ms, bound_by=bound_by, shape=[batch, m, m])
    if name == "chol_inv_lanes":
        pair = library_two_calls(torch)
        t["library_two_calls_ms"] = cuda_ms(torch, lambda: pair(Xu))
    if name in TWIN:
        twin = chol_named(TWIN[name])
        t.update(twin=TWIN[name], twin_ms=cuda_ms(torch, lambda: twin(X)))
        t.update(ratio=t["ms"] / t["library_ms"],
                 twin_ratio=t["twin_ms"] / t["library_ms"])
    return t


def twin_line(name, t):
    """The one blocked kernel timed under both of its names, beside
    cholesky_ex in the same call."""
    m = t["shape"][-1]
    return (f"kernel {name}: m={m} {t['ms']:.4f} ms = {t['ratio']:.3f} x "
            f"cholesky_ex ({t['library_ms']:.4f} ms); the same kernel as "
            f"{t['twin']} {t['twin_ms']:.4f} ms = {t['twin_ratio']:.3f} x")


def two_calls_line(name, t):
    """B2 beside the two library calls that give the same pair."""
    return (f"kernel {name}: m={t['shape'][-1]} {t['ms']:.4f} ms; two "
            f"library calls (cholesky_ex, then solve_triangular) "
            f"{t['library_two_calls_ms']:.4f} ms")


# the IMU chain against its plain version, per output (chain_errors):
# float32 ~1e-5 (the plain float32 version's own error against float64 is
# ~1e-6 on these inputs: the kernel sums in another order, over ~50
# substeps), float64 1e-12
CHAIN_TOL = {"float32": 1e-5, "float64": 1e-12}
CHAIN_B = 4096          # the benchmark cells' batch
CHAIN_SHAPES = ((5, 0.01), (10, 0.005))     # (KI, slot dt s): 100, 200 Hz


def imu_chain_inputs(torch, B, KI, dtype, seed, dt=None, device=DEV):
    """The IMU chain's inputs for B rows on `device`: (X, lg, la, sg, sa,
    gyro, accel, slot dt, dt_eff), any rotation, Rsg near the identity,
    non-identity Cg and upper-triangular Ca, biases. With `dt` every slot
    is dt long and dt_eff 0, as a packed stream at that rate; else slot
    lengths of 0.5-12 ms, padded slots (0) in the middle of row 0, at the
    end of row 1 and in all of row 2, and dt_eff 0 on every third row."""
    from xivo_tpu_torch.filter.state import MotionState
    from xivo_tpu_torch.geom import so3
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def rot(scale):
        w = torch.tensor(rng.standard_normal((B, 3)) * scale)
        return t(so3.exp(w).numpy())
    eye = np.eye(3)
    X = MotionState(
        Rsb=rot(1.0), Tsb=t(rng.standard_normal((B, 3))),
        Vsb=t(rng.standard_normal((B, 3))),
        bg=t(rng.standard_normal((B, 3)) * 0.01),
        ba=t(rng.standard_normal((B, 3)) * 0.05), Rbc=rot(0.1),
        Tbc=t(np.zeros((B, 3))), Rsg=rot(0.05), td=t(np.zeros(B)),
        Cg=t(eye + rng.standard_normal((B, 3, 3)) * 0.01),
        Ca=t(np.triu(eye + rng.standard_normal((B, 3, 3)) * 0.01)))
    g0 = np.array([0.0, 9.8, 0.0])
    lg = rng.standard_normal((B, 3)) * 0.3
    la = rng.standard_normal((B, 3)) + g0
    sg, sa = rng.standard_normal((B, 3)), rng.standard_normal((B, 3))
    gy = rng.standard_normal((B, KI, 3)) * 0.3
    ac = rng.standard_normal((B, KI, 3)) + g0
    if dt is None:
        dts = rng.uniform(0.0005, 0.012, (B, KI))
        dts[0, KI // 2] = 0.0
        dts[1 % B, -1] = 0.0
        if B > 2:
            dts[2] = 0.0
        dte = rng.uniform(0.0, 0.006, B)
        dte[::3] = 0.0
    else:
        dts, dte = np.full((B, KI), dt), np.zeros(B)
    return (X, t(lg), t(la), t(sg), t(sa), t(gy), t(ac), t(dts), t(dte))


def chain_config(S=4):
    return dataclasses.replace(pcw_config(), fast_substeps=S)


def chain_errors(torch, got, ref):
    """The kernel's outputs (X, Phi, Q, lg, la, sg, sa, nprop) against the
    plain version's: for Q, |dQ_ij| / sqrt(Q_ii Q_jj) (a covariance's
    entries are bounded so; where that is 0 the entry must be exactly 0);
    for every other output the row's largest |difference| over its
    largest |entry|; nprop must be equal. Returns {output: error}."""
    torch.cuda.synchronize()
    (Xg, *g), (Xr, *r) = got, ref
    pairs = dict(Rsb=(Xg.Rsb, Xr.Rsb), Tsb=(Xg.Tsb, Xr.Tsb),
                 Vsb=(Xg.Vsb, Xr.Vsb), Phi=(g[0], r[0]), lg=(g[2], r[2]),
                 la=(g[3], r[3]), sg=(g[4], r[4]), sa=(g[5], r[5]))
    err = {}
    for name, (a, b) in pairs.items():
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        if not torch.isfinite(a).all():
            raise AssertionError(f"imu_chain: non-finite {name}")
        scale = b.abs().amax(-1, keepdim=True)
        err[name] = float(((a - b).abs() / torch.where(
            scale > 0, scale, torch.ones_like(scale))).max())
    d = torch.sqrt(torch.diagonal(r[1], dim1=-2, dim2=-1).clamp(min=0))
    den = d[:, :, None] * d[:, None, :]
    dq = (g[1] - r[1]).abs()
    if bool(((den == 0) & (dq > 0)).any()):
        raise AssertionError("imu_chain: Q off its plain version's zeros")
    err["Q"] = float(torch.where(den > 0, dq / torch.where(
        den > 0, den, torch.ones_like(den)), torch.zeros_like(dq)).max())
    if not torch.equal(g[6], r[6]):
        raise AssertionError("imu_chain: interval counts differ")
    return err


def chain_work(dts, dte, S, h0, KI):
    """(bytes, flops) of one chain call at least: the inputs read and the
    outputs written once; 67,392 flops an active substep (A: 9 x 39
    entries of 9 products, P9's 9, M's and Q's columns' 39 each)."""
    B = dts.shape[0]
    lens = np.concatenate([dts, dte[:, None]], axis=1)
    n = np.clip(np.ceil(lens / h0), 1, S) * (lens > 0)
    flops = float(n.sum()) * 2 * 351 * (9 + 9 + 39 + 39)
    n_bytes = B * ((61 + 7 * KI + 27 + 2 * 39 * 39) * 4 + 8)
    return n_bytes, flops


def check_imu_chain(torch):
    """Phase 35: hold the IMU-chain kernel against its plain version and
    time both at the benchmark cells' shapes; returns its JSON entry."""
    from xivo_tpu_torch.ops import imu_chain as ic
    worst = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        for KI, S, Bc in ((1, 4, 1), (5, 4, 257), (10, 4, 64), (11, 5, 33)):
            args = imu_chain_inputs(torch, Bc, KI, dtype, seed=KI + S)
            cfg = chain_config(S)
            n = ic.CHAIN.launches
            got = ic.imu_chain(cfg, *args)
            if ic.CHAIN.launches != n + 1:
                raise AssertionError("imu_chain: not one launch a call")
            err = chain_errors(torch, got, ic.chain_plain(cfg, *args))
            worst[name] = max([worst.get(name, 0.0)] + list(err.values()))
        print(f"kernel imu_chain: {name} random inputs, worst error "
              f"{worst[name]:.3e} (limit {CHAIN_TOL[name]:.0e})", flush=True)
        if worst[name] > CHAIN_TOL[name]:
            raise AssertionError(f"imu_chain: {name} error above its limit")
    cfg = chain_config(4)
    times = {}
    for KI, dt in CHAIN_SHAPES:
        args = imu_chain_inputs(torch, CHAIN_B, KI, torch.float32,
                                seed=KI, dt=dt)
        err = chain_errors(torch, ic.imu_chain(cfg, *args),
                           ic.chain_plain(cfg, *args))
        if max(err.values()) > CHAIN_TOL["float32"]:
            raise AssertionError(f"imu_chain: B={CHAIN_B} KI={KI} error "
                                 f"above its limit: {err}")
        n_bytes, flops = chain_work(args[7].cpu().numpy(),
                                    args[8].cpu().numpy(), 4, cfg.stepsize,
                                    KI)
        bound_ms, bound_by = bound(n_bytes, flops)
        t = dict(ms=cuda_ms(torch, lambda: ic.imu_chain(cfg, *args)),
                 plain_ms=cuda_ms(torch, lambda: ic.chain_plain(cfg, *args),
                                  reps=3),
                 bound_ms=bound_ms, bound_by=bound_by,
                 error=max(err.values()), shape=[CHAIN_B, KI, 4])
        times[f"KI{KI}"] = t
        print(f"kernel imu_chain: B={CHAIN_B} KI={KI} S=4 float32 "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB); worst error {t['error']:.3e}",
              flush=True)
    return dict(name="imu_chain", route="cuda",
                source="xivo_tpu_torch/csrc/imu_chain.cu",
                replaces="none: XLA's fusion of the unrolled lax.scan of "
                         "xivo_tpu/filter/pipeline.py:1246",
                library_ms=None, worst_error=worst, times=times)


def check_kernels(torch, lc, captured):
    """Hold each Cholesky kernel against its plain version; time all
    three."""
    results = []
    cases = {"chol_lanes": (lc.chol_lanes, lc.chol_plain),
             "chol_inv_lanes": (lc.chol_inv_lanes, lc.chol_inv_plain),
             "tri_inv_lanes": (lc.tri_inv_lanes, lc.tri_inv_plain)}
    for name, (kernel, plain) in cases.items():
        inputs = [args[0] for args in captured[name]]
        real = inputs[-1]
        batch, m, _ = real.shape
        rnd, dead = random_psd(torch, batch, m, seed=len(results))
        if name == "tri_inv_lanes":
            rnd = lc.chol_plain(rnd) + torch.diag_embed(
                torch.where(torch.diagonal(rnd, dim1=-2, dim2=-1) > 0,
                            1.0, 0.0))
        rnd = rnd.contiguous()
        err, rel, rel_plain, use, _ = hold(
            torch, kernel, plain,
            [("real", X) for X in inputs] + [("random", rnd)])
        print(f"kernel {name}: row-relative error real {rel['real']:.3e} "
              f"random {rel['random']:.3e}; plain float32 vs float64 "
              f"{rel_plain:.3e}; worst error / limit {use:.3f}", flush=True)
        if use > 1.0:
            raise AssertionError(f"{name}: row-relative error above its "
                                 f"limit ({use:.3f} x)")
        if not zero_rows_kept(kernel(rnd), dead):
            raise AssertionError(f"{name}: planted zero rows leaked")
        t = chol_times(torch, name, kernel, plain, real.contiguous())
        results.append(dict(
            name=name, route="cuda",
            source="xivo_tpu_torch/csrc/chol_blocked.cu",
            replaces=REPLACES[name], launches=None, max_abs_err=err,
            row_rel_err=max(rel.values()), **t))
        print(f"kernel {name}: shape {batch}x{m}x{m} max_abs_err {err:.3e} "
              f"ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms "
              f"{t['library_ms']} bound_ms {t['bound_ms']:.4f} "
              f"({t['bound_by']})", flush=True)
        if name in TWIN:
            print(twin_line(name, t), flush=True)
        if "library_two_calls_ms" in t:
            print(two_calls_line(name, t), flush=True)
    return results


# ---------------------------------------------------------------------------
# the image path's LK kernels
# ---------------------------------------------------------------------------

def texture(H, W, seed, dx=0.0, dy=0.0):
    """A smooth random image (a sum of plane waves) sampled at x + dx,
    y + dy: the same scene moved by (-dx, -dy). The LK kernels' tests use
    it too."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W))
    amps = rng.uniform(10.0, 30.0, 12)
    for a in amps:
        kx, ky = rng.uniform(-0.35, 0.35, 2)
        img += a * np.sin(kx * (xs + dx) + ky * (ys + dy)
                          + rng.uniform(0.0, 2 * np.pi))
    return (128.0 + 100.0 * img / amps.sum()).astype(np.float32)


def texture_lk_inputs(torch, lko, cfg, batch, n):
    """The (B4, B5) inputs of every level of one LK call on `batch`
    random textures moved by a few pixels, `n` tracks each."""
    from xivo_tpu_torch.frontend import lk as flk
    from xivo_tpu_torch.frontend.image import build_pyramid
    H, W = 256, 256
    rng = np.random.default_rng(11)
    img0 = np.stack([texture(H, W, b) for b in range(batch)])
    img1 = np.stack([texture(H, W, b, *rng.uniform(-5.0, 5.0, 2))
                     for b in range(batch)])
    pts = torch.tensor(rng.uniform(16, H - 16, (batch, n, 2)),
                       dtype=torch.float32, device=DEV)
    valid = torch.tensor(rng.uniform(size=(batch, n)) < 0.9, device=DEV)
    levels = cfg.klt_max_level
    with Recorder(torch, lko, ["sample_templates", "gn_tracks"]) as seen:
        flk.track(build_pyramid(torch.tensor(img0, device=DEV), levels),
                  build_pyramid(torch.tensor(img1, device=DEV), levels),
                  pts, pts, valid, win_size=cfg.klt_win_size,
                  iters=cfg.klt_max_iter, eps=cfg.klt_eps)
    torch.cuda.synchronize()
    return seen


def check_lk_kernels(torch, lko, captured, random_inputs, cfg):
    """Hold B4 and B5 against their plain versions; time both (B5 on each
    level of the last recorded frame)."""
    from xivo_tpu_torch.tools.lk_breakdown import chain_lengths
    eps = cfg.klt_eps
    results = []

    # B4: template windows
    real = captured["sample_templates"]
    tp = real[-1][0]
    M, S, w = tp.shape[0] * tp.shape[1], tp.shape[-1], real[-1][4]
    rng = np.random.default_rng(3)
    rnd = tuple(torch.tensor(rng.uniform(-300, 300, tp.shape),
                             dtype=torch.float32, device=DEV)
                for _ in range(3)) + (torch.tensor(
                    rng.uniform(-1.0, S - w + 1.0, tp.shape[:-2] + (2,)),
                    dtype=torch.float32, device=DEV), w)
    worst = {"real": 0.0, "random": 0.0}
    err = 0.0
    for kind, args in ([("real", a) for a in real]
                       + [("random", a) for a in random_inputs[
                           "sample_templates"]] + [("random", rnd)]):
        got = lko.sample_templates(*args)
        ref = lko.sample_templates_plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if not torch.isfinite(g).all():
                raise AssertionError("lk_sample_templates: non-finite")
            d = (g - r).abs()
            err = max(err, float(d.max()))
            scale = r.abs().amax(dim=(-2, -1))
            rel = torch.where(scale > 0, d.amax(dim=(-2, -1)) / scale,
                              torch.where(d.amax(dim=(-2, -1)) > 0,
                                          float("inf"), 0.0))
            worst[kind] = max(worst[kind], float(rel.max()))
    print(f"kernel lk_sample_templates: per-track relative error real "
          f"{worst['real']:.3e} random {worst['random']:.3e} (limit "
          f"{TMPL_TOL:g})", flush=True)
    if max(worst.values()) > TMPL_TOL:
        raise AssertionError("lk_sample_templates disagrees with its plain "
                             "version")
    args = real[-1]
    ms = cuda_ms(torch, lambda: lko.sample_templates(*args))
    plain_ms = cuda_ms(torch, lambda: lko.sample_templates_plain(*args))
    # the library yardstick: grid_sample of the three patches as channels
    # at the same clipped sample points (bilinear, border, corners aligned)
    F = torch.nn.functional
    chans = torch.stack([a.reshape(M, S, S) for a in args[:3]], dim=1)
    start = args[3].reshape(M, 2).clamp(0.0, S - w - 1 + 0.999)
    ar = torch.arange(w, device=DEV, dtype=torch.float32)
    gx = (start[:, 0, None, None] + ar[None, None, :]).expand(M, w, w)
    gy = (start[:, 1, None, None] + ar[None, :, None]).expand(M, w, w)
    grid = (torch.stack([gx, gy], dim=-1) * (2.0 / (S - 1)) - 1.0)

    def library():
        return F.grid_sample(chans, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    lib_err = float((library()[:, 0] - lko.sample_templates_plain(*args)[0]
                     .reshape(M, w, w)).abs().max())
    library_ms = cuda_ms(torch, library)
    # least bytes: the (w + 1)^2 entries it needs of each of its three
    # patches and its position, read once; three w x w windows written.
    # Operations: 9 per window entry (two row lerps, one column lerp).
    n_bytes = M * (3 * (w + 1) ** 2 + 2) * 4 + 3 * M * w * w * 4
    bound_ms, bound_by = bound(n_bytes, 27 * M * w * w)
    print(f"kernel lk_sample_templates: shape {M}x{S}x{S} -> 3x{M}x{w}x{w} "
          f"max_abs_err {err:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} (grid_sample, max |diff| vs plain "
          f"{lib_err:.2e}) bound_ms {bound_ms:.5f} ({bound_by})", flush=True)
    results.append(dict(
        name="lk_sample_templates", route="cuda",
        source="xivo_tpu_torch/csrc/lk.cu", replaces=REPLACES[
            "lk_sample_templates"], launches=None, max_abs_err=err,
        row_rel_err=max(worst.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=[M, S, S]))

    # B5: the Gauss-Newton loop
    stats = {"live": 0, "flags_differ": 0, "converged": 0,
             "unconverged": 0}
    dconv = dunconv = dsame = 0.0
    for args in captured["gn_tracks"] + random_inputs["gn_tracks"]:
        sp, T, Gx, Gy, sc, pt, st, iters = args
        pk, sk = lko.gn_tracks(*args)
        pp, spl = lko.gn_tracks_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(pk).all():
            raise AssertionError("lk_gn_tracks: non-finite positions")
        live = st[..., 0] < 0.5
        same = (sk == spl).all(dim=-1) & live
        conv = same & (spl[..., 0] > 0.5) & (spl[..., 1] < 0.5)
        unconv = same & (spl[..., 0] < 0.5)
        d = (pk - pp).abs().amax(dim=-1)
        n_live, n_same = int(live.sum()), int(same.sum())
        stats["live"] += n_live
        stats["flags_differ"] += n_live - n_same
        stats["converged"] += int(conv.sum())
        stats["unconverged"] += int(unconv.sum())
        if n_same < GN_FLAG_SHARE * n_live:
            raise AssertionError(f"lk_gn_tracks: flags differ on "
                                 f"{n_live - n_same} of {n_live} tracks")
        dconv = max(dconv, float(torch.where(conv, d, 0.0).max()))
        dunconv = max(dunconv, float(torch.where(unconv, d, 0.0).max()))
        dsame = max(dsame, float(torch.where(same, d, 0.0).max()))
        lo, hi = sc[..., 4:6], sc[..., 6:8]
        inbox = ((pk >= lo) & (pk <= hi)).all(dim=-1)
        if not bool((inbox | ~live).all()):
            raise AssertionError("lk_gn_tracks: an iterate left its box")
        if not (torch.equal(pk[~live], pt[~live])
                and torch.equal(sk[~live], st[~live])):
            raise AssertionError("lk_gn_tracks: a done track moved")
    print(f"kernel lk_gn_tracks: {stats['live']} live tracks, flags differ "
          f"on {stats['flags_differ']} (limit "
          f"{(1 - GN_FLAG_SHARE) * 100:.1f} %); converged in both "
          f"{stats['converged']}, max |dpos| {dconv:.3e} px (limit "
          f"{2 * eps:g}); unconverged in both {stats['unconverged']}, max "
          f"|dpos| {dunconv:.3e} px (limit {GN_UNCONV_TOL:g})", flush=True)
    if dconv >= 2 * eps:
        raise AssertionError("lk_gn_tracks: converged positions disagree")
    if dunconv >= GN_UNCONV_TOL:
        raise AssertionError("lk_gn_tracks: unconverged positions disagree")
    # the last recorded frame's launches, one a level, coarse to fine:
    # its last is level 0, the row PERF.md keeps
    frame = captured["gn_tracks"][-cfg.klt_max_level:]
    level_ms = [cuda_ms(torch, lambda a=a: lko.gn_tracks(*a)) for a in frame]
    args = frame[-1]
    sp, T, Gx, Gy, sc, pt, st, iters = args
    ms = level_ms[-1]
    plain_ms = cuda_ms(torch, lambda: lko.gn_tracks_plain(*args))
    M, S, w = T.shape[0] * T.shape[1], sp.shape[-1], T.shape[-1]
    n_live = int((st[..., 0] < 0.5).sum())
    # iterations each track runs (the plain loop a step at a time): the
    # sum for the bound's operations, the largest the longest chain
    chains = chain_lengths(args)
    n_iter, max_chain = int(chains.sum()), int(chains.max())
    # least bytes: a live track reads T, Gx, Gy, one (w + 1)^2 window of
    # its search patch, its 9 scalars, position and state; every track
    # reads and writes its position and state. Operations, per iteration
    # this data ran: 14 per window entry (bilinear 9, residual 1, two
    # multiply-adds) and ~20 for the 2 x 2 step.
    n_bytes = (n_live * (3 * w * w + (w + 1) ** 2 + 9) + M * 8) * 4
    bound_ms, bound_by = bound(n_bytes, n_iter * (14 * w * w + 20))
    print(f"kernel lk_gn_tracks: shape {M}x{S}x{S}, {n_live} live tracks, "
          f"{n_iter} iterations in all ({iters} at most each) ms {ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms None bound_ms "
          f"{bound_ms:.5f} ({bound_by}); longest chain {max_chain} "
          f"iterations", flush=True)
    print(f"kernel lk_gn_tracks: a frame's {len(frame)} launches, levels "
          f"{len(frame) - 1} to 0: " + ", ".join(f"{t:.4f}" for t in level_ms)
          + f" ms, sum {sum(level_ms):.4f} ms (level 0: {ms:.4f} ms)",
          flush=True)
    results.append(dict(
        name="lk_gn_tracks", route="cuda", source="xivo_tpu_torch/csrc/lk.cu",
        # max_abs_err: positions of the tracks whose flags agree
        replaces=REPLACES["lk_gn_tracks"], launches=None, max_abs_err=dsame,
        flags_differ=stats["flags_differ"], live_tracks=stats["live"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=[M, S, S], gn_iterations=n_iter,
        max_chain=max_chain, level_ms=level_ms, frame_ms=sum(level_ms)))
    return results


def image_config(camera=None, **tracker):
    """Phase 8's config (IMG_BENCH_CFG, fast propagation, the square-root
    form, IMG_BENCH_DIMS), through `camera` where given, with its
    tracker_cfg updated by `tracker`."""
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.filter.layout import Dims
    from xivo_tpu_torch.sim.configs import IMG_BENCH_CFG, IMG_BENCH_DIMS
    raw = dict(IMG_BENCH_CFG,
               tracker_cfg=dict(IMG_BENCH_CFG["tracker_cfg"], **tracker))
    if camera is not None:
        raw["camera_cfg"] = dict(camera)
    return config_from_json(raw, dtype="float32", propagation_mode="fast",
                            covariance_form="sqrt",
                            dims=Dims(**IMG_BENCH_DIMS))


def counted(torch, kernels, fn, sync_check=True):
    """Run fn with every launch counter at 0 and (with sync_check) the
    sync debug mode set to raise; return (fn's result, wall s, launches
    by kernel)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    # the frame loop must never wait for the device: any PyTorch call that
    # synchronizes (.item(), a copy from pageable memory, ...) raises here
    torch.cuda.set_sync_debug_mode("error" if sync_check else "default")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.name: k.launches for k in kernels}


def chain_launches(cfg, T):
    """{the IMU chain's name: its launches over T frame steps of `cfg`}: one
    a step on fast propagation's static grid (``fast_substeps > 0``), none
    on every other path."""
    from xivo_tpu_torch.ops import imu_chain as ic
    grid = cfg.propagation_mode == "fast" and cfg.fast_substeps > 0
    return {ic.CHAIN.name: T if grid else 0}


def pcw_config():
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.configs import PCW_CFG
    return config_from_json(PCW_CFG, dtype="float32",
                            sim_initialize_depths=True,
                            propagation_mode="fast", covariance_form="sqrt")


def pcw_phases(torch, lc, others):
    """Phases 3-5: returns the B1-B3 JSON entries, the base config's
    ATE-RMSE of sequence 0 and the launches of every kernel (`others`:
    the kernels not on this path, counted at 0)."""
    from xivo_tpu_torch.runner import run_batch
    cfg = pcw_config()
    assert (cfg.dims.full, cfg.propagation_mode) == (228, "fast")
    assert cfg.fast_substeps > 0    # the IMU chain: one launch a frame step

    # phase 3: a few frames with the kernels' inputs recorded
    names = [k.name for k in lc.KERNELS]
    with Recorder(torch, lc, names) as captured:
        s, fib, _ = make_run(cfg, torch, DEV, B, frames=CAPTURE_FRAMES)
        run_batch(cfg, s, fib)
        torch.cuda.synchronize()
    kernels = check_kernels(torch, lc, captured)
    del captured

    # phase 4: CUDA kernels vs the CPU path on a small batch
    s, fib, _ = make_run(cfg, torch, DEV, 2, frames=10)
    _, out_gpu = run_batch(cfg, s, fib)
    s, fib, _ = make_run(cfg, torch, "cpu", 2, frames=10)
    _, out_cpu = run_batch(cfg, s, fib)
    dpos = float((out_gpu.Tsb.cpu() - out_cpu.Tsb).abs().max())
    print(f"cuda vs cpu path, 10 frames: max |dTsb| {dpos:.3e} m", flush=True)
    if not dpos < 1e-3:
        raise AssertionError(f"CUDA path disagrees with the CPU path: {dpos}")

    # phase 5: the main path, counted
    s, fib, gt = make_run(cfg, torch, DEV, B)
    T = int(fib.frame_dt.shape[1])
    (s, outs), wall, launches = counted(
        torch, lc.KERNELS + others, lambda: run_batch(cfg, s, fib))
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb[0] - gt["Tsb"], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    print(f"main path: B={B} T={T} D={cfg.dims.full} wall {wall:.3f} s "
          f"frames/s {B * T / wall:.1f} ATE-RMSE(seq 0) {ate:.5f} m "
          f"launches {launches} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    if not ate < ATE_BOUND:
        raise AssertionError(f"ATE {ate} >= {ATE_BOUND}")
    expect = {k.name: T for k in lc.KERNELS}
    expect.update({k.name: 0 for k in others})
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    return kernels, ate, launches


def image_phases(torch, lc, lko, others):
    """Phases 6-8: returns the B4-B5 JSON entries and the launches of
    every kernel on the image main path."""
    from xivo_tpu_torch.runner import run_batch_image
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    cfg = image_config()
    assert cfg.dims.full == 228 and tuple(cfg.cam_params[:2]) == (512, 512)
    t0 = time.time()
    stream = build_image_stream(cfg)
    n_frames = stream[0].image.shape[0]
    print(f"image stream: {n_frames} frames of "
          f"{stream[0].image.shape[1]}x{stream[0].image.shape[2]} rendered "
          f"in {time.time() - t0:.1f} s", flush=True)

    # phase 6: a few frames with the LK kernels' inputs recorded
    with Recorder(torch, lko, ["sample_templates", "gn_tracks"]) as captured:
        s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream,
                                   frames=IMG_CAPTURE_FRAMES)
        run_batch_image(cfg, s, f, fib)
        torch.cuda.synchronize()
    random_inputs = texture_lk_inputs(torch, lko, cfg, IMG_B,
                                      cfg.dims.nf_rows)
    kernels = check_lk_kernels(torch, lko, captured, random_inputs, cfg)
    del captured, random_inputs

    # phase 7: CUDA image path vs the CPU image path on a small batch.
    # The bench config's admission gate keeps features out of the state
    # for the first frames, so a second case with the default gate has
    # the filter update run on image tracks from frame ~3 on.
    open_cfg = dataclasses.replace(cfg, max_depth_var_for_admission=np.inf)
    for label, c, frames in (("bench config", cfg, IMG_CMP_FRAMES),
                             ("default admission gate", open_cfg,
                              IMG_CMP_OPEN_FRAMES)):
        s, f, fib = make_image_run(c, torch, DEV, 2, stream, frames=frames)
        _, _, out_gpu = run_batch_image(c, s, f, fib)
        s, f, fib = make_image_run(c, torch, "cpu", 2, stream, frames=frames)
        _, _, out_cpu = run_batch_image(c, s, f, fib)
        dpos = float((out_gpu.Tsb.cpu() - out_cpu.Tsb).abs().max())
        same = True
        for name in ("num_tracked", "num_instate_features"):
            x = getattr(out_gpu, name).cpu().numpy()
            y = getattr(out_cpu, name).numpy()
            same &= bool((x == y).all())
            print(f"image cuda vs cpu path, {label}: {name} cuda "
                  f"{x[0].tolist()} cpu {y[0].tolist()}", flush=True)
        print(f"image cuda vs cpu path, {label}, {frames} frames: max "
              f"|dTsb| {dpos:.3e} m", flush=True)
        if not dpos < IMG_PATH_TOL or not same:
            raise AssertionError(f"the CUDA image path disagrees with the "
                                 f"CPU image path ({label})")

    # phase 8: the image main path, counted
    s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream)
    T = int(fib.frame_dt.shape[1])
    (s, f, outs), wall, launches = counted(
        torch, lc.KERNELS + lko.KERNELS + others,
        lambda: run_batch_image(cfg, s, f, fib))
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    gt = stream[1]
    err = np.linalg.norm(Tsb[0] - gt["Tsb"], axis=1)
    ntr = outs.num_tracked.cpu().numpy()
    inst = outs.num_instate_features.cpu().numpy()
    print(f"image main path: B={IMG_B} T={T} 512x512 D={cfg.dims.full} "
          f"wall {wall:.3f} s sequence-frames/s {IMG_B * T / wall:.1f} "
          f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches {launches}", flush=True)
    print(f"image main path, sequence 0: final error {err[-1]:.4f} m "
          f"(bound {IMG_FINAL_BOUND}), median {np.median(err):.4f} m (bound "
          f"{IMG_MEDIAN_BOUND}), RMSE {np.sqrt(np.mean(err ** 2)):.4f} m; "
          f"tracked from frame 10 at least {int(ntr[0, 10:].min())} "
          f"(bound {IMG_MIN_TRACKED}); features in the state from frame "
          f"{int(np.argmax(inst[0] > 0)) if inst[0].any() else None}, "
          f"{int(inst[0, -1])} at the end; "
          f"all sequences: final error "
          f"{np.linalg.norm(Tsb[:, -1] - gt['Tsb'][-1], axis=1).max():.4f}"
          f" m at most", flush=True)
    if not (err[-1] < IMG_FINAL_BOUND and np.median(err) < IMG_MEDIAN_BOUND
            and ntr[0, 10:].min() >= IMG_MIN_TRACKED):
        raise AssertionError("image path outside the reference's bounds")
    expect = {k.name: T for k in lc.KERNELS}
    expect.update({k.name: cfg.klt_max_level * T for k in lko.KERNELS})
    expect.update({k.name: 0 for k in others})
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    return kernels, launches


# ---------------------------------------------------------------------------
# the mapped path (map, loop closure, bundle adjustment) and B6
# ---------------------------------------------------------------------------

def mapped_config(**over):
    """The mapped PCW config: diag_kidnap_pcw.py's mapper settings."""
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.configs import PCW_CFG
    kw = dict(dtype="float32", sim_initialize_depths=True,
              propagation_mode="fast", covariance_form="sqrt",
              use_mapper=True, lc_keyframe_every=8, lc_min_age_frames=120,
              lc_nn_dist_thresh=5, lc_min_matches=5, X_Vsb=(0.9, 0.0, 0.45))
    kw.update(over)
    return config_from_json(PCW_CFG, **kw)


def mapped_stream(cfg):
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    return build_pcw_stream(cfg, total_time=MAP_TOTAL_TIME, noise_px=0.25,
                            motion="loop", n_points=600)


def make_mapped_run(cfg, torch, device, batch, stream, frames=None,
                    capacity=None):
    """(states, maps, inputs, gt) for `batch` copies of the loop stream."""
    from xivo_tpu_torch.runner import batch_maps, inputs_to_device
    fi, gt = stream
    if frames is not None:
        fi = type(fi)(*(a[:frames] for a in fi))
    fib = inputs_to_device(type(fi)(*(
        np.broadcast_to(a, (batch,) + a.shape) for a in fi)), device)
    maps = batch_maps(capacity or cfg.map_capacity, batch, device,
                      dtype=torch.float32)
    return seeded_states(cfg, torch, device, batch, gt), maps, fib, gt


def window(fib, lo, hi):
    return type(fib)(*(x[:, lo:hi] for x in fib))


def moved(torch, tree, device):
    """A (nested) tuple of tensors moved to `device`: what later phases
    take waits on the host, so that it adds nothing to the peak memory
    that the phases between read."""
    from xivo_tpu_torch.filter.state import tree_map
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, tree)


def counted_split(torch, kernels, run, carry, fib, a, seeds,
                  after=lambda: None):
    """`counted` over every frame of `fib` in two calls, frames [0, a) and
    then the rest, so that the main run makes on its way the state at
    frame a (phase 12's: phases 10 and 34 start there). run(carry,
    inputs, seed) returns
    the new carry followed by the frames' outputs (B, T, ...); `after()`
    runs after each call, outside the sync check. Returns (the carry at
    frame a, the final carry and outputs joined along the frame axis, the
    two calls' wall s and launches summed, the larger of their peak
    memories in bytes, after()'s two results)."""
    T, n = int(fib.frame_dt.shape[1]), len(carry)
    parts, wall, launches, peak, checks = [], 0.0, {}, 0, []
    for (lo, hi), seed in zip(((0, a), (a, T)), seeds):
        res, w, got = counted(torch, kernels, lambda: run(
            carry, window(fib, lo, hi), seed))
        checks.append(after())
        peak = max(peak, torch.cuda.max_memory_allocated())
        wall += w
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        carry = tuple(res[:n])
        parts.append(res[n:])
        if lo == 0:
            at_a = carry

    def join(x, y):
        if isinstance(x, tuple):
            return type(x)(*(join(p, q) for p, q in zip(x, y)))
        return torch.cat((x, y), 1)
    return (at_a, carry + tuple(join(x, y) for x, y in zip(*parts)), wall,
            launches, peak, checks)


def max_sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out)


def hamming_bound(torch, q, desc, valid, clock_mhz, qmask=None):
    """What the function must move and do on this input: the unmasked
    queries, the mask and the query-row mask read once, the words of the
    valid entries of every sequence with an unmasked query only (an
    invalid entry's words decide nothing), dist and idx written once for
    every row (int64 words, bool masks); a distance for (unmasked query,
    valid entry) pairs only. Returns (bound ms, what bounds it, bytes,
    pairs)."""
    B, F, W = q.shape
    n_q = (torch.full((B,), F, device=q.device) if qmask is None
           else qmask.sum(1))
    n_v = valid.sum(1)
    n_entries = int(torch.where(n_q > 0, n_v, 0).sum())
    n_bytes = (int(n_q.sum()) + n_entries) * W * 8 + valid.numel() \
        + (0 if qmask is None else qmask.numel()) + 2 * B * F * 8
    n_pairs = int((n_q * n_v).sum())
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    clk_per_pair = max(LOGIC_PER_PAIR / LOGIC_PER_CLK_SM,
                       POPC_PER_PAIR / POPC_PER_CLK_SM)
    t_ops = n_pairs * clk_per_pair / (N_SMS * clock_mhz * 1e6) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", n_bytes, n_pairs)


def random_hamming_inputs(torch, B, M, F, seed):
    """Random descriptors with F // 2 queries planted as exact copies of
    map rows 5000..., those rows repeated at 15000... (ties: the first
    copy must win), copies in an invalid tail that must not be found, and
    sequence 1 all invalid."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)

    def words(*shape):
        return torch.randint(0, 2 ** 32, shape, generator=g, device=DEV,
                             dtype=torch.int64)
    desc, q = words(B, M, 8), words(B, F, 8)
    h = F // 2
    desc[:, 15000:15000 + h] = desc[:, 5000:5000 + h]
    q[:, :h] = desc[:, 5000:5000 + h]
    desc[:, M - h:] = q[:, F - h:]
    valid = torch.ones((B, M), dtype=torch.bool, device=DEV)
    valid[:, M - 2 * h:] = False
    valid[1] = False
    return q.contiguous(), desc.contiguous(), valid.contiguous()


def hamming_cases(torch, captured):
    """Phase 10's inputs, (label, (q, desc, valid, qmask or None)): the
    recorded calls as the path made them and, where it passed a query-row
    mask, without it; random descriptors at M = 20000 (F = 256 and 30)
    without a mask, with a random one and with every row masked."""
    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    cases = []
    for k, args in enumerate(captured):
        q, d, v, qm = tuple(args) + (None,) * (4 - len(args))
        cases.append((f"recorded {k}", (q, d, v, qm)))
        if qm is not None:
            cases.append((f"recorded {k} unmasked", (q, d, v, None)))
    for F in (256, 30):
        q, d, v = random_hamming_inputs(torch, MAP_B, 20000, F, seed=F)
        shape = (MAP_B, F)
        cases += [
            ("random", (q, d, v, None)),
            ("random masked", (q, d, v, torch.rand(
                shape, generator=g, device=DEV) < 0.3)),
            ("random all masked", (q, d, v, torch.zeros(
                shape, dtype=torch.bool, device=DEV)))]
    return cases


def hamming_timed(torch, hm, label, args, clock):
    """Kernel and plain version timed on one input, beside its bound."""
    q, d, v, qm = args
    ms = cuda_ms(torch, lambda: hm.hamming_nn(q, d, v, qm))
    plain_ms = cuda_ms(torch, lambda: hm.hamming_nn_plain(q, d, v, qm),
                       reps=3)
    bound_ms, bound_by, n_bytes, n_pairs = hamming_bound(torch, q, d, v,
                                                         clock, qm)
    B, F = q.shape[:2]
    rows = B * F if qm is None else int(qm.sum())
    print(f"kernel hamming_nn ({label}): B={B} F={F} M={d.shape[1]} "
          f"({int(v.sum())} valid, {rows} unmasked rows) ms {ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms None bound_ms "
          f"{bound_ms:.5f} ({bound_by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_pairs:.3e} pairs at {clock:.0f} MHz)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=[B, F, d.shape[1]],
                unmasked_rows=rows)


def check_hamming(torch, hm, captured):
    """Phase 10: B6 against its plain version, exactly, with and without
    the query-row mask; times beside bounds."""
    clock = max_sm_clock_mhz()
    for k, args in enumerate(captured):
        if len(args) > 3 and args[3] is not None:
            per = args[3].sum(1)
            print(f"kernel hamming_nn: recorded call {k} (F="
                  f"{args[0].shape[1]}) leaves {int(per.sum())} rows "
                  f"unmasked, {int(per.min())}-{int(per.max())} a "
                  f"sequence", flush=True)
        else:
            print(f"kernel hamming_nn: recorded call {k} (F="
                  f"{args[0].shape[1]}) has no query-row mask", flush=True)
    cases = hamming_cases(torch, captured)
    n_q = n_diff = err = 0
    for kind, (q, d, v, qm) in cases:
        gd, gi = hm.hamming_nn(q, d, v, qm)
        pd, pi = hm.hamming_nn_plain(q, d, v, qm)
        torch.cuda.synchronize()
        n_q += gd.numel()
        n_diff += int(((gd != pd) | (gi != pi)).sum())
        err = max(err, int((gd - pd).abs().max()), int((gi - pi).abs().max()))
        on = torch.ones_like(gd, dtype=torch.bool) if qm is None else qm
        if not (bool((gd[~on] == hm.NO_MATCH).all())
                and bool((gi[~on] == 0).all())):
            raise AssertionError(f"hamming_nn ({kind}): a masked row is "
                                 f"not (10000, 0)")
        if kind == "random":
            h = q.shape[1] // 2
            want = torch.arange(5000, 5000 + h, device=DEV)
            if not (bool((gi[0, :h] == want).all())
                    and bool((gd[0, :h] == 0).all())
                    and bool((gd[1] == hm.NO_MATCH).all())
                    and bool((gi[1] == 0).all())):
                raise AssertionError("hamming_nn: planted copies, ties or "
                                     "the all-invalid sequence wrong")
    print(f"kernel hamming_nn: {n_q} query rows over {len(cases)} inputs "
          f"(recorded and random, with and without the query-row mask), "
          f"{n_diff} differ from the plain version (required: 0), largest "
          f"|difference| {err}", flush=True)
    if n_diff:
        raise AssertionError("hamming_nn disagrees with its plain version")
    # the retirement search (the 256-row table) with its mask and without,
    # the closure search (the 30 in-state slots), and every entry valid
    real = [tuple(a) + (None,) * (4 - len(a)) for a in captured]
    q, d, v, _ = next(a for k, a in cases
                      if k == "random" and a[0].shape[1] == 256)
    out = {label: hamming_timed(torch, hm, label, args, clock)
           for label, args in (
               ("masked", real[0]), ("wide", real[0][:3] + (None,)),
               ("narrow", real[-1]),
               ("random", (q, d, torch.ones_like(v), None)))}
    entry = dict(
        name="hamming_nn", route="cuda",
        source="xivo_tpu_torch/csrc/hamming.cu",
        replaces=REPLACES["hamming_nn"], launches=None, max_abs_err=err,
        differ=n_diff, n_queries=n_q, library_ms=None)
    entry.update(out.pop("wide"))
    for label, t in out.items():
        entry.update({f"{k}_{label}": x for k, x in t.items()})
    return entry


def compare_retire(torch, cfg, s, ms, dtype=None):
    """retire_features with fusion on, on the card and on the CPU, from
    the same state and map (a CUDA run's, its floating tensors cast to
    `dtype` if given): every live non-gauge row is retired, so rows whose
    descriptors the map holds fuse. Returns the CUDA map, the CPU map,
    whether their tables are equal, the largest |difference| of the
    positions (m) and of the covariances over their largest entry."""
    from xivo_tpu_torch.filter.state import FS_GAUGE, tree_map
    from xivo_tpu_torch.map.mapper import retire_features
    c = dataclasses.replace(cfg, map_merge_on_retire=True)
    if dtype is not None:
        s, ms = tree_map(lambda x: x.to(dtype) if x.is_floating_point()
                         else x, (s, ms))
    fr = s.features
    mask = fr.active & (fr.status != FS_GAUGE)
    got = retire_features(c, s, ms, mask)
    ref = retire_features(c, *tree_map(lambda x: x.cpu(), (s, ms, mask)))
    got = tree_map(lambda x: x.cpu(), got)
    same = all(torch.equal(getattr(got, k), getattr(ref, k)) for k in (
        "desc", "gid", "epoch", "valid", "write_ptr", "count", "n_merged"))
    dx = float((got.Xs - ref.Xs).abs().max())
    dcov = float((got.cov - ref.cov).abs().max() / ref.cov.abs().max())
    return got, ref, same, dx, dcov


def compare_mapped_paths(torch, cfg, stream):
    """Phase 11: the CUDA mapped path against the CPU one as configured
    (fusion on retirement on), same draws; then retire_features with
    fusion from the CUDA run's live state, on both devices, in float32
    and in float64."""
    from xivo_tpu_torch.map.p3p import N_HYPS
    from xivo_tpu_torch.runner import run_batch_mapped
    c = dataclasses.replace(cfg, lc_min_age_frames=MAP_CMP_AGE)
    g = torch.Generator()
    g.manual_seed(7)
    u = torch.rand((2, MAP_CMP_FRAMES, N_HYPS, c.dims.n_features),
                   generator=g, dtype=torch.float32)
    res = {}
    for dev in (DEV, "cpu"):
        t0 = time.time()
        s, ms, fib, _ = make_mapped_run(c, torch, dev, 2, stream,
                                        frames=MAP_CMP_FRAMES,
                                        capacity=MAP_CMP_CAPACITY)
        s, ms, out, lcs = run_batch_mapped(c, s, ms, fib, uniforms=u.to(dev))
        res[dev] = (s, ms, out.Tsb.cpu(), lcs.cpu())
        print(f"mapped {dev} path: {MAP_CMP_FRAMES} frames in "
              f"{time.time() - t0:.1f} s", flush=True)
    (s, ms, tg, lg), (_, mc, tc, lcc) = res[DEV], res["cpu"]
    cg, cc = ms.count.cpu(), mc.count
    ng, nc = ms.n_merged.cpu(), mc.n_merged
    dpos = (tg - tc).abs().amax(dim=(0, 2))               # by frame
    apart = torch.nonzero((dpos >= MAP_POSE_EPS)
                          | (lg != lcc).any(dim=0)).flatten().tolist()
    first = [[int(torch.nonzero(x[b])[0]) if bool(x[b].any()) else None
              for b in range(2)] for x in (lg, lcc)]
    tot_g, tot_c = int(lg.sum()), int(lcc.sum())
    flips = int((ng - nc).abs().max())
    print(f"mapped cuda vs cpu path (fusion on): max |dTsb| "
          f"{float(dpos.max()):.3e} m; map count cuda {cg.tolist()} cpu "
          f"{cc.tolist()}; fusions cuda {ng.tolist()} cpu {nc.tolist()}; "
          f"first closure frame cuda {first[0]} cpu {first[1]}; closure rows "
          f"cuda {tot_g} cpu {tot_c}; frames where poses part by "
          f"{MAP_POSE_EPS} m or closure rows differ: {apart[:8]}"
          f"{' ...' if len(apart) > 8 else ''}", flush=True)
    if not (float(dpos.max()) < MAP_PATH_TOL
            and torch.equal(cg + ng, cc + nc) and int(nc.min()) > 0
            and flips <= MAP_FLIP_SHARE * int(nc.min())
            and first[0] == first[1] and None not in first[0]
            and abs(tot_g - tot_c) <= MAP_CLOSURE_SHARE * tot_c):
        raise AssertionError("the CUDA mapped path disagrees with the CPU "
                             "mapped path")
    for dtype, tol in ((None, MAP_FUSE_TOL32), (torch.float64,
                                                MAP_FUSE_TOL64)):
        got, ref, same, dx, dcov = compare_retire(torch, c, s, ms, dtype)
        fused = (ref.n_merged - mc.n_merged).tolist()
        print(f"retire_features with fusion, cuda vs cpu, "
              f"{ref.Xs.dtype}: {fused} fusions, tables "
              f"{'equal' if same else 'DIFFER'}, max |dXs| {dx:.3e} m, "
              f"covariance {dcov:.3e} of its largest entry (limit {tol} "
              f"for both)", flush=True)
        if not (same and min(fused) > 0 and dx < tol and dcov < tol):
            raise AssertionError("retire_features' fusion differs between "
                                 "the card and the CPU")


def mapped_phases(torch, lc, hm, others):
    """Phases 10-12: returns (the B6 JSON entry, launches on the mapped
    main path, the config, the state and maps at frame MAP_CAPTURE_FRAME
    + 1, and that frame's recorded B6 inputs (q, desc, valid) on the
    host)."""
    from xivo_tpu_torch.runner import run_batch_mapped
    cfg = mapped_config()
    stream = mapped_stream(cfg)

    # phase 11 (first: it also makes the path's device constants, which
    # the counted run below must find made)
    compare_mapped_paths(torch, cfg, stream)

    # phase 12: the mapped main path, counted, in two calls: frames
    # before MAP_CAPTURE_FRAME, then the rest
    s, ms, fib, gt = make_mapped_run(cfg, torch, DEV, MAP_B, stream,
                                     frames=MAP_FRAMES)
    T = int(fib.frame_dt.shape[1])
    a = MAP_CAPTURE_FRAME
    (st, m), (s, ms, outs, lcs), wall, launches, peak, _ = counted_split(
        torch, lc.KERNELS + hm.KERNELS + others,
        lambda c, w, seed: run_batch_mapped(cfg, *c, w, seed=seed),
        (s, ms), fib, a, (0, 1))
    # from the main run's state at frame 130: that frame's three
    # searches' inputs, kept for phase 10, and the state after it, which
    # phase 34 starts from
    with Recorder(torch, hm, ["hamming_nn"]) as seen:
        after = run_batch_mapped(cfg, st, m, window(fib, a, a + 1),
                                 seed=2)[:2]
    del st, m
    torch.cuda.synchronize()
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb[0] - gt["Tsb"][:T], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    lcs = lcs.cpu().numpy()
    count, merged = ms.count.cpu().numpy(), ms.n_merged.cpu().numpy()
    first = int(np.argmax(lcs[0] > 0)) if lcs[0].any() else None
    all_ate = np.sqrt(np.mean(np.linalg.norm(Tsb - gt["Tsb"][None, :T],
                                             axis=2)
                              ** 2, axis=1))
    print(f"mapped main path: B={MAP_B} T={T} D={cfg.dims.full} maps of "
          f"{cfg.map_capacity} (frames 0-{a - 1} and {a}-{T - 1} as two "
          f"calls) wall {wall:.3f} s sequence-frames/s "
          f"{MAP_B * T / wall:.1f} peak_mem_GB {peak / 1e9:.2f} launches "
          f"{launches}", flush=True)
    print(f"mapped main path, sequence 0: ATE-RMSE {ate:.5f} m (bound "
          f"{MAP_ATE_BOUND}), final error {err[-1]:.5f} m, closure rows "
          f"{int(lcs[0].sum())} (bound > {MAP_MIN_CLOSURES}) from frame "
          f"{first}, map count {int(count[0])}, fusions {int(merged[0])}; "
          f"all sequences: ATE-RMSE {all_ate.min():.5f}-{all_ate.max():.5f}"
          f" m, closure rows {int(lcs.sum(1).min())}-"
          f"{int(lcs.sum(1).max())}, map count {int(count.min())}-"
          f"{int(count.max())}", flush=True)
    if not (ate < MAP_ATE_BOUND and lcs[0].sum() > MAP_MIN_CLOSURES
            and count.min() > 0):
        raise AssertionError("mapped path outside its bounds")
    expect = {"chol_lanes": T, "chol_inv_lanes": 2 * T,
              "tri_inv_lanes": 2 * T, "hamming_nn": 3 * T}
    expect.update({k.name: 0 for k in others})
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")

    # phase 10: B6 against its plain version
    entry = check_hamming(torch, hm, seen["hamming_nn"])
    entry["launches"] = launches["hamming_nn"]
    searches = [moved(torch, tuple(a[:3]), "cpu")
                for a in seen["hamming_nn"]]
    return entry, launches, cfg, after, searches


def synthetic_bigmap(torch, cfg, n_lm=4096, n_kf=256, obs=4, noise=0.05,
                     seed=0):
    """tests/test_bigmap.py's synthetic map at the long-horizon sizes:
    keyframes along a line, each landmark seen by `obs` keyframes near
    it; landmarks and all keyframes but the first two moved by noise."""
    from xivo_tpu_torch.geom import so3
    from xivo_tpu_torch.map.bigmap import init_bigmap
    rng = np.random.default_rng(seed)
    bm = init_bigmap(cfg, capacity=n_lm, obs_cap=8, kf_capacity=n_kf,
                     dtype=torch.float32, device=DEV)
    kf_R = so3.exp(torch.tensor(rng.normal(0, 0.05, (n_kf, 3)))).numpy()
    kf_T = np.stack([0.4 * np.arange(n_kf) - 2.0,
                     0.1 * rng.normal(size=n_kf), np.zeros(n_kf)], 1)
    Xs = np.stack([rng.uniform(-2.0, 0.4 * n_kf - 2.0, n_lm),
                   rng.uniform(-2, 2, n_lm), rng.uniform(4, 8, n_lm)], 1)
    obs_kf = np.full((n_lm, 8), -1, np.int64)
    obs_xn = np.zeros((n_lm, 8, 2))
    for li in range(n_lm):
        near = np.argsort(np.abs(kf_T[:, 0] - Xs[li, 0]))[:3 * obs]
        for oi, k in enumerate(rng.choice(near, obs, replace=False)):
            Xc = kf_R[k].T @ (Xs[li] - kf_T[k])
            obs_kf[li, oi] = k
            obs_xn[li, oi] = Xc[:2] / Xc[2]
    kf_Tn = kf_T.copy()
    kf_Tn[2:] += rng.normal(0, noise, (n_kf - 2, 3))

    def dev(a, dt=torch.float32):
        return torch.tensor(a, dtype=dt, device=DEV)[None]
    return bm._replace(
        Xs=dev(Xs + rng.normal(0, noise, Xs.shape)),
        valid=torch.ones((1, n_lm), dtype=torch.bool, device=DEV),
        obs_kf=dev(obs_kf, torch.int64), obs_xn=dev(obs_xn),
        kf_R=dev(kf_R), kf_T=dev(kf_Tn),
        kf_valid=torch.ones((1, n_kf), dtype=torch.bool, device=DEV),
        write_ptr=bm.write_ptr[None], count=bm.count[None] + n_lm,
        kf_ptr=bm.kf_ptr[None], kf_of_grow=bm.kf_of_grow[None],
        kf_gid=bm.kf_gid[None], desc=bm.desc[None], epoch=bm.epoch[None])


def refine_phase(torch, cfg):
    """Phase 13: one refine_map job."""
    from xivo_tpu_torch.map.bigmap import refine_map
    bm = synthetic_bigmap(torch, cfg)
    refine_map(cfg, bm, iters=1)             # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, chi2 = refine_map(cfg, bm, iters=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = chi2[0].double().cpu().numpy()
    print(f"refine_map: 4096 landmarks x 256 keyframes, 8 iterations in "
          f"{wall * 1e3:.1f} ms; chi2 {h[0]:.6e} -> {h[-1]:.6e}: "
          f"{np.array2string(h, precision=4)}", flush=True)
    if not (np.isfinite(h).all() and (np.diff(h) <= 0).all()
            and h[-1] < h[0]):
        raise AssertionError("refine_map's chi2 history rose or stalled")
    return wall


def image_mapped_phase(torch, kernels):
    """Phase 14: a few frames of the image mapped path, counted."""
    from xivo_tpu_torch.runner import batch_maps, run_batch_image_mapped
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    cfg = dataclasses.replace(
        image_config(), use_mapper=True, lc_keyframe_every=8,
        lc_min_age_frames=120, lc_nn_dist_thresh=5, lc_min_matches=5)
    stream = build_image_stream(cfg)
    s, f, fib = make_image_run(cfg, torch, DEV, 2, stream,
                               frames=IMG_MAP_FRAMES)
    ms = batch_maps(cfg.map_capacity, 2, DEV)
    (s, f, ms, outs, lcs), wall, launches = counted(
        torch, kernels, lambda: run_batch_image_mapped(cfg, s, f, ms, fib))
    T = IMG_MAP_FRAMES
    print(f"image mapped path: B=2 T={T} 512x512 wall {wall:.3f} s map "
          f"count {ms.count.tolist()} launches {launches}", flush=True)
    if not torch.isfinite(outs.Tsb).all():
        raise AssertionError("non-finite poses")
    L = cfg.klt_max_level
    expect = {"chol_lanes": T, "chol_inv_lanes": 2 * T,
              "tri_inv_lanes": 2 * T, "lk_sample_templates": L * T,
              "lk_gn_tracks": L * T, "hamming_nn": 3 * T, "chol_blocked": 0}
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    return launches


# ---------------------------------------------------------------------------
# slice 4: the blocked Cholesky (B7), its profile, the accuracy config
# ---------------------------------------------------------------------------

def check_chol_blocked(torch, lc, chol):
    """Phase 15: B7 against its plain version and against B1 on random
    PSD matrices with planted zero rows and on the same with the dead rows
    made unit, at (B, 228, 228) and (B, 60, 60); times of kernel, plain
    version, B1 and cholesky_ex, and the bound."""
    entry = dict(name="chol_blocked", route="cuda",
                 source="xivo_tpu_torch/csrc/chol_blocked.cu",
                 replaces=REPLACES["chol_blocked"], launches=None)
    for m in CHOL_WIDTHS:
        rnd, dead = random_psd(torch, B, m, seed=70 + m)
        cases = [("random", rnd), ("unit_dead", unit_dead(torch, rnd))]
        err, rel, rel_plain, use, use_b1 = hold(
            torch, chol.cholesky_batched, chol.cholesky_plain, cases,
            rival=lc.chol_lanes)
        print(f"kernel chol_blocked: m={m} row-relative error random "
              f"{rel['random']:.3e} unit_dead {rel['unit_dead']:.3e}; plain "
              f"float32 vs float64 {rel_plain:.3e}; worst error / limit "
              f"{use:.3f} against the plain version, {use_b1:.3f} against "
              f"B1", flush=True)
        if use > 1.0 or use_b1 > 1.0:
            raise AssertionError(f"chol_blocked: row-relative error above "
                                 f"its limit at m={m}")
        if not zero_rows_kept(chol.cholesky_batched(rnd), dead):
            raise AssertionError("chol_blocked: planted zero rows leaked")
        t = chol_times(torch, "chol_blocked", chol.cholesky_batched,
                       chol.cholesky_plain, rnd)
        print(f"kernel chol_blocked: shape {B}x{m}x{m} max_abs_err "
              f"{err:.3e} ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} "
              f"library_ms {t['library_ms']:.4f} (cholesky_ex) bound_ms "
              f"{t['bound_ms']:.4f} ({t['bound_by']})", flush=True)
        print(twin_line("chol_blocked", t), flush=True)
        if m == CHOL_WIDTHS[0]:
            entry.update(max_abs_err=err, row_rel_err=max(rel.values()),
                         **t)
        else:
            entry.update({f"{k}_{m}": v for k, v in t.items()},
                         **{f"max_abs_err_{m}": err})
    return entry


def profile_phase(torch, chol):
    """Phase 16: the linear-algebra profile, B7's entry point, at B with
    PROFILE_ITERS chained calls a line; B7's launches counted; then
    ``factor_from_cov``'s check (not in the count)."""
    from xivo_tpu_torch.tools import profile_linalg
    res, wall, launches = counted(
        torch, chol.KERNELS,
        lambda: profile_linalg.profile(B, PROFILE_ITERS, device=DEV),
        sync_check=False)
    # two widths, a warm-up chain and a timed chain each
    expect = 2 * len(CHOL_WIDTHS) * PROFILE_ITERS
    print(f"profile_linalg: B={B} {PROFILE_ITERS} calls a line in "
          f"{wall:.1f} s; launches {launches}", flush=True)
    for m in CHOL_WIDTHS:
        lib = res[f"torch cholesky_ex({m})"]
        print(f"profile_linalg: m={m} one kernel, chained: "
              f"cholesky_batched {res[f'B7 cholesky_batched({m})'] / lib:.3f}"
              f" x and chol_lanes {res[f'B1 chol_lanes({m})'] / lib:.3f} x "
              f"cholesky_ex ({lib:.4f} ms)", flush=True)
    if launches["chol_blocked"] != expect:
        raise AssertionError(f"launches {launches}, expected chol_blocked "
                             f"{expect}")
    check_factor_from_cov(torch, chol)
    return launches["chol_blocked"]


def check_factor_from_cov(torch, chol):
    """Phase 16's check of ``sqrt_form.factor_from_cov`` on phase 15's
    input at full width (B x 228 x 228, planted dead rows): one launch of
    B7 under the sync debug mode, held against its CPU plain run by B7's
    row-relative limit, dead rows and the slack exactly 0."""
    from xivo_tpu_torch.filter.layout import Dims
    from xivo_tpu_torch.filter.sqrt_form import factor_from_cov
    dims = Dims()
    D = dims.full
    P, dead = random_psd(torch, B, D, seed=70 + D)
    S, wall, launches = counted(torch, chol.KERNELS,
                                lambda: factor_from_cov(P, dims))
    ref = factor_from_cov(P.cpu(), dims)
    ref64 = factor_from_cov(P.cpu().double(), dims)
    S = S.cpu()
    e = row_rel_err(torch, S[..., :D], ref[..., :D])
    e_plain = row_rel_err(torch, ref[..., :D].double(), ref64[..., :D])
    use = e / min(ROW_TOL + ROW_TOL_SCALE * e_plain, ROW_TOL_CAP)
    zeros = (zero_rows_kept(S[..., :D], dead)
             and float(S[..., D:].abs().max()) == 0.0)
    print(f"factor_from_cov: {B}x{D}x{D} -> {tuple(S.shape)} in {wall:.3f} "
          f"s; launches {launches}; row-relative error against the CPU "
          f"plain run {e:.3e}, worst error / limit {use:.3f}; dead rows and "
          f"slack {'exactly 0' if zeros else 'LEAKED'}", flush=True)
    if launches["chol_blocked"] != 1 or use > 1.0 or not zeros:
        raise AssertionError("factor_from_cov: not one B7 launch, above "
                             "B7's limit, or dead rows leaked")


class OosRows:
    """Add up, on the device, the OOS rows each sequence applied in each
    frame (the valid rows of ``oos.sqrt_update`` on the square-root form,
    of ``oos.joseph_rows`` on the full form) while the `with` block runs:
    nothing is read back to the host, so the frame loop does not wait."""

    UPDATES = ("sqrt_update", "joseph_rows")

    def __init__(self, oos):
        self.oos, self.rows = oos, []

    def __enter__(self):
        self.orig = {n: getattr(self.oos, n) for n in self.UPDATES}
        for name, fn in self.orig.items():
            setattr(self.oos, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def rec(P, H, inn, diagR, row_valid):
            self.rows.append(row_valid.sum(-1))
            return fn(P, H, inn, diagR, row_valid)
        return rec

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.oos, name, fn)

    def per_frame(self):
        """(B, T) int64 on the host."""
        return np.stack([r.cpu().numpy() for r in self.rows], axis=1)


def compare_accuracy_paths(torch, cfg, oos):
    """Phase 17: the accuracy config's CUDA path against its CPU path
    (plain versions) at full width on B = 2 for ACC_CMP_FRAMES frames:
    poses within ACC_PATH_TOL, and the OOS rows, in-state groups (the
    clones) and features and OOS drops equal frame by frame."""
    from xivo_tpu_torch.runner import run_batch
    res = {}
    for dev in (DEV, "cpu"):
        t0 = time.time()
        s, fib, gt = make_run(cfg, torch, dev, 2, frames=ACC_CMP_FRAMES)
        with OosRows(oos) as rows:
            _, out = run_batch(cfg, s, fib)
        res[dev] = (out, rows.per_frame())
        print(f"accuracy {dev} path: {ACC_CMP_FRAMES} frames in "
              f"{time.time() - t0:.1f} s", flush=True)
    (og, rg), (oc, rc) = res[DEV], res["cpu"]
    dpos = float((og.Tsb.cpu() - oc.Tsb).abs().max())
    same = bool((rg == rc).all())
    for name in ("num_instate_groups", "num_instate_features",
                 "num_oos_dropped"):
        same &= torch.equal(getattr(og, name).cpu(), getattr(oc, name))
    print(f"accuracy cuda vs cpu path, {ACC_CMP_FRAMES} frames: max |dTsb| "
          f"{dpos:.3e} m; OOS rows of sequence 0 cuda {rg[0].tolist()} cpu "
          f"{rc[0].tolist()}; in-state groups cuda "
          f"{og.num_instate_groups[0].tolist()}; counts "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not (dpos < ACC_PATH_TOL and same and rg.sum() > 0):
        raise AssertionError("the CUDA accuracy path disagrees with the CPU "
                             "accuracy path, or OOS never fired")


def accuracy_phases(torch, lc, chol, base_ate):
    """Phases 17-19: the recommended accuracy config (OOS updates, pose
    cloning, pose-only FEJ). Returns the launches of the main run, and
    B1-B3's checks and times at the OOS shapes."""
    from xivo_tpu_torch.filter import oos
    from xivo_tpu_torch.runner import run_batch
    from xivo_tpu_torch.sim.configs import accuracy_config
    from xivo_tpu_torch.ops import imu_chain as ic
    cfg = accuracy_config()
    assert cfg.dims.full == 228
    kernels = lc.KERNELS + chol.KERNELS + ic.KERNELS
    compare_accuracy_paths(torch, cfg, oos)

    # phase 18: the accuracy path at full width, counted
    s, fib, gt = make_run(cfg, torch, DEV, B)
    T = int(fib.frame_dt.shape[1])
    with OosRows(oos) as rows:
        (s, outs), wall, launches = counted(
            torch, kernels, lambda: run_batch(cfg, s, fib))
    rows = rows.per_frame()
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb - gt["Tsb"][None], axis=2)
    ates = np.sqrt(np.mean(err ** 2, axis=1))
    limit = max(ACC_ATE_FACTOR * base_ate, ACC_ATE_FLOOR)
    print(f"accuracy main path: B={B} T={T} D={cfg.dims.full} wall "
          f"{wall:.3f} s sequence-frames/s {B * T / wall:.1f} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches "
          f"{launches} ({ {k: v / T for k, v in launches.items()} } a "
          f"frame)", flush=True)
    print(f"accuracy main path, sequence 0: ATE-RMSE {ates[0]:.5f} m (bound "
          f"{limit:.5f} = max({ACC_ATE_FACTOR} x base {base_ate:.5f}, "
          f"{ACC_ATE_FLOOR})); OOS rows applied on {int((rows[0] > 0).sum())}"
          f" of {T} frames, {int(rows[0].sum())} in all, from frame "
          f"{int(np.argmax(rows[0] > 0)) if rows[0].any() else None}; "
          f"num_oos_dropped {int(outs.num_oos_dropped.sum())} (all "
          f"sequences); in-state groups at the end "
          f"{int(outs.num_instate_groups[0, -1])}; all sequences: ATE-RMSE "
          f"{ates.min():.5f}-{ates.max():.5f} m", flush=True)
    if not (ates[0] < limit and rows[0].sum() > 0):
        raise AssertionError("accuracy path outside its bound, or no OOS "
                             "update applied")
    expect = {"chol_lanes": T, "chol_inv_lanes": 3 * T,
              "tri_inv_lanes": 3 * T, "chol_blocked": 0}
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")

    # phase 19: the kernels at the OOS shapes, on the inputs of the frames
    # where OOS rows were applied (the others are identities or zeros). B2
    # and B3 on the two 120-row blocks of the 240-row stack...
    oos_shapes = {}
    s, fib, _ = make_run(cfg, torch, DEV, B, frames=ACC_CAPTURE_FRAMES)
    with Recorder(torch, lc, ["chol_inv_lanes", "tri_inv_lanes"]) as seen:
        run_batch(cfg, s, fib)
    torch.cuda.synchronize()
    pairs = {"chol_inv_lanes": (lc.chol_inv_lanes, lc.chol_inv_plain),
             "tri_inv_lanes": (lc.tri_inv_lanes, lc.tri_inv_plain)}
    for name, (kernel, plain) in pairs.items():
        inputs = [a[0] for a in seen[name] if a[0].shape[-1] != 60]
        oos_shapes[name] = check_oos_shape(torch, name, kernel, plain,
                                           inputs)
    del seen
    # ... and B1 at (D + 1)^2 = 229^2 with compression forced, counted
    ccfg = accuracy_config(compression_trigger_ratio=0.5)
    s, fib, _ = make_run(ccfg, torch, DEV, B, frames=ACC_COMPRESS_FRAMES)
    T = ACC_COMPRESS_FRAMES
    with Recorder(torch, lc, ["chol_lanes"]) as seen:
        (_, outs), wall, claunches = counted(
            torch, kernels, lambda: run_batch(ccfg, s, fib))
    print(f"accuracy path, compression forced: B={B} T={T} launches "
          f"{claunches}", flush=True)
    expect = {"chol_lanes": 2 * T, "chol_inv_lanes": 3 * T,
              "tri_inv_lanes": 3 * T, "chol_blocked": 0}
    expect.update(chain_launches(ccfg, T))
    if claunches != expect or not torch.isfinite(outs.Tsb).all():
        raise AssertionError(f"launches {claunches}, expected {expect}")
    inputs = [a[0] for a in seen["chol_lanes"] if a[0].shape[-1] == 229]
    if len(inputs) != T:
        raise AssertionError(f"B1 ran {len(inputs)} times at 229, "
                             f"expected {T}")
    del seen
    oos_shapes["chol_lanes"] = check_oos_shape(
        torch, "chol_lanes", lc.chol_lanes, lc.chol_plain, inputs,
        backward=True)
    return launches, oos_shapes


def default_config(**over):
    """``config_from_json(PCW_CFG)``: the reference's default filter
    (float32, default Dims, reference propagation, full covariance), with
    `over` on top and its substep cap sized to the bench stream."""
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.runner import fit_substeps
    from xivo_tpu_torch.sim.configs import PCW_CFG
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    cfg = config_from_json(PCW_CFG, **over)
    fi, _ = build_pcw_stream(cfg, total_time=TOTAL_TIME, noise_px=0.25)
    return fit_substeps(cfg, fi)


def full_form_phases(torch, lc, chol):
    """Phases 20-22: the reference's default filter. Returns the main
    run's launches, the full-form accuracy run's launches with compression
    forced and B1's check at 229 on that run's inputs."""
    from xivo_tpu_torch.filter import oos, propagate
    from xivo_tpu_torch.ops import imu_chain as ic
    from xivo_tpu_torch.runner import run_batch
    from xivo_tpu_torch.sim.configs import accuracy_config
    kernels = lc.KERNELS + chol.KERNELS + ic.KERNELS

    # phase 20: the unmodified config, CUDA path against the CPU path
    cfg = default_config()
    assert (cfg.dims.full, cfg.dtype, cfg.propagation_mode,
            cfg.covariance_form) == (228, "float32", "reference", "full")
    res = {}
    for dev in (DEV, "cpu"):
        t0 = time.time()
        s, fib, _ = make_run(cfg, torch, dev, 2, frames=FULL_CMP_FRAMES)
        res[dev] = run_batch(cfg, s, fib)[1]
        print(f"default filter {dev} path: {FULL_CMP_FRAMES} frames in "
              f"{time.time() - t0:.1f} s", flush=True)
    og, oc = res[DEV], res["cpu"]
    dpos = float((og.Tsb.cpu() - oc.Tsb).abs().max())
    same = all(torch.equal(getattr(og, n).cpu(), getattr(oc, n))
               for n in COUNT_FIELDS)
    print(f"default filter cuda vs cpu path (config_from_json(PCW_CFG), "
          f"max_substeps {cfg.max_substeps}), {FULL_CMP_FRAMES} frames: max "
          f"|dTsb| {dpos:.3e} m; in-state features cuda "
          f"{og.num_instate_features[0].tolist()} cpu "
          f"{oc.num_instate_features[0].tolist()}; counts "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not (dpos < FULL_PATH_TOL and same):
        raise AssertionError("the CUDA default-filter path disagrees with "
                             "the CPU path")

    # phase 21: the main run at full width, counted
    cfg = default_config(sim_initialize_depths=True)
    s, fib, gt = make_run(cfg, torch, DEV, B, frames=FULL_FRAMES)
    T = int(fib.frame_dt.shape[1])
    (s, outs), wall, launches = counted(
        torch, kernels, lambda: run_batch(cfg, s, fib, check=False))
    peak = torch.cuda.max_memory_allocated()
    # the substep counters read after the run (raises on an unfinished
    # interval)
    most = propagate.check_substeps(DEV)
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb - gt["Tsb"][None, :T], axis=2)
    ates = np.sqrt(np.mean(err ** 2, axis=1))
    print(f"default filter main path: B={B} T={T} D={cfg.dims.full} "
          f"(reference Prince-Dormand propagation, stepsize "
          f"{cfg.stepsize}, max_substeps {cfg.max_substeps}; full "
          f"covariance) "
          f"wall {wall:.3f} s sequence-frames/s "
          f"{B * T / wall:.1f} peak_mem_GB {peak / 1e9:.2f} launches "
          f"{launches}; the most substeps an interval took {most}, "
          f"intervals left unfinished 0", flush=True)
    print(f"default filter main path, sequence 0: ATE-RMSE {ates[0]:.5f} m "
          f"(bound {ATE_BOUND}), final error {err[0, -1]:.5f} m; in-state "
          f"features at the end {int(outs.num_instate_features[0, -1])}; "
          f"all sequences: ATE-RMSE {ates.min():.5f}-{ates.max():.5f} m",
          flush=True)
    if not ates[0] < ATE_BOUND:
        raise AssertionError(f"ATE {ates[0]} >= {ATE_BOUND}")
    if any(launches.values()):
        raise AssertionError(f"launches {launches}, expected none")

    # phase 22: the accuracy config in the full form, compression forced
    ccfg = accuracy_config(covariance_form="full",
                           compression_trigger_ratio=0.5)
    run_batch(ccfg, *make_run(ccfg, torch, DEV, 2, frames=2)[:2])  # constants
    s, fib, _ = make_run(ccfg, torch, DEV, B, frames=FULL_COMPRESS_FRAMES)
    T = FULL_COMPRESS_FRAMES
    with Recorder(torch, lc, ["chol_lanes"]) as seen, OosRows(oos) as rows:
        (_, outs), wall, claunches = counted(
            torch, kernels, lambda: run_batch(ccfg, s, fib))
    rows = rows.per_frame()
    print(f"full-form accuracy path, compression forced: B={B} T={T} wall "
          f"{wall:.3f} s sequence-frames/s {B * T / wall:.1f} launches "
          f"{claunches}; OOS rows of sequence 0 {rows[0].tolist()}",
          flush=True)
    expect = {"chol_lanes": T, "chol_inv_lanes": 0, "tri_inv_lanes": 0,
              "chol_blocked": 0}
    expect.update(chain_launches(ccfg, T))
    if claunches != expect or not torch.isfinite(outs.Tsb).all():
        raise AssertionError(f"launches {claunches}, expected {expect}")
    inputs = [a[0] for a in seen["chol_lanes"] if a[0].shape[-1] == 229]
    if len(inputs) != T or rows[0].sum() == 0:
        raise AssertionError(f"B1 ran {len(inputs)} times at 229, expected "
                             f"{T}, or no OOS row was applied")
    del seen
    check = check_oos_shape(torch, "chol_lanes", lc.chol_lanes,
                            lc.chol_plain, inputs, backward=True)
    return launches, claunches, check


# ---------------------------------------------------------------------------
# slice 11: the shipped TUM-VI configs (equidistant lens, homography
# outlier rejection) and the equidistant image bench variant
# ---------------------------------------------------------------------------

def tumvi_config(path=TUMVI_CFGS[0]):
    """The shipped config at `path` (``config_from_json`` of the file), its
    substep cap sized to its image stream, and that stream (rendered
    through the config's lens)."""
    from xivo_tpu_torch.filter.config import (config_from_json,
                                              load_json_with_comments)
    from xivo_tpu_torch.runner import fit_substeps
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    cfg = config_from_json(load_json_with_comments(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), path)))
    stream = build_image_stream(cfg)
    return fit_substeps(cfg, stream[0]), stream


def hom_draws(torch, cfg, batch, frames, seed=0):
    """Homography draws (B, T, N_HYPS, NF) in the config's dtype, made on
    the host, for two devices to share."""
    from xivo_tpu_torch.frontend.homography import N_HYPS
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.random((batch, frames, N_HYPS,
                                    cfg.dims.nf_rows)),
                        dtype=getattr(torch, cfg.dtype))


def compare_image_devices(torch, label, cfg, stream, frames, oos=None,
                          kernels=(), warm=True):
    """The CUDA image path of `cfg` against its CPU path on B = 2 for
    `frames` frames with the same homography draws: poses within
    IMG_PATH_TOL and the TUMVI_COUNTS (and, with `oos`, the OOS rows)
    equal frame by frame. Returns the CUDA run's launches of `kernels`.
    `warm=False` skips the CUDA path's two-frame first run where a config
    with the same device constants has run on the card already."""
    from xivo_tpu_torch.filter import propagate
    from xivo_tpu_torch.runner import run_batch_image
    draws = hom_draws(torch, cfg, 2, frames)
    res, launches = {}, None
    for dev in (DEV, "cpu"):
        t0 = time.time()
        s, f, fib = make_image_run(cfg, torch, dev, 2, stream, frames=frames)
        hom = draws.to(dev)

        def run(check):
            return run_batch_image(cfg, s, f, fib, check=check,
                                   hom_uniforms=hom)[2]
        if dev == DEV and warm:
            # a first run fills ops.dense.constant's cache (each new
            # constant's upload waits for the device once; a config makes
            # all of its constants in its first two frames)
            run_batch_image(cfg, *make_image_run(cfg, torch, dev, 2, stream,
                                                 frames=2),
                            hom_uniforms=hom[:, :2])
        rec = None if oos is None else OosRows(oos)
        with rec or contextlib.nullcontext():
            if dev == DEV:
                # the frame loop under the sync debug mode, the substep
                # counters read after it
                out, _, launches = counted(torch, kernels,
                                           lambda: run(False))
                propagate.check_substeps(DEV)
            else:
                out = run(True)
        res[dev] = (out, None if rec is None else rec.per_frame())
        print(f"{label} {dev} path: {frames} frames in "
              f"{time.time() - t0:.1f} s", flush=True)
    (og, rg), (oc, rc) = res[DEV], res["cpu"]
    dpos = float((og.Tsb.cpu() - oc.Tsb).abs().max())
    same = rg is None or bool((rg == rc).all())
    for name in TUMVI_COUNTS:
        x, y = getattr(og, name).cpu(), getattr(oc, name)
        same &= torch.equal(x, y)
        print(f"{label} cuda vs cpu path: {name} cuda {x[0].tolist()} cpu "
              f"{y[0].tolist()}", flush=True)
    if rg is not None:
        print(f"{label} cuda vs cpu path: OOS rows of sequence 0 cuda "
              f"{rg[0].tolist()} cpu {rc[0].tolist()}", flush=True)
    print(f"{label} cuda vs cpu path, {frames} frames: max |dTsb| "
          f"{dpos:.3e} m; counts {'equal' if same else 'DIFFER'}",
          flush=True)
    if not (dpos < IMG_PATH_TOL and same):
        raise AssertionError(f"the CUDA path disagrees with the CPU path "
                             f"({label})")
    return launches, rg, og


def tumvi_phases(torch, lc, lko, others):
    """Phases 23-24: ``cfg/tumvi_cam0.json`` on the CUDA and CPU paths, then
    at full width, counted. Returns the B4-B5 checks at the config's shapes
    and the main run's launches."""
    from xivo_tpu_torch.filter import propagate
    from xivo_tpu_torch.runner import run_batch_image
    cfg, stream = tumvi_config()
    assert (cfg.dims.full, cfg.dims.nf_rows, cfg.dtype, cfg.cam_model,
            cfg.propagation_mode, cfg.covariance_form,
            cfg.do_outlier_rejection, tuple(cfg.cam_params[:2])) == (
        228, 256, "float32", "equidistant", "reference", "full", True,
        (512, 512))
    kernels = lc.KERNELS + lko.KERNELS + others

    # phase 23: CUDA against CPU, as shipped, then with outliers planted
    # and with the gate open (the same device constants: made already)
    compare_image_devices(torch, "tumvi as shipped", cfg, stream,
                          TUMVI_CMP_FRAMES)
    fi, gt = stream
    image = fi.image.copy()
    rows = slice(TUMVI_PLANT_FRAMES[0], TUMVI_PLANT_FRAMES[-1] + 1)
    image[rows, TUMVI_PLANT_PX:, :TUMVI_PLANT_COLS] = \
        image[rows, :-TUMVI_PLANT_PX, :TUMVI_PLANT_COLS]
    _, _, out = compare_image_devices(
        torch, "tumvi planted outliers", cfg, (fi._replace(image=image), gt),
        TUMVI_PLANT_CMP_FRAMES, warm=False)
    if not bool((out.num_tracker_outlier_rejected[
            :, TUMVI_PLANT_FRAMES[0]] > 0).all()):
        raise AssertionError("the planted outliers were not rejected")
    open_cfg = dataclasses.replace(cfg, max_depth_var_for_admission=np.inf)
    compare_image_devices(torch, "tumvi default admission gate", open_cfg,
                          stream, TUMVI_CMP_OPEN_FRAMES, warm=False)

    # phase 24: the main run, counted; the substep counters read after
    # each of its two calls (raises on an unfinished interval); the calls
    # draw their homography uniforms from seeds 1 and 2
    s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream,
                               frames=TUMVI_FRAMES)
    T, a = int(fib.frame_dt.shape[1]), TUMVI_SPLIT_FRAME
    _, (s, f, outs), wall, launches, peak, most = counted_split(
        torch, kernels, lambda c, w, seed: run_batch_image(
            cfg, *c, w, check=False, seed=seed),
        (s, f), fib, a, (1, 2), after=lambda: propagate.check_substeps(DEV))
    most = max(most)
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    gt = stream[1]
    err = np.linalg.norm(Tsb[0] - gt["Tsb"][:T], axis=1)
    ntr = outs.num_tracked.cpu().numpy()
    inst = outs.num_instate_features.cpu().numpy()
    rej = outs.num_tracker_outlier_rejected.cpu().numpy()
    print(f"tumvi main path: B={IMG_B} T={T} 512x512 D={cfg.dims.full} "
          f"nf_rows {cfg.dims.nf_rows} (equidistant lens, reference "
          f"propagation, max_substeps {cfg.max_substeps}, the most an "
          f"interval took {most}, full covariance; frames 0-{a - 1} and "
          f"{a}-{T - 1} as two calls) "
          f"wall {wall:.3f} s sequence-frames/s {IMG_B * T / wall:.1f} "
          f"peak_mem_GB {peak / 1e9:.2f} "
          f"launches {launches}; outlier rejections {int(rej.sum())} in "
          f"all, sequence 0 {int(rej[0].sum())}, at most "
          f"{int(rej.max())} in a frame", flush=True)
    print(f"tumvi main path, sequence 0: final error {err[-1]:.4f} m "
          f"(bound {IMG_FINAL_BOUND}), median {np.median(err):.4f} m (bound "
          f"{IMG_MEDIAN_BOUND}), RMSE {np.sqrt(np.mean(err ** 2)):.4f} m; "
          f"tracked from frame 10 at least {int(ntr[0, 10:].min())} "
          f"(bound {IMG_MIN_TRACKED}); features in the state from frame "
          f"{int(np.argmax(inst[0] > 0)) if inst[0].any() else None}, "
          f"{int(inst[0, -1])} at the end; all sequences: final error "
          f"{np.linalg.norm(Tsb[:, -1] - gt['Tsb'][T - 1], axis=1).max():.4f}"
          f" m at most", flush=True)
    if not (err[-1] < IMG_FINAL_BOUND and np.median(err) < IMG_MEDIAN_BOUND
            and ntr[0, 10:].min() >= IMG_MIN_TRACKED):
        raise AssertionError("TUM-VI path outside the image path's bounds")
    expect = {k.name: 0 for k in kernels}
    expect.update({k.name: cfg.klt_max_level * T for k in lko.KERNELS})
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    del s, f, outs

    # B4 and B5 at the config's shapes: the inputs of its first frames
    with Recorder(torch, lko, ["sample_templates", "gn_tracks"]) as seen:
        s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream,
                                   frames=TUMVI_CAPTURE_FRAMES)
        run_batch_image(cfg, s, f, fib)
        torch.cuda.synchronize()
    checks = check_lk_kernels(torch, lko, seen, {"sample_templates": [],
                                                 "gn_tracks": []}, cfg)
    del seen
    return {c["name"]: c for c in checks}, launches


def equidistant_bench_phase(torch, kernels):
    """Phase 25: the equidistant image bench variant, counted."""
    from xivo_tpu_torch.runner import run_batch_image
    from xivo_tpu_torch.sim.configs import EQUIDISTANT_512_CAM
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    cfg = image_config(EQUIDISTANT_512_CAM)
    assert cfg.cam_model == "equidistant" and cfg.dims.full == 228
    stream = build_image_stream(cfg)
    run_batch_image(cfg, *make_image_run(cfg, torch, DEV, 2, stream,
                                         frames=2))          # constants
    s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream,
                               frames=EQUI_FRAMES)
    T = int(fib.frame_dt.shape[1])
    (s, f, outs), wall, launches = counted(
        torch, kernels, lambda: run_batch_image(cfg, s, f, fib))
    Tsb = outs.Tsb.cpu().numpy()
    err = np.linalg.norm(Tsb[0] - stream[1]["Tsb"][:T], axis=1)
    print(f"equidistant image bench variant: B={IMG_B} T={T} 512x512 D="
          f"{cfg.dims.full} wall {wall:.3f} s sequence-frames/s "
          f"{IMG_B * T / wall:.1f} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches "
          f"{launches}; sequence 0: final error {err[-1]:.4f} m, median "
          f"{np.median(err):.4f} m, tracked from frame 10 at least "
          f"{int(outs.num_tracked[0, 10:].min())}", flush=True)
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    expect = {k.name: 0 for k in kernels}
    expect.update({"chol_lanes": T, "chol_inv_lanes": T, "tri_inv_lanes": T,
                   "lk_sample_templates": cfg.klt_max_level * T,
                   "lk_gn_tracks": cfg.klt_max_level * T})
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    return launches


def tumvi_accuracy_phase(torch, lko, kernels):
    """Phase 26: ``cfg/tumvi_cam0_accuracy.json`` on the CUDA and CPU
    paths. Returns the CUDA run's launches."""
    from xivo_tpu_torch.filter import oos
    cfg, stream = tumvi_config(TUMVI_CFGS[1])
    assert cfg.use_OOS and cfg.covariance_form == "full"
    T = TUMVI_ACC_FRAMES
    label = "tumvi accuracy as shipped"
    launches, rows, _ = compare_image_devices(torch, label, cfg, stream, T,
                                              oos=oos, kernels=kernels)
    print(f"{label}: cuda launches {launches}", flush=True)
    expect = {k.name: 0 for k in kernels}
    expect.update({k.name: cfg.klt_max_level * T for k in lko.KERNELS})
    expect.update(chain_launches(cfg, T))
    b1 = launches.pop("chol_lanes")
    expect.pop("chol_lanes")
    if launches != expect or b1 > T or rows.sum() == 0:
        raise AssertionError(f"launches {launches}, B1 {b1}, expected "
                             f"{expect}, B1 at most {T}; or no OOS row")
    launches["chol_lanes"] = b1
    return launches


def backward_use(torch, kernel, plain, inputs):
    """Worst ratio of the kernel's backward error to its limit over the
    inputs, and the plain float32 version's own worst (see BACKWARD_TOL)."""
    def berr(L, X):
        return float((L @ L.transpose(-1, -2) - X).abs().amax()
                     / X.abs().amax())
    use = own = 0.0
    for X in inputs:
        e, e_plain = berr(kernel(X), X), berr(plain(X), X)
        own = max(own, e_plain)
        use = max(use, e / (BACKWARD_TOL + ROW_TOL_SCALE * e_plain))
    return use, own


def check_oos_shape(torch, name, kernel, plain, inputs, backward=False):
    """A kernel of B1-B3 at an OOS shape, held against its plain version
    on those of the path's inputs that carry OOS rows (an off-diagonal
    entry that is not zero) and timed on the last of them: row by row as
    phase 3 does, or (`backward`) by its backward error."""
    n_all = len(inputs)
    inputs = [X for X in inputs if bool(
        (X - torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))).abs()
        .amax() > 0)]
    if len(inputs) < 2:
        raise AssertionError(f"{name}: {len(inputs)} inputs with OOS rows")
    err, rel, rel_plain, use, _ = hold(torch, kernel, plain,
                                       [("real", X) for X in inputs])
    if backward:
        use, own = backward_use(torch, kernel, plain, inputs)
        print(f"kernel {name} at m={inputs[0].shape[-1]}: backward error / "
              f"limit {use:.3f} (the plain float32 version's own "
              f"{own:.3e})", flush=True)
    t = chol_times(torch, name, kernel, plain, inputs[-1].contiguous())
    m = t["shape"][-1]
    print(f"kernel {name} at the OOS shape {t['shape']}: row-relative error "
          f"{rel['real']:.3e} (plain float32 vs float64 {rel_plain:.3e}), "
          f"worst error / limit {use:.3f} on the {len(inputs)} of {n_all} "
          f"inputs with OOS rows; ms "
          f"{t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms "
          f"{t['library_ms']} bound_ms {t['bound_ms']:.4f} "
          f"({t['bound_by']})", flush=True)
    if name in TWIN:
        print(twin_line(name, t), flush=True)
    if "library_two_calls_ms" in t:
        print(two_calls_line(name, t), flush=True)
    if use > 1.0:
        raise AssertionError(f"{name} at m={m}: error above its limit "
                             f"({use:.3f} x)")
    return dict(max_abs_err=err, row_rel_err=rel["real"], **t)


def slice11_phases(torch, lc, lko, hm, chol):
    """Phases 23-26. Returns B4-B5's checks at the TUM-VI shapes and the
    launches of phases 24, 26 and 25."""
    from xivo_tpu_torch.ops import imu_chain as ic
    others = hm.KERNELS + chol.KERNELS + ic.KERNELS
    kernels = lc.KERNELS + lko.KERNELS + others
    checks, launches = tumvi_phases(torch, lc, lko, others)
    equi = equidistant_bench_phase(torch, kernels)
    acc = tumvi_accuracy_phase(torch, lko, kernels)
    return checks, launches, acc, equi


API_T = 2.0             # tests/test_api.py::run_short: 2 s of stream
API_RUN_T = 1.0         # phase 27 drives the stream's first second
API_WARM_T = 0.3        # the stream's head, run once before a checked run
API_PATH_TOL = 1e-3     # CUDA vs CPU through the Estimator, m
# the frames of the default filter's CUDA run held against the CPU (the
# square-root run's are all held): its CPU run is the slow one, and the
# script keeps within its time limit
API_FULL_CMP_FRAMES = 10
ASL_FINAL_BOUND = 1.0   # tests/test_io.py:95
TUMVI_API_FRAMES, TUMVI_API_CMP_FRAMES = 40, 10


def drive_api(torch, est, msgs, checked=False, max_frames=None):
    """Feed the messages to the estimator, up to the `max_frames`-th frame
    after vision init where given; returns each frame's position and
    counts (read after it) and the wall s of the whole run. With
    `checked`, every entry-point call from the second frame after vision
    init on runs under the sync debug mode "error"."""
    frames = []
    t0 = time.perf_counter()
    for t, kind, a, b in msgs:
        if len(frames) == max_frames:
            break
        check = checked and len(frames) >= 2
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if kind == "imu":
                est.InertialMeas(t, a, b)
            else:
                est.VisualMeasPointCloud(t, a, b)
        finally:
            if check:
                torch.cuda.set_sync_debug_mode("default")
        if kind != "imu" and est.VisionInitialized():
            frames.append((est.gsb()[1], [
                est.num_instate_features(), est.num_instate_groups(),
                est.num_tracked_features(), est.num_mh_rejected(),
                est.num_tracker_outlier_rejected()]))
    est.flush()
    if est.device.type == "cuda":
        torch.cuda.synchronize()
    return frames, time.perf_counter() - t0


def compare_api_frames(label, got, want):
    """CUDA frames against CPU frames: positions within API_PATH_TOL,
    counts equal; returns the largest difference."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"{label}: {len(got)} frames on CUDA, "
                             f"{len(want)} on the CPU")
    worst = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got, want))
    counts = [g[1] for g in got] == [w[1] for w in want]
    if not (np.isfinite(worst) and worst < API_PATH_TOL and counts):
        raise AssertionError(f"{label}: CUDA and CPU differ by {worst} m "
                             f"(counts equal: {counts})")
    return worst


def api_pcw_phase(torch, kernels, lc):
    """Phase 27. Returns the launches of the default filter's and the
    square-root form's checked runs."""
    from xivo_tpu_torch.api import Estimator
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.configs import PCW_CFG
    from xivo_tpu_torch.sim.stream import run_short_messages
    t_phase = time.time()
    card = card_line()
    out = {}
    for label, over in (("default filter", {}),
                        ("square-root", dict(propagation_mode="fast",
                                             covariance_form="sqrt"))):
        cfg = config_from_json(PCW_CFG, sim_initialize_depths=True, **over)
        assert (cfg.dims.full, cfg.dtype) == (228, "float32")
        msgs = [m for m in run_short_messages(
            *Estimator(cfg, device="cpu").gbc(), T=API_T)
            if m[0] < API_RUN_T]
        drive_api(torch, Estimator(cfg, device=DEV),
                  [m for m in msgs if m[0] < API_WARM_T])
        for k in kernels:
            k.launches = 0
        got, wall = drive_api(torch, Estimator(cfg, device=DEV), msgs,
                              checked=True)
        launches = {k.name: k.launches for k in kernels}
        n_cmp = API_FULL_CMP_FRAMES if over == {} else None
        want, cpu_wall = drive_api(torch, Estimator(cfg, device="cpu"), msgs,
                                   max_frames=n_cmp)
        worst = compare_api_frames(f"api {label}", got[:n_cmp], want)
        n, n_cpu = len(got), len(want)
        expect = {k.name: 0 for k in kernels}
        if cfg.covariance_form == "sqrt":
            expect.update({k.name: n for k in lc.KERNELS})
        expect.update(chain_launches(cfg, n))
        print(f"api {label} (Estimator, PCW_CFG, D={cfg.dims.full}, "
              f"float32, B=1): {n} frames, CUDA {wall:.3f} s = "
              f"{n / wall:.2f} frames/s of one sequence (CPU, {n_cpu} "
              f"frames: {cpu_wall:.3f} s = {n_cpu / cpu_wall:.2f} frames/s);"
              f" CUDA vs CPU over {n_cpu} frames max |dTsb| "
              f"{worst:.3e} m, counts equal; launches {launches}; no host "
              f"sync in the frame entry points from frame 2; on {card}",
              flush=True)
        if launches != expect:
            raise AssertionError(f"launches {launches}, expected {expect}")
        out[label] = launches
    print(f"phase 27 done in {time.time() - t_phase:.1f} s", flush=True)
    return out["default filter"], out["square-root"]


def asl_replay_phase(torch, kernels, lko):
    """Phase 28. Returns the launches the replay app reports."""
    import ast
    import tempfile
    from xivo_tpu_torch.eval.estimator_data import load_trajectory
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.asl import write_dots_dataset
    from xivo_tpu_torch.sim.configs import IMG_CFG
    t_phase = time.time()
    cfg = config_from_json(IMG_CFG)
    with tempfile.TemporaryDirectory() as tmp:
        imu = write_dots_dataset(tmp, cfg)
        cfg_path, out = (os.path.join(tmp, n) for n in ("img.json", "traj"))
        with open(cfg_path, "w") as f:
            json.dump(IMG_CFG, f)
        r = subprocess.run(
            [sys.executable, "-m", "xivo_tpu_torch.apps.vio", "-cfg",
             cfg_path, "-root", tmp, "-dataset", "xivo", "-seq", "seq",
             "-out", out, "-device", DEV],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"the replay app failed:\n{r.stderr[-3000:]}")
        summary, line = r.stdout.strip().splitlines()[-2:]
        launches = ast.literal_eval(line[len("launches "):])
        traj = load_trajectory(out)
    err = np.linalg.norm(traj["T"][-1] - imu.gsb(traj["ts"][-1])[1])
    n = len(traj["ts"])
    print(f"asl replay (python -m xivo_tpu_torch.apps.vio, IMG_CFG, "
          f"{cfg.propagation_mode} propagation, {cfg.covariance_form} "
          f"covariance, float32): {summary}; {n} poses, final error "
          f"{err:.4f} m (bound {ASL_FINAL_BOUND}); launches {launches}; "
          f"on {card_line()}; phase 28 done in "
          f"{time.time() - t_phase:.1f} s", flush=True)
    if not (n == 20 and np.isfinite(traj["T"]).all()
            and np.isfinite(traj["q"]).all() and err < ASL_FINAL_BOUND):
        raise AssertionError("the ASL replay is outside its bounds")
    expect = {k.name: 0 for k in kernels}
    expect.update({k.name: cfg.klt_max_level * n for k in lko.KERNELS})
    expect.update(chain_launches(cfg, n))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    return launches


def replay_dataset(torch, est, entries, max_frames):
    """The vio app's loop through an estimator: each frame's (stamp,
    position, counts), and the wall s."""
    from xivo_tpu_torch.apps.vio import replay
    frames = []
    t0 = time.perf_counter()
    for m in replay(est, entries, max_frames):
        frames.append((m.ts, est.gsb()[1], [
            est.num_tracked_features(), est.num_instate_features(),
            est.num_instate_groups(), est.num_tracker_outlier_rejected()]))
    return frames, time.perf_counter() - t0


def tumvi_api_phase(torch, kernels, lko):
    """Phase 29. Returns the launches of the 40-frame CUDA run."""
    import tempfile
    from xivo_tpu_torch.api import Estimator
    from xivo_tpu_torch.eval.metrics import ate_rmse
    from xivo_tpu_torch.filter.config import (config_from_json,
                                              load_json_with_comments)
    from xivo_tpu_torch.io import load_dataset
    from xivo_tpu_torch.io.loader import load_mocap_tumvi
    from xivo_tpu_torch.sim.asl import write_tumvi_dataset
    t_phase = time.time()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        TUMVI_CFGS[0])
    cfg = config_from_json(load_json_with_comments(path))
    with tempfile.TemporaryDirectory() as tmp:
        write_tumvi_dataset(tmp, cfg, TUMVI_API_FRAMES)
        entries = load_dataset(tmp, "tumvi", "room1")
        mocap = load_mocap_tumvi(tmp, "room1")
        for k in kernels:
            k.launches = 0
        got, wall = replay_dataset(torch, Estimator(path, device=DEV),
                                   entries, TUMVI_API_FRAMES)
        launches = {k.name: k.launches for k in kernels}
        want, cpu_wall = replay_dataset(torch, Estimator(path, device="cpu"),
                                        entries, TUMVI_API_CMP_FRAMES)
    worst = compare_api_frames(
        "api tumvi", [f[1:] for f in got[:TUMVI_API_CMP_FRAMES]],
        [f[1:] for f in want])
    n = len(got)
    ts = np.asarray([f[0] for f in got])
    pos = np.asarray([f[1] for f in got])
    rmse, pairs, _ = ate_rmse(ts, pos, mocap[:, 0], mocap[:, 1:4])
    print(f"api tumvi (Estimator, {TUMVI_CFGS[0]} as shipped, gravity "
          f"init from rest, float32): {n} frames on CUDA in {wall:.3f} s = "
          f"{n / wall:.2f} frames/s of one sequence (CPU, "
          f"{len(want)} frames: {len(want) / cpu_wall:.2f} frames/s); CUDA "
          f"vs CPU over {len(want)} frames max |dTsb| {worst:.3e} m, counts "
          f"equal; ATE-RMSE {rmse:.5f} m over {pairs} pairs (no bound); "
          f"tracked at the end {got[-1][2][0]}, in-state features "
          f"{got[-1][2][1]}; launches {launches}; on {card_line()}; phase "
          f"29 done in {time.time() - t_phase:.1f} s", flush=True)
    if n != TUMVI_API_FRAMES or not np.isfinite(pos).all():
        raise AssertionError("the TUM-VI replay lost frames or poses")
    expect = {k.name: 0 for k in kernels}
    expect.update({k.name: cfg.klt_max_level * n for k in lko.KERNELS})
    expect.update(chain_launches(cfg, n))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    return launches


# ---------------------------------------------------------------------------
# slice 13: the other filter options and batched propagation
# ---------------------------------------------------------------------------

def corrupted(fi):
    """The options' stream: outliers planted from OPT_CORRUPT['start']."""
    from xivo_tpu_torch.sim.stream import corrupt_measurements
    return corrupt_measurements(fi, **OPT_CORRUPT)


def compare_devices(torch, label, cfg, frames, counts, tol, edit=None):
    """`cfg`'s CUDA path against its CPU path (plain versions) at full
    width on B = 2: poses within `tol`, the `counts` of StepOutputs equal
    frame by frame. Returns the CPU run's outputs."""
    from xivo_tpu_torch.runner import run_batch
    res = {}
    for dev in (DEV, "cpu"):
        t0 = time.time()
        s, fib, _ = make_run(cfg, torch, dev, 2, frames=frames, edit=edit)
        res[dev] = run_batch(cfg, s, fib)[1]
        print(f"{label} {dev} path: {frames} frames in "
              f"{time.time() - t0:.1f} s", flush=True)
    og, oc = res[DEV], res["cpu"]
    dpos = float((og.Tsb.cpu() - oc.Tsb).abs().max())
    differ = [n for n in counts
              if not torch.equal(getattr(og, n).cpu(), getattr(oc, n))]
    print(f"{label} cuda vs cpu path, {frames} frames: max |dTsb| "
          f"{dpos:.3e} m; 1-point RANSAC rejects of sequence 0 cuda "
          f"{og.num_oneptransac_rejected[0].tolist()} cpu "
          f"{oc.num_oneptransac_rejected[0].tolist()}; MH rejects cuda "
          f"{og.num_mh_rejected[0].tolist()}; counts "
          f"{'equal' if not differ else f'DIFFER: {differ}'}", flush=True)
    if not (dpos < tol and not differ):
        raise AssertionError(f"the CUDA {label} path disagrees with its CPU "
                             "path")
    return oc


def options_phase(torch, lc, others):
    """Phase 30: every filter option on the square-root path at full
    width. Returns the main run's launches and B1-B3's checks on its
    inputs."""
    from xivo_tpu_torch.filter.validate import validate_state
    from xivo_tpu_torch.runner import run_batch
    from xivo_tpu_torch.sim.configs import OPTIONS, options_config
    cfg = options_config()
    assert (cfg.dims.full, cfg.dtype, cfg.covariance_form) == (
        228, "float32", "sqrt")
    kernels = lc.KERNELS + others

    # (a) the CUDA path against the CPU path, outliers included
    oc = compare_devices(torch, "options", cfg, OPT_CMP_FRAMES, OPT_COUNTS,
                         OPT_PATH_TOL, corrupted)
    if not int(oc.num_oneptransac_rejected.sum()) > 0:
        raise AssertionError("1-point RANSAC rejected nothing in the "
                             "comparison")

    # (b) the main run, counted, no sync
    s, fib, gt = make_run(cfg, torch, DEV, B, frames=OPT_FRAMES,
                          edit=corrupted)
    T = OPT_FRAMES
    (s, outs), wall, launches = counted(
        torch, kernels, lambda: run_batch(cfg, s, fib))
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb - gt["Tsb"][None, :T], axis=2)
    ates = np.sqrt(np.mean(err ** 2, axis=1))
    n_1pt = int(outs.num_oneptransac_rejected.sum())
    errs = validate_state(cfg, s, 0)
    print(f"options main path ({sorted(OPTIONS)}): B={B} T={T} "
          f"D={cfg.dims.full} wall {wall:.3f} s sequence-frames/s "
          f"{B * T / wall:.1f} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches "
          f"{launches} ({ {k: v / T for k, v in launches.items()} } a "
          f"frame)", flush=True)
    print(f"options main path: 1-point RANSAC rejects {n_1pt} (all "
          f"sequences; sequence 0 "
          f"{outs.num_oneptransac_rejected[0].tolist()}), MH rejects "
          f"{int(outs.num_mh_rejected.sum())}; sequence 0: ATE-RMSE "
          f"{ates[0]:.5f} m (bound {OPT_ATE_BOUND}), final error "
          f"{err[0, -1]:.5f} m, intrinsics {s.cam[0, :4].tolist()}, "
          f"validate_state {errs}; all sequences: ATE-RMSE "
          f"{ates.min():.5f}-{ates.max():.5f} m", flush=True)
    if not (ates[0] < OPT_ATE_BOUND and n_1pt > 0 and errs == []):
        raise AssertionError("options path outside its bound, no 1-point "
                             "RANSAC reject, or an invariant broken")
    expect = {k.name: 0 for k in others}
    expect.update({"chol_lanes": T, "chol_inv_lanes": 4 * T,
                   "tri_inv_lanes": 4 * T})
    expect.update(chain_launches(cfg, T))
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")

    # (c) B1-B3 on the inputs of this path's frames, past the outliers'
    # start (the instate and 1-point downdates at 60, the OOS blocks at
    # 120, the recompression at 228)
    s, fib, _ = make_run(cfg, torch, DEV, B, frames=OPT_CAPTURE_FRAMES,
                         edit=corrupted)
    names = ["chol_lanes", "chol_inv_lanes", "tri_inv_lanes"]
    with Recorder(torch, lc, names) as seen:
        run_batch(cfg, s, fib)
    torch.cuda.synchronize()
    pairs = {"chol_lanes": (lc.chol_lanes, lc.chol_plain),
             "chol_inv_lanes": (lc.chol_inv_lanes, lc.chol_inv_plain),
             "tri_inv_lanes": (lc.tri_inv_lanes, lc.tri_inv_plain)}
    start = OPT_CORRUPT["start"]
    checks = {}
    for name, (kernel, plain) in pairs.items():
        per_frame = len(seen[name]) // OPT_CAPTURE_FRAMES
        inputs = [a[0] for a in seen[name][start * per_frame:]]
        err, rel, rel_plain, use, _ = hold(torch, kernel, plain,
                                           [("options", X) for X in inputs])
        shapes = sorted({X.shape[-1] for X in inputs})
        print(f"kernel {name} on the options path (frames {start}-"
              f"{OPT_CAPTURE_FRAMES - 1}, {len(inputs)} inputs, m in "
              f"{shapes}): row-relative error {rel['options']:.3e} (plain "
              f"float32 vs float64 {rel_plain:.3e}), worst error / limit "
              f"{use:.3f}, max_abs_err {err:.3e}", flush=True)
        if use > 1.0:
            raise AssertionError(f"{name} on the options path: error above "
                                 f"its limit ({use:.3f} x)")
        checks[name] = dict(max_abs_err=err, row_rel_err=rel["options"],
                            use=use, inputs=len(inputs), m=shapes)
    del seen
    return launches, checks


def batched_phase(torch, kernels):
    """Phase 31: batched propagation (the full form) and the closed-form
    VI bootstrap. Returns the main run's launches."""
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.filter.vi_init import vi_bootstrap
    from xivo_tpu_torch.runner import fit_substeps, run_batch
    from xivo_tpu_torch.sim.configs import PCW_CFG
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    cfg = config_from_json(PCW_CFG, propagation_mode="batched")
    assert (cfg.dims.full, cfg.dtype, cfg.covariance_form) == (
        228, "float32", "full")
    fi, gt = build_pcw_stream(cfg, total_time=TOTAL_TIME, noise_px=0.25)
    assert fit_substeps(cfg, fi) is cfg
    compare_devices(torch, "batched propagation", cfg, BAT_CMP_FRAMES,
                    COUNT_FIELDS, BAT_PATH_TOL)

    cfg = config_from_json(PCW_CFG, propagation_mode="batched",
                           sim_initialize_depths=True)
    s, fib, gt = make_run(cfg, torch, DEV, BAT_B, frames=BAT_FRAMES)
    T = BAT_FRAMES
    (s, outs), wall, launches = counted(
        torch, kernels, lambda: run_batch(cfg, s, fib))
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb - gt["Tsb"][None, :T], axis=2)
    ates = np.sqrt(np.mean(err ** 2, axis=1))
    print(f"batched propagation main path: B={BAT_B} T={T} D={cfg.dims.full}"
          f" (total_substeps {cfg.total_substeps}, max_substeps "
          f"{cfg.max_substeps}; full covariance) wall {wall:.3f} s "
          f"sequence-frames/s {BAT_B * T / wall:.1f} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches "
          f"{launches}; sequence 0: ATE-RMSE {ates[0]:.5f} m (bound "
          f"{BAT_ATE_BOUND}); all sequences: ATE-RMSE {ates.min():.5f}-"
          f"{ates.max():.5f} m", flush=True)
    if not ates[0] < BAT_ATE_BOUND:
        raise AssertionError(f"ATE {ates[0]} >= {BAT_ATE_BOUND}")
    if any(launches.values()):
        raise AssertionError(f"launches {launches}, expected none")

    # vi_bootstrap on a window of the same stream, both devices
    res = {}
    for dev in (DEV, "cpu"):
        w = [torch.from_numpy(np.ascontiguousarray(a[:VI_WINDOW])).to(dev)
             for a in fi]
        intrin = torch.tensor(list(cfg.cam_params[2:6]) + [0.0] * 5,
                              dtype=w[0].dtype).to(dev)
        for depth in (True, False):
            t0 = time.time()
            r = vi_bootstrap(cfg, intrin, *w[:6], w[7],
                             *([w[6]] if depth else []))
            ok = bool(r.cond_ok)
            res[dev, depth] = (r.v0.cpu().numpy(), r.g_b0.cpu().numpy(), ok,
                               time.time() - t0)
    for depth in (True, False):
        (vg, gg, okg, tg), (vc, gc, okc, tc) = res[DEV, depth], \
            res["cpu", depth]
        dv, dg = float(np.abs(vg - vc).max()), float(np.abs(gg - gc).max())
        print(f"vi_bootstrap ({'depth-aided' if depth else 'visual-only'}, "
              f"{VI_WINDOW} frames): cuda v0 {vg.tolist()} g {gg.tolist()} "
              f"cond_ok {okg} ({tg:.2f} s); cpu cond_ok {okc} ({tc:.2f} s); "
              f"|dv0| {dv:.3e} |dg| {dg:.3e}", flush=True)
        if not (okg and okc and dv < VI_TOL and dg < VI_TOL):
            raise AssertionError("vi_bootstrap: ill-conditioned, or CUDA "
                                 "disagrees with the CPU")
    return launches


def front_end_run(torch, cfg, stream, dev, batch, frames):
    """`run_batch_image`'s frame loop, also keeping each frame's next
    track id: (StepOutputs stacked (B, T), tracks spawned each frame
    (B, T))."""
    from xivo_tpu_torch.frontend.tracker import vio_frame_image
    from xivo_tpu_torch.runner import _stack
    s, f, fib = make_image_run(cfg, torch, dev, batch, stream, frames)
    outs, fids = [], [s.next_fid]
    for t in range(fib.frame_dt.shape[1]):
        s, f, out = vio_frame_image(cfg, s, f, *(a[:, t] for a in fib))
        outs.append(out)
        fids.append(s.next_fid)
    return _stack(outs), torch.diff(torch.stack(fids, 1), dim=1)


def compare_front_end(torch, label, cfg, stream, frames):
    """The CUDA path of `cfg` against its CPU path on B = 2 for `frames`
    frames: poses within IMG_PATH_TOL; FRONT_COUNTS and the tracks spawned
    equal frame by frame. The CUDA run also fills the config's device
    constants (the warm-up before a checked run)."""
    res = {}
    for dev in (DEV, "cpu"):
        t0 = time.time()
        res[dev] = front_end_run(torch, cfg, stream, dev, 2, frames)
        print(f"{label} {dev} path: {frames} frames in "
              f"{time.time() - t0:.1f} s", flush=True)
    (og, sg), (oc, sc) = res[DEV], res["cpu"]
    dpos = float((og.Tsb.cpu() - oc.Tsb).abs().max())
    same = torch.equal(sg.cpu(), sc)
    for name in FRONT_COUNTS:
        x, y = getattr(og, name).cpu(), getattr(oc, name)
        same &= torch.equal(x, y)
        print(f"{label} cuda vs cpu path: {name} cuda {x[0].tolist()} cpu "
              f"{y[0].tolist()}", flush=True)
    print(f"{label} cuda vs cpu path: spawned cuda {sg[0].tolist()} cpu "
          f"{sc[0].tolist()}", flush=True)
    print(f"{label} cuda vs cpu path, {frames} frames: max |dTsb| "
          f"{dpos:.3e} m; counts {'equal' if same else 'DIFFER'}",
          flush=True)
    if not (dpos < IMG_PATH_TOL and same):
        raise AssertionError(f"the CUDA path disagrees with the CPU path "
                             f"({label})")


def front_end_main_run(torch, label, cfg, stream, kernels, expect):
    """`cfg` at IMG_B over the whole stream, counted under the sync debug
    mode (after `compare_front_end`'s CUDA run): finite poses and the
    launches `expect`; returns (outputs, launches)."""
    from xivo_tpu_torch.runner import run_batch_image
    s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream)
    T = int(fib.frame_dt.shape[1])
    (s, f, outs), wall, launches = counted(
        torch, kernels, lambda: run_batch_image(cfg, s, f, fib))
    if not torch.isfinite(outs.Tsb).all() or \
            not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    print(f"{label} main path: B={IMG_B} T={T} 512x512 D={cfg.dims.full} "
          f"wall {wall:.3f} s sequence-frames/s {IMG_B * T / wall:.1f} "
          f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches {launches}", flush=True)
    want = {k.name: 0 for k in kernels}
    want.update({name: n * T for name, n in expect.items()})
    want.update(chain_launches(cfg, T))
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return outs, launches


def match_phase(torch, kernels):
    """Phase 32: the MATCH tracker at full width. Returns its launches and
    its stream."""
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    t_phase = time.time()
    cfg = image_config(tracker_type="MATCH", detector="ORB",
                           descriptor="orb")
    assert (cfg.tracker_type, cfg.detector, cfg.descriptor_type,
            cfg.dims.full) == ("MATCH", "ORB", "orb", 228)
    stream = build_image_stream(cfg)
    compare_front_end(torch, "match", cfg, stream, MATCH_CMP_FRAMES)
    outs, launches = front_end_main_run(
        torch, "match", cfg, stream, kernels,
        {"chol_lanes": 1, "chol_inv_lanes": 1, "tri_inv_lanes": 1})
    err = np.linalg.norm(outs.Tsb[0].cpu().numpy() - stream[1]["Tsb"],
                         axis=1)
    ntr = outs.num_tracked[0].cpu().numpy()
    print(f"match main path, sequence 0: final error {err[-1]:.4f} m "
          f"(bound {IMG_FINAL_BOUND}), median {np.median(err):.4f} m (bound "
          f"{IMG_MEDIAN_BOUND}), RMSE {np.sqrt(np.mean(err ** 2)):.4f} m; "
          f"tracked from frame 10 at least {int(ntr[10:].min())} (bound "
          f"{IMG_MIN_TRACKED}); on {card_line()}; phase 32 done in "
          f"{time.time() - t_phase:.1f} s", flush=True)
    if not (err[-1] < IMG_FINAL_BOUND and np.median(err) < IMG_MEDIAN_BOUND
            and ntr[10:].min() >= IMG_MIN_TRACKED):
        raise AssertionError("MATCH path outside the image path's bounds")
    return launches, stream


def detector_checks(torch, label, images):
    """Phase 33(a) on (DET_B, H, W) float32 images: each new detector
    score, its non-maximum suppression and top-DET_K pick on the card
    against the CPU, then each descriptor kind at the CPU's oFAST picks."""
    from xivo_tpu_torch.frontend import brief, descriptors, fast
    from xivo_tpu_torch.frontend.image import blur5
    img = {dev: torch.from_numpy(np.ascontiguousarray(images)).to(dev)
           for dev in (DEV, "cpu")}
    B = images.shape[0]
    picks = {}
    for name in DET_SCORES:
        out = {}
        for dev in (DEV, "cpu"):
            t0 = time.time()
            sc = getattr(fast, name)(img[dev])
            none = torch.zeros((B, 1), dtype=torch.bool, device=dev)
            pk = fast.select_topk(fast.nms3(sc), DET_K, 8,
                                  torch.zeros((B, 1, 2), device=dev), none,
                                  15)
            out[dev] = [x.cpu() for x in (sc,) + pk] + [time.time() - t0]
        (sg, xg, vg, og, tg), (sc, xc, vc, oc, tcpu) = out[DEV], out["cpu"]
        scale = sc.abs().amax(dim=(-2, -1)).clamp_min(1e-30)
        rel = float(((sg - sc).abs().amax(dim=(-2, -1)) / scale).max())
        same = torch.equal(xg, xc) and torch.equal(og, oc)
        print(f"detector {name} on {label}: scores within {rel:.3e} of each "
              f"map's largest (limit {DET_SCORE_RTOL}); {int(oc.sum())} "
              f"picks, {'equal' if same else 'DIFFER'}; cuda {tg:.3f} s cpu "
              f"{tcpu:.3f} s", flush=True)
        if not (rel <= DET_SCORE_RTOL and same):
            raise AssertionError(f"detector {name} on the card disagrees "
                                 f"with the CPU ({label})")
        picks[name] = (xc, oc)
    xy, ok = picks["ofast_score"]
    for kind, k in sorted(descriptors.KINDS.items()):
        words = [descriptors.extract(k, blur5(img[dev]), xy.to(dev)).cpu()
                 for dev in (DEV, "cpu")]
        flips = brief.popcount32(torch.bitwise_xor(*words)).sum(-1)
        share = float(flips[ok].sum()) / (int(ok.sum()) * brief.N_BITS)
        print(f"descriptor {kind} on {label}: {share:.5f} of the bits "
              f"differ (limit {DESC_BIT_SHARE}) over {int(ok.sum())} "
              f"keypoints", flush=True)
        if not share <= DESC_BIT_SHARE:
            raise AssertionError(f"descriptor {kind} on the card disagrees "
                                 f"with the CPU ({label})")


def textured_phase(torch, kernels, match_stream):
    """Phase 33: the building blocks on the card against the CPU, then the
    LK tracker with GFTT, BRISK words and the dropped-track rescue on the
    textured stream. Returns its launches."""
    from xivo_tpu_torch.sim.configs import EQUIDISTANT_512_CAM
    from xivo_tpu_torch.sim.image_stream import VIS_DT, build_image_stream
    from xivo_tpu_torch.sim.texture import world_for
    t_phase = time.time()
    cfg = image_config(EQUIDISTANT_512_CAM, detector="GFTT",
                           descriptor="brisk", match_dropped_tracks=True)
    assert (cfg.cam_model, cfg.detector, cfg.descriptor_type,
            cfg.match_dropped_tracks) == ("equidistant", "GFTT", "brisk",
                                          True)
    t0 = time.time()
    stream = build_image_stream(cfg, total_time=VIS_DT * TEX_FRAMES + 0.01,
                                world=world_for(cfg))
    assert stream[0].image.shape == (TEX_FRAMES, 512, 512)
    print(f"textured stream: {TEX_FRAMES} frames of 512x512 through "
          f"EQUIDISTANT_512_CAM rendered in {time.time() - t0:.1f} s",
          flush=True)
    dots = match_stream[0].image
    detector_checks(torch, "phase 32's frames",
                    dots[::len(dots) // DET_B][:DET_B])
    detector_checks(torch, "textured frames", stream[0].image[:DET_B])

    compare_front_end(torch, "textured", cfg, stream, TEX_CMP_FRAMES)
    outs, launches = front_end_main_run(
        torch, "textured", cfg, stream, kernels,
        {"chol_lanes": 1, "chol_inv_lanes": 1, "tri_inv_lanes": 1,
         "lk_sample_templates": cfg.klt_max_level,
         "lk_gn_tracks": cfg.klt_max_level})
    err = np.linalg.norm(outs.Tsb[0].cpu().numpy() - stream[1]["Tsb"],
                         axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    ntr = outs.num_tracked[0].cpu().numpy()
    print(f"textured main path, sequence 0: ATE-RMSE {ate:.5f} m (bound "
          f"{TEX_ATE_BOUND}), final error {err[-1]:.4f} m; tracked from "
          f"frame 10 at least {int(ntr[10:].min())} (bound "
          f"{TEX_MIN_TRACKED}); on {card_line()}; phase 33 done in "
          f"{time.time() - t_phase:.1f} s", flush=True)
    if not (ate < TEX_ATE_BOUND and ntr[10:].min() >= TEX_MIN_TRACKED):
        raise AssertionError("textured path outside its bounds")
    return launches


def same_tree(torch, a, b):
    """Whether two (nested) tuples of tensors are equal, leaf by leaf."""
    if isinstance(a, tuple):
        return all(same_tree(torch, x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def on_device(torch, fn):
    """fn() with the sync debug mode set to raise (the caller counts)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def dist_phase(torch, kernels, searches, mapped):
    """Phase 34: the distribution layer on a one-rank NCCL group of cuda:0,
    each path counted under the sync debug mode against the path without
    it. `searches`: phase 10's recorded B6 inputs; `mapped`: (config,
    state, maps) of the mapped main run at frame 131, on the host.
    Returns ({path: launches}, B6's JSON entry's additions)."""
    import torch.distributed as tdist

    from xivo_tpu_torch.dist import make_sharded_matcher
    from xivo_tpu_torch.dist.multihost import global_mesh
    from xivo_tpu_torch.dist.segments import run_segment_parallel
    from xivo_tpu_torch.map.bigmap import refine_map
    from xivo_tpu_torch.map.mapper import detect_loop_closures
    from xivo_tpu_torch.ops import hamming as hm
    from xivo_tpu_torch.runner import (draw_generator, fit_substeps,
                                       inputs_to_device, make_sharded_runner,
                                       p3p_draws, run_batch)
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    t_phase = time.time()
    # the group and NCCL's communicator, before any sync check
    group = global_mesh()
    warm = torch.ones(1, device=DEV)
    tdist.all_reduce(warm, group=group)
    torch.cuda.synchronize()
    n = tdist.get_world_size(group)
    print(f"dist: {n}-rank {tdist.get_backend(group)} group on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    launches, extra = {}, {}

    # (a) the sharded runner on the PCW main path at full width
    cfg = pcw_config()
    s, fib, _ = make_run(cfg, torch, DEV, B, frames=DIST_FRAMES)
    sharded = make_sharded_runner(cfg, group)
    (s1, o1), w1, l1 = counted(torch, kernels, lambda: sharded(s, fib))
    (s0, o0), w0, l0 = counted(torch, kernels,
                               lambda: run_batch(cfg, s, fib))
    inst = int(o1.num_instate_features[:, -1].min())
    print(f"dist (a) sharded runner: B={B} T={DIST_FRAMES} "
          f"D={cfg.dims.full}, wall {w1:.3f} s against run_batch's "
          f"{w0:.3f} s; in-state features at the last frame >= {inst}; "
          f"launches {l1} (run_batch {l0})", flush=True)
    if not (same_tree(torch, o1, o0) and same_tree(torch, s1, s0)):
        raise AssertionError("the sharded runner differs from run_batch")
    want = {k.name: 0 for k in kernels}
    want.update({name: DIST_FRAMES for name in
                 ("chol_lanes", "chol_inv_lanes", "tri_inv_lanes")})
    want.update(chain_launches(cfg, DIST_FRAMES))
    if not (l1 == l0 == want and inst > 0):
        raise AssertionError(f"launches {l1}, {l0}, expected {want}; "
                             f"in-state features {inst}")
    launches["sharded_pcw"] = l1
    del s, fib, s1, o1, s0, o0

    # (b) the sharded matcher on phase 10's searches and the random case;
    # detect_loop_closures with it on the mapped main run's state
    match = make_sharded_matcher(group)
    cases = [(f"recorded {k}", tuple(t.to(DEV) for t in a[:3]))
             for k, a in enumerate(searches)]
    cases.append(("random", random_hamming_inputs(torch, MAP_B, 20000, 256,
                                                  seed=256)))
    total = {k.name: 0 for k in kernels}
    for label, (q, d, v) in cases:
        (nn, nd), _, got = counted(torch, kernels, lambda: match(q, d, v))
        dd, ii = hm.hamming_nn(q, d, v)
        if not (torch.equal(nn, ii) and torch.equal(nd, dd)):
            raise AssertionError(f"sharded matcher differs ({label})")
        total = {k: total[k] + got[k] for k in total}
    q, d, v = cases[-1][1]
    ms_match = cuda_ms(torch, lambda: match(q, d, v))
    ms_single = cuda_ms(torch, lambda: hm.hamming_nn(q, d, v))
    mcfg, st, mp = mapped
    st, mp = moved(torch, (st, mp), DEV)
    u = p3p_draws(mcfg, st, draw_generator(st, 3))
    kw = dict(nn_dist_thresh=mcfg.lc_nn_dist_thresh,
              ransac_thresh=mcfg.lc_ransac_thresh,
              min_matches=mcfg.lc_min_matches)
    lc1, _, got = counted(torch, kernels, lambda: detect_loop_closures(
        mcfg, st, mp, u, matcher=match, **kw))
    lc0 = detect_loop_closures(mcfg, st, mp, u, **kw)
    if not same_tree(torch, tuple(lc1), tuple(lc0)):
        raise AssertionError("detect_loop_closures(matcher=) differs")
    total = {k: total[k] + got[k] for k in total}
    print(f"dist (b) sharded matcher: {len(cases)} searches (phase 10's "
          f"{len(cases) - 1}, random (64, 256, 8) x (64, 20000, 8)) equal "
          f"to hamming_nn; random: {ms_match:.4f} ms against "
          f"{ms_single:.4f} ms alone; detect_loop_closures(matcher=) on "
          f"the mapped state at frame {MAP_CAPTURE_FRAME + 1} equal, "
          f"{int(lc1[2].sum())} inliers on {int(lc1[3].sum())} of "
          f"{MAP_B} sequences; launches {total}", flush=True)
    want = {k.name: 0 for k in kernels}
    want["hamming_nn"] = len(cases) + 1
    if total != want or not bool(lc1[3].any()):
        raise AssertionError(f"launches {total}, expected {want}, or no "
                             f"closure")
    launches["sharded_matcher"] = total
    extra["sharded_matcher_ms"] = ms_match
    del cases, st, mp, u

    # (c) refine_map(mesh=) on phase 13's map
    bm = synthetic_bigmap(torch, mcfg)
    times, hists = {}, {}
    for name, mesh in (("single", None), ("mesh", group)):
        refine_map(mcfg, bm, iters=1, mesh=mesh)            # warm
        torch.cuda.synchronize()
        (out, chi2), times[name], _ = counted(
            torch, kernels, lambda: refine_map(mcfg, bm, iters=8,
                                               mesh=mesh))
        hists[name] = (out, chi2[0].double().cpu().numpy())
    h1, h0 = hists["mesh"][1], hists["single"][1]
    dchi = np.abs(h1 - h0)
    lim = DIST_CHI2_RTOL * h0 + DIST_CHI2_ATOL * h0[0]
    dX = float((hists["mesh"][0].Xs - hists["single"][0].Xs).abs().max())
    print(f"dist (c) refine_map(mesh=): 4096 landmarks x 256 keyframes, 8 "
          f"iterations in {times['mesh'] * 1e3:.1f} ms against "
          f"{times['single'] * 1e3:.1f} ms alone; chi2 {h1[0]:.6e} -> "
          f"{h1[-1]:.6e}; largest |dchi2| / limit "
          f"{float((dchi / lim).max()):.3e}; landmarks within "
          f"{dX:.3e} m", flush=True)
    if not (dchi <= lim).all():
        raise AssertionError("refine_map(mesh=)'s chi2 history differs")
    del bm, hists

    # (d) segments over the sharded runner against the default runner;
    # each runner's frame loop under the sync debug mode, its upload
    # before it
    fi, _ = build_pcw_stream(cfg, total_time=TOTAL_TIME, noise_px=0.25,
                             motion="orbit")

    def loop(make):
        def run(states, fis):
            c = fit_substeps(cfg, fis)
            f = inputs_to_device(fis, DEV)
            torch.cuda.synchronize()
            return on_device(torch, lambda: make(c)(states, f))
        return run
    runs = {}
    for name, make in (
            ("default", lambda c: lambda st, f: run_batch(c, st, f)),
            ("sharded", lambda c: make_sharded_runner(c, group))):
        runs[name], _, launches[f"segments_{name}"] = counted(
            torch, kernels, lambda: run_segment_parallel(
                cfg, fi, runner=loop(make), device=DEV, **DIST_SEG),
            sync_check=False)
    (f1, o1), (f0, o0) = runs["sharded"], runs["default"]
    L = int(o1.Tsb.shape[1])
    print(f"dist (d) run_segment_parallel: {DIST_SEG['n_segments']} "
          f"segments of {L} frames over the {fi.frame_dt.shape[0]}-frame "
          f"orbit; sharded runner against the default: fused trajectory "
          f"and outputs equal; in-state features at the segments' last "
          f"frame {o1.num_instate_features[:, -1].tolist()}; launches "
          f"{launches['segments_sharded']}", flush=True)
    if not (np.array_equal(f1, f0) and same_tree(torch, o1, o0)
            and launches["segments_sharded"] == launches[
                "segments_default"]):
        raise AssertionError("segments over the sharded runner differ")
    tdist.destroy_process_group()
    print(f"phase 34 done in {time.time() - t_phase:.1f} s on "
          f"{card_line()}", flush=True)
    return launches, extra


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xivo_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from xivo_tpu_torch.ops import chol
    from xivo_tpu_torch.ops import hamming as hm
    from xivo_tpu_torch.ops import imu_chain as ic
    from xivo_tpu_torch.ops import lanes_chol as lc
    from xivo_tpu_torch.ops import lk as lko

    t_start = time.time()
    card = card_line()
    print(f"card: {card}; host: {len(os.sched_getaffinity(0))} CPUs "
          f"usable, {torch.get_num_threads()} PyTorch threads", flush=True)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on"

    t0 = time.time()
    built = build_kernels()
    print(f"build: {sorted(built)} in {time.time() - t0:.1f} s", flush=True)
    chol_entry = check_chol_blocked(torch, lc, chol)
    chol_entry["launches"] = profile_phase(torch, chol)
    stamp("B7 phases", t_start)
    kernels, base_ate, pcw_launches = pcw_phases(torch, lc,
                                                chol.KERNELS + ic.KERNELS)
    stamp("pcw phases", t_start)
    chain_entry = check_imu_chain(torch)
    stamp("IMU chain phase", t_start)
    acc_launches, oos_shapes = accuracy_phases(torch, lc, chol, base_ate)
    stamp("accuracy phases", t_start)
    full_launches, full_acc_launches, full_b1 = full_form_phases(
        torch, lc, chol)
    stamp("default filter phases", t_start)
    lk_kernels, img_launches = image_phases(torch, lc, lko,
                                            chol.KERNELS + ic.KERNELS)
    stamp("image phases", t_start)
    tumvi_checks, tumvi_launches, tumvi_acc_launches, equi_launches = \
        slice11_phases(torch, lc, lko, hm, chol)
    stamp("TUM-VI phases", t_start)
    hm_kernel, map_launches, mcfg, after, searches = mapped_phases(
        torch, lc, hm, chol.KERNELS + ic.KERNELS)
    dist_mapped = (mcfg,) + tuple(moved(torch, after, "cpu"))
    del after
    stamp("mapped phases", t_start)
    refine_phase(torch, mcfg)
    all_kernels = (lc.KERNELS + lko.KERNELS + hm.KERNELS + chol.KERNELS
                   + ic.KERNELS)
    img_map_launches = image_mapped_phase(torch, all_kernels)
    stamp("refine and image-mapped phases", t_start)
    api_full_launches, api_sqrt_launches = api_pcw_phase(
        torch, all_kernels, lc)
    asl_launches = asl_replay_phase(torch, all_kernels, lko)
    tumvi_api_launches = tumvi_api_phase(torch, all_kernels, lko)
    stamp("API phases", t_start)
    opt_launches, opt_checks = options_phase(
        torch, lc, lko.KERNELS + hm.KERNELS + chol.KERNELS + ic.KERNELS)
    stamp("options phase", t_start)
    bat_launches = batched_phase(torch, all_kernels)
    stamp("batched propagation phase", t_start)
    match_launches, match_stream = match_phase(torch, all_kernels)
    tex_launches = textured_phase(torch, all_kernels, match_stream)
    del match_stream
    stamp("image-mode options phases", t_start)
    dist_launches, dist_extra = dist_phase(torch, all_kernels, searches,
                                           dist_mapped)
    del searches, dist_mapped
    stamp("distribution phase", t_start)
    for k in kernels:
        k["oos_shape"] = oos_shapes[k["name"]]
        k["options_path"] = opt_checks[k["name"]]
        if k["name"] == "chol_lanes":
            k["full_form_compression"] = full_b1
    hm_kernel.update(dist_extra)
    kernels += lk_kernels + [hm_kernel, chol_entry, chain_entry]
    for k in kernels:
        name = k["name"]
        k["launches_pcw_path"] = pcw_launches.get(name, 0)
        k["launches_accuracy_path"] = acc_launches.get(name, 0)
        k["launches_default_filter_path"] = full_launches.get(name, 0)
        k["launches_full_accuracy_compressed_path"] = full_acc_launches.get(
            name, 0)
        k["launches_image_path"] = img_launches.get(name, 0)
        k["launches_mapped_path"] = map_launches.get(name, 0)
        k["launches_image_mapped_path"] = img_map_launches[name]
        k["launches_profile_path"] = (chol_entry["launches"]
                                      if k is chol_entry else 0)
        k["launches_tumvi_path"] = tumvi_launches.get(name, 0)
        k["launches_tumvi_accuracy_cmp_path"] = tumvi_acc_launches.get(
            name, 0)
        k["launches_equidistant_image_path"] = equi_launches.get(name, 0)
        k["launches_api_default_filter_path"] = api_full_launches[name]
        k["launches_api_sqrt_path"] = api_sqrt_launches[name]
        k["launches_asl_replay_path"] = asl_launches[name]
        k["launches_tumvi_api_path"] = tumvi_api_launches[name]
        k["launches_options_sqrt_path"] = opt_launches[name]
        k["launches_batched_path"] = bat_launches[name]
        k["launches_match_path"] = match_launches[name]
        k["launches_textured_path"] = tex_launches[name]
        for path, got in dist_launches.items():
            k[f"launches_{path}_path"] = got[name]
        if name in tumvi_checks:
            k["tumvi_shape"] = tumvi_checks[name]
    stamp("elapsed", t_start, ":")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
