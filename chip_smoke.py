#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`gorio_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (more for the tables):
  1. device  — the card (`nvidia-smi` name and power limit, torch's name);
               fails without CUDA.
  2. build   — builds the 1-NN kernels from `gorio_tpu_torch/ops/csrc/` with
               nvcc and the native `.grf` runtime with g++, side by side, and
               prints the build seconds and ptxas' report.
  3. kernels — holds both kernels (`nn1_best` <- `gorio_nn1`, `nn1_select` <-
               `gorio_nn1_select`) against their plain PyTorch versions, run
               at the kernel's float32 arithmetic, on the same CUDA inputs:
               the main path's call (N = M = 2048, f64 query, f32 ref, bool
               mask, f32 11-column payload), the same all-f32 and all-f64,
               refs that repeat every M / S so that each minimum ties across
               the cluster's CTAs (the lowest copy must win), M = 5 < S,
               N = 1, a ragged batch (B = 3, N = 1537, M = 1999, 30% masked,
               the payload a strided view) and a batch whose refs are all
               masked. Indices must agree except at near-ties (the two
               candidates' d2 within 1e-5 * max(1, d2)); d2 and the payload
               must be allclose (rtol 1e-5, atol 1e-6; the payload on rows
               whose indices agree). Then, at the main path's call: one call
               must put exactly one kernel on the card (torch.profiler);
               each kernel's time per launch (CUDA events around 100
               launches), alone (profiler) and per single call, the plain
               version's, the library's (`torch.cdist`, masked `min`, and a
               gather for `nn1_select`) and the bound.
               The same checks and timing row at the loop-verification call:
               B = 32 pairs of N = M = 2048 (the library: batched `cdist`),
               at scan-to-submap's (N = 2048, M = 8192, f64), and at the
               align pair's (N = M = 131072, f32 query and ref, the
               synthetic pair's masks and padding rows; the library there:
               `cdist` + `min` over blocks of 8192 queries, as the whole
               distance matrix, 64 GiB, does not fit).
  4. slice   — the port's CLI, its default command: `simulate` (seed 0, 20 s
               at 5 Hz, capacity 2048, 9000 landmarks: 98 frames), `slam
               --device cuda --dump D --map M` (loop closure on), `evaluate`.
               Fails unless the
               `nn1_select` launches equal the per-frame LM iterations plus
               the loop verification's outer LM iterations, `nn1` launched
               too, every keyframe cloud lives on the card, loop detection
               ran (its gate counts are not empty), the keyframe count is
               80 +- 4, the loop count the JAX package's (0: the 40 m drive
               never passes the 50 m accumulated-distance gate) and the ATE
               is <= 0.05 m. The dumped graph, reloaded with
               `PoseGraph.load`, must hold one vertex per keyframe at the
               trajectory's poses (1e-9 m); the map's point count must lie
               within 2% of the JAX package's record and its bounds within
               0.05 m. Then the same `slam` with `--config` of `dump-config`'s
               tree must give the same trajectory to the bit.
               `estimate_ground` and `dbscan_cluster`, each run twice on one
               frame of the sequence (float64, on the card), must agree to
               the bit (their segment sums are sorted and segmented).
  5. circuit — the repo's loop sequence at full width: `simulate --duration
               75 --rate 5 --seed 22 --circuit --laps 2 --dynamic 2` (373
               frames, two laps of a closed route), `slam --optimize-every 15
               --device cuda`, `evaluate`. Fails unless the block-sparse
               solver ran at 256 and at 512 padded poses, a candidate pair
               reached registration
               verification, a loop was accepted, no accepted loop joins two
               keyframes more than 7 m apart in ground truth, `nn1_select`
               launched over a batch of more than one pair, its launches
               equal the odometry's plus the verification's LM iterations,
               and the keyframes (+-2%), loops (+-2) and ATE (<= 1.25 x + 0.02
               m) hold against the JAX package's record of the same run.
               Prints each graph solve's time per LM iteration (the card
               synchronised around each) and profiles the last sparse solve
               once more.
  6. full-slice — the 98-frame sequence with the paper's configuration:
               `slam --fused --preprocess --floor --preint ugpm` (the fused
               preprocessing frontend: gates, ego-velocity, dynamic-object
               removal, deskew, Patchwork++ ground segmentation, DBSCAN ids,
               APDGICP; UGPM preintegration; the floor plane solved jointly
               with the poses, dense at 128 padded poses). Fails unless the
               launch identity above holds, dense plane solves ran, the
               keyframes are within 2% of the JAX package's record and the
               ATE is <= 0.05 m.
  7. full-circuit — the circuit with the same four flags and
               `--optimize-every 15` (the configuration of ACCURACY.json's and
               RECALL.json's circuit): fails unless sparse plane solves ran,
               the keyframes (+-2%), loops (+-2, none with a ground-truth
               endpoint gap over 7 m), ATE (<= 1.25 x + 0.02 m) and the floor
               plane (normal within 1e-2 rad, offset within 0.05 m) hold
               against the JAX package's record on float64 frames (the
               frames the port's CLI uploads). It prints the same comparison
               with the JAX CLI's own run on its float32 frames (ACCURACY.json's
               record), which is not held (ROADMAP Queue C).
  Phases 5-7 print the stage medians and means, every graph solve's time per
  LM iteration, UGPM's ms per keyframe (the card synchronised around each
  call), the launches, and the card's name and power limit on the same line.
  8. ndt-slice — the 98-frame sequence with `slam --registration ndt`, then
               `slam --fused --registration ndt` (NDT P2D DIRECT7 against the
               keyframe's voxel map, built on every align). Fails unless each
               gives the JAX record's keyframes (+-2%), 0 loops, ATE <= 0.05
               m, `nn1` launched (frames - 1) + (keyframes - 1) times (the
               inlier fraction and the edge information) and `nn1_select`
               never (NDT replaced APDGICP, no loop was verified), and a
               voxel map built from a keyframe cloud lives on the card. Two
               builds of the same keyframe's NDT map, VGICP map and voxel
               downsample must agree to the bit. Prints the ATE beside the
               JAX record, the stage medians and means, NDT's outer
               iterations per frame and one map build's time.
  9. scan-to-map — `ScanMatchingOdometry(OdometryConfig(enable_scan_to_map=
               True, registration=r))` for r in ndt and apdgicp over the 98
               frames (uploaded as float64, ego velocity as the CLI's
               unfused path), through the Python API
               (`pipeline/odometry_replay.odometry_run`): fails unless the
               odometry trajectory's ATE is <= 1.25 x the JAX package's
               record of the same loop + 0.02 m, the submap lives on the
               card, and the apdgicp run launched `nn1_select` with M = 8192
               refs. Prints the submap rebuild's ms per keyframe.
  10. align  — `bench.py`'s synthetic pair (69,000 points, a known z-rotation
               of 0.02 rad and [0.3, 0.1, 0] m) written as PCD files and
               aligned by `python -m gorio_tpu_torch.cli align` with its
               eight default methods (0.1 m leaf, capacity 131072): fails
               unless each recovers the known transform within 0.05 m and
               1 deg, except NDT_CUDA_D2D, whose JAX CPU run misses them and
               which is held to that run's errors plus the same margins.
               (The NDT readings of `bench.py`'s protocol on the same pair
               are the bench phase's, 17.)
  11. stream — `python -m gorio_tpu_torch.cli stream` on the 98 frames, after
               its warm-up: `--mode block --rate-multiplier 1` (the sensor's
               5 Hz) with `--output`, then `--mode drop --rate-multiplier 4`
               (a 50 ms period), then block mode at 5 Hz through
               `stream_sequence` with an optimize every 15 keyframes, on the
               consumer thread and then on the async worker. Each prints its
               `StreamReport` and launches. Fails unless block mode processes
               all 98 frames and drops none, with the slice's keyframes +-2%;
               drop mode processes or counts every frame; the frames each
               CLI run processed, fed again through a plain loop of the same
               calls (`step_fused` with the same seeded generator,
               `add_frame`, the final `optimize`), give its keyframes and
               trajectory to the bit; the optimizing runs process all 98
               frames and optimize; `nn1_select` launched at least once per
               odometry LM iteration; and the block runs' ATE is <= 0.05 m
               (drop mode's is printed, not held: the odometry's 1 m sanity
               gate rejects the jumps across dropped frames). The realtime
               factor, frames on time and the latency percentiles are
               printed, not held.
  12. posterior — on the slice's and the circuit's `slam` of phases 4-5:
               `sample_posterior()` at the defaults (4 chains x 200 draws
               after 100 warmup iterations, the whitened kernel at step 0.15
               x 16 leapfrog steps), on the slice and the circuit, and with
               `window=10` on the slice: fails unless everything is finite,
               the mean acceptance is > 0.3, the last pose's empirical std
               is within (0.1, 10) x its Laplace std, and the window's
               covariance is (60, 60); prints acceptance, R-hat max, Geyer
               ESS min / median, samples/s, ms per leapfrog step of the
               whole call, and of the sampled density (rebuilt from
               `posterior_graph` and the same solve) through the CUDA
               graph and eager; on the circuit also the kernels and device
               time of one eager density value and gradient (profiler),
               whose CUDA graph replay must equal it within 1e-10, and
               the JAX package's CPU f64 record (`CIRCUIT_POSTERIOR_JAX`,
               not held). (`bench.py`'s 50-keyframe posteriors are the
               bench phase's, 17.) smoother:
               `smc_loop_relaxation(None, ...)` over the circuit's
               keyframes (odometry, preintegration and anchor factors
               around the odometry poses, the accepted loops tempered in)
               with 10,240 particles, 8 stages x 2 MALA moves, printing
               each run's ESS per stage and the stages it resampled: with
               the true loops it fails unless the log evidence and the
               mean are finite, every stage's ESS lies in (1, N], the MALA
               acceptance is > 0.05, the posterior mean's ATE is below the
               odometry's, and the evidence gate passes; then with the
               first loop moved by 255 of its own translation stddevs, and
               replaced by the JAX test's bogus loop (information 100 I, no
               Huber kernel, moved by [20, -15, 5] m,
               `test_evidence_rejects_bogus_loop`'s move): each must lower
               the log evidence by more than 50, and the last must resample
               at a stage; each drop is printed beside the JAX package's
               record (`CIRCUIT_SMOOTHER_JAX`, not held); prints the peak
               memory. Last, `run_hmc` (2 chains x 20 draws, the
               slice's posterior) and `smc_loop_relaxation` (256
               particles, 2 stages, the circuit with the JAX test's bogus
               loop) on the card and on the CPU from the same inputs and
               draws must agree within 1e-8 (the smoother's fields
               relative to each field's largest value), and the smoother
               must resample at the same stages on both, at least one. The
               launch counts of the three `sample_posterior` runs are the
               path's (`launches_by_path["posterior"]`).
  13. solvers-batched — cg-slice: `slam --config` with `dump-config`'s tree
               and `slam.solve.solver = "cg"` on the 98 frames (the dense
               Jacobi-PCG at 128 padded poses), then `evaluate`: fails
               unless the slice's launch identity holds, CG solves ran, and
               the keyframes and loops equal and the ATE lies within 1e-4 m
               of the JAX package's CPU f64 record of the same command
               (`CG_SLICE_JAX`); prints the dense slice's ATE beside it.
               cg-graphs: on the graphs of the runs above (the circuit's
               final pose graph, 512 padded poses; the full-circuit's and
               the full-slice's final floor graphs), each solver's ms per LM
               iteration; the block PCG must end within 1e-6 relative in
               chi2 and 1 mm (and 1e-3 in rotation entries) of the direct
               solve (on the full-circuit's first floor graph at 512 padded
               poses: its final one starts at its own optimum), and two CG solves of the circuit must agree to the
               bit; the dense Jacobi-PCG's gap to the dense Cholesky is
               printed at its default steps and capped at 20 CG steps
               (before an unconverged CG's late steps amplify rounding),
               where it must equal the port's CPU run of the same solve
               within 1e-6 relative and 1e-6 m. (`bench.py`'s batched workloads
               against their loops are the bench phase's, 17.) gn:
               `gn_optimize` on APDGICP's callbacks for slice frames 40 and
               41, 8 iterations:
               `nn1_select` must launch 8 times and T equal the CPU run's
               within 1e-6. preint: `preintegrate` over the JAX test's 4 s
               window, `quantum=1.0` against one window, LPM (within 2e-3
               rad / 2e-2 m, the JAX test's limits) and UGPM (its gaps, which
               exceed those limits in both packages, within 1e-6 of the JAX
               record `CHUNKED_JAX`); then, with the start and the queries
               moved 3.7 / 1.3 ms off the sample grid (where the time-shift
               Jacobians are one-sided), the card against the CPU within 1e-9
               per field, or 10x the CPU's own response to a 1e-15 relative
               move of the gyro samples where that is more; UGPM's covariance
               is printed, not held (on these noiseless streams it inverts a
               JtJ that a 1e-15 move of the input shifts by ~5e-5).
               The launch counts of the cg-slice and of gn are paths of the
               kernels' line.
  14. bag    — the 98-frame slice written as an NTU4DRadLM-style rosbag by
               `tests/tool_inputs.py` in a child process started once the
               slice is simulated (the fire drill's independent writer:
               chunks alternating bz2 / greedy LZ4 / none; the frames in the
               radar frame, intensity as the power channel, the gyro, the
               twist stream and one NavSatFix per second made from the
               ground truth; every stamp shifted by 1.6e9 s). `convert-bag
               --list-topics` must count 98 radar messages and every IMU,
               twist and GPS message; `convert-bag` (timed: pure-Python LZ4
               and bz2) must write 98 frames with the slice's point counts
               net of the points whose power is not above 0, doppler and
               intensity to the bit, points within two float32 roundings
               (2^-22 of their range), stamps within 1e-6 s of the shifted
               ones, and `gps.npz`. Then `slam --fused --preprocess --preint
               ugpm --optimize-every 15` (loops on) with `--config` of
               `dump-config`'s tree with the GPS drift gate at 0 (the
               reference's 5 m gate passes no fix on this run), and
               `evaluate` against the shifted ground truth: fails unless the
               launch identity holds, the keyframe stamps are >= 1.6e9 s, the
               GPS edges equal and the keyframes lie within 2% of the JAX
               package's CPU f64 record of the same bag (`BAG_JAX`), and the
               ATE is <= 1.25 x its + 0.02 m; prints the fixes passing each
               GPS gate and the ATE beside the slice's and the full-slice's.
  15. tools  — `gt-adjust --device cuda` on the circuit's ground truth at
               every 60th pose (1,251 poses, 7,506 dense dimensions) with
               `tests/test_cli_tools.py`'s per-step drift and up to 16
               identity loops one lap apart: fails unless chi2 (1e-9
               relative), the iterations and 11 sampled poses (1e-6 m)
               equal the JAX CPU f64 record (`GT_ADJUST_JAX`); prints ms per
               LM iteration, the peak memory and the end and loop gaps
               before and after. `utm-align --device cuda` on the bag's
               ground truth and its fixes as UTM rows: `n_pairs` equal and
               T_world_utm within 1e-6 m / 1e-7 rad of `UTM_ALIGN_JAX`.
               `align-traj --scale` of the drifted circuit onto its truth:
               the record's JSON within 1e-12 (bit equality printed). None
               launches a kernel. Then both kernels against the exact
               kd-tree (`io/native.NativeKDTree`, float32) at the main
               path's call and the align pair's: d2 within 1e-5 relative,
               indices equal except where the two refs' d2 tie within 1e-6
               relative (counted). `visualize` needs matplotlib, which the
               card's machine lacks: the CPU tests hold it.
  16. mesh   — the sharded programs of `gorio_tpu_torch/parallel/` at full
               width, at the end of the circuit lane: through NCCL at world
               1 in the lane's process (`dryrun_multichip` at its own sizes,
               then the five programs below), then as 4 spawned ranks that
               share the card over gloo with CUDA tensors (the multi-rank
               arithmetic; never a stand-in for NCCL): `sharded_gicp_align`
               over "mp" on the align phase's pair (capacity 131,072,
               APDGICP, float32: 32,768 queries per rank against the whole
               target through `gorio_nn1`), `sharded_ugpm_windows` over "dp"
               on bench.py's 64 windows (float64), `sharded_optimize_graph`
               on the circuit's final graph (512 padded poses, the dense
               solve), `sharded_smc_step` on bench_scaling's 4,096 particles
               per rank (D = 60, float32) and the smoother's mesh form at
               10,240 particles on the smoother phase's draws. Each world
               against the one-card programs on the same inputs (the
               tolerances of tests/test_sharded_programs.py, float32
               loosened: `MESH_*`): the same LM iteration counts, the SMC
               parents equal off ties, the ranks' outputs equal to the bit,
               `gorio_nn1` launched on every rank; NCCL at world > 1 where
               the machine has more cards. Prints each program's seconds,
               ms per LM iteration of the graph at world 1 and 4, launches
               per rank, peak memory per rank and the phase's wall; its
               launches (world 1 and every rank) are the "mesh" path.
  17. bench  — `gorio_tpu_torch/bench.py` (`cli bench`'s workloads) at full
               width with `BENCH_COUNTS`, bench.py's repetition counts cut to
               fit: the 69,000-point `synth_pair` (NDT DIRECT7 single-
               resolution, its synchronised median, coarse-to-fine, DIRECT1,
               the map build, 8 jittered sources batched, fitness and the
               known-pose recovery), APDGICP on 4096-point `random_cloud`s
               and its NN / linearize split, ego velocity over 64 scans, 64
               UGPM windows, HMC (16 chains x 64 draws; the whitened
               quality passes, 16 chains x 512 draws, quadratic and Huber
               loops), the sparse solves at K = 256 and 1024 (float64) and
               8 batched verification aligns. Prints its JSON line tagged
               `[bench]`; fails on a missing key or a non-finite reading, a
               known-pose error over 5 cm / 1 deg (bench.py:360), `fitness`
               not below `fitness_identity`, `hmc_accept_mean` <= 0.5
               (which a TF32 leak collapses), or no launch of either
               kernel. Then bench.py's batched workloads as single batched
               calls, each against a loop of single calls on the same inputs
               (1e-9 relative in f64, 1e-5 in f32; UGPM 1e-8, its LM's own
               noise floor being ~1e-9), timed by the bench module's
               protocol, with their rates: ego velocity over
               64 rendered radar scans of 1,024 points (scans/s; the masks
               must be equal), UGPM fit and query over 64 windows of G =
               128, V = 32 (10 LM iterations; windows/s), NDT DIRECT7
               coarse-to-fine over the 8 jittered sources against the
               phase's maps, both cast to float64 (aligns/s; the same outer
               iterations per lane; in float32 a lane whose stop test sits
               near its threshold parts from its single align by more than
               rounding, whatever the draws: ROADMAP C4).
               Its launches are the "bench" path. It runs first in the
               full-circuit lane, while the circuit is simulated.
  18. evaluation — `gorio_tpu_torch/evaluation/` (the port's counterparts
               of `scripts/`): (a) in both lanes, `recall.analyze` on the
               circuit's and the full-circuit's keyframe stamps and loops:
               fails on a false accept, or where its count of false accepts
               differs from the loops' ground-truth gaps above 7 m; prints
               recall_regions, precision and n_regions beside RECALL.json's
               circuit2 (not held: the loop set is chaotic). (b) In a
               third lane, `evaluation`, `accuracy.
               run_sequence` on the accuracy straight cut to `STRAIGHT_S`
               seconds (`simulate --rate 5 --seed 21 --stops 2 --dynamic 4
               --gps`, the straight's `slam` flags, the CLI's capacity):
               keyframes within 2%, no loop, ATE <= 1.25 x + 0.02 m and the
               GPS edge count of `STRAIGHT_JAX`; its launches are the
               "straight" path. (c) The circuit lane records its `slam`
               with `loop_replay.capture()` (the script's wrapper of
               `detect_batch` and `__post_init__`) and pickles the
               recording; then the evaluation lane's `loop_replay.replay`
               replays it on the card at the default config, which must
               give the run's accepted loops pair for pair (the JAX
               package's replay gives its own run back on the small loop
               circuit, `tests/test_torch_loop_replay.py`), and with
               `REPLAY_COMBO` of `loop_sweep.DEFAULT_COMBOS`; prints loops,
               gate counts, false loops and region recall of each; their
               launches are the "replay" path.
  19. scripts — the rest of `scripts/` as `gorio_tpu_torch/evaluation/`
               modules, in the evaluation lane between 18 (b) and (c), each
               at its script's widths with the repetitions cut
               (`SCRIPTS_DEPTH`): `scaling` over worlds `SCALING_NS`
               (NCCL at 1, gloo ranks sharing cuda:0 above; every row of
               the script's keys, finite, both kernels launched: the
               "scaling" path); `multihost`, two OS processes over TCP
               (gloo on cuda:0): both ranks' ESS equal, within 1e-5, to
               the plain ESS of the demo's population (numpy, float64:
               the normalised weights of -0.5 |x|^2, 1 / sum w^2);
               `ugpm_golden` in float64 on
               the card, every check of `tests/test_ugpm_golden.py` within
               its tolerance against `tests/golden/ugpm_golden.npz`; the
               four profilers (`profile_linearize`, whose launches are the
               "profile_linearize" path, `profile_ndt`,
               `profile_graph_solve`, `profile_ugpm`): host and device ms
               per call, finite; `dispatch`: the four probes' aligns/s
               and the allocator's MiB, `nn1_select` launched (the
               "dispatch" path). A failed rank, a failed multihost
               assertion or a golden value off its tolerance fails the
               run. The kernel phase holds both kernels at
               `profile_linearize`'s call (N = M = 4096, f32) too.
The two sequences are simulated in child processes started at the beginning,
beside the build and the kernel phase. Once the kernel phase has taken its
times alone on the card, three lanes start, each a child process of this
script (`--lane NAME`); the first two wait for the circuit's simulation:
`circuit` runs phase 5, the circuit's part of phase 12 (its `sample_posterior`, the
smoother, `smc_loop_relaxation` on the card against the CPU), CG on its
graph (phase 13), the mesh phase (16) and the recall of phase 18 (a);
`full-circuit` runs the bench phase (17), then phase 7, its recall (18 a)
and CG on its graph; `evaluation` runs phase 18 (b) and phase 19, then
waits for the circuit lane's recording and replays it (18 c). The
other phases run here meanwhile; the host threads and the card are shared,
so each phase's wall clock includes the others' load. A lane's output is
printed when it ends, and its failure fails the script. Each phase prints
a `[time]` line: its seconds and when it ended since the start. Then the
kernels' JSON line, the card line, and the last line `{"ok": true,
"device": {...}}`. Any failure exits non-zero with no result.

"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL, TIE = 1e-5, 1e-6, 1e-5
MAIN_N = 2048  # points per scan at the default capacity: N = M on the main path
MAIN = "main path: (2048, 3) f64 query, f32 ref, bool mask, f32 P=11 payload"
CALLS = 10  # calls profiled to show that one call is one kernel
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: FP32 FLOP/s off the tensor cores, HBM B/s
KEYFRAMES, KEYFRAME_TOL, ATE_MAX = 80, 4, 0.05
VERIFY_B = 32  # loop verification: 2 seeds x up to 16 candidate pairs per batch
VERIFY = f"loop verification: B={VERIFY_B} pairs of (2048, 3), the main path's types"
SUBMAP_M = 8192  # OdometryConfig.submap_capacity
SUBMAP = f"scan-to-submap: (2048, 3) f64 query, ({SUBMAP_M}, 3) f64 ref, f64 P=11 payload"
ALIGN_CAP = 131072  # the align pair's power-of-two capacity
ALIGN = (f"align pair: ({ALIGN_CAP}, 3) f32 query and ref, the synthetic pair's masks, f32 "
         f"P=11 payload")
ALIGN_LIBRARY_BLOCK = 8192  # queries per `cdist` call at the align pair
BENCH_APD = ("bench APDGICP: (4096, 3) f32 source as query, f32 target and its mask as ref, "
             "the linearize's f32 P=11 payload")
BENCH_VERIFY = ("bench verification: B=8 pairs of (1024, 3) f32, the linearize's f32 P=11 "
                "payload")
PROFILE_LIN = ("profile_linearize: N = M = 4096 f32 (`profile_linearize.problem`), the "
               "linearize's f32 P=11 payload")
CIRCUIT_SIM = ["--duration", "75", "--rate", "5", "--seed", "22", "--circuit", "--laps", "2",
               "--dynamic", "2"]
# The JAX package's record of the same commands (`python -m gorio_tpu.cli`,
# CPU, JAX_ENABLE_X64=1; PERF.md): the slice has no loop; the circuit 361
# keyframes, 13 loops, ATE 0.029995 m
SLICE_JAX_LOOPS = 0
CIRCUIT_JAX = {"keyframes": 361, "loops": 13, "ate_m": 0.02999533198297208}
CIRCUIT_SPARSE_POSES = (256, 512)  # the padded pose counts of its sparse solves
FALSE_RADIUS_M = 7.0  # RECALL.json's false_radius_m
FULL = ["--fused", "--preprocess", "--floor", "--preint", "ugpm"]
# The JAX package's record of the same commands with the four flags, on the
# frames as float64 (`PYTHONPATH= JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python
# -m gorio_tpu.cli slam ... --fused --preprocess --floor --preint ugpm
# [--optimize-every 15]`, its reader's float32 frames handed over as
# float64, as the port's CLI uploads them; then `evaluate`; PERF.md): the
# floor plane [n, d] in the world frame, the accepted loops (key_new,
# key_old, fitness). On its float32 frames the JAX package's fused LM ends
# millimetres from its own float64 run, and the circuit's loops follow.
FULL_SLICE_JAX = {"keyframes": 80, "loops": [], "ate_m": 0.027108189154713712,
                  "rte_m": 0.02574896282294756,
                  "floor": [-0.02892324255175875, -0.10207407046233284, 0.99435623907106,
                            2.968624458738188]}
FULL_CIRCUIT_JAX = {
    "keyframes": 360, "ate_m": 0.11139701525822152, "rte_m": 0.016120189131934793,
    "loops": [(168, 0, 0.4339), (221, 47, 0.3936), (232, 53, 0.0956), (245, 69, 0.0599),
              (258, 83, 0.0603), (269, 90, 0.1245), (282, 104, 0.0617)],
    "floor": [-0.0537109826476861, 0.025717365997253324, 0.9982252989326524,
              2.1943016033809934],
    "gate_counts": {"no_eligible_candidate": 39, "accum_distance": 116, "yaw": 18,
                    "ellipse_since_last_loop": 57, "gated_fallback_match": 163, "accepted": 7,
                    "interval": 89, "not_converged": 9, "pairwise": 87, "fallback_trans": 20,
                    "sc_distance": 2}}
# The JAX CLI's own run of the full-circuit command, on its reader's float32
# frames (JAX_ENABLE_X64=1, CPU; ACCURACY.json's 10 loops and 0.1233 m):
# printed beside the port's, not held. Its float32 LM stops millimetres from
# the float64 one within a few frames, and the port's does not follow it
# (`tests/test_torch_fused_frames.py`).
FULL_CIRCUIT_JAX32 = {
    "keyframes": 360, "ate_m": 0.12328771985040748, "rte_m": 0.01614211419166521,
    "loops": [(173, 1, 0.3126), (190, 10, 0.0876), (205, 21, 0.1346), (220, 40, 0.0678),
              (230, 56, 0.0817), (244, 68, 0.0646), (256, 80, 0.062), (268, 93, 0.0736),
              (281, 108, 0.0749), (291, 113, 0.0647)],
    "floor": [-0.057263361084994975, 0.028297373638347605, 0.9979579981754849,
              2.226405724383945]}
FLOOR_NORMAL_RAD, FLOOR_OFFSET_M = 1e-2, 0.05
# The JAX package's record of `slam --registration ndt [--fused]` on the
# 98-frame sequence (`python -m gorio_tpu.cli`, CPU, JAX_ENABLE_X64=1, its
# reader's frames handed over as float64; unfused and fused alike)
NDT_SLICE_JAX = {"keyframes": 77, "loops": 0, "ate_m": 0.0134656, "rte_m": 0.0223001}
# scan-to-submap odometry over the 98 frames (`tests/jax_records.py
# scan-to-map`, JAX CPU f64, float64 frames): the odometry trajectory's ATE
SCAN_TO_MAP_JAX = {"ndt": 0.7752972399712745, "apdgicp": 0.7671944008819945}
# the align pair (`tests/jax_records.py align`, the JAX CLI's float32 run on
# a CPU): each method's (translation m, rotation deg) error against the
# known transform. NDT_CUDA_D2D misses the 0.05 m / 1 deg tolerances there,
# so the port is held to its errors plus those margins
ALIGN_TRANS_M, ALIGN_ROT_DEG = 0.05, 1.0  # `tests/test_reference_pcd.py`
ALIGN_JAX = {"ICP": (5.214236404787842e-05, 0.0),
             "GICP": (0.00019326367688587788, 0.01396459938639004),
             "FAST_GICP": (0.00019326367688587788, 0.01396459938639004),
             "FAST_APDGICP": (0.000365593811171593, 0.0),
             "FAST_VGICP": (0.001579685718105856, 0.0),
             "FAST_VGICP_CUDA": (0.001579685718105856, 0.0),
             "NDT_OMP": (0.027744391381214824, 0.014163451642024599),
             "NDT_CUDA_D2D": (0.25514880550804603, 0.0)}
ALIGN_JAX_MISSES = ("NDT_CUDA_D2D",)
# `slam --map` of the slice (`tests/jax_records.py slice-map`, JAX CPU f64,
# its reader's float32 frames as the port's unfused CLI reads them): the
# 0.2 m voxel map's point count and bounds
SLICE_MAP_JAX = {"points": 6639, "min": [2.7560989087806274, -37.01992436277447,
                                          -4.47985824354537],
                 "max": [74.07914565383835, 45.219184813470044, 11.709315422946588]}
MAP_POINTS_TOL, MAP_BOUNDS_M = 0.02, 0.05
STREAM_OPTIMIZE_EVERY = 15
# The JAX package's CPU f64 records of the bag and tools phases
# (`tests/jax_records.py bag | utm-align | gt-adjust`, JAX_ENABLE_X64=1, on
# `tests/tool_inputs.py`'s inputs): the bag's `slam` (its reader's frames as
# float64), `utm-align` on the bag's ground truth and fixes, `gt-adjust`
# (11 sampled positions) and `align-traj --scale` on the drifted circuit
T_BASE = 1.6e9
# The JAX package's CPU f64 record of the accuracy straight cut to
# STRAIGHT_S seconds (`tests/jax_records.py straight OUT 10`,
# JAX_ENABLE_X64=1: the port's `simulate --duration 10 --rate 5 --seed 21
# --stops 2 --dynamic 4 --gps`, then the JAX CLI's `slam --fused --preprocess
# --floor --preint ugpm --no-loops --optimize-every 15` on its reader's
# frames as float64). 10 s keeps the phase near 40 s on the card: the 16 s
# cut (78 frames, 54 keyframes, one GPS edge) took 74.4 s alone on an NVIDIA
# H100 (700 W).
STRAIGHT_S = 10
STRAIGHT_JAX = {"keyframes": 29, "loops": [], "gps_utm_coords": 17, "gps_edges": 0,
                "gps_near_keyframes": 17, "ate_m": 0.5730730955128794,
                "rte_m": 1.5172060359778117}
REPLAY_COMBO = 4  # the index in `loop_sweep.DEFAULT_COMBOS` replayed beside the default
BAG_JAX = {"keyframes": 80, "loops": [], "gps_edges": 7, "gps_utm_coords": 7,
           "gps_near_keyframes": 18, "ate_m": 0.014386889696969793, "rte_m": 0.023770986984932466,
           "first_stamp": 1600000000.2}
UTM_ALIGN_JAX = {"n_pairs": 20, "chi2": 3.7409127024735596e-17, "T_world_utm": [
    [0.9977239746077069, -0.0631993283996441, -0.023509899677224482, -343020.19801880815],
    [0.0642454518834734, 0.9968370727632424, 0.046780041439677046, -171093.26414074103],
    [0.020479072373706855, -0.0481839730060064, 0.9986285156854219, -90.70399990987724],
    [0.0, 0.0, 0.0, 1.0],
]}
GT_ADJUST_JAX = {
    "loops": ["9:636", "14:640", "122:743", "127:750", "132:759", "249:870", "254:874",
              "260:880", "269:896", "324:943", "402:1025", "557:1178", "594:1223", "599:1225",
              "604:1227", "609:1230"],
    "iterations": 4, "chi2": 0.10093375348107755, "loop_gap_after_m": 0.025296614356449657,
    "sampled": {
        "0": [0.02212386762945088, -0.18315072394319595, -0.08242133675876345],
        "125": [13.08514610725738, 6.853367098807239, -0.2833730550929713],
        "250": [8.67665340045881, 20.645488236028303, -0.22664012316265406],
        "375": [-5.699621996704798, 22.23437694844212, 0.06369058435160665],
        "500": [-10.888244749710696, 8.061640516094894, 0.1423655048193787],
        "625": [-0.3224391411714936, -0.1724509512626208, -0.12749318580876728],
        "750": [13.187475459750813, 7.119766482837568, -0.29977255329787555],
        "875": [8.129995103559187, 21.06379377150918, -0.22369431786675123],
        "1000": [-5.340026543897655, 22.733636248032724, 0.16326429276253274],
        "1125": [-10.72982839041556, 8.564387694181839, 0.26441535565077423],
        "1250": [0.09916138234583793, -0.22169958042932397, 0.05356155985176367],
    }}
ALIGN_TRAJ_JAX = {"scale": 0.9671300314231808, "T": [
    [0.9666314350461801, 0.031051025971767766, 1.5724659709737915e-05, 0.0018350938080611279],
    [-0.031051029555370414, 0.9666312202926578, 0.0006443599003796232, 0.01099210855782573],
    [4.97150211629863e-06, -0.0006445325672973395, 0.9671298166397605, -0.0014634346590495298],
    [0.0, 0.0, 0.0, 1.0],
]}
BAG_KEYFRAME_TOL, GT_CHI2_RTOL, GT_POSE_M = 0.02, 1e-9, 1e-6
UTM_M, UTM_RAD, ALIGN_TRAJ_RTOL = 1e-6, 1e-7, 1e-12
KDTREE_D2_RTOL, KDTREE_TIE = 1e-5, 1e-6
CARD = ""  # the card's `nvidia-smi` name and power limit, set by main()


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    from gorio_tpu_torch.bench import card_name

    try:
        return card_name(0)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")


def check_pair(name, q, r, mask, got, want, split=None):
    """Hold a kernel's (idx, d2[, sel]) against the plain version's. With
    `split`, every ref block of that size repeats the first one, so each
    query's minimum is tied across the cluster's CTAs and the lowest copy,
    in the first block, must win."""
    import torch

    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}: kernel gives {g.dtype} {tuple(g.shape)}, "
                 f"plain {w.dtype} {tuple(w.shape)}")
    idx_k, d2_k = got[0].long(), got[1]
    idx_p, d2_p = want[0].long(), want[1]
    if split is not None and int(idx_k.max()) >= split:
        fail(f"{name}: a tie across the cluster split went to index {int(idx_k.max())} "
             f">= {split}, not to the lowest copy")
    agree = idx_k == idx_p
    if not bool(agree.all()):
        # a disagreement is allowed only at a near-tie: both candidates'
        # exact (float64) distances, on the float32 values the kernel
        # reads, within TIE * max(1, d2)
        q64, r64 = q.float().double(), r.float().double()
        if q64.dim() == 2:
            q64, r64, idx_k, idx_p = q64[None], r64[None], idx_k[None], idx_p[None]
            mask = None if mask is None else mask[None]
        bias = torch.zeros_like(r64[..., 0])
        if mask is not None:
            bias = torch.where(mask, 0.0, 1e12).double()

        def exact(idx):
            rr = torch.gather(r64, 1, idx[..., None].expand(*idx.shape, 3))
            return ((q64 - rr) ** 2).sum(-1) + torch.gather(bias, 1, idx)

        dk, dp = exact(idx_k), exact(idx_p)
        tie_ok = (dk - dp).abs() <= TIE * torch.clamp(dp.abs(), min=1.0)
        bad = int((~agree.reshape(tie_ok.shape) & ~tie_ok).sum())
        if bad:
            fail(f"{name}: {bad} indices disagree beyond a near-tie")
    if not torch.allclose(d2_k, d2_p, rtol=RTOL, atol=ATOL):
        fail(f"{name}: d2 differs, max abs err {float((d2_k - d2_p).abs().max())}")
    err = float((d2_k - d2_p).abs().max())
    if len(got) == 3:
        sk, sp = got[2][agree], want[2][agree]
        if not torch.allclose(sk, sp, rtol=RTOL, atol=ATOL):
            fail(f"{name}: payload differs, max abs err {float((sk - sp).abs().max())}")
        err = max(err, float((sk - sp).abs().max()) if sk.numel() else 0.0)
    return int((~agree).sum()), err


def call_ms(fn, repeats=50, warmup=5):
    """Median time of one call, CUDA events around each: the wrapper's host
    work between the events counts."""
    from gorio_tpu_torch.utils.profiling import events_ms

    for _ in range(warmup):
        fn()
    return statistics.median(events_ms(fn) for _ in range(repeats))


def per_launch_ms(fn, launches=100, warmup=10):
    """One pair of CUDA events around `launches` back-to-back calls, after a
    warm-up; the time per call."""
    import torch
    from gorio_tpu_torch.utils.profiling import events_ms

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return events_ms(fn, launches) / launches


def device_kernels(fn, calls):
    """(name, device us) of every device activity (kernel, copy, memset)
    that `calls` calls of `fn` put on the card, under torch.profiler."""
    from gorio_tpu_torch.utils.profiling import device_activities

    fn()
    return device_activities(lambda: [fn() for _ in range(calls)])


def bound(q, r, mask, payload, sel):
    """The least time the card could take for one call (ms) and what sets
    it: ~9 FP32 operations per (query, ref) pair at 67 TFLOP/s, against each
    input read once and each output written once at 3.35 TB/s."""
    B = q.shape[0] if q.dim() == 3 else 1
    N, M = q.shape[-2], r.shape[-2]
    ops = 9.0 * B * N * M
    nbytes = q.numel() * q.element_size() + r.numel() * r.element_size()
    nbytes += 0 if mask is None else mask.numel() * mask.element_size()
    nbytes += B * N * (4 + q.element_size())  # idx, d2
    if payload is not None:
        nbytes += B * M * payload.shape[-1] * payload.element_size()
        nbytes += sel.numel() * sel.element_size()
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(K):
    import torch

    from gorio_tpu_torch import bench
    from gorio_tpu_torch.evaluation import profile_linearize

    f32, f64 = torch.float32, torch.float64
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def inputs(B, N, M, masked_frac, qdt=f64, rdt=f32, pdt=f32, P=11, split=None):
        ref = torch.rand(B, M, 3, generator=g, device=dev, dtype=f64) * 80.0 - 40.0
        if split is not None:  # every block of `split` refs repeats the first
            ref = ref[:, :split].repeat(1, M // split, 1)
        query = ref[:, torch.randint(0, M, (N,), generator=g, device=dev)]
        query = query + 0.3 * torch.randn(B, N, 3, generator=g, device=dev, dtype=f64)
        mask = torch.rand(B, M, generator=g, device=dev) >= masked_frac
        payload = torch.randn(B, M, P, generator=g, device=dev, dtype=f64)
        return query.to(qdt), ref.to(rdt), mask, payload.to(pdt)

    S_main = K.cluster_size(1, MAIN_N)
    split = MAIN_N // S_main
    cases = {
        # the main path's call: (N, 3) f64 moved source, f32 target, bool
        # mask, f32 11-column payload
        MAIN: tuple(t[0] for t in inputs(1, MAIN_N, MAIN_N, 0.1)),
        "all f32, N=M=2048": inputs(1, MAIN_N, MAIN_N, 0.1, f32, f32, f32),
        "all f64, N=M=2048": inputs(1, MAIN_N, MAIN_N, 0.1, f64, f64, f64),
        f"ties across the split: refs repeat every {split}, N=M=2048":
            inputs(1, MAIN_N, MAIN_N, 0.0, split=split),
        f"M=5 < S={S_main}, N=2048": inputs(1, MAIN_N, 5, 0.0),
        "N=1, M=2048": inputs(1, 1, MAIN_N, 0.1),
    }
    q, r, m, p = inputs(3, 1537, 1999, 0.3, f32, f32, f32, P=16)
    cases["ragged B=3 N=1537 M=1999 30% masked, payload the first 11 of 16 columns"] = (
        q, r, m, p[..., :11])
    q, r, m, p = inputs(2, 1024, 1500, 0.0)
    m[1] = False  # every ref of the second batch masked
    cases["all refs masked in one batch"] = (q, r, m, p)
    cases[VERIFY] = inputs(VERIFY_B, MAIN_N, MAIN_N, 0.1)
    cases[SUBMAP] = tuple(t[0] for t in inputs(1, MAIN_N, SUBMAP_M, 0.1, f64, f64, f64))
    cases[ALIGN] = align_inputs(g)
    cases[BENCH_APD] = bench_gicp_inputs(*bench.apdgicp_pair(dev))
    cases[BENCH_VERIFY] = bench_gicp_inputs(*bench.verify_pairs(dev))
    cases[PROFILE_LIN] = bench_gicp_inputs(*profile_linearize.problem(dev)[:2])

    errs = {}
    for label, (q, r, m, p) in cases.items():
        tie_split = split if label.startswith("ties") else None
        ties1, e1 = check_pair(f"nn1 [{label}]", q, r, m, K.nn1_best(q, r, m),
                               K.nn1_plain(q, r, m, compute_dtype=f32), tie_split)
        ties2, e2 = check_pair(f"nn1_select [{label}]", q, r, m, K.nn1_select(q, r, p, m),
                               K.nn1_select_plain(q, r, p, m, compute_dtype=f32), tie_split)
        torch.cuda.synchronize()
        for name, e in (("nn1", e1), ("nn1_select", e2)):
            errs[name] = max(errs.get(name, 0.0), e)
        B = q.shape[0] if q.dim() == 3 else 1
        print(f"[kernels] {label} (S={K.cluster_size(B, q.shape[-2])}): nn1 ok (near-ties "
              f"{ties1}, max abs err {e1:.3g}), nn1_select ok (near-ties {ties2}, "
              f"max abs err {e2:.3g})", flush=True)

    q, r, m, p = cases[MAIN]
    fns = _timed_fns(K, q, r, m, p)
    # one call at the main path's types is one launch: no cast, pad or copy.
    # The profiler can drop an activity but never adds one, so over CALLS
    # calls it must see nothing but the kernel, and at most CALLS of it.
    for name, (kernel, _, _) in fns.items():
        acts = device_kernels(kernel, CALLS)
        names = sorted({n for n, _ in acts})
        if not acts or len(acts) > CALLS or any("nn1_kernel" not in n for n in names):
            fail(f"{CALLS} {name} calls put {len(acts)} activities on the card: {names}")
        print(f"[kernels] {CALLS} {name} calls at the main path's types put {len(acts)} "
              f"activities on the card, all one kernel: {names[0]}", flush=True)

    stats = {name: timing_row(name, fns[name], q, r, m, p, MAIN) for name in fns}
    for name, st in stats.items():
        st["call_ms"] = call_ms(fns[name][0])
        print(f"[kernels] {name} at {MAIN}: one call {st['call_ms']:.5f} ms (median of 50)",
              flush=True)
    q, r, m, p = cases[VERIFY]
    fns = _timed_fns(K, q, r, m, p)
    stats_b = {name: timing_row(name, fns[name], q, r, m, p, VERIFY) for name in fns}
    q, r, m, p = cases[SUBMAP]
    fns = _timed_fns(K, q, r, m, p)
    stats_s = {name: timing_row(name, fns[name], q, r, m, p, SUBMAP) for name in fns}
    q, r, m, p = cases[ALIGN]
    fns = _timed_fns(K, q, r, m, p, library_block=ALIGN_LIBRARY_BLOCK)
    stats_a = {name: timing_row(name, fns[name], q, r, m, p, ALIGN, launches=3, warmup=1)
               for name in fns}
    return errs, stats, {"verify_batch": (stats_b, VERIFY), "submap": (stats_s, SUBMAP),
                         "align": (stats_a, ALIGN)}, S_main, cases


def align_inputs(g):
    """The align path's call at its capacity: the synthetic pair after the
    CLI's 0.1 m leaf, padded to ALIGN_CAP (source as query, target as ref,
    f32), and the GICP payload's layout: the target's xyz, six covariance
    columns, cluster and mask."""
    import torch

    from gorio_tpu_torch.bench import synth_pair
    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.io.pcd import voxel_centroid_downsample

    dev = torch.device("cuda")
    (a, _), (b, _) = synth_pair()
    src, tgt = (make_cloud(torch.as_tensor(voxel_centroid_downsample(x, res=0.1)),
                           capacity=ALIGN_CAP, device=dev) for x in (a, b))
    cov6 = torch.randn(ALIGN_CAP, 6, generator=g, device=dev)
    payload = torch.cat([tgt.xyz, cov6, tgt.cluster[:, None], tgt.mask.float()[:, None]], -1)
    return src.xyz, tgt.xyz, tgt.mask, payload


def bench_gicp_inputs(src, tgt):
    """The bench's own calls on a GICP pair (one or a batch): the source as
    query, the target and its mask as ref, and the linearize's payload
    (`nn_inprog_ms` is the same call without it)."""
    from gorio_tpu_torch.registration.gicp import GICPConfig, gicp_payload, prepare_gicp

    return src.xyz, tgt.xyz, tgt.mask, gicp_payload(prepare_gicp(src, tgt, GICPConfig()))


def _timed_fns(K, q, r, m, p, library_block=None):
    """(kernel, plain, library) callables of both kernels on one input. The
    library: `torch.cdist` on the float32 inputs, squared, plus the mask
    bias, `min`, and for `nn1_select` a gather of the payload; with
    `library_block`, one such call per block of that many queries."""
    import torch

    f32 = torch.float32
    qf, rf = q.float(), r.float()
    bias = torch.where(m, 0.0, 1e12).to(f32)
    if bias.dim() == 2:
        bias = bias[:, None]
    block = library_block or qf.shape[-2]

    def library_nn1():
        parts = [(torch.cdist(qf[..., s:s + block, :], rf).square_() + bias).min(dim=-1)
                 for s in range(0, qf.shape[-2], block)]
        d2 = torch.cat([d for d, _ in parts], dim=-1)
        return torch.cat([i for _, i in parts], dim=-1), d2

    def library_select():
        idx, d2 = library_nn1()
        if p.dim() == 2:
            return idx, d2, p[idx]
        return idx, d2, torch.gather(p, 1, idx[..., None].expand(*idx.shape, p.shape[-1]))

    return {
        "nn1": (lambda: K.nn1_best(q, r, m), lambda: K.nn1_plain(q, r, m, compute_dtype=f32),
                library_nn1),
        "nn1_select": (lambda: K.nn1_select(q, r, p, m),
                       lambda: K.nn1_select_plain(q, r, p, m, compute_dtype=f32),
                       library_select),
    }


def timing_row(name, fns, q, r, m, p, label, launches=100, warmup=10):
    """A kernel's time per launch (events around `launches`), alone
    (profiler, mean of 20), the plain version's and the library's per
    launch, and the bound."""
    kernel, plain, library = fns
    acts = device_kernels(kernel, 20)
    kernel_us = statistics.mean(t for n, t in acts if "nn1_kernel" in n)
    want = plain()
    st = {"ms": per_launch_ms(kernel, launches, warmup),
          "plain_ms": per_launch_ms(plain, launches, warmup),
          "library_ms": per_launch_ms(library, launches, warmup), "kernel_ms": kernel_us / 1e3}
    st["bound_ms"], st["bound_by"] = bound(q, r, m, p if name == "nn1_select" else None,
                                           want[2] if name == "nn1_select" else None)
    print(f"[kernels] {name} at {label}: {st['ms']:.5f} ms per launch (events around "
          f"{launches}), "
          f"kernel alone {st['kernel_ms']:.5f} ms (profiler, mean of 20); plain "
          f"{st['plain_ms']:.5f} ms, library (cdist + min"
          f"{' + gather' if name == 'nn1_select' else ''}) {st['library_ms']:.5f} ms; bound "
          f"{st['bound_ms']:.6f} ms ({st['bound_by']}), kernel alone at "
          f"{100 * st['bound_ms'] / st['kernel_ms']:.1f}% of it", flush=True)
    return st


def simulate(out, flags):
    """Start `python -m gorio_tpu_torch.cli simulate` in a child process (a
    CPU-only numpy job), writing to `out`."""
    return subprocess.Popen(
        [sys.executable, "-m", "gorio_tpu_torch.cli", "simulate", "--output", str(out), *flags],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def wait_for(proc, what, timeout=900):
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        fail(f"simulate ({what}) exited {proc.returncode}: {out[-2000:]}")
    print(f"[{what}] {out.strip().splitlines()[-1]} (waited {time.perf_counter() - t0:.1f} s)",
          flush=True)


def run_slam(K, seq, traj, flags):
    """One `slam` run of the port's CLI on the card with the launch counts
    set to 0 just before it and read just after. Returns (slam, odometry,
    timer, launches, batched launches, wall s, evaluate's result)."""
    import torch

    from gorio_tpu_torch.cli import main as cli

    K.reset_launch_counts()
    t0 = time.perf_counter()
    slam, odo, timer = cli(["slam", "--dataset", str(seq), "--output", str(traj), *flags,
                            "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, batched = dict(K.launch_counts), dict(K.batched_launch_counts)
    result = cli(["evaluate", str(traj), str(seq / "groundtruth.tum")])
    return slam, odo, timer, launches, batched, wall, result


def check_common(what, slam, odo, launches):
    """The checks both runs share: the `nn1_select` launches are the
    odometry's LM iterations plus the loop verification's outer LM
    iterations, `nn1` ran, the keyframe clouds live on the card, loop
    detection ran, the trajectory is finite."""
    import numpy as np

    lm_iters = sum(st.iterations for st in odo.statuses)
    verify_iters = slam.loop_detector.verify_iterations
    if launches["nn1_select"] == 0 or launches["nn1_select"] != lm_iters + verify_iters:
        fail(f"{what}: nn1_select launches {launches['nn1_select']} != odometry LM iterations "
             f"{lm_iters} + verification LM iterations {verify_iters}")
    if launches["nn1"] == 0:
        fail(f"{what}: the nn1 kernel was not launched")
    devices = {str(t.device) for kf in slam.keyframes for t in kf.cloud}
    if any(not d.startswith("cuda") for d in devices):
        fail(f"{what}: keyframe clouds live on {sorted(devices)}")
    if not slam.loop_detector.gate_counts:
        fail(f"{what}: loop detection never ran (no gate counts)")
    if not np.isfinite(slam.trajectory()[1]).all():
        fail(f"{what}: non-finite poses in the trajectory")
    return lm_iters, verify_iters


def report(what, n_frames, slam, timer, launches, batched, wall, result, lm_iters, verify_iters):
    medians = {k: 1000 * statistics.median(v) for k, v in timer.samples.items()}
    means = {k: 1000 * statistics.mean(v) for k, v in timer.samples.items()}
    print(f"[{what}] {CARD}: frames {n_frames}, keyframes {len(slam.keyframes)}, loops "
          f"{[(l.key_new, l.key_old, round(float(l.fitness), 4)) for l in slam.loops]}, "
          f"LM iterations {lm_iters} (odometry) + {verify_iters} (verification), launches "
          f"{launches} ({batched} over more than one lane), solves {slam.solver_counts}, "
          f"wall {wall:.2f} s ({n_frames / wall:.2f} frames/s), ATE {result['ate_rmse_m']:.6f} m, "
          f"RTE {result['rte_m']:.6f} m", flush=True)
    print(f"[{what}] loop gate counts {slam.loop_detector.gate_counts}", flush=True)
    print(f"[{what}] stage median / mean ms: "
          + ", ".join(f"{k} {medians[k]:.2f} / {means[k]:.2f}" for k in sorted(medians)),
          flush=True)


def slice_phase(K, seq, tmp):
    import numpy as np

    from gorio_tpu_torch.cli import main as cli
    from gorio_tpu_torch.graph.graph import PoseGraph

    slam, odo, timer, launches, batched, wall, result = run_slam(
        K, seq, tmp / "slice.tum", ["--dump", str(tmp / "dump"), "--map", str(tmp / "map.npz")])
    lm_iters, verify_iters = check_common("slice", slam, odo, launches)
    report("slice", len(list(seq.glob("*.grf"))), slam, timer, launches, batched, wall, result,
           lm_iters, verify_iters)
    n_kf = len(slam.keyframes)
    if abs(n_kf - KEYFRAMES) > KEYFRAME_TOL:
        fail(f"slice: {n_kf} keyframes, expected {KEYFRAMES} +- {KEYFRAME_TOL}")
    if len(slam.loops) != SLICE_JAX_LOOPS:
        fail(f"slice: {len(slam.loops)} loops, the JAX package accepts {SLICE_JAX_LOOPS}")
    if not result["ate_rmse_m"] <= ATE_MAX:
        fail(f"slice: ATE {result['ate_rmse_m']} m > {ATE_MAX} m")

    # --dump: the graph reloads with a vertex per keyframe at its pose
    traj = slam.trajectory()[1]
    g = PoseGraph.load(tmp / "dump" / "graph.g2o")
    gap = float(np.abs(np.stack(g.poses)[:, :3, 3] - traj[:, :3, 3]).max()) if g.poses else None
    print(f"[slice] --dump: {len(g.poses)} vertices, {len(g._between)} between edges, "
          f"{len(list((tmp / 'dump').glob('0*')))} keyframe directories; largest vertex gap "
          f"to the trajectory {gap} m", flush=True)
    if len(g.poses) != n_kf or not gap <= 1e-9:
        fail(f"slice: the dumped graph has {len(g.poses)} vertices for {n_kf} keyframes, "
             f"largest gap {gap} m")
    # --map: the voxel map against the JAX package's record
    xyz = np.load(tmp / "map.npz")["xyz"]
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    rec = SLICE_MAP_JAX
    print(f"[slice] --map: {len(xyz)} points (JAX {rec['points']}), bounds "
          f"{lo.round(4).tolist()} .. {hi.round(4).tolist()} (JAX "
          f"{np.round(rec['min'], 4).tolist()} .. {np.round(rec['max'], 4).tolist()})",
          flush=True)
    bounds_gap = float(max(np.abs(lo - rec["min"]).max(), np.abs(hi - rec["max"]).max()))
    if abs(len(xyz) - rec["points"]) > MAP_POINTS_TOL * rec["points"] or \
            not bounds_gap <= MAP_BOUNDS_M:
        fail(f"slice: the map's {len(xyz)} points / bounds {bounds_gap:.4f} m off the JAX "
             f"record ({rec['points']} points; limits {MAP_POINTS_TOL:.0%}, {MAP_BOUNDS_M} m)")
    # --config: the default tree gives the flags' run to the bit
    cli(["dump-config", "--output", str(tmp / "config.json")])
    again, _, _ = cli(["slam", "--dataset", str(seq), "--output", str(tmp / "slice_cfg.tum"),
                       "--config", str(tmp / "config.json"), "--device", "cuda"])
    same = np.array_equal(again.trajectory()[1], traj)
    print(f"[slice] --config of dump-config's tree: {len(again.keyframes)} keyframes, the "
          f"trajectory {'equal to the bit' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail("slice: `slam --config` with the default tree changed the trajectory")
    return launches, n_kf, slam, result["ate_rmse_m"]


def repeat_check(seq):
    """`estimate_ground` and `dbscan_cluster` twice on one frame of `seq`
    (float64 on the card, the CLI's density): the same bits."""
    import torch

    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.estimators.clustering import DBSCANConfig, dbscan_cluster
    from gorio_tpu_torch.estimators.groundseg import GroundSegConfig, estimate_ground
    from gorio_tpu_torch.io.native import NativePipelineDataset

    _, n, packed = next(NativePipelineDataset(sorted(seq.glob("*.grf"))[40:41], capacity=2048))
    frame = torch.tensor(packed[:n], dtype=torch.float64, device="cuda")
    cloud = make_cloud(frame[:, :3], intensity=frame[:, 3], doppler=frame[:, 4], capacity=2048)
    for what, fn in (("estimate_ground", lambda: estimate_ground(cloud, GroundSegConfig())),
                     ("dbscan_cluster", lambda: dbscan_cluster(cloud, DBSCANConfig()))):
        first, again = fn(), fn()
        diff = [f for f, a, b in zip(first._fields, first, again)
                if isinstance(a, torch.Tensor) and not torch.equal(a, b)]
        if diff:
            fail(f"repeat: two runs of {what} on one scan differ in {diff}")
        print(f"[repeat] two runs of {what} on a {n}-point scan agree to the bit", flush=True)


class SolveTimer:
    """Times every graph solve of the slam back end on the card, and every
    UGPM preintegration: wraps the four solvers (pose-only and joint pose +
    plane, dense and block-sparse) and `ugpm_preintegrate` where
    `pipeline/slam.py` calls them, synchronising the card around each, and
    keeps the arguments of each one's last call and of its first call at
    its largest padded size (the last block-sparse call's for a profiled
    replay). Restores them on exit."""

    SOLVERS = {"dense": "optimize_graph", "sparse": "optimize_graph_sparse",
               "dense_planes": "optimize_graph_with_planes",
               "sparse_planes": "optimize_graph_with_planes_sparse"}

    def __init__(self, what):
        import gorio_tpu_torch.pipeline.slam as slam_mod

        self.what, self.mod = what, slam_mod
        self.solves, self.ugpm_s, self.last_sparse = [], [], None
        self.last, self.first_largest = {}, {}
        self.orig = {k: getattr(slam_mod, n) for k, n in self.SOLVERS.items()}
        self.orig["ugpm"] = slam_mod.ugpm_preintegrate

    def _wrap(self, kind):
        import torch

        def timed(*args):
            if kind.startswith("sparse"):
                self.last_sparse = (kind, args)
            self.last[kind] = args
            if args[0].shape[0] > self.first_largest.get(kind, (torch.zeros(0),))[0].shape[0]:
                self.first_largest[kind] = args
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = self.orig[kind](*args)
            torch.cuda.synchronize()
            self.solves.append((kind, args[0].shape[0], int(res.iterations),
                                time.perf_counter() - t0))
            return res
        return timed

    def _ugpm(self, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = self.orig["ugpm"](*args, **kwargs)
        torch.cuda.synchronize()
        self.ugpm_s.append(time.perf_counter() - t0)
        return res

    def __enter__(self):
        for kind, name in self.SOLVERS.items():
            setattr(self.mod, name, self._wrap(kind))
        self.mod.ugpm_preintegrate = self._ugpm
        return self

    def __exit__(self, *exc):
        for kind, name in self.SOLVERS.items():
            setattr(self.mod, name, self.orig[kind])
        self.mod.ugpm_preintegrate = self.orig["ugpm"]

    def report(self):
        """Per solver and padded pose count: solves, LM iterations, seconds,
        ms per LM iteration; UGPM's ms per keyframe; then the last sparse
        solve's first three LM iterations replayed under the profiler: device
        activities and device busy time per LM iteration."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        what = self.what
        rows = {}
        for kind, K, iters, dt in self.solves:
            r = rows.setdefault((kind, K), [0, 0, 0.0])
            r[0], r[1], r[2] = r[0] + 1, r[1] + iters, r[2] + dt
        for (kind, K), (n, iters, dt) in sorted(rows.items()):
            print(f"[{what}] {kind} solves at {K} padded poses: {n} solves, {iters} LM "
                  f"iterations, {dt:.3f} s, {1e3 * dt / max(iters, 1):.2f} ms per LM "
                  f"iteration", flush=True)
        if self.ugpm_s:
            ms = [1e3 * t for t in self.ugpm_s]
            print(f"[{what}] {CARD}: UGPM preintegration {len(ms)} keyframes, "
                  f"{statistics.median(ms):.2f} ms median / {statistics.mean(ms):.2f} ms mean "
                  f"per keyframe (max {max(ms):.2f}, the first {ms[0]:.2f}), {sum(ms) / 1e3:.2f} s "
                  f"in all", flush=True)
        if self.last_sparse is None:
            return
        # three LM iterations are enough for the per-iteration numbers, and
        # the profiler's host-side event list grows with every kernel
        kind, args = self.last_sparse
        cfg = args[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = self.orig[kind](*args[:-1], cfg._replace(max_iterations=3))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        iters = int(res.iterations)
        busy = sum(e.device_time_total for e in acts) / 1e3
        print(f"[{what}] the last {kind} solve replayed under the profiler "
              f"({args[0].shape[0]} padded poses, {cfg.loop_capacity} loop slots): {iters} LM "
              f"iterations, "
              f"{len(acts) / iters:.0f} device activities and {busy / iters:.3f} ms of device "
              f"time per LM iteration, wall {1e3 * wall / iters:.2f} ms per LM iteration "
              f"(profiled), device busy {100 * busy / (1e3 * wall):.1f}%", flush=True)


def loop_gaps(seq, slam):
    """Ground-truth distance between the endpoints of each accepted loop, at
    the keyframe stamps (as scripts/recall_benchmark.py measures it)."""
    import numpy as np

    from gorio_tpu_torch.evaluation.sequence import gt_positions

    gs, gt_pos = gt_positions(seq)
    stamps = np.asarray([kf.stamp for kf in slam.keyframes])
    pos = np.stack([np.interp(stamps, gs, gt_pos[:, k]) for k in range(3)], axis=1)
    return [float(np.linalg.norm(pos[l.key_new] - pos[l.key_old])) for l in slam.loops]


def circuit_phase(K, seq, tmp):
    with SolveTimer("circuit") as solves:
        slam, odo, timer, launches, batched, wall, result = run_slam(
            K, seq, tmp / "circuit.tum", ["--optimize-every", "15"])
    lm_iters, verify_iters = check_common("circuit", slam, odo, launches)
    report("circuit", len(list(seq.glob("*.grf"))), slam, timer, launches, batched, wall,
           result, lm_iters, verify_iters)
    det = slam.loop_detector
    gaps = loop_gaps(seq, slam)
    print(f"[circuit] pairs verified {len(det.candidate_log)}, accepted loops' ground-truth "
          f"endpoint gaps (m) {[round(g, 3) for g in gaps]}", flush=True)
    solves.report()

    n_kf, n_loops, ate = len(slam.keyframes), len(slam.loops), result["ate_rmse_m"]
    ate_max = 1.25 * CIRCUIT_JAX["ate_m"] + 0.02
    sparse_at = {K for kind, K, _, _ in solves.solves if kind == "sparse"}
    if not sparse_at >= set(CIRCUIT_SPARSE_POSES):
        fail(f"circuit: block-sparse solves at {sorted(sparse_at)} padded poses, not at all of "
             f"{CIRCUIT_SPARSE_POSES} ({slam.solver_counts})")
    if not det.candidate_log:
        fail(f"circuit: no candidate pair reached registration verification "
             f"({det.gate_counts})")
    if CIRCUIT_JAX["loops"] and not n_loops:
        fail("circuit: no loop accepted")
    if any(g > FALSE_RADIUS_M for g in gaps):
        fail(f"circuit: a false loop, endpoints {max(gaps):.2f} m > {FALSE_RADIUS_M} m apart")
    if batched["nn1_select"] == 0:
        fail("circuit: nn1_select never launched over more than one lane")
    if abs(n_kf - CIRCUIT_JAX["keyframes"]) > 0.02 * CIRCUIT_JAX["keyframes"]:
        fail(f"circuit: {n_kf} keyframes, the JAX record {CIRCUIT_JAX['keyframes']} +- 2%")
    if abs(n_loops - CIRCUIT_JAX["loops"]) > 2:
        fail(f"circuit: {n_loops} loops, the JAX record {CIRCUIT_JAX['loops']} +- 2")
    if not ate <= ate_max:
        fail(f"circuit: ATE {ate} m > {ate_max} m (1.25 x the JAX record + 0.02 m)")
    print(f"[circuit] keyframes {n_kf} (JAX {CIRCUIT_JAX['keyframes']}), loops {n_loops} "
          f"(JAX {CIRCUIT_JAX['loops']}), ATE {ate:.6f} m (JAX {CIRCUIT_JAX['ate_m']:.6f} m, "
          f"limit {ate_max:.6f} m)", flush=True)
    return launches, slam, solves.last["sparse"]


def full_phase(K, seq, tmp, what, flags, jax_rec, ate_max, planes_kind):
    """The paper's configuration through the port's CLI: the common checks,
    the loops and their ground-truth gaps, the floor plane, and the limits
    against the JAX package's record `jax_rec`."""
    import numpy as np

    with SolveTimer(what) as solves:
        slam, odo, timer, launches, batched, wall, result = run_slam(
            K, seq, tmp / f"{what}.tum", [*FULL, *flags])
    lm_iters, verify_iters = check_common(what, slam, odo, launches)
    report(what, len(list(seq.glob("*.grf"))), slam, timer, launches, batched, wall, result,
           lm_iters, verify_iters)
    gaps = loop_gaps(seq, slam)
    print(f"[{what}] pairs verified {len(slam.loop_detector.candidate_log)}, accepted loops' "
          f"ground-truth endpoint gaps (m) {[round(g, 3) for g in gaps]}; JAX loops "
          f"{jax_rec['loops']}", flush=True)
    solves.report()

    floor = slam.floor_plane
    if floor is None or not np.isfinite(floor).all():
        fail(f"{what}: no finite floor plane ({floor})")
    floored = sum(kf.floor_coeffs is not None for kf in slam.keyframes)
    ang, off = floor_gap(floor, jax_rec)
    print(f"[{what}] floor plane [n, d] {[round(float(x), 6) for x in floor]} from {floored} "
          f"floored keyframes (JAX {[round(x, 6) for x in jax_rec['floor']]}): normal {ang:.3g} "
          f"rad, offset {off:.3g} m apart", flush=True)

    n_kf, n_loops, ate = len(slam.keyframes), len(slam.loops), result["ate_rmse_m"]
    jax_kf, jax_loops = jax_rec["keyframes"], len(jax_rec["loops"])
    if slam.solver_counts[planes_kind] == 0:
        fail(f"{what}: no {planes_kind} solve ran ({slam.solver_counts})")
    if not solves.ugpm_s:
        fail(f"{what}: UGPM never ran")
    if abs(n_kf - jax_kf) > 0.02 * jax_kf:
        fail(f"{what}: {n_kf} keyframes, the JAX record {jax_kf} +- 2%")
    if abs(n_loops - jax_loops) > 2:
        fail(f"{what}: {n_loops} loops, the JAX record {jax_loops} +- 2")
    if any(g > FALSE_RADIUS_M for g in gaps):
        fail(f"{what}: a false loop, endpoints {max(gaps):.2f} m > {FALSE_RADIUS_M} m apart")
    if not ate <= ate_max:
        fail(f"{what}: ATE {ate} m > {ate_max} m")
    print(f"[{what}] keyframes {n_kf} (JAX {jax_kf}), loops {n_loops} (JAX {jax_loops}), ATE "
          f"{ate:.6f} m (JAX {jax_rec['ate_m']:.6f} m, limit {ate_max:.6f} m), RTE "
          f"{result['rte_m']:.6f} m (JAX {jax_rec['rte_m']:.6f} m)", flush=True)
    return slam, result, launches, (ang, off), solves.first_largest[planes_kind]


def floor_gap(floor, rec):
    """(angle between the normals in rad, offset difference in m) of the
    world floor plane `floor` and a record's."""
    import numpy as np

    want = np.asarray(rec["floor"])
    cos = floor[:3] @ want[:3] / np.linalg.norm(floor[:3]) / np.linalg.norm(want[:3])
    return float(np.arccos(np.clip(cos, -1.0, 1.0))), float(abs(floor[3] - want[3]))


def full_slice_phase(K, seq, tmp):
    _, result, launches, _, last = full_phase(K, seq, tmp, "full-slice", [], FULL_SLICE_JAX,
                                              ATE_MAX, "dense_planes")
    return launches, last, result["ate_rmse_m"]


def full_circuit_phase(K, seq, tmp):
    ate_max = 1.25 * FULL_CIRCUIT_JAX["ate_m"] + 0.02
    slam, result, launches, (ang, off), last = full_phase(
        K, seq, tmp, "full-circuit", ["--optimize-every", "15"], FULL_CIRCUIT_JAX, ate_max,
        "sparse_planes")
    print(f"[full-circuit] loop gate counts of the JAX record {FULL_CIRCUIT_JAX['gate_counts']}",
          flush=True)
    rec32 = FULL_CIRCUIT_JAX32
    ang32, off32 = floor_gap(slam.floor_plane, rec32)
    print(f"[full-circuit] beside the JAX CLI's run on its float32 frames (not held): keyframes "
          f"{len(slam.keyframes)} (JAX {rec32['keyframes']}), loops {len(slam.loops)} (JAX "
          f"{len(rec32['loops'])}: {rec32['loops']}), ATE {result['ate_rmse_m']:.6f} m (JAX "
          f"{rec32['ate_m']:.6f} m, 1.25 x + 0.02 m = {1.25 * rec32['ate_m'] + 0.02:.6f} m), floor "
          f"plane {ang32:.3g} rad / {off32:.3g} m apart", flush=True)
    if ang > FLOOR_NORMAL_RAD or off > FLOOR_OFFSET_M:
        fail(f"full-circuit: floor plane {ang:.3g} rad / {off:.3g} m from the JAX record "
             f"(limits {FLOOR_NORMAL_RAD} rad, {FLOOR_OFFSET_M} m)")
    if FULL_CIRCUIT_JAX["loops"] and not slam.loops:
        fail("full-circuit: no loop accepted")
    return launches, slam, last


def ndt_slice_phase(K, seq, tmp):
    """`slam --registration ndt`, unfused then fused, on the 98 frames."""
    import numpy as np
    import torch

    from gorio_tpu_torch.core.pointcloud import voxel_downsample
    from gorio_tpu_torch.pipeline.odometry import OdometryConfig
    from gorio_tpu_torch.registration.ndt import NDTConfig, build_voxel_map
    from gorio_tpu_torch.registration.vgicp import VGICPConfig, build_gaussian_voxel_map

    n_frames = len(list(seq.glob("*.grf")))
    launches = {}
    for what, flags in (("ndt-slice", []), ("ndt-fused-slice", ["--fused"])):
        slam, odo, timer, counts, batched, wall, result = run_slam(
            K, seq, tmp / f"{what}.tum", [*flags, "--registration", "ndt"])
        launches[what] = counts
        n_kf = len(slam.keyframes)
        iters = [st.iterations for st in odo.statuses]
        report(what, n_frames, slam, timer, counts, batched, wall, result, sum(iters), 0)
        print(f"[{what}] {CARD}: NDT outer iterations per frame mean {statistics.mean(iters):.2f}, "
              f"median {statistics.median(iters)}, max {max(iters)}; matching error median "
              f"{statistics.median(st.matching_error for st in odo.statuses):.3f}; ATE "
              f"{result['ate_rmse_m']:.6f} m (JAX {NDT_SLICE_JAX['ate_m']} m), RTE "
              f"{result['rte_m']:.6f} m (JAX {NDT_SLICE_JAX['rte_m']} m)", flush=True)
        want_nn1 = (n_frames - 1) + (n_kf - 1)
        if counts["nn1"] != want_nn1 or counts["nn1_select"] != 0:
            fail(f"{what}: launches {counts}, expected nn1 {want_nn1} (frames - 1 + keyframes - 1)"
                 f" and nn1_select 0")
        if abs(n_kf - NDT_SLICE_JAX["keyframes"]) > 0.02 * NDT_SLICE_JAX["keyframes"]:
            fail(f"{what}: {n_kf} keyframes, the JAX record {NDT_SLICE_JAX['keyframes']} +- 2%")
        if len(slam.loops) != NDT_SLICE_JAX["loops"]:
            fail(f"{what}: {len(slam.loops)} loops, the JAX record {NDT_SLICE_JAX['loops']}")
        if not result["ate_rmse_m"] <= ATE_MAX:
            fail(f"{what}: ATE {result['ate_rmse_m']} m > {ATE_MAX} m")
        if not slam.loop_detector.gate_counts or not np.isfinite(slam.trajectory()[1]).all():
            fail(f"{what}: loop detection never ran or the trajectory is not finite")
    cloud = slam.keyframes[-1].cloud
    vmap = build_voxel_map(cloud, NDTConfig())
    devices = {str(t.device) for t in vmap}
    if devices != {"cuda:0"}:
        fail(f"ndt-slice: a keyframe's voxel map lives on {sorted(devices)}")
    # the segment sums run in a fixed order: a rebuild agrees to the bit
    for build in (lambda: build_voxel_map(cloud, NDTConfig()),
                  lambda: build_gaussian_voxel_map(cloud, VGICPConfig()),
                  lambda: voxel_downsample(cloud, OdometryConfig().submap_resolution)):
        first, again = build(), build()
        diff = [f for f, a, b in zip(first._fields, first, again) if not torch.equal(a, b)]
        if diff:
            fail(f"ndt-slice: two builds of {type(first).__name__} differ in {diff}")
    print("[ndt-slice] two builds of the keyframe's NDT map, VGICP map and voxel downsample "
          "agree to the bit", flush=True)
    ms = call_ms(lambda: build_voxel_map(cloud, NDTConfig()), repeats=20, warmup=3)
    print(f"[ndt-slice] {CARD}: the voxel map of a {cloud.capacity}-point keyframe lives on "
          f"{sorted(devices)}; build_voxel_map {ms:.3f} ms (median of 20, table "
          f"{vmap.table.numel() * 4 / 2**20:.1f} MiB)", flush=True)
    torch.cuda.synchronize()
    return launches


def scan_to_map_phase(K, seq):
    """Scan-to-submap odometry with NDT and with APDGICP."""
    import gorio_tpu_torch.registration.gicp as gicp_mod
    from gorio_tpu_torch.io.tum import ate_rmse, load_tum
    from gorio_tpu_torch.pipeline.odometry import OdometryConfig
    from gorio_tpu_torch.pipeline.odometry_replay import odometry_run

    gs, gp = load_tum(seq / "groundtruth.tum")
    launches = {}
    select = gicp_mod.nn1_select
    ref_sizes = set()

    def recording_select(query, ref, *args, **kwargs):
        ref_sizes.add(ref.shape[-2])
        return select(query, ref, *args, **kwargs)

    gicp_mod.nn1_select = recording_select
    try:
        for reg in ("ndt", "apdgicp"):
            what = f"scan-to-map-{reg}"
            K.reset_launch_counts()
            t0 = time.perf_counter()
            odo, stamps, poses, rebuild_s = odometry_run(
                seq, OdometryConfig(enable_scan_to_map=True, registration=reg))
            wall = time.perf_counter() - t0
            launches[what] = dict(K.launch_counts)
            ate = ate_rmse(stamps, poses, gs, gp)
            rec = SCAN_TO_MAP_JAX[reg]
            limit = 1.25 * rec + 0.02
            kf = odo.keyframe_cloud
            iters = [st.iterations for st in odo.statuses]
            ms = [1e3 * t for t in rebuild_s]
            print(f"[{what}] {CARD}: frames {len(stamps)}, keyframes {len(odo._submap_frames)}, "
                  f"fallbacks {sum(st.used_prediction for st in odo.statuses)}, submap "
                  f"{int(kf.mask.sum())} of {kf.capacity} on {kf.xyz.device}, outer iterations "
                  f"per frame mean {statistics.mean(iters):.2f}; rebuild {len(ms)} keyframes, "
                  f"{statistics.median(ms):.2f} ms median / {statistics.mean(ms):.2f} ms mean; "
                  f"launches {launches[what]}, wall {wall:.2f} s ({len(stamps) / wall:.2f} "
                  f"frames/s); ATE {ate:.6f} m (JAX {rec:.6f} m, limit {limit:.6f} m)",
                  flush=True)
            if kf.capacity != SUBMAP_M or kf.xyz.device.type != "cuda":
                fail(f"{what}: the submap is {kf.capacity} points on {kf.xyz.device}")
            if not ate <= limit:
                fail(f"{what}: ATE {ate} m > {limit} m (1.25 x the JAX record + 0.02 m)")
    finally:
        gicp_mod.nn1_select = select
    if SUBMAP_M not in ref_sizes or launches["scan-to-map-apdgicp"]["nn1_select"] == 0:
        fail(f"scan-to-map-apdgicp: nn1_select ran at ref sizes {sorted(ref_sizes)}, "
             f"not at M = {SUBMAP_M}")
    # for scale, not held: the same loop against the last keyframe alone
    _, stamps, poses, _ = odometry_run(seq, OdometryConfig())
    print(f"[scan-to-map] beside it, scan-to-keyframe APDGICP odometry over the same frames "
          f"(not held): ATE {ate_rmse(stamps, poses, gs, gp):.6f} m", flush=True)
    return launches


def stream_phase(K, seq, tmp, slice_keyframes):
    """The `stream` CLI in block and drop mode, and `stream_sequence` with
    the async optimize worker, on the 98 frames."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gorio_tpu_torch.cli import _imu_and_slam
    from gorio_tpu_torch.cli import main as cli
    from gorio_tpu_torch.io.tum import save_tum
    from gorio_tpu_torch.pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from gorio_tpu_torch.pipeline.streaming import stream_sequence

    frames = sorted(seq.glob("*.grf"))
    launches = {}
    defaults = SimpleNamespace(no_loops=False, preint="lpm")  # the `stream` CLI's

    def done(what, report, slam, odo, traj, exact=True, hold_ate=True):
        launches[what] = counts = dict(K.launch_counts)
        ate = cli(["evaluate", str(traj), str(seq / "groundtruth.tum")])["ate_rmse_m"]
        lm_iters = sum(st.iterations for st in odo.statuses)
        verify = slam.loop_detector.verify_iterations
        print(f"[{what}] {CARD}: {report.to_json()}", flush=True)
        print(f"[{what}] launches {counts}; LM iterations {lm_iters} (odometry) + {verify} "
              f"(verification); realtime factor {report.realtime_factor}, on time "
              f"{report.on_time_frac}, latency p50 / p95 / max {report.latency_p50_ms} / "
              f"{report.latency_p95_ms} / {report.latency_max_ms} ms at a {report.period_ms} ms "
              f"period; ATE {ate:.6f} m{'' if hold_ate else ' (not held)'}", flush=True)
        # at least: the warm-up's two frames launch too (and with the async
        # worker two threads count, so only launches at all are held)
        if counts["nn1_select"] < (lm_iters + verify if exact else 1):
            fail(f"{what}: nn1_select launched {counts['nn1_select']} times for {lm_iters} + "
                 f"{verify} LM iterations")
        if hold_ate and not ate <= ATE_MAX:
            fail(f"{what}: ATE {ate} m > {ATE_MAX} m")

    def replay(what, slam, stamps):
        """The frames a stream processed, through a plain loop of the same
        calls on the card: its keyframes and final trajectory to the bit."""
        from gorio_tpu_torch.io.native import NativePipelineDataset

        imu, ref = _imu_and_slam(defaults, seq, "cuda", floor=False)
        odo = ScanMatchingOdometry(OdometryConfig())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        keep = set(stamps)
        gyr_t, gyr = np.asarray(imu["gyr_t"]), np.asarray(imu["gyr"])
        for stamp, n, packed in NativePipelineDataset(frames, capacity=2048):
            if float(stamp) not in keep:
                continue
            omega = gyr[np.clip(np.searchsorted(gyr_t, stamp) - 1, 0, gyr_t.size - 1)]
            frame = torch.tensor(packed, dtype=torch.float64, device="cuda")
            pose, _ = odo.step_fused(float(stamp), frame, n, omega=omega, generator=gen)
            ref.add_frame(float(stamp), odo.last_cloud, pose)
        ref.optimize()
        same_kfs = [kf.stamp for kf in ref.keyframes] == [kf.stamp for kf in slam.keyframes] \
            and all(np.array_equal(a.odom_scan2scan, b.odom_scan2scan)
                    for a, b in zip(ref.keyframes, slam.keyframes))
        got, want = slam.trajectory()[1], ref.trajectory()[1]
        gap = float(np.abs(got[:, :3, 3] - want[:, :3, 3]).max()) if got.shape == want.shape \
            else float("inf")
        print(f"[{what}] its {len(stamps)} processed frames through a plain loop: "
              f"{len(ref.keyframes)} keyframes against {len(slam.keyframes)}, equal to the bit: "
              f"{same_kfs}; trajectory gap {gap} m", flush=True)
        if not same_kfs or not np.array_equal(got, want):
            fail(f"{what}: the stream's keyframes or trajectory differ from a plain loop over "
                 f"the frames it processed")

    stepped = []
    step_fused = ScanMatchingOdometry.step_fused

    def recording_step(self, stamp, *args, **kwargs):
        stepped.append((self, float(stamp)))
        return step_fused(self, stamp, *args, **kwargs)

    for what, flags in (("stream", ["--mode", "block", "--rate-multiplier", "1"]),
                        ("stream-drop", ["--mode", "drop", "--rate-multiplier", "4"])):
        K.reset_launch_counts()
        stepped.clear()
        traj = tmp / f"{what}.tum"
        ScanMatchingOdometry.step_fused = recording_step
        try:
            report, slam, odo = cli(["stream", "--dataset", str(seq), *flags, "--output",
                                     str(traj), "--report-out", str(tmp / f"{what}.json"),
                                     "--device", "cuda"])
        finally:
            ScanMatchingOdometry.step_fused = step_fused
        # dropped frames leave 0.4-0.8 s gaps, past the odometry's 1 m sanity
        # gate at 2 m/s: the odometry keeps its prediction and drifts metres
        done(what, report, slam, odo, traj, hold_ate=what == "stream")
        if report.n_frames != len(frames) or \
                report.n_processed + report.n_dropped != report.n_frames:
            fail(f"{what}: {report.n_processed} processed + {report.n_dropped} dropped of "
                 f"{report.n_frames} frames ({len(frames)} in the sequence)")
        if what == "stream":
            if report.n_dropped or abs(report.n_keyframes - slice_keyframes) > \
                    0.02 * slice_keyframes:
                fail(f"stream: {report.n_dropped} dropped, {report.n_keyframes} keyframes (the "
                     f"slice's {slice_keyframes} +- 2%)")
        stamps = [t for o, t in stepped if o is odo]  # not the warm-up's odometry
        if len(stamps) != report.n_processed:
            fail(f"{what}: {len(stamps)} frames stepped, {report.n_processed} processed")
        replay(what, slam, stamps)

    # optimize every 15 keyframes, on the consumer thread and on the async
    # worker: the CLI's back end and odometry
    for what, async_ in (("stream-sync", False), ("stream-async", True)):
        imu, slam = _imu_and_slam(defaults, seq, "cuda", floor=False)
        odo = ScanMatchingOdometry(OdometryConfig())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        K.reset_launch_counts()
        report = stream_sequence(frames, slam, odo,
                                 imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]},
                                 optimize_every=STREAM_OPTIMIZE_EVERY, optimize_async=async_,
                                 generator=gen)
        slam.optimize()
        save_tum(tmp / f"{what}.tum", *slam.trajectory())
        done(what, report, slam, odo, tmp / f"{what}.tum", exact=not async_)
        print(f"[{what}] optimize cycles {report.n_opt_cycles}, skipped "
              f"{report.n_opt_skipped}, p50 / max {report.opt_p50_ms} / {report.opt_max_ms} ms",
              flush=True)
        if report.n_processed != len(frames) or report.n_opt_cycles == 0:
            fail(f"{what}: {report.n_processed} frames processed, {report.n_opt_cycles} "
                 f"optimize cycles")
    return launches


def align_phase(K, tmp):
    """The align CLI on `bench.py`'s synthetic pair (its NDT readings are the
    bench phase's)."""
    import numpy as np

    from gorio_tpu_torch.bench import synth_pair, synth_transform
    from gorio_tpu_torch.cli import main as cli
    from gorio_tpu_torch.io.pcd import write_pcd

    (a, inten), (b, _) = synth_pair()
    T_true = synth_transform().astype(np.float64)
    write_pcd(tmp / "tgt.pcd", b, inten)
    write_pcd(tmp / "src.pcd", a, inten)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rows = cli(["align", str(tmp / "tgt.pcd"), str(tmp / "src.pcd"), "--repeat", "3",
                "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = dict(K.launch_counts)
    bad = []
    for row in rows:
        d = np.linalg.inv(row["T"].double().cpu().numpy()) @ T_true
        te = float(np.linalg.norm(d[:3, 3]))
        re = float(np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))))
        jax = ALIGN_JAX[row["method"]]
        t_max, r_max = ALIGN_TRANS_M, ALIGN_ROT_DEG
        if row["method"] in ALIGN_JAX_MISSES:
            t_max, r_max = jax[0] + ALIGN_TRANS_M, jax[1] + ALIGN_ROT_DEG
        print(f"[align] {CARD}: {row['method']:<16} fitness {row['fitness']:.6f}, first "
              f"{row['first_ms']:.2f} ms, warm {row['warm_ms']:.2f} ms, {row['iterations']} "
              f"iterations; error {te:.6f} m / {re:.6f} deg (JAX CPU {jax}; limits "
              f"{t_max:.4f} m / {r_max:.2f} deg)", flush=True)
        if not (te <= t_max and re <= r_max):
            bad.append(row["method"])
    print(f"[align] launches {launches}, wall {wall:.2f} s", flush=True)
    if bad:
        fail(f"align: {bad} miss the known transform")

    return launches


# ---- posterior -------------------------------------------------------------

POSTERIOR_CHAINS, POSTERIOR_DRAWS = 4, 200  # sample_posterior's defaults (100 warmup)
POSTERIOR_LEAPFROG = 16
POSTERIOR_WINDOW = 10
ACCEPT_MIN, LAPLACE_RATIO = 0.3, (0.1, 10.0)  # JAX `test_posterior_sampling`'s criteria
# The JAX package's CPU f64 record of `sample_posterior(PRNGKey(0))` at the
# defaults on the keyframes of its CLI's circuit run (`tests/jax_records.py
# posterior`; PERF.md): Monte Carlo quantities, printed beside the card's
CIRCUIT_POSTERIOR_JAX = {"keyframes": 361, "loops": 13, "dofs": 2166,
                         "accept": 0.9242661964101941, "rhat_max": 0.9986175310943047,
                         "laplace_std_last_pose": 0.16240869078927544}
SMOOTHER_N, SMOOTHER_STAGES, SMOOTHER_MOVES = 10240, 8, 2  # BASELINE config 5: 10k+ particles
# JAX `test_evidence_rejects_bogus_loop`: its loop (information 100 I, a
# 0.1 m translation stddev, no Huber kernel) moved by [20, -15, 5] m, 255
# stddevs, must lower log Z by > 50
BOGUS_OFFSET_M, BOGUS_STDDEVS, BOGUS_DROP = (20.0, -15.0, 5.0), 255.0, 50.0
JAX_TEST_LOOP_SQRT_INFO = 10.0
# The JAX package's CPU f64 record (`tests/jax_records.py smoother`; PERF.md)
# of the smoother on its own circuit run's keyframes, 1,024 particles (the
# port's CPU run on its draws equal within 1e-10): log Z of the true loops,
# its drop in each other run, the stages resampled; printed, not held
CIRCUIT_SMOOTHER_JAX = {
    "true loops": {"log_evidence": -7.557912588705501, "resampled_stages": 0},
    "first loop moved 255 of its stddevs": {"drop": 127.34440978114125, "resampled_stages": 0},
    "the JAX test's bogus loop in place of the first": {"drop": 53775.3127072056,
                                                        "resampled_stages": 8},
}
CARD_CPU_TOL = 1e-8
CARD_CPU_PARTICLES, CARD_CPU_STAGES = 256, 2


def leapfrog_ms(lp, y0, graphed, steps):
    """ms per leapfrog step of `hmc_step` on the density `lp` at the chains
    `y0`, eager or through a captured CUDA graph (as `run_hmc` runs it)."""
    import torch

    from gorio_tpu_torch.inference.hmc import CudaGraphed, hmc_init, hmc_step

    fn = CudaGraphed(lp, y0) if graphed else lp
    state = hmc_init(fn, y0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, _ = hmc_step(state, fn, 0.05, POSTERIOR_LEAPFROG, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = hmc_step(state, fn, 0.05, POSTERIOR_LEAPFROG, generator=gen)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (steps * POSTERIOR_LEAPFROG)


def density_profile(what, lp, y0):
    """One `value_and_grad` of `lp` at `y0`, eager under the profiler (its
    kernels and device time) and through a captured CUDA graph (equal to the
    eager result to the bit)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gorio_tpu_torch.inference.hmc import CudaGraphed, value_and_grad

    y = 0.3 * torch.randn(y0.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                          dtype=y0.dtype, device=y0.device)
    eager = value_and_grad(lp, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        value_and_grad(lp, y)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    graphed = value_and_grad(CudaGraphed(lp, y0), y)
    gap = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
              for a, b in zip(graphed, eager))
    print(f"[{what}] {CARD}: one whitened density value and gradient, {y0.shape[0]} chains x "
          f"{y0.shape[1]} dofs: {sum(e.count for e in ev)} kernels and "
          f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f} ms of device time eager; the "
          f"CUDA graph's replay against the eager call: max relative difference {gap:.3e}",
          flush=True)
    if not gap <= 1e-10:
        fail(f"{what}: the CUDA graph's density differs from the eager one by {gap:.3e}")


def posterior_run(what, slam, window=None, profile_density=False):
    """`sample_posterior` at the defaults on the card: its checks, its
    diagnostics and its timing. The density it sampled is rebuilt from
    `posterior_graph` and the same dense solve, and timed per leapfrog step
    through the CUDA graph and eager."""
    import numpy as np
    import torch

    from gorio_tpu_torch.graph.solver import laplace_covariance, optimize_graph
    from gorio_tpu_torch.inference.hmc import chain_ess
    from gorio_tpu_torch.inference.laplace import graph_logprob, whitened_logprob

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, accepts, rhat, cov = slam.sample_posterior(gen, window=window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    C, n, D = samples.shape
    K = D // 6
    if not all(bool(torch.isfinite(x).all()) for x in (samples, accepts, rhat, cov)):
        fail(f"{what}: non-finite samples, accept probabilities, R-hat or covariance")
    if samples.device.type != "cuda" or cov.shape != (D, D):
        fail(f"{what}: samples on {samples.device}, covariance {tuple(cov.shape)} for {D} dofs")
    if window is not None and D != 6 * window:
        fail(f"{what}: {D} dofs, expected 6 x {window}")
    post = samples[:, n // 4:]
    emp_std = post.reshape(-1, D).std(dim=0)
    lap_std = torch.sqrt(torch.diagonal(cov))
    ratio = float(emp_std[D - 6:].mean() / lap_std[D - 6:].mean())
    accept = float(accepts.mean())
    ess = chain_ess(post.cpu().numpy())
    poses0, graph = slam.posterior_graph(window)
    res = optimize_graph(poses0, graph, slam.cfg.solve)
    cov_gap = float((laplace_covariance(res) - cov).abs().max())
    lp_y, _ = whitened_logprob(graph_logprob(res.poses, graph), res.H)
    y0 = torch.zeros((C, D), dtype=poses0.dtype, device=poses0.device)
    graphed, eager = leapfrog_ms(lp_y, y0, True, 8), leapfrog_ms(lp_y, y0, False, 2)
    iters = n + n // 2
    print(f"[{what}] {CARD}: {K} keyframes, {D} dofs, {C} chains x {n} draws after {n // 2} "
          f"warmup, accept {accept:.4f}, R-hat max {float(rhat.max()):.4f} (last 3/4), Geyer "
          f"ESS min / median {ess.min():.1f} / {np.median(ess):.1f} of {C * (n - n // 4)}, last "
          f"pose's std / Laplace std {ratio:.4f}, {C * n / wall:.1f} samples/s (whole call "
          f"{wall:.2f} s, {1e3 * wall / (iters * POSTERIOR_LEAPFROG):.3f} ms per leapfrog step "
          f"of its {iters} x {POSTERIOR_LEAPFROG}); the sampled density rebuilt (its Laplace "
          f"covariance within {cov_gap:.3e} of the call's): {graphed:.3f} ms per leapfrog step "
          f"through the CUDA graph, {eager:.3f} ms eager", flush=True)
    if not accept > ACCEPT_MIN:
        fail(f"{what}: mean acceptance {accept:.4f} <= {ACCEPT_MIN}")
    if not LAPLACE_RATIO[0] < ratio < LAPLACE_RATIO[1]:
        fail(f"{what}: the last pose's std is {ratio:.4f} x its Laplace std, outside "
             f"{LAPLACE_RATIO}")
    if profile_density:
        density_profile(what, lp_y, y0)
    return dict(accept=accept, rhat_max=float(rhat.max()),
                laplace_std_last_pose=float(lap_std[D - 6:].mean()),
                inputs=dict(poses=res.poses, graph=graph, H=res.H, D=D))


def smoother_graph(slam, device="cuda"):
    """The circuit's keyframes as `sample_posterior` builds their graph,
    around the odometry poses: the anchor prior, the odometry and
    preintegration betweens and, masked as the tempered factors, the
    accepted loops. Returns (poses0, graph, loop_mask)."""
    import numpy as np

    from gorio_tpu_torch.graph.graph import PoseGraph

    kfs = slam.keyframes
    g = PoseGraph()
    for kf in kfs:
        g.add_pose(kf.odom_scan2scan)
    g.add_prior(0, kfs[0].odom_scan2scan, info=np.eye(6) * slam.cfg.anchor_info)
    for k in range(1, len(kfs)):
        prev, curr = kfs[k - 1], kfs[k]
        g.add_between(k - 1, k, np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan,
                      info=curr.edge_info)
        if curr.trans_integrated is not None:
            var = np.clip(np.diag(curr.preint_cov), 1e-6, None)
            g.add_between(k - 1, k, curr.trans_integrated, info=np.diag(1.0 / var))
    slots = []
    for loop in slam.loops:
        slots.append(len(g._between))
        g.add_between(loop.key_old, loop.key_new, loop.T_rel, info=loop.information,
                      robust_delta=slam.cfg.loop_robust_delta)
    poses0, graph = g.freeze(device=device)
    mask = np.zeros(graph.between.mask.shape[0], bool)
    mask[slots] = True
    return poses0, graph, mask


def smoother_variants(graph, mask):
    """The runs of the smoother phase, name -> graph: the true loops; the
    first loop moved by 255 of its own translation stddevs (the circuit's
    loops carry the fitness-based information of the reference, a
    translation stddev of metres, and a Huber kernel); and replaced by the
    JAX test's bogus loop (information 100 I, no Huber kernel, moved by
    [20, -15, 5] m: 255 stddevs). Also returns the first loop's stddev (m)."""
    import numpy as np
    import torch

    bw = graph.between
    idx = int(np.flatnonzero(mask)[0])
    sq = bw.sqrt_info[idx, 3:, 3:]
    stddev = float(torch.sqrt(1.0 / torch.diagonal(sq.T @ sq).mean()))
    offset = torch.tensor(BOGUS_OFFSET_M, dtype=bw.T_meas.dtype, device=bw.T_meas.device)

    def edit(k, jax_loop=False):
        T_meas, sqrt_info, delta = bw.T_meas.clone(), bw.sqrt_info.clone(), bw.robust_delta.clone()
        T_meas[idx, :3, 3] += k * offset
        if jax_loop:
            sqrt_info[idx] = JAX_TEST_LOOP_SQRT_INFO * torch.eye(6, dtype=sqrt_info.dtype,
                                                                 device=sqrt_info.device)
            delta[idx] = float("inf")
        return graph._replace(between=bw._replace(T_meas=T_meas, sqrt_info=sqrt_info,
                                                  robust_delta=delta))

    scale = BOGUS_STDDEVS * stddev / float(torch.linalg.norm(offset))
    return stddev, {
        "true loops": graph,
        "first loop moved 255 of its stddevs": edit(scale),
        "the JAX test's bogus loop in place of the first": edit(1.0, jax_loop=True),
    }


def resampled(res, n):
    """The stages whose ESS fell below half the particles: those the
    smoother resampled (its `ess_threshold` 0.5)."""
    return [s for s, e in enumerate(res.ess_per_stage.tolist()) if e < 0.5 * n]


def smoother_phase(slam, seq):
    """`smc_loop_relaxation` over the circuit at 10,240 particles, in each
    of `smoother_variants`: the true loops hold the JAX test's checks;
    moving the first loop 255 of its stddevs and the JAX test's bogus loop
    must each lower log Z by more than 50, and the latter must resample.
    Returns the circuit's poses, its graph with the true loops and with the
    JAX test's bogus loop, the loop mask, and the last (bogus-loop) run."""
    import numpy as np
    import torch

    from gorio_tpu_torch.inference.smoother import loop_evidence_gate, smc_loop_relaxation
    from gorio_tpu_torch.io.tum import ate_rmse, load_tum

    poses0, graph, mask = smoother_graph(slam)
    gs, gp = load_tum(seq / "groundtruth.tum")
    stamps = np.asarray([kf.stamp for kf in slam.keyframes])
    stddev, variants = smoother_variants(graph, mask)
    print(f"[smoother] the first loop's translation stddev {stddev:.4f} m", flush=True)
    logz = {}
    for what, g in variants.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = smc_loop_relaxation(None, poses0, g, mask, n_particles=SMOOTHER_N,
                                  n_stages=SMOOTHER_STAGES, n_moves=SMOOTHER_MOVES)(gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ess = res.ess_per_stage.cpu().numpy()
        rs = resampled(res, SMOOTHER_N)
        logz[what], acc = float(res.log_evidence), float(res.accept_rate)
        ate_odom = ate_rmse(stamps, poses0.cpu().numpy(), gs, gp)
        ate_mean = ate_rmse(stamps, res.poses_mean.cpu().numpy(), gs, gp)
        drop = logz["true loops"] - logz[what]
        print(f"[smoother] {CARD}: {what}: {SMOOTHER_N} particles over {poses0.shape[0]} poses, "
              f"{int(mask.sum())} loops, {SMOOTHER_STAGES} stages x {SMOOTHER_MOVES} MALA moves "
              f"in {wall:.2f} s, log evidence {logz[what]:.4f} (lower by {drop:.4f}), ESS per "
              f"stage {np.round(ess, 1).tolist()}, resampled at stages {rs}, accept {acc:.4f}, "
              f"ATE of the posterior mean {ate_mean:.6f} m (odometry {ate_odom:.6f} m), gate "
              f"{loop_evidence_gate(res)}, peak memory {peak:.2f} GiB; the JAX package's "
              f"record on its own circuit run (1,024 particles) {CIRCUIT_SMOOTHER_JAX[what]}",
              flush=True)
        if what == "true loops":
            if not (np.isfinite(logz[what]) and bool(torch.isfinite(res.mean_delta).all())):
                fail("smoother: non-finite log evidence or posterior mean")
            if not (np.all(ess > 1.0) and np.all(ess <= SMOOTHER_N * (1 + 1e-9))):
                fail(f"smoother: a stage's ESS outside (1, {SMOOTHER_N}]: {ess.tolist()}")
            if not acc > 0.05:
                fail(f"smoother: MALA acceptance {acc:.4f} <= 0.05")
            if not ate_mean < ate_odom:
                fail(f"smoother: the posterior mean's ATE {ate_mean:.6f} m is not below the "
                     f"odometry's {ate_odom:.6f} m")
            if not loop_evidence_gate(res):
                fail(f"smoother: loop_evidence_gate rejects the true loops (log Z "
                     f"{logz[what]:.4f})")
        elif not drop > BOGUS_DROP:
            fail(f"smoother: {what}: log evidence lower by only {drop:.4f} (must exceed "
                 f"{BOGUS_DROP})")
        if what.startswith("the JAX test's") and not rs:
            fail(f"smoother: {what}: no stage resampled (ESS {ess.tolist()})")
    return poses0, graph, variants["the JAX test's bogus loop in place of the first"], mask, res


def _graph_on(dev, graph):
    return type(graph)(*(type(f)(*(t.to(dev) for t in f)) for f in graph))


def hmc_card_equals_cpu(inputs):
    """`run_hmc` (2 chains x 20 draws on the slice's whitened posterior) on
    the card and on the CPU from the same inputs and the same draws, made on
    the CPU from a seeded generator: equal within 1e-8."""
    import torch

    from gorio_tpu_torch.inference.hmc import run_hmc
    from gorio_tpu_torch.inference.laplace import graph_logprob, whitened_logprob

    gen = torch.Generator().manual_seed(0)
    D = inputs["D"]
    n, S = 20, 30
    draws = (torch.randn((S, 2, D), generator=gen, dtype=torch.float64),
             torch.log(torch.rand((S, 2), generator=gen, dtype=torch.float64)))
    runs = []
    for dev in ("cuda", "cpu"):
        lp_y, _ = whitened_logprob(graph_logprob(inputs["poses"].to(dev),
                                                 _graph_on(dev, inputs["graph"])),
                                   inputs["H"].to(dev))
        runs.append(run_hmc(lp_y, torch.zeros((2, D), dtype=torch.float64, device=dev),
                            n_samples=n, step_size=0.15, n_leapfrog=POSTERIOR_LEAPFROG,
                            draws=tuple(d.to(dev) for d in draws)))
    hmc_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(*runs))
    print(f"[posterior] card = CPU on the same draws: run_hmc (2 chains x {n} draws, {D} dofs) "
          f"max |diff| {hmc_err:.3e} (limit {CARD_CPU_TOL})", flush=True)
    if not hmc_err <= CARD_CPU_TOL:
        fail(f"posterior: the card's run_hmc differs from the CPU's on the same draws "
             f"({hmc_err:.3e})")


def smc_card_equals_cpu(smoother_inputs):
    """`smc_loop_relaxation` (256 particles, 2 stages on the circuit with the
    JAX test's bogus loop, where it resamples) on the card and on the CPU
    from the same inputs and the same draws, made on the CPU from a seeded
    generator: equal within 1e-8 relative to each field's largest value, and
    resampled at the same stages, at least one."""
    import torch

    from gorio_tpu_torch.inference.smoother import smc_loop_relaxation

    gen = torch.Generator().manual_seed(0)
    poses0, graph, mask = smoother_inputs
    N, S2, D2 = CARD_CPU_PARTICLES, CARD_CPU_STAGES, poses0.shape[0] * 6
    sdraws = (torch.randn((N, D2), generator=gen, dtype=torch.float64),
              torch.rand((S2,), generator=gen, dtype=torch.float64),
              torch.randn((S2, 1, N, D2), generator=gen, dtype=torch.float64),
              torch.log(torch.rand((S2, 1, N), generator=gen, dtype=torch.float64)))
    res = []
    for dev in ("cuda", "cpu"):
        run = smc_loop_relaxation(None, poses0.to(dev), _graph_on(dev, graph), mask,
                                  n_particles=N, n_stages=S2, n_moves=1)
        res.append(run(draws=tuple(d.to(dev) for d in sdraws)))
    smc_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1.0))
                  for a, b in zip(*res))
    rs = resampled(res[0], N), resampled(res[1], N)
    print(f"[posterior] card = CPU on the same draws: smc_loop_relaxation ({N} particles, {S2} "
          f"stages, {poses0.shape[0]} poses, the JAX test's bogus loop; resampled at stages "
          f"{rs[0]} on the card, {rs[1]} on the CPU) max |diff| relative to each field's "
          f"largest {smc_err:.3e} (limit {CARD_CPU_TOL})", flush=True)
    if not smc_err <= CARD_CPU_TOL:
        fail(f"posterior: the card's smc_loop_relaxation differs from the CPU's on the same "
             f"draws ({smc_err:.3e})")
    if not rs[0] or rs[0] != rs[1]:
        fail(f"posterior: smc_loop_relaxation resampled at stages {rs[0]} on the card and "
             f"{rs[1]} on the CPU: the comparison must cover a resample")


def posterior_phase(K, slice_slam):
    """Posterior inference on the slice's SLAM: the two `sample_posterior`
    runs (their launch counts are part of the path's) and `run_hmc` on the
    card against the CPU."""
    t0 = time.perf_counter()
    K.reset_launch_counts()
    first = posterior_run("slice-posterior", slice_slam)
    posterior_run(f"slice-posterior window={POSTERIOR_WINDOW}", slice_slam,
                  window=POSTERIOR_WINDOW)
    launches = dict(K.launch_counts)
    hmc_card_equals_cpu(first["inputs"])
    print(f"[posterior] {CARD}: the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def circuit_posterior_phase(K, circuit_slam, circuit_seq):
    """Posterior inference on the circuit's SLAM: `sample_posterior` (its
    launch count is the rest of the path's), the smoother, and
    `smc_loop_relaxation` on the card against the CPU. Returns the launches
    and what `smoother_phase` returns."""
    t0 = time.perf_counter()
    K.reset_launch_counts()
    rec = posterior_run("circuit-posterior", circuit_slam, profile_density=True)
    launches = dict(K.launch_counts)
    print(f"[circuit-posterior] the JAX package's CPU f64 record on its own run's keyframes "
          f"{CIRCUIT_POSTERIOR_JAX}; the card's accept {rec['accept']:.4f}, R-hat max "
          f"{rec['rhat_max']:.4f}, Laplace std of the last pose "
          f"{rec['laplace_std_last_pose']:.6f} (Monte Carlo quantities: printed, not held); "
          f"launches {launches}", flush=True)
    poses0, graph, bogus, mask, bogus_res = smoother_phase(circuit_slam, circuit_seq)
    smc_card_equals_cpu((poses0, bogus, mask))
    print(f"[circuit-posterior] {CARD}: the phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, (poses0, graph, bogus, mask, bogus_res)


# ---- solvers-batched -------------------------------------------------------

# The JAX package's CPU f64 record of `slam --config` with `dump-config`'s
# tree and slam.solve.solver = "cg" on the slice (`PYTHONPATH=
# JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python tests/jax_records.py cg-slice SEQ
# OUT`; its dense run is ROADMAP's 80 keyframes, 0.014179 m)
CG_SLICE_JAX = {"keyframes": 80, "loops": 0, "ate_m": 0.014178711904797445,
                "rte_m": 0.022326770313002297}
CG_SLICE_ATE_M = 1e-4  # the cg-slice's ATE against the JAX record
CG_CHI2_RTOL, CG_POSE_M = 1e-6, 1e-3  # block PCG against the direct solve
CG_CPU_CHI2_RTOL, CG_CPU_POSE_M = 1e-6, 1e-6  # dense Jacobi-PCG: the card against the CPU
# ... held at this step cap: an unconverged Jacobi-PCG of 100 steps on a floor
# graph moves by ~1e-4-1e-3 m under a reordered matvec on one CPU (the
# rounding of its late steps decides where it stops), so the card and the
# CPU part there; the default's gaps are printed
CG_CPU_STEPS = 20
BATCH_RTOL = {"torch.float64": 1e-9, "torch.float32": 1e-5}  # a batch against its loop
# UGPM's: its LM solves (damping down to 1e-6 x 0.33^k) carry the last-bit
# differences of batched against single products to ~1e-9 of each field
# (2.6e-9 on the card, 1.1e-9 on the CPU), the noise floor of one window's
# own result; held at the port's single-window limit against the JAX
# package (`tests/test_torch_ugpm.py`)
UGPM_BATCH_RTOL = 1e-8
GN_ITERS = 8
CHUNK_RAD, CHUNK_M = 2e-3, 2e-2  # JAX `test_chunked_preintegration_matches_single`
# The JAX package's CPU f64 gaps between `quantum=1.0` and one window on that
# test's input (`PYTHONPATH= JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python
# tests/jax_records.py preint-chunked`): UGPM's exceed the test's LPM limits
# in both packages, so UGPM is held to the record's gaps instead
CHUNKED_JAX = {"lpm": {"rad": 0.0004720585830339202, "m": 0.0006514350457613033},
               "ugpm": {"rad": 0.0038930662055908258, "m": 0.00890275712416877}}
CHUNKED_JAX_TOL = 1e-6
CARD_CPU_PREINT = 1e-9


def _sync_s(fn):
    """(fn(), seconds) of one call on the card, the bench module's timer."""
    import torch

    from gorio_tpu_torch.bench import timed_call

    return timed_call(fn, torch.device("cuda"))


def _mean_s(fn, n):
    """Seconds per call of `n` calls after a warm-up, the bench module's
    protocol."""
    import torch

    from gorio_tpu_torch.bench import mean_s

    return mean_s(fn, n, torch.device("cuda"))


def _rel_gap(got, want):
    """Largest |got - want| over the largest |want|, of tensors or tuples."""
    gaps = [float((g.double().cpu() - w.double().cpu()).abs().max())
            / max(float(w.double().abs().max()), 1e-300)
            for g, w in zip(got, want) if g is not None and g.numel()]
    return max(gaps) if gaps else 0.0


def cg_slice_phase(K, seq, tmp, dense_ate):
    """`slam --config` with dump-config's tree and solver "cg" on the
    slice: the dense Jacobi-PCG at 128 padded poses, through both kernels."""
    from gorio_tpu_torch.cli import main as cli

    cli(["dump-config", "--output", str(tmp / "cg.json")])
    tree = json.loads((tmp / "cg.json").read_text())
    tree["slam"]["solve"]["solver"] = "cg"
    (tmp / "cg.json").write_text(json.dumps(tree))
    with SolveTimer("cg-slice") as solves:
        slam, odo, timer, launches, batched, wall, result = run_slam(
            K, seq, tmp / "cg_slice.tum", ["--config", str(tmp / "cg.json")])
    lm_iters, verify_iters = check_common("cg-slice", slam, odo, launches)
    report("cg-slice", len(list(seq.glob("*.grf"))), slam, timer, launches, batched, wall,
           result, lm_iters, verify_iters)
    solves.report()
    n_kf, ate, rec = len(slam.keyframes), result["ate_rmse_m"], CG_SLICE_JAX
    print(f"[cg-slice] keyframes {n_kf} (JAX {rec['keyframes']}), ATE {ate:.6f} m (JAX CPU f64 "
          f"{rec['ate_m']:.6f} m, limit +-{CG_SLICE_ATE_M} m; the dense slice's ATE "
          f"{dense_ate:.6f} m), CG solves {slam.solver_counts['cg']}", flush=True)
    if slam.solver_counts["cg"] == 0:
        fail(f"cg-slice: no CG solve ran ({slam.solver_counts})")
    if n_kf != rec["keyframes"] or len(slam.loops) != rec["loops"]:
        fail(f"cg-slice: {n_kf} keyframes, {len(slam.loops)} loops; the JAX record "
             f"{rec['keyframes']}, {rec['loops']}")
    if not abs(ate - rec["ate_m"]) <= CG_SLICE_ATE_M:
        fail(f"cg-slice: ATE {ate} m, the JAX record {rec['ate_m']} m +- {CG_SLICE_ATE_M} m")
    return launches


def _cpu_tree(x):
    """Tensors of nested dicts and (named) tuples, on the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu_tree(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_cpu_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu_tree(v) for v in x)
    return x


def _solve_line(what, solver, res, s):
    iters = int(res.iterations)
    print(f"[cg-graphs] {CARD}: {what} {solver}: {iters} LM iterations, {s:.3f} s, "
          f"{1e3 * s / max(iters, 1):.2f} ms per LM iteration, chi2 {float(res.chi2):.9g}",
          flush=True)


def _pose_gap(a, b):
    """(largest translation gap m, largest rotation-entry gap) of two pose
    sets."""
    return (float((a[:, :3, 3] - b[:, :3, 3]).abs().max()),
            float((a[:, :3, :3] - b[:, :3, :3]).abs().max()))


def cg_graph_phase(what, graph_cfg):
    """CG against the direct solve on a graph a slam run built: the
    circuit's final pose graph, or the full-circuit's first floor graph at
    512 padded poses (its final one starts at its own optimum: 360
    keyframes are 24 x 15, so the last `--optimize-every` cycle has solved
    it already and every LM step is rejected)."""
    import torch

    from gorio_tpu_torch.graph.sparse import (optimize_graph_sparse,
                                              optimize_graph_with_planes_sparse)

    fn = {"circuit": optimize_graph_sparse,
          "full-circuit": optimize_graph_with_planes_sparse}[what]
    *graph, cfg = graph_cfg
    ref, s_ref = _sync_s(lambda: fn(*graph, cfg._replace(solver="direct")))
    cg, s_cg = _sync_s(lambda: fn(*graph, cfg._replace(solver="cg")))
    _solve_line(f"{what} ({graph[0].shape[0]} padded poses)", "direct", ref, s_ref)
    _solve_line(f"{what} ({graph[0].shape[0]} padded poses)", "cg", cg, s_cg)
    dt, dr = _pose_gap(cg.poses, ref.poses)
    rel = abs(float(cg.chi2) - float(ref.chi2)) / abs(float(ref.chi2))
    extra = ""
    if hasattr(cg, "planes"):
        extra = f", planes {float((cg.planes - ref.planes).abs().max()):.3g} apart"
    print(f"[cg-graphs] {what}: CG against direct: chi2 {rel:.3g} relative, poses "
          f"{dt:.3g} m / {dr:.3g} (rotation entries){extra}; the solves moved the poses by "
          f"up to {_pose_gap(ref.poses, graph[0])[0]:.3g} m", flush=True)
    if not (rel <= CG_CHI2_RTOL and dt <= CG_POSE_M and dr <= CG_POSE_M):
        fail(f"{what}: CG ends chi2 {rel:.3g} relative and {dt:.3g} m / {dr:.3g} from the "
             f"direct solve (limits {CG_CHI2_RTOL}, {CG_POSE_M} m)")
    if what == "circuit":
        again, _ = _sync_s(lambda: fn(*graph, cfg._replace(solver="cg")))
        same = (torch.equal(again.poses, cg.poses) and torch.equal(again.chi2, cg.chi2)
                and int(again.iterations) == int(cg.iterations))
        print(f"[cg-graphs] circuit: a second CG solve "
              f"{'agrees to the bit' if same else 'DIFFERS'}", flush=True)
        if not same:
            fail("circuit: two CG solves of one graph differ")


def cg_full_slice_phase(graph_cfg):
    """The dense Jacobi-PCG against the dense Cholesky on the full-slice's
    floor graph at its default steps and at `CG_CPU_STEPS`, and the latter
    against the port's CPU run of the same solve."""
    from gorio_tpu_torch.graph.solver import optimize_graph_with_planes

    *graph, cfg = graph_cfg
    what = f"full-slice ({graph[0].shape[0]} padded poses, dense)"
    ref, s_ref = _sync_s(lambda: optimize_graph_with_planes(*graph, cfg._replace(solver="dense")))
    _solve_line(what, "dense", ref, s_ref)
    for cg_iters in (cfg.cg_iters, CG_CPU_STEPS):
        ccfg = cfg._replace(solver="cg", cg_iters=cg_iters)
        cg, s_cg = _sync_s(lambda: optimize_graph_with_planes(*graph, ccfg))
        _solve_line(what, f"cg ({cg_iters} steps at most)", cg, s_cg)
        dt, dr = _pose_gap(cg.poses, ref.poses)
        print(f"[cg-graphs] full-slice, Jacobi-PCG of {cg_iters} steps: against the dense "
              f"Cholesky chi2 {float(cg.chi2) / float(ref.chi2) - 1:.3g} relative, poses "
              f"{dt:.3g} m / {dr:.3g}", flush=True)
    t0 = time.perf_counter()
    cpu = optimize_graph_with_planes(*_cpu_tree(graph), ccfg)
    s_cpu = time.perf_counter() - t0
    rel = abs(float(cg.chi2) - float(cpu.chi2)) / abs(float(cpu.chi2))
    dtc, drc = _pose_gap(cg.poses.cpu(), cpu.poses)
    print(f"[cg-graphs] full-slice, Jacobi-PCG of {CG_CPU_STEPS} steps: the card against the CPU "
          f"({int(cpu.iterations)} LM iterations, {s_cpu:.1f} s there) chi2 {rel:.3g} relative, "
          f"poses {dtc:.3g} m / {drc:.3g} (held)", flush=True)
    if not (rel <= CG_CPU_CHI2_RTOL and dtc <= CG_CPU_POSE_M and drc <= CG_CPU_POSE_M):
        fail(f"full-slice: the card's CG ends chi2 {rel:.3g} relative and {dtc:.3g} m / "
             f"{drc:.3g} from the CPU's (limits {CG_CPU_CHI2_RTOL}, {CG_CPU_POSE_M} m)")


def _rate_line(what, unit, n, s_batch, s_loop, err, dtype, extra="", limit=None):
    limit = BATCH_RTOL[str(dtype)] if limit is None else limit
    print(f"[batched] {CARD}: {what}: batch {n / s_batch:.1f} {unit}/s ({1e3 * s_batch:.2f} ms "
          f"per batch of {n}), loop of single calls {n / s_loop:.1f} {unit}/s; largest gap to "
          f"the loop {err:.3g} relative ({dtype}, limit {limit}){extra}", flush=True)
    if not err <= limit:
        fail(f"{what}: the batch is {err:.3g} from its loop of single calls")


def ego_batch():
    """`estimate_ego_velocity` over bench.py's 64 scans of 1,024 points
    against 64 single calls on the same scans and draws. The scans are
    rendered radar scans with Doppler (bench.py's `random_cloud`s carry
    none, so every lane would read zero velocity)."""
    import numpy as np
    import torch

    from gorio_tpu_torch.bench import EGO_B, EGO_N
    from gorio_tpu_torch.core.pointcloud import PointCloud
    from gorio_tpu_torch.estimators.egovel import (EgoVelConfig, _gate, draw_hypotheses,
                                                   estimate_ego_velocity)
    from gorio_tpu_torch.io.synthetic import make_world, render_radar_scan

    rng = np.random.default_rng(2)
    world = make_world(seed=2, n_landmarks=4000)
    scans = [render_radar_scan(world, np.eye(3), np.zeros(3), rng.normal(size=3) * [2, 0.5, 0.1],
                               capacity=EGO_N, seed=100 + b, azimuth_fov_deg=56.5,
                               elevation_fov_deg=22.5) for b in range(EGO_B)]
    batch = PointCloud(*(torch.stack(xs).to("cuda") for xs in zip(*scans)))
    cfg = EgoVelConfig()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    hyp = draw_hypotheses(_gate(batch, cfg)[0], cfg.ransac_iter, cfg.n_ransac_points, gen)
    got = estimate_ego_velocity(batch, cfg, hyp_idx=hyp)

    def loop():
        return [estimate_ego_velocity(PointCloud(*(x[b] for x in batch)), cfg, hyp_idx=hyp[b])
                for b in range(EGO_B)]

    loop()  # warm
    one, s_loop = _sync_s(loop)
    err = max(_rel_gap((got.v[b], got.sigma[b]), (r.v, r.sigma)) for b, r in enumerate(one))
    masks = all(torch.equal(got.inlier_mask[b], r.inlier_mask) and torch.equal(got.ok[b], r.ok)
                for b, r in enumerate(one))
    s_batch = _mean_s(lambda: estimate_ego_velocity(batch, cfg, hyp_idx=hyp), 10)
    _rate_line(f"ego-velocity ({EGO_B} scans of {EGO_N} points)", "scans", EGO_B, s_batch, s_loop,
               err, batch.xyz.dtype, f", masks {'equal' if masks else 'DIFFERENT'}, "
               f"{int(got.ok.sum())} ok, {int(got.zero_velocity.sum())} at zero velocity")
    if not masks:
        fail("ego-velocity: the batch's inlier masks differ from its loop's")


def ugpm_batch():
    """`ugpm_fit` and `ugpm_query` over bench.py's 64 windows (float64)
    against 64 single calls."""
    import torch

    from gorio_tpu_torch.bench import UGPM_CFG, UGPM_G, UGPM_Q, UGPM_V, UGPM_W, ugpm_inputs
    from gorio_tpu_torch.preintegration.ugpm import UGPMConfig, ugpm_fit, ugpm_query

    (gyr_t, gyr, vel_t, vel, starts, queries), _ = ugpm_inputs(torch.device("cuda"))
    W, G, V, Q, dt = UGPM_W, UGPM_G, UGPM_V, UGPM_Q, torch.float64
    cfg = UGPMConfig(**UGPM_CFG)
    fit = lambda: ugpm_fit(gyr_t, gyr, vel_t, vel, starts, 1e-4, 1e-3, cfg)  # noqa: E731
    s_fit = _mean_s(fit, 2)
    state = fit()
    s_query = _mean_s(lambda: ugpm_query(state, starts, queries), 5)
    got = ugpm_query(state, starts, queries)

    def loop():
        return [ugpm_query(ugpm_fit(gyr_t[w], gyr[w], vel_t[w], vel[w], starts[w], 1e-4, 1e-3,
                                    cfg), starts[w], queries[w]) for w in range(W)]

    one, s_loop = _sync_s(loop)
    err = max(_rel_gap(tuple(x[w] for x in got), r) for w, r in enumerate(one))
    _rate_line(f"UGPM fit + query ({W} windows, G = {G}, V = {V}, Q = {Q}, 10 LM iterations)",
               "windows", W, s_fit + s_query, s_loop, err, dt,
               f"; the fit {1e3 * s_fit:.2f} ms, the query {1e3 * s_query:.2f} ms "
               f"({W * Q / s_query:.0f} points/s)", limit=UGPM_BATCH_RTOL)


def ndt_batch(inp):
    """`ndt_align_multires` over bench.py's 8 jittered sources against 8
    single aligns, on the bench phase's pair and maps cast to float64: there
    the two forms agree to rounding whatever the draws, where in float32 a
    lane whose stop test sits near its threshold parts from its single
    align by more (ROADMAP C4)."""
    import torch

    from gorio_tpu_torch.bench import B_NDT as NDT_B
    from gorio_tpu_torch.bench import ndt_batch_sources
    from gorio_tpu_torch.core.pointcloud import PointCloud
    from gorio_tpu_torch.registration.ndt import build_voxel_map, coarse_cfg, ndt_align_multires

    def f64(cloud):
        return cloud._replace(**{f: x.double() for f, x in zip(cloud._fields, cloud)
                                 if x.is_floating_point()})

    target, source, cfg = f64(inp.target), f64(inp.source), inp.cfg
    vmap_t, vmap_c = build_voxel_map(target, cfg), build_voxel_map(target, coarse_cfg(cfg))
    srcs = ndt_batch_sources(source)
    eye = torch.eye(4, device="cuda", dtype=source.xyz.dtype)
    got = ndt_align_multires(srcs, vmap_c, vmap_t, eye, cfg)

    def loop():
        return [ndt_align_multires(PointCloud(*(x[b] for x in srcs)), vmap_c, vmap_t, eye, cfg)
                for b in range(NDT_B)]

    one, s_loop = _sync_s(loop)
    err = max(_rel_gap((got.T[b], got.error[b]), (r.T, r.error)) for b, r in enumerate(one))
    iters = got.iterations.tolist()
    same_iters = iters == [int(r.iterations) for r in one]
    s_batch = _mean_s(lambda: ndt_align_multires(srcs, vmap_c, vmap_t, eye, cfg), 1)
    _rate_line(f"NDT DIRECT7 coarse-to-fine ({NDT_B} sources of capacity "
               f"{source.xyz.shape[0]})", "aligns", NDT_B, s_batch, s_loop, err, source.xyz.dtype,
               f"; outer iterations per lane {iters} "
               f"({'the loop' if same_iters else 'NOT the loop'}'s)")
    if not same_iters:
        fail(f"ndt batch: lane iterations {iters} differ from the loop's")


def gn_phase(K, seq):
    """`gn_optimize` on APDGICP's callbacks for one slice frame pair, 8
    iterations on the card: `nn1_select` launches 8 times; T equals the
    CPU run's."""
    import torch

    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.io.native import NativePipelineDataset
    from gorio_tpu_torch.registration import gn_optimize
    from gorio_tpu_torch.registration.gicp import GICPConfig, make_gicp_callbacks, prepare_gicp

    frames = [torch.tensor(packed[:n], dtype=torch.float64) for _, n, packed in
              NativePipelineDataset(sorted(seq.glob("*.grf"))[40:42], capacity=MAIN_N)]
    cfg = GICPConfig(mode="apdgicp")

    def run(device):
        tgt, src = (make_cloud(f[:, :3].to(device), intensity=f[:, 3].to(device),
                               doppler=f[:, 4].to(device), capacity=MAIN_N) for f in frames)
        lin, _ = make_gicp_callbacks(prepare_gicp(src, tgt, cfg), cfg)
        T0 = torch.eye(4, dtype=torch.float64, device=device)
        K.reset_launch_counts()
        res = gn_optimize(lin, T0, iterations=GN_ITERS)
        if device == "cuda":
            torch.cuda.synchronize()
        return res, dict(K.launch_counts)

    res, launches = run("cuda")
    cpu, _ = run("cpu")
    gap = float((res.T.cpu() - cpu.T).abs().max())
    print(f"[gn] {CARD}: gn_optimize, {GN_ITERS} iterations on APDGICP's callbacks (frames 40 "
          f"and 41 of the slice): launches {launches}, T {res.T[:3, 3].tolist()}, the CPU's "
          f"within {gap:.3g}", flush=True)
    if launches["nn1_select"] != GN_ITERS:
        fail(f"gn: nn1_select launched {launches['nn1_select']} times, not {GN_ITERS}")
    if not gap <= 1e-6:
        fail(f"gn: the card's T is {gap:.3g} from the CPU's")
    return launches


def _field_gaps(got, want):
    """{field: largest |got - want| over the largest |want|} of two
    PreintMeas."""
    return {f: _rel_gap((g,), (w,)) for f, g, w in zip(got._fields, got, want)}


def chunked_preint_phase():
    """`preintegrate` over the JAX test's 4 s window on the card, one window
    against `quantum=1.0` (LPM and UGPM); then the card against the CPU on
    the same streams with the start and the queries moved off the 200 Hz
    sample grid (at a sample time the time-shift Jacobians have two
    one-sided values, and rounding picks one): each field within
    CARD_CPU_PREINT, or within 10x of what the CPU's own result moves when
    the gyro samples move by 1e-15 relative, where that is more. UGPM's
    covariance is printed, not held: on these noiseless streams (variances
    1e-6) the window's state covariance inverts a JtJ so ill-conditioned
    that a 1e-15 move of the input moves it by ~5e-5 and another LU by
    ~2e-3."""
    import numpy as np
    import torch

    from gorio_tpu_torch.core.lie import rotation_geodesic_angle
    from gorio_tpu_torch.io.synthetic import sample_imu, simulate_trajectory
    from gorio_tpu_torch.preintegration import preintegrate

    traj = simulate_trajectory(seed=12, duration=4.0)
    imu = sample_imu(traj, gyr_rate=200.0, vel_rate=20.0, gyr_std=0.0, vel_std=0.0, seed=13)
    arrays = (imu.gyr_t, imu.gyr, imu.vel_t, imu.vel)

    def run(method, device, start, queries, quantum, scale=1.0):
        args = [torch.as_tensor(a, dtype=torch.float64, device=device) for a in arrays]
        args[1] = args[1] * scale
        q = torch.as_tensor(queries, dtype=torch.float64, device=device)
        return _sync_s(lambda: preintegrate(*args, start, q, 1e-6, 1e-6, method=method,
                                            quantum=quantum, grid_n=1024))

    queries = np.array([1.1, 2.3, 3.4])
    off_start, off_queries = 0.5037, queries + 0.0013
    for method in ("lpm", "ugpm"):
        (single, s_single), (chunked, s_chunked) = (run(method, "cuda", 0.5, queries, qu)
                                                    for qu in (-1.0, 1.0))
        ang = max(float(rotation_geodesic_angle(single.delta_R[i], chunked.delta_R[i]))
                  for i in range(3))
        dp = float((single.delta_p - chunked.delta_p).abs().max())
        rec = CHUNKED_JAX[method]
        print(f"[preint] {CARD}: preintegrate {method}, 4 s window, queries {queries.tolist()}: "
              f"one window {1e3 * s_single:.1f} ms, quantum=1.0 {1e3 * s_chunked:.1f} ms; "
              f"chunked against one window {ang:.6g} rad, {dp:.6g} m (the JAX test's limits "
              f"{CHUNK_RAD}, {CHUNK_M}; the JAX record's gaps {rec['rad']:.6g} rad, "
              f"{rec['m']:.6g} m)", flush=True)
        if not (ang <= CHUNK_RAD and dp <= CHUNK_M) and method == "lpm":
            fail(f"preint {method}: chunked {ang:.3g} rad / {dp:.3g} m from one window")
        if not (abs(ang - rec["rad"]) <= CHUNKED_JAX_TOL and abs(dp - rec["m"]) <= CHUNKED_JAX_TOL):
            fail(f"preint {method}: chunked-to-single gaps {ang:.6g} rad / {dp:.6g} m, the JAX "
                 f"record's {rec['rad']:.6g} / {rec['m']:.6g} (+- {CHUNKED_JAX_TOL})")
        for quantum in (-1.0, 1.0):
            card = run(method, "cuda", off_start, off_queries, quantum)[0]
            cpu = run(method, "cpu", off_start, off_queries, quantum)[0]
            moved = run(method, "cpu", off_start, off_queries, quantum, 1.0 + 1e-15)[0]
            gaps, noise = _field_gaps(card, cpu), _field_gaps(moved, cpu)
            limit = {f: max(CARD_CPU_PREINT, 10.0 * noise[f]) for f in gaps}
            print(f"[preint] {method} quantum={quantum}, start {off_start}, queries "
                  f"{off_queries.tolist()}: the card against the CPU, per field (limit): "
                  + ", ".join(f"{f} {gaps[f]:.3g} ({limit[f]:.3g})" for f in gaps), flush=True)
            bad = [f for f in gaps if not gaps[f] <= limit[f]
                   and not (method == "ugpm" and f == "cov")]
            if bad:
                fail(f"preint {method} quantum={quantum}: the card is off the CPU in {bad}")


def solvers_batched_phase(K, seq, tmp, dense_ate, full_slice_graph):
    """CG on the slice through the CLI and on the full-slice's floor graph,
    `gn_optimize` and the chunked preintegration (CG on the circuits'
    graphs runs in their lanes, the batched forms in the bench phase)."""
    t0 = time.perf_counter()
    launches = {"cg-slice": cg_slice_phase(K, seq, tmp, dense_ate)}
    cg_full_slice_phase(full_slice_graph)
    launches["gn"] = gn_phase(K, seq)
    chunked_preint_phase()
    print(f"[solvers-batched] {CARD}: the phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def tool_inputs():
    """`tests/tool_inputs.py`, the inputs both packages' runs share."""
    sys.path.insert(0, str(ROOT / "tests"))
    import tool_inputs as ti

    return ti


def start_inputs(seq, out):
    """Build the bag and gt-adjust's inputs in a child process (host numpy
    and pure-Python LZ4) while the card runs the earlier phases."""
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "tool_inputs.py"), str(seq), str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def bag_phase(K, seq, tmp, inputs_proc, slice_ate, full_slice_ate):
    """convert-bag -> slam on the card with GPS edges -> evaluate, on the
    slice written as a rosbag with epoch stamps."""
    import shutil

    import numpy as np

    from gorio_tpu_torch.cli import main as cli

    ti = tool_inputs()
    t_phase = t0 = time.perf_counter()
    out, _ = inputs_proc.communicate(timeout=600)
    if inputs_proc.returncode != 0:
        fail(f"tool_inputs.py exited {inputs_proc.returncode}: {out[-2000:]}")
    info = json.loads((tmp / "inputs" / "inputs.json").read_text())
    counts = info["bag"]
    print(f"[bag] built {info['bag_bytes']} bytes in {info['bag_s']:.1f} s in a child process "
          f"(waited {time.perf_counter() - t0:.1f} s): {counts}", flush=True)
    bag = tmp / "inputs" / "bag" / "slice.bag"
    n_seq = len(list(seq.glob("*.grf")))  # the slice's 98
    summary = cli(["convert-bag", str(bag), "--list-topics"])
    want = {ti.TOPICS["radar"]: n_seq, ti.TOPICS["imu"]: counts["imu"],
            ti.TOPICS["twist"]: counts["twist"], ti.TOPICS["gps"]: counts["gps"]}
    got = {topic: n for topic, (_, n) in summary.items()}
    if got != want or counts["frames"] != n_seq:
        fail(f"bag: topics_summary counts {got}, the bag holds {want}")
    conv = tmp / "bag_seq"
    t0 = time.perf_counter()
    n = cli(["convert-bag", str(bag), "--output", str(conv), *ti.CONVERT_FLAGS])
    t_convert = time.perf_counter() - t0
    gaps = ti.frame_gaps(seq, conv, t_base=T_BASE)
    rate = info["bag_bytes"] / t_convert / 1e6
    print(f"[bag] convert-bag: {n} frames in {t_convert:.2f} s ({rate:.2f} MB/s, pure-Python "
          f"LZ4 and bz2); against the slice: {gaps}; points {counts['points']}, "
          f"{counts['points'] - counts['kept']} with power <= 0", flush=True)
    if not (n == n_seq and gaps["counts_equal"] and gaps["bits_equal"]
            and gaps["xyz_rel_gap"] <= 2.0 ** -22 and gaps["stamp_gap_s"] <= 1e-6
            and (conv / "gps.npz").is_file()):
        fail(f"bag: the converted sequence differs from the slice: {n} frames, {gaps}")
    shutil.copy(bag.parent / "groundtruth.tum", conv / "groundtruth.tum")
    ti.write_bag_config(cli, tmp / "bag_config.json")
    slam, odo, timer, launches, batched, wall, result = run_slam(
        K, conv, tmp / "bag.tum", [*ti.BAG_SLAM, "--config", str(tmp / "bag_config.json")])
    lm_iters, verify_iters = check_common("bag", slam, odo, launches)
    report("bag", n, slam, timer, launches, batched, wall, result, lm_iters, verify_iters)
    gates = ti.gps_gates(slam, np.load(conv / "gps.npz")["t"])
    stamps = slam.trajectory()[0]
    rec = BAG_JAX
    ate = result["ate_rmse_m"]
    print(f"[bag] {CARD}: fixes {counts['gps']}, GPS gates {gates} (JAX "
          f"{ {k: rec[k] for k in gates} }); keyframes {len(slam.keyframes)} (JAX "
          f"{rec['keyframes']}), loops {len(slam.loops)} (JAX {len(rec['loops'])}), first "
          f"stamp {stamps[0]:.6f}; ATE {ate:.6f} m (JAX {rec['ate_m']:.6f} m; the slice "
          f"{slice_ate:.6f} m, the full-slice {full_slice_ate:.6f} m)", flush=True)
    if not stamps.min() >= T_BASE:
        fail(f"bag: keyframe stamps from {stamps.min()} s, the bag's from {T_BASE} s")
    if gates["gps_edges"] != rec["gps_edges"] or gates["gps_edges"] == 0:
        fail(f"bag: {gates['gps_edges']} GPS edges, the JAX record {rec['gps_edges']}")
    if abs(len(slam.keyframes) - rec["keyframes"]) > BAG_KEYFRAME_TOL * rec["keyframes"]:
        fail(f"bag: {len(slam.keyframes)} keyframes, the JAX record {rec['keyframes']} +- 2%")
    if not ate <= 1.25 * rec["ate_m"] + 0.02:
        fail(f"bag: ATE {ate} m > 1.25 x the JAX record {rec['ate_m']} + 0.02 m")
    print(f"[bag] {CARD}: the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def kdtree_oracle(K, label, q, r, m, p):
    """Both kernels against the exact kd-tree's 1-NN (float32) over the
    unmasked refs, on one input's queries (a padded cloud's queries at
    the pad coordinate excluded: the masked refs' bias decides theirs):
    d2 within KDTREE_D2_RTOL, indices equal except at ties within
    KDTREE_TIE. Returns the near-ties of each kernel."""
    import numpy as np

    from gorio_tpu_torch.core.pointcloud import PAD_COORD
    from gorio_tpu_torch.io.native import NativeKDTree

    qf = q.float().cpu().numpy().reshape(-1, 3)
    rf = r.float().cpu().numpy().reshape(-1, 3)
    valid = np.flatnonzero(m.cpu().numpy().reshape(-1))
    real = np.flatnonzero(~np.all(qf == np.float32(PAD_COORD), axis=1))
    qf = qf[real]
    t0 = time.perf_counter()
    idx, d2 = NativeKDTree(rf[valid]).knn(qf, 1)
    t_tree = time.perf_counter() - t0
    want_idx, want_d2 = valid[idx[:, 0]], d2[:, 0].astype(np.float64)
    ties = {}
    for name, out in (("nn1", K.nn1_best(q, r, m)), ("nn1_select", K.nn1_select(q, r, p, m))):
        got_idx = out[0].cpu().numpy().reshape(-1)[real]
        got_d2 = out[1].double().cpu().numpy().reshape(-1)[real]
        if not np.all(np.abs(got_d2 - want_d2) <= KDTREE_D2_RTOL * np.maximum(want_d2, 1e-12)):
            fail(f"kd-tree [{label}]: {name}'s d2 off the exact 1-NN by "
                 f"{np.abs(got_d2 - want_d2).max():.3g}")
        differ = np.flatnonzero(got_idx != want_idx)
        alt = ((qf[differ].astype(np.float64) - rf[got_idx[differ]]) ** 2).sum(axis=1)
        if not np.all(np.abs(alt - want_d2[differ]) <= KDTREE_TIE * np.maximum(want_d2[differ],
                                                                               1e-12)):
            fail(f"kd-tree [{label}]: {name} picks other refs than the exact 1-NN off a tie")
        ties[name] = len(differ)
    print(f"[tools] kd-tree [{label}]: {len(qf)} queries ({len(q.reshape(-1, 3)) - len(qf)} "
          f"padding left out), {len(valid)} refs, tree {t_tree:.2f} s; nn1 and nn1_select "
          f"agree, near-ties {ties}", flush=True)
    return ties


def tools_phase(K, tmp, cases):
    """gt-adjust and utm-align as graph solves on the card, align-traj,
    and both kernels against the exact kd-tree."""
    import importlib.util

    import numpy as np
    import torch

    import gorio_tpu_torch.graph.solver as solver
    from gorio_tpu_torch.cli import main as cli
    from gorio_tpu_torch.io.tum import load_tum

    ti = tool_inputs()
    t_phase = time.perf_counter()
    d = tmp / "inputs"
    loops = json.loads((d / "inputs.json").read_text())["loops"]
    K.reset_launch_counts()
    solves = []
    plain = solver.optimize_graph

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plain(*args, **kwargs)
        torch.cuda.synchronize()
        solves.append((time.perf_counter() - t0, int(res.iterations)))
        return res

    solver.optimize_graph = timed
    torch.cuda.reset_peak_memory_stats()
    try:
        got = cli(["gt-adjust", str(d / "drifty.tum"), str(tmp / "adjusted.tum"),
                   *[f"--loop={pair}" for pair in loops], "--device", "cuda"])
    finally:
        solver.optimize_graph = plain
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = GT_ADJUST_JAX
    _, before = load_tum(d / "drifty.tum")
    _, after = load_tum(tmp / "adjusted.tum")
    s, iters = solves[0]
    gap = max(float(np.abs(after[int(k), :3, 3] - np.asarray(v)).max())
              for k, v in rec["sampled"].items())
    print(f"[tools] gt-adjust {CARD}: {got['n_poses']} poses ({6 * got['n_poses']} dense dims), "
          f"{got['n_loops']} loops, {iters} LM iterations (JAX {rec['iterations']}) in {s:.2f} s "
          f"({1e3 * s / iters:.2f} ms per LM iteration), peak {peak:.2f} GiB; chi2 "
          f"{got['chi2']!r} (JAX {rec['chi2']!r}); sampled poses {gap:.3g} m from the JAX "
          f"record; end gap {ti.end_gap(before):.4f} -> {ti.end_gap(after):.4f} m, loop gap "
          f"{ti.loop_gap(before, loops):.4f} -> {ti.loop_gap(after, loops):.4f} m (JAX "
          f"{rec['loop_gap_after_m']:.4f})", flush=True)
    if loops != rec["loops"] or got["iterations"] != rec["iterations"]:
        fail(f"gt-adjust: loops {loops} / iterations {got['iterations']} differ from the JAX "
             f"record's {rec['loops']} / {rec['iterations']}")
    if not abs(got["chi2"] - rec["chi2"]) <= GT_CHI2_RTOL * rec["chi2"] or not gap <= GT_POSE_M:
        fail(f"gt-adjust: chi2 {got['chi2']} (JAX {rec['chi2']}), poses {gap} m off the record")

    got = cli(["utm-align", str(d / "bag" / "groundtruth.tum"), str(d / "bag" / "gps_utm.txt"),
               "--device", "cuda"])
    rec = UTM_ALIGN_JAX
    T, Tr = np.asarray(got["T_world_utm"]), np.asarray(rec["T_world_utm"])
    dt, dR = float(np.abs(T[:3, 3] - Tr[:3, 3]).max()), float(np.abs(T[:3, :3] - Tr[:3, :3]).max())
    print(f"[tools] utm-align {CARD}: {got['n_pairs']} pairs (JAX {rec['n_pairs']}), chi2 "
          f"{got['chi2']!r} (JAX {rec['chi2']!r}); T_world_utm {dt:.3g} m / {dR:.3g} off the "
          f"JAX record", flush=True)
    if got["n_pairs"] != rec["n_pairs"] or not (dt <= UTM_M and dR <= UTM_RAD):
        fail(f"utm-align: {got['n_pairs']} pairs, T {dt} m / {dR} off the JAX record")

    got = cli(["align-traj", str(d / "drifty.tum"), str(d / "circuit_gt.tum"), "--scale"])
    rec = ALIGN_TRAJ_JAX
    same = json.dumps(got) == json.dumps(rec)
    gap = max(abs(got["scale"] - rec["scale"]),
              float(np.abs(np.subtract(got["T"], rec["T"])).max()))
    print(f"[tools] align-traj: scale {float(got['scale'])!r}, "
          f"{'equal to the bit' if same else f'{gap:.3g} from'} the JAX record", flush=True)
    if not gap <= ALIGN_TRAJ_RTOL * max(1.0, float(np.abs(rec["T"]).max())):
        fail(f"align-traj: {gap} from the JAX record")
    launches = dict(K.launch_counts)
    if any(launches.values()):
        fail(f"tools: gt-adjust, utm-align and align-traj launched kernels: {launches}")

    ties = {label: kdtree_oracle(K, label, *cases[label]) for label in (MAIN, ALIGN)}
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    print(f"[tools] visualize: matplotlib {'present' if have_mpl else 'absent'} here, not run "
          f"(the CPU tests hold it against the JAX package's PNG)", flush=True)
    print(f"[tools] {CARD}: the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, ties


# ---- mesh ------------------------------------------------------------------

MESH_WORLD = 4  # ranks that share the card over gloo: the multi-rank arithmetic
MESH_SMC_PER_RANK, MESH_SMC_D, MESH_SMC_STD = 4096, 60, 0.1  # scripts/bench_scaling.py:66-80
MESH_TIMEOUT = 480.0  # s for the spawned ranks; a rank still running then is killed
# The sharded programs against their one-card forms, float64, at the
# tolerances of tests/test_sharded_programs.py (:86-98, :141-144, :184-189):
MESH_UGPM = (1e-3, 1e-7)  # cov rtol / atol x its scale; the deltas: UGPM_BATCH_RTOL
MESH_GRAPH = (1e-7, 1e-9, 1e-7, 1e-6, 1e-8)  # poses rtol / atol, chi2 rtol, H rtol / atol
# The graph solve runs the slam's 30 LM iterations in full in every form: past
# the optimum (~20 iterations on the circuit) its stop rule (an accepted step
# within rel_tol) is decided by the last bits of two chi2 sums, so the sharded
# and one-card solves stop at different counts there (21 against 30 on an H100)
MESH_GRAPH_CFG = dict(solver="dense", rel_tol=0.0)
# ... loosened for float32 (the align pair and bench_scaling's SMC step run in
# float32: a rounding is 6e-8 relative, and a sum over 69k points or 16k
# particles reorders thousands of them):
MESH_ALIGN = (1e-5, 1e-3, 1e-4)  # T entries abs (m / rotation), H rel, cost rel
MESH_SMC = (1e-5, 1e-5)  # ESS and log weights rel; a comb point's tie window
# the smoother: the card = CPU check's, relative to each field's largest value


def _digests(x, name="out"):
    """{name: sha256 of its bytes} of every tensor in nested dicts and
    (named) tuples."""
    import hashlib

    import torch

    if isinstance(x, torch.Tensor):
        return {name: hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()}
    items = (x.items() if isinstance(x, dict)
             else zip(getattr(x, "_fields", range(len(x))), x))
    return {k: v for key, y in items for k, v in _digests(y, f"{name}.{key}").items()}


def _mesh_lp(x):
    """bench_scaling.py's SMC target, N(0, I)."""
    import torch

    return -0.5 * torch.sum(x * x, dim=-1)


def mesh_inputs(solve_cfg, circuit):
    """The mesh programs' inputs on the CPU, as every rank receives them: the
    align phase's pair as `cli align` downsamples it (0.1 m leaf), bench.py's
    64 UGPM windows, the circuit's pose graph (361 keyframes, its 13 loops)
    from the odometry poses with the slam's solve config, dense, its stop
    rule off (`MESH_GRAPH_CFG`),
    bench_scaling's SMC particles with a seeded uniform and normals, and
    the smoother phase's graph with the JAX test's bogus loop (where it
    resamples). `circuit` is what `smoother_phase` returns."""
    import numpy as np
    import torch

    from gorio_tpu_torch.bench import synth_pair, ugpm_inputs
    from gorio_tpu_torch.io.pcd import voxel_centroid_downsample

    (a, _), (b, _) = synth_pair()
    src, tgt = (voxel_centroid_downsample(x, 0.1) for x in (a, b))
    ugpm, _ = ugpm_inputs(torch.device("cpu"))
    rng = np.random.default_rng(1)
    n = MESH_SMC_PER_RANK * MESH_WORLD
    gen = torch.Generator().manual_seed(0)
    smc = (torch.as_tensor(rng.normal(size=(n, MESH_SMC_D)), dtype=torch.float32),
           torch.zeros(n), torch.rand((), generator=gen),
           torch.randn((n, MESH_SMC_D), generator=gen))
    poses0, graph, bogus, mask, _ = circuit
    return {"align": (src, tgt), "ugpm": ugpm,
            "graph": (poses0.cpu(), _graph_on("cpu", graph),
                      solve_cfg._replace(**MESH_GRAPH_CFG)),
            "smc": smc, "smoother": (poses0.cpu(), _graph_on("cpu", bogus), mask)}


def mesh_programs(dp, mp, inp, dev, smoother=True):
    """The five sharded programs at full width (every rank calls it alike;
    `dp` / `mp` None: the one-card programs; the smoother only with
    `smoother`). Returns (outputs on the card, seconds per program, the card
    synchronised and the ranks met before each)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.graph.solver import optimize_graph
    from gorio_tpu_torch.inference.smc import sharded_parents, sharded_smc_step
    from gorio_tpu_torch.inference.smoother import smc_loop_relaxation
    from gorio_tpu_torch.parallel.sharded import (sharded_gicp_align, sharded_optimize_graph,
                                                  sharded_ugpm_windows)
    from gorio_tpu_torch.preintegration.ugpm import UGPMConfig, ugpm_preintegrate
    from gorio_tpu_torch.registration.gicp import GICPConfig, gicp_align

    out, secs = {}, {}

    def run(name, fn):
        torch.cuda.synchronize(dev)
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0

    cap = 1 << int(np.ceil(np.log2(max(len(x) for x in inp["align"]))))
    src, tgt = (make_cloud(torch.as_tensor(x), capacity=cap, device=dev) for x in inp["align"])
    cfg = GICPConfig(mode="apdgicp")
    run("align", lambda: gicp_align(src, tgt, cfg=cfg) if mp is None
        else sharded_gicp_align(mp, cfg, "mp")(src, tgt))
    ug = [torch.as_tensor(x, dtype=torch.float64, device=dev) for x in inp["ugpm"]]
    ucfg = UGPMConfig(window_duration=0.6, lm_iters=10)
    run("ugpm", lambda: ugpm_preintegrate(*ug, 1e-4, 1e-3, ucfg) if dp is None
        else sharded_ugpm_windows(dp, "dp")(*ug, 1e-4, 1e-3, ucfg))
    poses0, graph, gcfg = inp["graph"]
    poses0, graph = poses0.to(dev), _graph_on(dev, graph)
    run("graph", lambda: optimize_graph(poses0, graph, gcfg) if dp is None
        else sharded_optimize_graph(dp, gcfg, "dp")(poses0, graph))
    p, lw, u, z = (t.to(dev) for t in inp["smc"])
    step = sharded_smc_step(dp, _mesh_lp)
    run("smc", lambda: (*step(p, lw, MESH_SMC_STD, u=u, z=z),
                        *sharded_parents(dp, _mesh_lp, p, lw, u)))
    if not smoother:
        return out, secs
    sp, sg, mask = inp["smoother"]
    sp, sg = sp.to(dev), _graph_on(dev, sg)
    run("smoother", lambda: smc_loop_relaxation(
        dp, sp, sg, mask, n_particles=SMOOTHER_N, n_stages=SMOOTHER_STAGES,
        n_moves=SMOOTHER_MOVES)(torch.Generator(device=dev).manual_seed(0)))
    return out, secs


def mesh_rank(inp, device):
    """One rank of a spawned world: the five programs on flat "dp" and "mp"
    meshes of the world. Every rank returns its outputs' digests, seconds,
    launches and peak memory; rank 0 also its outputs."""
    import torch
    import torch.distributed as dist

    from gorio_tpu_torch.ops import nn as K
    from gorio_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.load_library()  # built by the parent
    world = dist.get_world_size()
    dp, mp = make_mesh((world,), ("dp",), device), make_mesh((world,), ("mp",), device)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, secs = mesh_programs(dp, mp, inp, dp.device)
    res = {"digests": _digests(out), "secs": secs, "launches": dict(K.launch_counts),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "device": str(dp.device), "backend": dp.backend}
    if dist.get_rank() == 0:
        res["out"] = out  # `spawn` hands it back on the CPU
    return res


def _mesh_gap(a, b):
    """Largest |a - b| over the largest |b| (at least 1)."""
    return float((a.double().cpu() - b.double().cpu()).abs().max()
                 / b.double().abs().max().clamp(min=1.0))


def mesh_check(what, got, ref, tie_cum=None):
    """Hold `got` (one world's outputs) to the one-card programs' `ref`;
    prints the gaps and fails past a tolerance."""
    import torch

    def within(a, b, rtol, atol):
        return bool(torch.all((a.double().cpu() - b.double().cpu()).abs()
                              <= atol + rtol * b.double().cpu().abs()))

    bad = []
    a, r = got["align"], ref["align"]
    t_gap = float((a.T.double().cpu() - r.T.double().cpu()).abs().max())
    if int(a.iterations) != int(r.iterations):
        bad.append(f"align iterations {int(a.iterations)} vs {int(r.iterations)}")
    if not (t_gap <= MESH_ALIGN[0] and within(a.H, r.H, MESH_ALIGN[1], 0.0)
            and within(a.error, r.error, MESH_ALIGN[2], 0.0)):
        bad.append(f"align T {t_gap:.3g} apart, H / cost past {MESH_ALIGN[1:]}")
    # UGPM's deltas: a rank's batch of W / world windows takes other batched
    # kernels than the one card's W (2.41e-9 apart at world 4, 0 at world 1):
    # held, as the batched phase holds a batch to its loop, within
    # UGPM_BATCH_RTOL of each field's largest value (the JAX test's per-entry
    # 1e-8 / 1e-10 is CPU XLA's, one window per device)
    a, r = got["ugpm"], ref["ugpm"]
    crt, cat = MESH_UGPM
    scale = float(torch.diagonal(r.cov.double(), dim1=-2, dim2=-1).abs().max())
    u_gap = _rel_gap((a.delta_p, a.delta_R), (r.delta_p, r.delta_R))
    if not (u_gap <= UGPM_BATCH_RTOL and within(a.cov, r.cov, crt, cat * scale)):
        bad.append(f"ugpm deltas {u_gap:.3g} apart")
    a, r = got["graph"], ref["graph"]
    prt, pat, crt, hrt, hat = MESH_GRAPH
    if int(a.iterations) != int(r.iterations):
        bad.append(f"graph iterations {int(a.iterations)} vs {int(r.iterations)}")
    if not (within(a.poses, r.poses, prt, pat) and within(a.chi2, r.chi2, crt, 0.0)
            and within(a.H, r.H, hrt, hat)):
        bad.append(f"graph poses {_mesh_gap(a.poses, r.poses):.3g} apart, chi2 "
                   f"{float(a.chi2)!r} vs {float(r.chi2)!r}")
    (ap, aw, aess, apar, _), (rp, rw, ress, rpar, rcum) = got["smc"], ref["smc"]
    n = rp.shape[0]
    us = (float(ref["smc_u"]) + torch.arange(n, dtype=torch.float64)) / n
    near = (rcum.double().cpu()[None, :] - us[:, None]).abs().min(dim=1).values <= MESH_SMC[1]
    differ = apar.cpu() != rpar.cpu()
    if bool((differ & ~near).any()):
        bad.append(f"smc: {int((differ & ~near).sum())} parents differ off a tie")
    same = ~differ
    if not (within(aess, ress, MESH_SMC[0], 0.0) and within(aw, rw, MESH_SMC[0], MESH_SMC[0])
            and torch.equal(ap.cpu()[same], rp.cpu()[same])):
        bad.append("smc: ESS, log weights or particles past the limits")
    a, r = got["smoother"], ref["smoother"]
    s_gap = max(_mesh_gap(x, y) for x, y in zip(a, r))
    rs_a, rs_r = resampled(a, SMOOTHER_N), resampled(r, SMOOTHER_N)
    if not (s_gap <= CARD_CPU_TOL and rs_a == rs_r):
        bad.append(f"smoother {s_gap:.3g} apart (resampled at {rs_a} vs {rs_r})")
    print(f"[mesh] {what} against the one-card programs: align {int(got['align'].iterations)} "
          f"LM iterations (one card {int(ref['align'].iterations)}), T {t_gap:.3g} apart; UGPM "
          f"deltas {u_gap:.3g}; graph "
          f"{int(got['graph'].iterations)} LM iterations, poses "
          f"{_mesh_gap(got['graph'].poses, ref['graph'].poses):.3g}; SMC step ESS "
          f"{float(aess):.2f} (one card {float(ress):.2f}), {int(differ.sum())} parents differ "
          f"({int(near.sum())} comb points within {MESH_SMC[1]} of a cumulative weight); "
          f"smoother {s_gap:.3g} (resampled at {rs_a}), log Z {float(a.log_evidence):.6f}",
          flush=True)
    if bad:
        fail(f"mesh: {what}: " + "; ".join(bad))


def _mesh_times(secs, iters):
    return (f"align {secs['align']:.2f} s, UGPM {secs['ugpm']:.2f} s, graph {secs['graph']:.2f} s "
            f"({1e3 * secs['graph'] / max(iters, 1):.2f} ms per LM iteration), SMC step "
            f"{1e3 * secs['smc']:.2f} ms, smoother {secs['smoother']:.2f} s")


def mesh_phase(K, tmp, solve_cfg, circuit):
    """The sharded programs (`parallel/`) at full width: through NCCL at
    world 1 in this process (the dry run at its own sizes, then the five
    programs), then as MESH_WORLD ranks sharing the card over gloo; each
    against the one-card programs on the same inputs, the ranks' outputs
    equal to the bit. NCCL at world > 1 where the machine has more cards.
    Returns the mesh path's kernel launches (world 1 and every rank)."""
    import torch
    import torch.distributed as dist

    from gorio_tpu_torch.parallel.dryrun import dryrun_multichip
    from gorio_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, spawn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    inp = mesh_inputs(solve_cfg, circuit)
    ref, ref_secs = mesh_programs(None, None, inp, dev, smoother=False)
    ref["smoother"] = circuit[4]  # the smoother phase's run, on the same draws
    ref["smc_u"] = inp["smc"][2]
    ref_secs["smoother"] = float("nan")
    print(f"[mesh] {CARD}: one card: "
          f"{_mesh_times(ref_secs, int(ref['graph'].iterations))} (the smoother: the smoother "
          f"phase's run)", flush=True)

    # (a) NCCL at world 1, in this process
    rank, world = initialize_distributed(f"file://{tmp / 'nccl-world1'}", 1, 0, device=dev)
    try:
        mesh = make_mesh((1, 1), ("dp", "mp"), dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        dry = dryrun_multichip(mesh)
        torch.cuda.synchronize()
        dry_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        one, secs = mesh_programs(make_mesh((1,), ("dp",), dev), make_mesh((1,), ("mp",), dev),
                                  inp, mesh.device)
        peak1 = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(K.launch_counts)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    print(f"[mesh] {CARD}: {backend} world {world}: dry run (UGPM {dry['ugpm'].delta_p.shape[0]} "
          f"windows, APDGICP {int(dry['gicp'].iterations)} LM iterations, graph chi2 "
          f"{float(dry['graph'].chi2):.3g}, SMC ESS {float(dry['smc'][2]):.2f}) in {dry_s:.2f} "
          f"s; {_mesh_times(secs, int(one['graph'].iterations))}; peak "
          f"{peak1:.2f} GiB; launches {launches}", flush=True)
    one["smc_u"] = inp["smc"][2]
    mesh_check(f"{backend} world 1", one, ref)
    del one, dry
    torch.cuda.empty_cache()

    # (b) MESH_WORLD ranks on this card over gloo: the multi-rank arithmetic
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, MESH_WORLD, inp, "cuda:0", device="cuda:0", backend="gloo",
                  timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    four = ranks[0]["out"]
    d0 = ranks[0]["digests"]
    differ = {r: sorted(k for k, v in ranks[r]["digests"].items() if d0.get(k) != v)
              for r in range(1, MESH_WORLD) if ranks[r]["digests"] != d0}
    per_rank = [r["launches"] for r in ranks]
    print(f"[mesh] {CARD}: gloo world {MESH_WORLD} on {ranks[0]['device']} (ranks sharing the "
          f"card: the multi-rank arithmetic, not a speed reading), spawned and run in "
          f"{wall:.2f} s; rank 0: {_mesh_times(ranks[0]['secs'], int(four['graph'].iterations))}; "
          f"gorio_nn1 launches per rank {[c['nn1'] for c in per_rank]}; peak per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; {len(ranks[0]['digests'])} outputs "
          f"{'equal to the bit on every rank' if not differ else f'DIFFER: {differ}'}",
          flush=True)
    if differ:
        fail(f"mesh: outputs differ from rank 0's (rank: names) {differ}")
    if not all(c["nn1"] > 0 for c in per_rank):
        fail(f"mesh: gorio_nn1 not launched on every rank ({per_rank})")
    four["smc_u"] = inp["smc"][2]
    mesh_check(f"gloo world {MESH_WORLD}", four, ref)
    for counts in per_rank:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        n = min(MESH_WORLD, n_cards)
        ranks = spawn(mesh_rank, n, inp, "cuda", device="cuda", timeout=MESH_TIMEOUT)
        mesh_check(f"nccl world {n}", ranks[0]["out"] | {"smc_u": inp["smc"][2]}, ref)
        for counts in (r["launches"] for r in ranks):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    else:
        print(f"[mesh] NCCL at world > 1 did not run: this machine has {n_cards} card",
              flush=True)
    print(f"[mesh] {CARD}: the phase took {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


# ---- bench -----------------------------------------------------------------

# `gorio_tpu_torch.bench`'s repetition counts cut to fit the script's budget;
# the widths are the module's (the 69,000-point pair, 4096-point clouds, 64
# windows, K = 50 / 256 / 1024, 16 chains x 512 draws in the quality passes)
BENCH_COUNTS = dict(ndt=3, ndt_sync=3, ndt_batch=2, apdgicp=3, nn_linearize=20, ego=5, ugpm=3,
                    gp_interp=5, hmc=2, graph_solve=1, verify=3)
KNOWN_POSE_M, KNOWN_POSE_DEG = 0.05, 1.0  # bench.py:360 (`gicp_test.cpp:150-151`)
BENCH_ACCEPT_MIN = 0.5  # the quality pass's acceptance, which a TF32 leak collapses


def bench_phase(K):
    """The bench's workloads through `gorio_tpu_torch.bench.run` on the card
    (both kernels must launch), its JSON line and its gates; then bench.py's
    batched workloads against loops of single calls. Returns the launches."""
    import math

    import torch

    from gorio_tpu_torch import bench

    K.reset_launch_counts()
    ndt, extras, inp = bench.run(torch.device("cuda"), bench.Counts(**BENCH_COUNTS),
                                 log=lambda *a: print("[bench]", *a, flush=True))
    launches = dict(K.launch_counts)
    try:
        line = bench.bench_line(ndt, extras, CARD)
    except KeyError as e:
        fail(f"bench: {e}")
    print(f"[bench] {json.dumps(line)}", flush=True)
    print(f"[bench] {CARD}: launches {launches} (counts {BENCH_COUNTS})", flush=True)
    bad = [k for k, v in line.items() if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        fail(f"bench: non-finite readings {bad}")
    if not (line["known_pose_trans_err_m"] <= KNOWN_POSE_M
            and line["known_pose_rot_err_deg"] <= KNOWN_POSE_DEG):
        fail(f"bench: known-pose error {line['known_pose_trans_err_m']:.4f} m / "
             f"{line['known_pose_rot_err_deg']:.4f} deg over {KNOWN_POSE_M} m / {KNOWN_POSE_DEG}")
    if not line["fitness"] < line["fitness_identity"]:
        fail(f"bench: fitness {line['fitness']} not below the identity's "
             f"{line['fitness_identity']}")
    if not line["hmc_accept_mean"] > BENCH_ACCEPT_MIN:
        fail(f"bench: hmc_accept_mean {line['hmc_accept_mean']:.4f} <= {BENCH_ACCEPT_MIN} (TF32?)")
    if not (launches["nn1"] > 0 and launches["nn1_select"] > 0):
        fail(f"bench: a kernel never launched: {launches}")
    ego_batch()
    ugpm_batch()
    ndt_batch(inp)
    return launches


# ---- evaluation ------------------------------------------------------------


def recall_phase(what, seq, slam):
    """(a) `evaluation.recall.analyze` on a run's own keyframe stamps and
    loops: no false accept, and as many false accepts as loops whose
    ground-truth gap passes `FALSE_RADIUS_M`; recall and precision printed
    beside RECALL.json's circuit2 (the JAX package's record of the paper's
    configuration on this circuit), not held."""
    from gorio_tpu_torch.evaluation.recall import analyze
    from gorio_tpu_torch.evaluation.sequence import gt_positions

    gs, gt_pos = gt_positions(seq)
    res = analyze([kf.stamp for kf in slam.keyframes],
                  [(l.key_new, l.key_old, float(l.fitness)) for l in slam.loops], gs, gt_pos)
    by_gaps = sum(g > FALSE_RADIUS_M for g in loop_gaps(seq, slam))
    rec = json.loads((ROOT / "RECALL.json").read_text())["circuit2"]
    keys = ("n_regions", "n_regions_covered", "recall_regions", "recall_key_new_only",
            "precision", "n_true_accepts", "n_false_accepts")
    print(f"[recall {what}] " + ", ".join(f"{k} {res[k]}" for k in keys) + " (RECALL.json "
          "circuit2, JAX CPU f64 on float32 frames: " + ", ".join(f"{k} {rec[k]}" for k in keys)
          + ")", flush=True)
    if res["n_false_accepts"] != by_gaps:
        fail(f"recall {what}: {res['n_false_accepts']} false accepts, {by_gaps} loops' ground-"
             f"truth gaps over {FALSE_RADIUS_M} m")
    if res["n_false_accepts"]:
        fail(f"recall {what}: {res['n_false_accepts']} false accepts")
    return res


def straight_phase(K, tmp):
    """(b) `evaluation.accuracy.run_sequence` on the straight cut to
    `STRAIGHT_S` seconds, held to `STRAIGHT_JAX`."""
    import numpy as np

    from gorio_tpu_torch.evaluation import accuracy

    spec = dict(accuracy.SEQUENCES["straight"], name="straight")
    sim = list(spec["simulate"])
    sim[sim.index("--duration") + 1] = str(STRAIGHT_S)
    spec["simulate"] = sim
    runs = []
    K.reset_launch_counts()
    res = accuracy.run_sequence(spec, workdir=str(tmp / "straight-run"), device="cuda", runs=runs)
    launches = dict(K.launch_counts)
    run = runs[0]
    slam = run.slam
    stamps = np.asarray([kf.stamp for kf in slam.keyframes])
    fix_t = np.load(run.ds / "gps.npz")["t"]
    gates = {"gps_utm_coords": sum(kf.utm_coord is not None for kf in slam.keyframes),
             "gps_edges": sum(bool(getattr(kf, "_gps_edge", False)) for kf in slam.keyframes),
             "gps_near_keyframes": int((np.abs(fix_t[None, :] - stamps[:, None]).min(axis=1)
                                        <= 0.2).sum())}
    rec = STRAIGHT_JAX
    ate_max = 1.25 * rec["ate_m"] + 0.02
    print(f"[straight] {CARD}: {STRAIGHT_S} s, frames {run.timing['n_frames']}, {res}, GPS "
          f"{gates}, launches {launches}, slam wall {run.wall_s:.2f} s "
          f"({run.timing['n_frames'] / run.wall_s:.2f} frames/s); JAX CPU f64 {rec}", flush=True)
    if abs(res["n_keyframes"] - rec["keyframes"]) > 0.02 * rec["keyframes"]:
        fail(f"straight: {res['n_keyframes']} keyframes, the JAX record {rec['keyframes']} +- 2%")
    if res["n_loops"] != len(rec["loops"]):
        fail(f"straight: {res['n_loops']} loops with --no-loops")
    if not res["ate_rmse_m"] <= ate_max:
        fail(f"straight: ATE {res['ate_rmse_m']} m > {ate_max:.4f} m (1.25 x the JAX record + "
             "0.02 m)")
    if gates["gps_edges"] != rec["gps_edges"]:
        fail(f"straight: {gates['gps_edges']} GPS edges, the JAX record {rec['gps_edges']}")
    if not (launches["nn1"] and launches["nn1_select"]):
        fail(f"straight: a kernel was not launched ({launches})")
    return launches


def record_circuit(tmp, cap, seq, slam):
    """(c), in the circuit lane: the recording of its `slam`, pickled and
    shared with the evaluation lane."""
    import pickle

    from gorio_tpu_torch.evaluation import loop_replay

    rec = loop_replay.recording(cap, "circuit", seq, slam)
    path = tmp / "circuit-recording.pkl"
    with open(path, "wb") as fh:
        pickle.dump(rec, fh)
    print(f"[replay] recorded {len(rec['cycles'])} detect_batch cycles, {len(rec['clouds'])} "
          f"clouds, {path.stat().st_size / 2**20:.1f} MiB", flush=True)
    share(tmp, "circuit-recording", {"path": str(path)})


def replay_phase(K, tmp):
    """(c), in the evaluation lane: the circuit's recording replayed on the
    card at the default config (the run's loops pair for pair) and with
    `REPLAY_COMBO`."""
    import pickle

    from gorio_tpu_torch.evaluation import loop_replay, loop_sweep

    with open(shared(tmp, "circuit-recording")["path"], "rb") as fh:
        rec = pickle.load(fh)
    K.reset_launch_counts()
    lines = {}
    for name, ov in (("default", {}), ("combo", loop_sweep.DEFAULT_COMBOS[REPLAY_COMBO])):
        t0 = time.perf_counter()
        det, loops = loop_replay.replay(rec, ov, device="cuda")
        wall = time.perf_counter() - t0
        lines[name] = (det, loops, loop_replay.summary(rec, det, loops))
        print(f"[replay {name}] {CARD}: overrides {ov}, {wall:.2f} s, "
              f"{json.dumps(lines[name][2])}", flush=True)
    launches = dict(K.launch_counts)
    det, loops, summ = lines["default"]
    got = [[l.key_new, l.key_old] for l in loops]
    want = [l[:2] for l in rec["loops_real"]]
    fits = [round(float(l.fitness), 4) for l in loops]
    print(f"[replay default] the run's loops {rec['loops_real']}, replayed fitness {fits}; gate "
          f"counts {'equal to' if det.gate_counts == rec['gate_counts_real'] else 'unlike'} the "
          f"run's {rec['gate_counts_real']}; launches {launches}", flush=True)
    if got != want:
        fail(f"replay: the default config gives loops {got}, the run accepted {want}")
    if not (launches["nn1"] and launches["nn1_select"]):
        fail(f"replay: a kernel was not launched ({launches})")
    return launches


# ---- scripts ---------------------------------------------------------------

# n <= 4: with n = 8 as well this script took 655.7 s on an H100; the module alone runs 1-8
SCALING_NS = (1, 2, 4)
# repetitions cut to fit the lane; the widths are the scripts'
SCRIPTS_DEPTH = dict(
    scaling={"smc_step": 3, "ugpm_fit": 1, "apdgicp_pairs_dp": 1, "apdgicp_mp_strong": 1,
             "graph_solve": 1},
    profile_linearize=dict(ch=20, reps=2), profile_ndt=dict(reps=1),
    # K = 1,024 left out: its PCG and full solve take minutes alone
    profile_graph_solve=dict(ks=(256,), reps=1, cg_reps=1),
    profile_ugpm=dict(reps=1, n_batches=2),
    dispatch=dict(reps=5))


def _finite_ms(what, rows):
    """Fail unless every split row has a finite, positive host time and a
    device time (the profiler saw the card)."""
    import math

    for name, row in rows.items():
        if not (math.isfinite(row["host_ms"]) and row["host_ms"] > 0
                and row["device_ms"] is not None and math.isfinite(row["device_ms"])):
            fail(f"{what}: {name}: {row}")


def scaling_check(K):
    from gorio_tpu_torch.evaluation import scaling

    def log(*a, **k):
        print(*a, flush=True)

    results, _, what = scaling.main(SCALING_NS, "cuda", SCRIPTS_DEPTH["scaling"], log=log)
    if len(results) != len(SCALING_NS) * len(scaling.REPS):
        fail(f"scaling: {len(results)} rows for worlds {SCALING_NS}")
    bad = [r for r in results
           if not all(isinstance(v, str) or (v == v and v > 0) for v in r.values())]
    if bad:
        fail(f"scaling: rows not finite and positive: {bad}")
    launches = {k: sum(c[k] for c in what["launches"].values()) for k in ("nn1", "nn1_select")}
    print(f"[scaling] {CARD}: worlds {SCALING_NS}, n <= 4 (n = 8 left out of the lane, so "
          f"that it does not outlast the circuit lane) ({what['backend']}) in "
          f"{ {n: round(s, 1) for n, s in what['wall_s'].items()} } s, repetitions "
          f"{SCRIPTS_DEPTH['scaling']} (the script's: {scaling.REPS}); launches {launches}",
          flush=True)
    if not (launches["nn1"] and launches["nn1_select"]):
        fail(f"scaling: a kernel was not launched ({launches})")
    return launches


def plain_ess(particles, log_weights):
    """The ESS of a population weighed by N(0, I), in numpy float64: the
    normalised weights w of log_weights - 0.5 |x|^2, then 1 / sum w^2."""
    import numpy as np

    lw = log_weights.astype(np.float64) - 0.5 * np.sum(particles.astype(np.float64) ** 2, -1)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    return float(1.0 / np.sum(w * w))


def multihost_check():
    from gorio_tpu_torch.evaluation import multihost

    want = plain_ess(*multihost.population())
    res = multihost.driver(device="cuda", log=lambda *a: print(*a, flush=True))
    if not res["ok"]:
        fail(f"multihost: {res}")
    print(f"[multihost] plain ESS {want!r}", flush=True)
    for rank, ess in res["ess"].items():
        if abs(ess - want) > 1e-5 * want:
            fail(f"multihost: rank {rank} ESS {ess!r}, the plain ESS {want!r}")


def golden_check():
    from gorio_tpu_torch.evaluation import ugpm_golden

    res = ugpm_golden.main("cuda", golden=ugpm_golden.GOLDEN,
                           log=lambda *a: print(*a, flush=True))
    off = {k: v for k, v in res["gaps"].items() if not v <= 1.0}
    if off:
        fail(f"ugpm_golden: off the fixture's tolerances (error / tolerance): {off}")


def scripts_phase(K):
    """Phase 19: the rest of `scripts/` on the card; returns the launches of
    the paths that reach the kernels."""
    from gorio_tpu_torch.evaluation import (dispatch, profile_graph_solve, profile_linearize,
                                            profile_ndt, profile_ugpm)

    def log(*a):
        print(*a, flush=True)

    d = SCRIPTS_DEPTH
    launches = {"scaling": timed("scaling", scaling_check, K)}
    timed("multihost", multihost_check)
    timed("ugpm-golden", golden_check)
    res = timed("profile_linearize", profile_linearize.main, "cuda", log=log,
                **d["profile_linearize"])
    _finite_ms("profile_linearize", res["components"])
    launches["profile_linearize"] = res["launches"]
    if not (res["launches"]["nn1"] and res["launches"]["nn1_select"]):
        fail(f"profile_linearize: a kernel was not launched ({res['launches']})")
    res = timed("profile_ndt", profile_ndt.main, "cuda", log=log, **d["profile_ndt"])
    _finite_ms("profile_ndt", res["components"])
    if not (res["align_iterations"] >= 1 and res["align_score"] < 0):
        fail(f"profile_ndt: align {res['align_iterations']} iterations, score "
             f"{res['align_score']}")
    res = timed("profile_graph_solve", profile_graph_solve.main, "cuda", log=log,
                **d["profile_graph_solve"])
    for k, row in res["K"].items():
        _finite_ms(f"profile_graph_solve K={k}", {n: row[n] for n in (
            "build", "cg20", "cg100", "tridiag_factor", "tridiag_solve")})
        if not (row["cg100"]["rel_residual"] < 1e-3 and row["full_solve"]["iterations"] >= 1):
            fail(f"profile_graph_solve K={k}: {row['cg100']}, {row['full_solve']}")
    res = timed("profile_ugpm", profile_ugpm.main, "cuda", log=log, **d["profile_ugpm"])
    _finite_ms("profile_ugpm", res["variants"])
    res = timed("dispatch", dispatch.main, "cuda", log=log, **d["dispatch"])
    if not (res["hmc"]["finite"] and res["launches"]["nn1_select"]
            and all(p["aligns_per_s"] > 0 for p in res["probes"].values())):
        fail(f"dispatch: {res}")
    launches["dispatch"] = res["launches"]
    print(f"[scripts] {CARD}: depth {SCRIPTS_DEPTH}", flush=True)
    return launches


# ---- lanes -----------------------------------------------------------------

# The phases of the two circuit runs go in child processes of their own
# (`chip_smoke.py --lane NAME TMP T0`), side by side with the slice's phases
# in the parent: each process is bound by its own host thread, and the card
# is idle most of the time. A lane waits for the circuit's simulation, runs
# its phases and shares their launch counts. Values that cross processes
# are small JSON files under TMP/shared.
T0 = time.time()  # the script's start, on every process's clock


def timed(name, fn, *args, **kwargs):
    """Run one phase and print its seconds and when it ended since the
    script started."""
    t = time.time()
    out = fn(*args, **kwargs)
    print(f"[time] {name}: {time.time() - t:.1f} s, ended {time.time() - T0:.1f} s after the "
          f"start", flush=True)
    return out


def share(tmp, name, value):
    """Write `value` for another process (atomically)."""
    path = tmp / "shared" / f"{name}.json"
    path.parent.mkdir(exist_ok=True)
    part = path.with_name(f".{path.name}.{os.getpid()}")
    part.write_text(json.dumps(value))
    os.replace(part, path)


def shared(tmp, name, timeout=900):
    """Wait for the value another process `share`d under `name`."""
    path = tmp / "shared" / f"{name}.json"
    t = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t > timeout:
            fail(f"nothing shared as {name} after {timeout} s")
        time.sleep(0.2)
    return json.loads(path.read_text())


def share_simulation(tmp, proc, what):
    """Wait for a simulation (in a thread of the parent) and share its end."""
    out, _ = proc.communicate()
    share(tmp, f"simulated-{what}", {"rc": proc.returncode, "tail": out[-2000:]})


def wait_simulation(tmp, what):
    t0 = time.perf_counter()
    sim = shared(tmp, f"simulated-{what}")
    if sim["rc"] != 0:
        fail(f"simulate ({what}) exited {sim['rc']}: {sim['tail']}")
    print(f"[{what}] {sim['tail'].strip().splitlines()[-1]} (waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def circuit_lane(K, tmp):
    """The circuit's `slam` (its loop detector recorded for the replay),
    its recall, its posterior and smoother, CG on its final graph, and the
    mesh phase on the circuit's graphs."""
    from gorio_tpu_torch.evaluation import loop_replay

    seq = tmp / "circuit"
    wait_simulation(tmp, "circuit")
    launches = {}
    with loop_replay.capture() as cap:
        launches["circuit"], slam, graph = timed("circuit", circuit_phase, K, seq, tmp)
    timed("record circuit", record_circuit, tmp, cap, seq, slam)
    timed("recall circuit", recall_phase, "circuit", seq, slam)
    launches["posterior"], circuit = timed("circuit-posterior", circuit_posterior_phase, K,
                                           slam, seq)
    timed("cg-graphs circuit", cg_graph_phase, "circuit", graph)
    launches["mesh"] = timed("mesh", mesh_phase, K, tmp, slam.cfg.solve, circuit)
    return launches


def full_circuit_lane(K, tmp):
    """The bench phase while the circuit is simulated, then the circuit with
    the paper's configuration, its recall, and CG on its first floor graph
    at 512 padded poses."""
    seq = tmp / "circuit"
    bench_launches = timed("bench", bench_phase, K)
    wait_simulation(tmp, "circuit")
    launches, slam, graph = timed("full-circuit", full_circuit_phase, K, seq, tmp)
    timed("recall full-circuit", recall_phase, "full-circuit", seq, slam)
    timed("cg-graphs full-circuit", cg_graph_phase, "full-circuit", graph)
    return {"bench": bench_launches, "full-circuit": launches}


def evaluation_lane(K, tmp):
    """The shortened straight, the rest of `scripts/`, then the circuit
    lane's recording replayed."""
    launches = {"straight": timed("straight", straight_phase, K, tmp)}
    launches.update(timed("scripts", scripts_phase, K))
    launches["replay"] = timed("replay", replay_phase, K, tmp)
    return launches


LANES = {"circuit": circuit_lane, "full-circuit": full_circuit_lane,
         "evaluation": evaluation_lane}
LANES_PRINTED = set()  # the lanes whose output this process has printed


def start_lane(name, tmp):
    with open(tmp / f"lane-{name}.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--lane", name, str(tmp), repr(T0)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)


def print_lane(tmp, name, tail=None):
    log = (tmp / f"lane-{name}.log").read_text()[-tail if tail else 0:]
    print(log, end="" if log.endswith("\n") or not log else "\n", flush=True)
    LANES_PRINTED.add(name)


def lane_failed(tmp, name, rc):
    print_lane(tmp, name, tail=6000)
    fail(f"the {name} lane exited {rc}")


def check_lanes(tmp, lanes):
    """Fail as soon as a lane has failed."""
    for name, proc in lanes.items():
        if proc.poll() not in (None, 0):
            lane_failed(tmp, name, proc.returncode)


def finish_lane(tmp, name, proc, timeout=1100):
    """Wait for a lane, print its output and return its launch counts."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"the {name} lane did not end within {timeout} s")
    if rc != 0:
        lane_failed(tmp, name, rc)
    print_lane(tmp, name)
    return shared(tmp, f"lane-{name}", timeout=0)


def lane_main(name, tmp, t0):
    """One lane in its own process: the card set up as in `main`, the
    kernels loaded from the parent's build."""
    global CARD, T0
    T0 = t0
    sys.path.insert(0, str(ROOT))
    import torch

    from gorio_tpu_torch.ops import nn as K

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    CARD = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.load_library()
    share(tmp, f"lane-{name}", LANES[name](K, tmp))


def main():
    if not (ROOT / "gorio_tpu_torch" / "ops" / "csrc" / "nn1.cu").is_file():
        fail(f"no gorio_tpu_torch package beside {Path(__file__).name}: run from the repository")
    if sys.argv[1:2] == ["--lane"]:
        name, tmp, t0 = sys.argv[2:5]
        lane_main(name, Path(tmp), float(t0))
        return
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    global CARD
    card = CARD = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"{kind} | count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory(prefix="gorio_smoke_") as tmp:
        tmp = Path(tmp)
        procs = {"slice": simulate(tmp / "slice", []),  # the JAX CLI's defaults
                 "circuit": simulate(tmp / "circuit", CIRCUIT_SIM)}
        threading.Thread(target=share_simulation, args=(tmp, procs["circuit"], "circuit"),
                         daemon=True).start()
        try:
            kernels = run_phases(tmp, procs)
        except BaseException:
            for name in LANES:  # what a lane still running had printed
                if name not in LANES_PRINTED and (tmp / f"lane-{name}.log").exists():
                    print(f"[lane {name}] the end of its output so far:", flush=True)
                    print_lane(tmp, name, tail=3000)
            raise
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def run_phases(tmp, procs):
    from gorio_tpu_torch.io import native
    from gorio_tpu_torch.ops import nn as K

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
        kernels_lib, native_lib = pool.submit(K.build_library), pool.submit(native.build_native)
        lib = kernels_lib.result()
        print(f"[build] {native_lib.result().name} (g++)", flush=True)
    K.load_library()
    print(f"[build] {lib.name} (nvcc) and the native runtime in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = K.BUILD_DIR / f"{lib.name}.log"
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)

    # the kernels' times are taken alone on the card, before the lanes start
    errs, stats, shapes, S_main, cases = timed("kernels", kernel_phase, K)
    lanes = {name: start_lane(name, tmp) for name in LANES}
    procs.update({f"lane {name}": proc for name, proc in lanes.items()})
    wait_for(procs["slice"], "slice")
    procs["inputs"] = start_inputs(tmp / "slice", tmp / "inputs")
    seq = tmp / "slice"
    launches = {}
    launches["slice"], slice_keyframes, slice_slam, slice_ate = timed(
        "slice", slice_phase, K, seq, tmp)
    timed("repeat", repeat_check, seq)
    launches["full-slice"], full_slice_graph, full_slice_ate = timed(
        "full-slice", full_slice_phase, K, seq, tmp)
    check_lanes(tmp, lanes)
    launches.update(timed("ndt-slice", ndt_slice_phase, K, seq, tmp))
    launches.update(timed("scan-to-map", scan_to_map_phase, K, seq))
    launches["align"] = timed("align", align_phase, K, tmp)
    check_lanes(tmp, lanes)
    launches.update(timed("stream", stream_phase, K, seq, tmp, slice_keyframes))
    check_lanes(tmp, lanes)
    launches["posterior"] = timed("posterior", posterior_phase, K, slice_slam)
    check_lanes(tmp, lanes)
    launches.update(timed("solvers-batched", solvers_batched_phase, K, seq, tmp, slice_ate,
                          full_slice_graph))
    check_lanes(tmp, lanes)
    launches["bag"] = timed("bag", bag_phase, K, seq, tmp, procs["inputs"], slice_ate,
                            full_slice_ate)
    launches["tools"], _ = timed("tools", tools_phase, K, tmp, cases)
    for name, proc in lanes.items():
        for path, counts in finish_lane(tmp, name, proc).items():
            mine = launches.get(path, {})  # the posterior path spans both processes
            launches[path] = {k: mine.get(k, 0) + n for k, n in counts.items()}
    print(f"[time] {CARD}: the whole script {time.time() - T0:.1f} s", flush=True)

    replaces = {"nn1": "gorio_tpu/ops/nn_pallas.py:34",
                "nn1_select": "gorio_tpu/ops/nn_pallas.py:125"}
    kernels = [
        {"name": name, "route": "cuda", "source": "gorio_tpu_torch/ops/csrc/nn1.cu",
         "replaces": replaces[name],
         "launches": launches["circuit"][name],
         "launches_by_path": {path: counts[name] for path, counts in launches.items()},
         "max_abs_err": errs[name], **stats[name], "cluster": S_main, "shape": MAIN,
         **{key: {**st[name], "shape": shape} for key, (st, shape) in shapes.items()}}
        for name in ("nn1", "nn1_select")
    ]
    return kernels


if __name__ == "__main__":
    main()
