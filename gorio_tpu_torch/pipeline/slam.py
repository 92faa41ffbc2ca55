"""Radar graph-SLAM back end.

Port of `RadarGraphSLAM` from `gorio_tpu/pipeline/slam.py`
(`RadarGraphSlamNodelet`): keyframe selection, LPM or UGPM velocity
preintegration between keyframes, Scan-Context loop closure verified by
batched APDGICP, the pose graph (odometry between-factors with
fitness-based information, preintegration between-factors, Huber loop
factors, GPS priors, and with the floor constraint one world floor plane
vertex observed by every keyframe with an accepted ground fit) and its LM
solve: dense up to `solve_dense_max_dim` stacked pose dimensions,
block-sparse direct (tridiagonal + Woodbury, with a Schur step for the
plane) above. The graph is built on the host and solved on `device`, the
card unless the caller asks for the CPU. The outputs: the trajectory, the
graph and keyframes dumped to a directory (`save`), the voxelised map
(`generate_map`) and the markers' JSON (`export_markers`); and the
trajectory posterior around the GN solution (`sample_posterior`).

`optimize` may run on a worker thread while another thread ingests frames
and measurements (`pipeline/streaming.py`): it snapshots the keyframe list
up front, and one lock guards the GPS queue's appends and its consumption.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.pointcloud import PointCloud, make_cloud, voxel_downsample
from ..graph.graph import PoseGraph
from ..graph.solver import (SolveConfig, laplace_covariance, optimize_graph,
                            optimize_graph_with_planes)
from ..graph.sparse import optimize_graph_sparse, optimize_graph_with_planes_sparse
from ..inference.hmc import potential_scale_reduction, run_hmc
from ..inference.laplace import graph_logprob, unwhiten, whitened_logprob
from ..loopclosure.information import InformationConfig, calc_information_matrix
from ..loopclosure.loop_detector import LoopConfig, LoopDetector
from ..preintegration.lpm import lpm_preintegrate
from ..preintegration.ugpm import UGPMConfig, ugpm_preintegrate
from .keyframes import KeyFrame, KeyframeUpdater


class SLAMConfig(NamedTuple):
    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.15
    max_keyframes_per_update: int = 10
    enable_preintegration: bool = True
    preint_mode: str = "lpm"  # "lpm" | "ugpm"
    preint_grid_n: int = 256
    preint_window_samples: int = 256  # fixed gyro-sample count per window
    preint_vel_samples: int = 64
    ugpm: UGPMConfig = UGPMConfig()
    gyr_var: float = 1e-4
    vel_var: float = 1e-3
    enable_loop_closure: bool = True
    loop: LoopConfig = LoopConfig()
    info: InformationConfig = InformationConfig()
    loop_robust_delta: float = 1.0  # Huber on loop edges (`:836-852`)
    gps_xy_info: float = 25.0
    gps_z_info: float = 4.0
    # GPS edge gate chain (`flush_gps_queue`, `radar_graph_slam_nodelet.cpp:
    # 1248-1327`)
    gps_edge_intervals: int = 10
    max_gps_edge_stddev_xy: float = 1.0
    max_gps_edge_stddev_z: float = 2.0
    gps_residual_skip_dist: float = 5.0
    gps_robust_delta: float = np.inf
    anchor_info: float = 1e6
    solve: SolveConfig = SolveConfig(max_iterations=30)
    # floor constraint: keyframe ground-plane observations tied to one world
    # floor plane vertex (EdgeSE3Plane; keyframe floor_coeffs)
    enable_floor_constraint: bool = False
    floor_normal_info: float = 100.0
    floor_distance_info: float = 100.0
    floor_robust_delta: float = 1.0
    floor_min_ground_points: int = 30
    floor_max_tilt_nz: float = 0.8
    # pad the pose count to the next power of two with unit-prior dummy poses
    # (the JAX package's compile buckets; kept so the dense/sparse switch
    # falls at the same keyframe count)
    pad_poses_pow2: bool = True
    # above this stacked dimension the solve is block-sparse (graph/sparse.py)
    solve_dense_max_dim: int = 768


class GPSMeasurement(NamedTuple):
    stamp: float
    xyz: np.ndarray  # world/UTM-aligned position
    has_z: bool
    cov: Optional[np.ndarray] = None  # (3,) position covariance diagonal


@dataclass
class RadarGraphSLAM:
    cfg: SLAMConfig = SLAMConfig()
    device: torch.device = torch.device("cuda")
    keyframes: list = field(default_factory=list)
    updater: KeyframeUpdater = None
    loop_detector: LoopDetector = None
    gyr_t: list = field(default_factory=list)
    gyr: list = field(default_factory=list)
    vel_t: list = field(default_factory=list)
    vel: list = field(default_factory=list)
    gps_queue: list = field(default_factory=list)
    loops: list = field(default_factory=list)
    trans_odom2map: np.ndarray = field(default_factory=lambda: np.eye(4))
    # graph solves by solver, counted where `optimize` picks one (the joint
    # pose + floor-plane solves apart); "cg" counts again those that ran CG
    solver_counts: dict = field(default_factory=lambda: {
        "dense": 0, "sparse": 0, "dense_planes": 0, "sparse_planes": 0, "cg": 0})
    floor_plane: Optional[np.ndarray] = None  # optimized world floor [n, d]
    _last_gps_edge_index: int = -(10**9)
    _loop_checked_upto: int = 0
    _gps_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _gps_converter: object = field(default=None, repr=False)  # push_nmea's GPSConverter

    def __post_init__(self):
        if self.cfg.preint_mode not in ("lpm", "ugpm"):
            raise ValueError(f"preint_mode={self.cfg.preint_mode!r}: 'lpm' or 'ugpm'")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"RadarGraphSLAM(device={self.device}): no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        if self.updater is None:
            self.updater = KeyframeUpdater(
                delta_trans=self.cfg.keyframe_delta_trans,
                delta_angle=self.cfg.keyframe_delta_angle,
                delta_time=np.inf,
            )
        if self.loop_detector is None:
            self.loop_detector = LoopDetector(cfg=self.cfg.loop, info_cfg=self.cfg.info,
                                              device=self.device)

    # ---- measurement ingestion ------------------------------------------
    def push_imu(self, t: float, gyro):
        self.gyr_t.append(float(t))
        self.gyr.append(np.asarray(gyro))

    def push_twist(self, t: float, vel):
        self.vel_t.append(float(t))
        self.vel.append(np.asarray(vel))

    def push_gps(self, t: float, xyz, has_z: bool = True, cov=None):
        fix = GPSMeasurement(t, np.asarray(xyz), has_z, None if cov is None else np.asarray(cov))
        with self._gps_lock:
            self.gps_queue.append(fix)

    def push_nmea(self, t: float, sentence: str, converter=None) -> bool:
        """An NMEA sentence as a GPS fix (`nmea_callback` + `flush_gps_queue`):
        parsed, converted to zeroed UTM by `converter` (default: one
        `GPSConverter` per SLAM object, zeroed at its first fix) and queued
        by `push_gps`. Returns whether a fix was queued."""
        from ..io.gps import GPSConverter, parse_nmea

        if converter is None:
            if self._gps_converter is None:
                self._gps_converter = GPSConverter()
            converter = self._gps_converter
        fix = parse_nmea(sentence)
        if fix is None:
            return False
        p = converter.convert(fix)
        if p is None:
            return False
        self.push_gps(t, p, has_z=fix.alt is not None)
        return True

    # ---- keyframe path (`cloud_handler_callback`, `:626-743`) ------------
    def add_frame(
        self,
        stamp: float,
        cloud: PointCloud,
        odom_pose: np.ndarray,
        floor_coeffs: Optional[np.ndarray] = None,
        altitude: Optional[float] = None,
    ) -> bool:
        if not self.updater.decide(odom_pose, stamp):
            return False
        kf = KeyFrame(
            index=len(self.keyframes),
            stamp=stamp,
            odom_scan2scan=np.asarray(odom_pose),
            accum_distance=self.updater.accum_distance,
            cloud=cloud,
            floor_coeffs=None if floor_coeffs is None else np.asarray(floor_coeffs),
            altitude=None if altitude is None else float(altitude),
        )
        if self.cfg.enable_preintegration and self.keyframes:
            meas = self._preintegrate(self.keyframes[-1].stamp, stamp)
            if meas is not None:
                kf.trans_integrated, kf.preint_cov = meas
        self.keyframes.append(kf)
        if self.cfg.enable_loop_closure:
            self.loop_detector.add_keyframe(cloud)
        return True

    def _preintegrate(self, t0: float, t1: float):
        """LPM or UGPM preintegration over [t0, t1] (`preIntegrationTransform`,
        `radar_graph_slam_nodelet.cpp:363-533`): the window start is clamped
        to at most 2 s before the end, the streams are read from 0.2 s
        before it, in fixed sample budgets padded by repeating the last
        sample. Returns (T (4, 4), cov (6, 6)) or None."""
        gyr_t = np.asarray(self.gyr_t)
        vel_t = np.asarray(self.vel_t)
        if gyr_t.size < 4 or vel_t.size < 4:
            return None
        if t1 - t0 > 2.0:
            t0 = t1 - 2.0  # `:424-426`
        pad = 0.2
        G = self.cfg.preint_window_samples
        V = self.cfg.preint_vel_samples
        i_g = int(np.searchsorted(gyr_t, t0 - pad))
        i_v = int(np.searchsorted(vel_t, t0 - pad))
        g_sl = slice(max(0, min(i_g, gyr_t.size - G)), None)
        v_sl = slice(max(0, min(i_v, vel_t.size - V)), None)
        gt = gyr_t[g_sl][:G]
        vt = vel_t[v_sl][:V]
        if gt.size < 4 or vt.size < 4 or gt[-1] < t1 or vt[-1] < t1:
            return None
        gd = np.stack(self.gyr)[g_sl][:G]
        vd = np.stack(self.vel)[v_sl][:V]
        if gt.size < G:
            rep = G - gt.size
            gt = np.concatenate([gt, gt[-1] + 1e-3 * (1 + np.arange(rep))])
            gd = np.concatenate([gd, np.repeat(gd[-1:], rep, axis=0)])
        if vt.size < V:
            rep = V - vt.size
            vt = np.concatenate([vt, vt[-1] + 1e-3 * (1 + np.arange(rep))])
            vd = np.concatenate([vd, np.repeat(vd[-1:], rep, axis=0)])

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

        args = (dev(gt), dev(gd), dev(vt), dev(vd), float(t0), dev([t1]), self.cfg.gyr_var,
                self.cfg.vel_var)
        if self.cfg.preint_mode == "ugpm":
            meas = ugpm_preintegrate(*args, self.cfg.ugpm, with_jacobians=False)
        else:
            meas = lpm_preintegrate(*args, grid_n=self.cfg.preint_grid_n, with_jacobians=False)
        out = torch.cat([meas.delta_R[0].reshape(-1), meas.delta_p[0], meas.cov[0].reshape(-1)])
        out = out.cpu().numpy()  # one device->host read per keyframe
        T = np.eye(4)
        T[:3, :3] = out[:9].reshape(3, 3)
        T[:3, 3] = out[9:12]
        return T, out[12:48].reshape(6, 6)

    def _flush_gps_queue(self, est, keyframes) -> None:
        """Associate queued GPS fixes to keyframes through the reference's
        gate chain (`flush_gps_queue`, `radar_graph_slam_nodelet.cpp:
        1248-1327`): keyframe spacing, closest fix within 0.2 s, covariance
        gate, one `utm_coord` per keyframe, and the 5 m drift gate. Consumed
        fixes older than the newest keyframe are dropped; a fix pushed while
        this runs stays queued."""
        with self._gps_lock:
            queue = list(self.gps_queue)
        if not queue or not keyframes:
            return
        cfg = self.cfg
        q_stamps = np.asarray([g.stamp for g in queue])
        last_idx = self._last_gps_edge_index
        for kf in keyframes:
            if kf.index - last_idx < cfg.gps_edge_intervals or kf.utm_coord is not None:
                continue
            gps = queue[int(np.argmin(np.abs(q_stamps - kf.stamp)))]
            if abs(gps.stamp - kf.stamp) > 0.2:
                continue
            if gps.cov is not None:
                cx, cy, cz = (float(v) for v in gps.cov)
                if (
                    cx > cfg.max_gps_edge_stddev_xy
                    or cy > cfg.max_gps_edge_stddev_xy
                    or cz > cfg.max_gps_edge_stddev_z
                ):
                    continue
            kf.utm_coord = np.asarray(gps.xyz)
            kf._gps_has_z = bool(gps.has_z) and np.isfinite(gps.xyz[2])
            if np.linalg.norm(est(kf)[:3, 3] - np.asarray(gps.xyz)) < cfg.gps_residual_skip_dist:
                kf._gps_edge = False
                continue
            if gps.cov is not None:
                info = 1.0 / np.maximum(np.asarray(gps.cov, float), 1e-12)
            else:
                info = np.asarray([cfg.gps_xy_info, cfg.gps_xy_info, cfg.gps_z_info])
            kf._gps_edge = True
            kf._gps_info = info
            last_idx = kf.index
        self._last_gps_edge_index = last_idx
        newest = keyframes[-1].stamp
        with self._gps_lock:
            self.gps_queue = [g for g in self.gps_queue if g.stamp > newest]

    # ---- optimization cycle (`optimization_timer_callback`, `:750-834`) --
    def optimize(self, window: Optional[int] = None) -> Optional[np.ndarray]:
        """One graph-optimization cycle.

        `window=W` runs fixed-lag optimization: only the last W keyframes are
        variables, the window's first pose is anchored at its current
        estimate, and a loop closure whose old keyframe lies before the
        window enters as a prior on its new keyframe through the frozen old
        pose. The keyframe list is snapshot once up front."""
        keyframes = list(self.keyframes)
        K = len(keyframes)
        if K < 2:
            return None
        base = 0 if (window is None or K <= window) else K - window
        kfs = keyframes[base:]

        def est(kf):
            return kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan

        g = PoseGraph()
        for kf in kfs:
            g.add_pose(est(kf))
        # anchor: keyframe 0's odometry for the full graph; the window-edge
        # pose's current estimate in fixed-lag mode
        anchor = keyframes[0].odom_scan2scan if base == 0 else est(kfs[0])
        g.add_prior(0, anchor, info=np.eye(6) * self.cfg.anchor_info)
        for k in range(1, len(kfs)):
            prev, curr = kfs[k - 1], kfs[k]
            rel = np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan
            if curr.edge_info is None:
                info, _ = calc_information_matrix(
                    curr.cloud, prev.cloud, torch.as_tensor(rel, device=self.device), self.cfg.info
                )
                curr.edge_info = info.cpu().numpy()
            g.add_between(k - 1, k, rel, info=curr.edge_info)
            if curr.trans_integrated is not None:
                # stddev-diag information from the preint covariance (`:596-612`)
                var = np.clip(np.diag(curr.preint_cov), 1e-6, None)
                g.add_between(k - 1, k, curr.trans_integrated, info=np.diag(1.0 / var))

        # loop detection over every keyframe added since the last cycle, in
        # chunks of max_keyframes_per_update (the reference's keyframe-queue
        # batching, `:552`; here it bounds the verification batch)
        if self.cfg.enable_loop_closure and K > 3:
            poses_arr = np.stack([est(kf) for kf in keyframes])
            odom_arr = np.stack([kf.odom_scan2scan for kf in keyframes])
            accum_arr = np.asarray([kf.accum_distance for kf in keyframes])
            clouds = [kf.cloud for kf in keyframes]
            alts = [kf.altitude for kf in keyframes]
            new_idx = [kf.index for kf in keyframes[self._loop_checked_upto:]]
            chunk = max(self.cfg.max_keyframes_per_update, 1)
            for c in range(0, len(new_idx), chunk):
                self.loops.extend(self.loop_detector.detect_batch(
                    new_idx[c: c + chunk], clouds, poses_arr, odom_arr, accum_arr,
                    keyframe_altitudes=alts,
                ))
            self._loop_checked_upto = K
        for loop in self.loops:
            # edge old->new measuring old_T_new = T_rel (`addLoopFactor`)
            i, j = loop.key_old - base, loop.key_new - base
            if j < 0:
                continue  # fully outside the window: already absorbed
            if i >= 0:
                g.add_between(i, j, loop.T_rel, info=loop.information,
                              robust_delta=self.cfg.loop_robust_delta)
            else:
                # old endpoint frozen: T_new ~ T_old_frozen @ T_rel as a prior
                g.add_prior(j, est(keyframes[loop.key_old]) @ loop.T_rel,
                            info=loop.information, robust_delta=self.cfg.loop_robust_delta)

        self._flush_gps_queue(est, keyframes)
        for k, kf in enumerate(kfs):
            if kf.utm_coord is None or not getattr(kf, "_gps_edge", False):
                continue
            axes = (1, 1, 1) if kf._gps_has_z else (1, 1, 0)
            g.add_point_prior(
                k, kf.utm_coord, info=np.diag(kf._gps_info), axes=axes,
                robust_delta=self.cfg.gps_robust_delta,
            )

        # floor constraint: the keyframes' ground-plane observations tied to
        # one world floor plane, seeded from the first floored keyframe and
        # carried between optimizations
        floored = ([kf for kf in kfs if kf.floor_coeffs is not None]
                   if self.cfg.enable_floor_constraint else [])
        if floored:
            if self.floor_plane is not None:
                plane_w = self.floor_plane
            else:
                T0 = est(floored[0])
                n_b, d_b = floored[0].floor_coeffs[:3], floored[0].floor_coeffs[3]
                n_w = T0[:3, :3] @ n_b
                plane_w = np.concatenate([n_w, [d_b - n_w @ T0[:3, 3]]])
            j = g.add_plane(plane_w)
            info3 = np.diag([self.cfg.floor_normal_info, self.cfg.floor_normal_info,
                             self.cfg.floor_distance_info])
            for kf in floored:
                g.add_se3_plane(kf.index - base, j, kf.floor_coeffs, info3,
                                robust_delta=self.cfg.floor_robust_delta)

        if self.cfg.pad_poses_pow2:
            K_real = len(g.poses)
            K_pad = max(4, 1 << (K_real - 1).bit_length())
            for _ in range(K_pad - K_real):
                g.add_prior(g.add_pose(np.eye(4)), np.eye(4), info=1.0)
        poses0, graph = g.freeze(device=self.device)
        solve_cfg = self.cfg.solve
        # above the dense cutoff, the block-sparse direct solver: exact
        # tridiagonal + Woodbury, its low-rank capacity sized from the live
        # loop count in power-of-two buckets (the JAX package's rule)
        use_sparse = len(g.poses) * 6 > self.cfg.solve_dense_max_dim
        if use_sparse and solve_cfg.solver in ("dense", "direct"):
            n_loop = max(len(self.loops), 1)
            lcap = max(8, 1 << (n_loop - 1).bit_length())
            solve_cfg = solve_cfg._replace(solver="direct", loop_capacity=lcap)
        kind = "sparse" if use_sparse else "dense"
        if floored:
            planes0, plane_graph = g.freeze_planes(device=self.device)
            solve = optimize_graph_with_planes_sparse if use_sparse else optimize_graph_with_planes
            res = solve(poses0, planes0, graph, plane_graph, solve_cfg)
            self.floor_plane = res.planes[0].cpu().numpy()
            kind += "_planes"
        else:
            solve = optimize_graph_sparse if use_sparse else optimize_graph
            res = solve(poses0, graph, solve_cfg)
        self.solver_counts[kind] += 1
        self.solver_counts["cg"] += solve_cfg.solver == "cg"
        opt = res.poses.cpu().numpy()[: len(kfs)]  # drop the padding dummies
        for k, kf in enumerate(kfs):
            kf.optimized_pose = opt[k]
        last = keyframes[-1]
        self.trans_odom2map = last.optimized_pose @ np.linalg.inv(last.odom_scan2scan)
        return opt

    # ---- posterior inference (BASELINE configs 3-4) -----------------------
    def posterior_graph(self, window: Optional[int] = None):
        """The frozen factor graph whose posterior `sample_posterior`
        samples, on the SLAM's device: (poses0 (K, 4, 4), GraphData) at the
        current keyframes (or the last `window` of them), around their
        optimized poses (else their odometry), the first pose anchored at
        its current estimate; the odometry edges with the fitness-based
        information of `optimize`, the preintegration edges, and the loops
        with both ends in the graph, robust at `loop_robust_delta`."""
        kfs = self.keyframes if window is None else self.keyframes[-window:]
        base = self.keyframes[0].index if window is None else kfs[0].index

        g = PoseGraph()
        for kf in kfs:
            g.add_pose(kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan)
        anchor = kfs[0].odom_scan2scan if kfs[0].optimized_pose is None else kfs[0].optimized_pose
        g.add_prior(0, anchor, info=np.eye(6) * self.cfg.anchor_info)
        for k in range(1, len(kfs)):
            prev, curr = kfs[k - 1], kfs[k]
            rel = np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan
            # the information of the GN graph (`optimize`): the sampled
            # posterior is the posterior of that graph
            if curr.edge_info is None:
                info, _ = calc_information_matrix(
                    curr.cloud, prev.cloud, torch.as_tensor(rel, device=self.device), self.cfg.info
                )
                curr.edge_info = info.cpu().numpy()
            g.add_between(k - 1, k, rel, info=curr.edge_info)
            if curr.trans_integrated is not None:
                var = np.clip(np.diag(curr.preint_cov), 1e-6, None)
                g.add_between(k - 1, k, curr.trans_integrated, info=np.diag(1.0 / var))
        for loop in self.loops:
            i, j = loop.key_old - base, loop.key_new - base
            if i < 0 or j < 0 or i >= len(kfs) or j >= len(kfs):
                continue
            g.add_between(i, j, loop.T_rel, info=loop.information,
                          robust_delta=self.cfg.loop_robust_delta)
        return g.freeze(device=self.device)

    def sample_posterior(self, generator=None, n_chains: int = 4, n_samples: int = 200,
                         method: str = "hmc", window: Optional[int] = None, *, draws=None):
        """Sample the trajectory posterior around the GN solution.

        Solves `posterior_graph(window)` densely and runs `n_chains` HMC
        chains in one batch on the Laplace-whitened density (step 0.15, 16
        leapfrog steps, dual-averaging warmup of n_samples // 2). Returns
        (samples (C, n, 6K), accept probabilities (C, n), split R-hat (6K,)
        over the last 3/4 of each chain, the Laplace covariance (6K, 6K)),
        on the SLAM's device.

        `window=w` samples the fixed-lag posterior of the last `w` keyframes,
        the window's first pose anchored at its current estimate. `method`
        must be "hmc" (the JAX package ignores it; the port refuses other
        names). The draws come from `generator` on the device, or as
        `draws` = (z (S, C, 6K), log_u (S, C)), S = warmup + n_samples."""
        if method != "hmc":
            raise ValueError(f"sample_posterior(method={method!r}): only 'hmc' is implemented")
        poses0, graph = self.posterior_graph(window)
        res = optimize_graph(poses0, graph, self.cfg.solve)
        n = poses0.shape[0] * 6
        # the Laplace-whitened kernel: a diagonal inverse mass cannot undo a
        # chain graph's cross-pose correlations
        lp_y, L = whitened_logprob(graph_logprob(res.poses, graph), res.H)
        y0 = torch.zeros((n_chains, n), dtype=poses0.dtype, device=self.device)
        samples_y, accepts = run_hmc(lp_y, y0, n_samples=n_samples, step_size=0.15,
                                     n_leapfrog=16, generator=generator, draws=draws)
        samples = unwhiten(L, samples_y)
        rhat = potential_scale_reduction(samples[:, n_samples // 4:])
        return samples, accepts, rhat, laplace_covariance(res)

    # ---- outputs ---------------------------------------------------------
    def trajectory(self):
        """(stamps, poses) using optimized poses where available."""
        stamps = np.asarray([kf.stamp for kf in self.keyframes])
        poses = np.stack(
            [
                kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan
                for kf in self.keyframes
            ]
        )
        return stamps, poses

    def export_markers(self, path: str):
        """Nodes, odometry edges and loops as JSON (the rviz MarkerArray of
        `radar_graph_slam_nodelet.cpp:885-1121`), for outside viewers."""
        stamps, poses = self.trajectory()
        data = {
            "nodes": [
                {"id": int(kf.index), "stamp": float(s), "position": p[:3, 3].tolist()}
                for kf, s, p in zip(self.keyframes, stamps, poses)
            ],
            "edges": [
                {"from": k - 1, "to": k, "type": "odometry"}
                for k in range(1, len(self.keyframes))
            ],
            "loops": [
                {"from": int(l.key_old), "to": int(l.key_new), "fitness": float(l.fitness)}
                for l in self.loops
            ],
            # the candidate search sphere (`:1114`, the reference's only use
            # of distance_thresh)
            "loop_search_radius": float(self.cfg.loop.distance_thresh) * 2.0,
        }
        with open(path, "w") as fh:
            json.dump(data, fh, indent=1)

    def save(self, directory: str):
        """The graph (`graph.g2o`) and one directory per keyframe (the
        `DumpGraph` service, `:1129-1208`)."""
        os.makedirs(directory, exist_ok=True)
        g = PoseGraph()
        for kf in self.keyframes:
            g.add_pose(kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan)
        for k in range(1, len(self.keyframes)):
            prev, curr = self.keyframes[k - 1], self.keyframes[k]
            g.add_between(k - 1, k, np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan,
                          info=np.eye(6))
        g.save(os.path.join(directory, "graph.g2o"))
        for kf in self.keyframes:
            kf.save(os.path.join(directory, f"{kf.index:06d}"))

    def generate_map(self, resolution: float = 0.1, max_range: float = 50.0) -> PointCloud:
        """The keyframe clouds' points within `max_range`, moved by their
        poses and voxel-downsampled at `resolution` (`MapCloudGenerator::
        generate`), in float64 on the clouds' device; capacity = the point
        count."""
        pts = []
        for kf in self.keyframes:
            T = kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan
            xyz = kf.cloud.xyz.to(torch.float64)
            keep = kf.cloud.mask & (torch.linalg.norm(xyz, dim=-1) < max_range)
            T = torch.as_tensor(T, dtype=torch.float64, device=xyz.device)
            pts.append(xyz[keep] @ T[:3, :3].T + T[:3, 3])
        allpts = torch.cat(pts)
        return voxel_downsample(make_cloud(allpts), resolution, capacity=allpts.shape[0])
