"""Scan-matching odometry front-end.

Port of `ScanMatchingOdometry` from `gorio_tpu/pipeline/odometry.py`
(`ScanMatchingOdometryNodelet`): per (ego-velocity, cloud) pair, align the
new scan to the current keyframe scan from the cumulative ego-velocity
guess, sanity-threshold the result against that prediction (with the IMU
fallback), and refresh the keyframe target on the delta gates. The
registration runs on the clouds' device; the state machine runs on the host
in float64 numpy.

`step_fused` is the fused frontend (`fused_frontend_step`): one upload of
the packed frame and one of a small state vector, the cloud built on the
device, [the full preprocessing chain ->] ego-velocity -> motion guess ->
registration -> inlier fraction, and one pull of a (25/30/31,) host vector, the
JAX package's layout. Where the JAX program is one jitted dispatch, here
it is a sequence of launches with the LM's per-iteration reads of its stop
flags.

The registration is APDGICP, GICP or NDT (`registration="ndt"`, which
builds the keyframe's voxel map on every align, as the JAX package does).
With `enable_scan_to_map` the target is a submap instead of the last
keyframe: the last `max_submap_frames` keyframe clouds moved into the
current keyframe's frame, merged and voxel-downsampled on their own device
to a fixed `submap_capacity` (`_rebuild_submap`), in `step` and in
`step_fused` alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.pointcloud import PointCloud, make_cloud, voxel_downsample
from ..estimators.egovel import EgoVelConfig, estimate_ego_velocity
from ..estimators.groundseg import GroundSegConfig, estimate_ground
from ..ops.nn import nn1_best
from ..registration.gicp import GICPConfig, _transform, gicp_align
from ..registration.ndt import NDTConfig, ndt_align
from .preprocessing import PreprocessConfig, preprocess_frame


class OdometryConfig(NamedTuple):
    """Defaults mirror the nodelet params (`:116-127`)."""

    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.15
    keyframe_delta_time: float = 1.0
    max_acceptable_trans: float = 1.0
    max_acceptable_angle: float = 1.0  # rad
    max_diff_trans: float = 1.0
    max_diff_angle: float = 1.0
    max_egovel_cum: float = 1.0
    enable_imu_fusion: bool = False
    imu_fusion_ratio: float = 0.1
    enable_imu_thresholding: bool = True
    enable_imu_frontend: bool = False
    compute_inlier_fraction: bool = True
    inlier_max_correspondence_dist: float = 0.5
    scan_period: float = 0.1
    registration: str = "apdgicp"  # "apdgicp" | "gicp" | "ndt"
    gicp: GICPConfig = GICPConfig()
    ndt: NDTConfig = NDTConfig()
    egovel: EgoVelConfig = EgoVelConfig()  # used by the fused frontend
    groundseg: GroundSegConfig = GroundSegConfig()  # fused ground / floor segmentation
    # scan-to-submap mode (`:602-618`): register against the merged last-N
    # keyframe clouds instead of the single last keyframe
    enable_scan_to_map: bool = False
    max_submap_frames: int = 5
    submap_resolution: float = 0.25
    submap_capacity: int = 8192


def _rot_angle(R) -> float:
    """Geodesic angle of a rotation matrix (host-side numpy)."""
    return float(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)))


def _r2ypr(R):
    """ZYX Euler (yaw, pitch, roll) of R; `ros_utils.hpp:29-42`."""
    y = np.arctan2(R[1, 0], R[0, 0])
    p = np.arctan2(-R[2, 0], R[0, 0] * np.cos(y) + R[1, 0] * np.sin(y))
    r = np.arctan2(
        R[0, 2] * np.sin(y) - R[1, 2] * np.cos(y),
        -R[0, 1] * np.sin(y) + R[1, 1] * np.cos(y),
    )
    return y, p, r


def _rpy_to_mat(roll, pitch, yaw):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _inlier_fraction(src_xyz, src_mask, tgt_xyz, tgt_mask, T, max_dist):
    """`publish_scan_matching_status` inlier count (`:677-689`): aligned
    source points whose 1-NN in the target is within max_dist."""
    moved, _ = _transform(src_xyz, T)
    _, d2 = nn1_best(moved, tgt_xyz, ref_mask=tgt_mask)
    inl = (d2 < max_dist * max_dist) & src_mask
    return torch.sum(inl.to(d2.dtype)) / torch.clamp(torch.sum(src_mask.to(d2.dtype)), min=1)


def _cloud_from_packed(packed, count):
    """PointCloud on the packed frame's device from its [x, y, z, intensity,
    doppler] rows and the valid count (a device scalar): one upload instead
    of five. The points are copied out of the packed rows: the 1-NN kernels
    take a contiguous ref."""
    cap = packed.shape[0]
    return PointCloud(
        xyz=packed[:, :3].contiguous(),
        intensity=packed[:, 3],
        doppler=packed[:, 4],
        cluster=torch.zeros((cap,), dtype=packed.dtype, device=packed.device),
        mask=torch.arange(cap, device=packed.device) < count,
    )


class FusedStepOut(NamedTuple):
    host: torch.Tensor  # (25,) [T.ravel() (16), converged, error, v (3), sigma (3),
    # zero_vel]; with ground segmentation, (30,) with [n_ground, plane (4)]
    # appended; with the inlier fraction, one more entry at the end. The
    # frame's one device->host pull.
    cloud: PointCloud  # the built source cloud (on the device, reusable as
    # the next keyframe target with no transfer)
    iterations: int = 0  # outer LM iterations of the align (0 on the first frame)


def _fused_ingest_core(packed, host_state, egocfg, gscfg, ppcfg, generator, hyp_idx):
    """The cloud build and per-scan estimation shared by both fused steps.
    With `ppcfg`, the full preprocessing chain of `preprocess_frame` (gates,
    ego-velocity, dynamic-object removal, deskew, ground segmentation and
    under-ground removal, DBSCAN ids); otherwise the ego-velocity alone,
    plus ground segmentation with `gscfg`. Returns (cloud for registration,
    ego, ground parts of the host vector)."""
    cloud = _cloud_from_packed(packed, host_state[16])
    dtype = packed.dtype
    if ppcfg is not None:
        pf, _ = preprocess_frame(cloud, host_state[20:23], ppcfg, generator=generator,
                                 hyp_idx=hyp_idx)
        parts = []
        if ppcfg.enable_ground_seg:
            parts = [torch.sum(pf.ground_mask).to(dtype)[None], pf.plane.to(dtype)]
        return pf.cloud, pf.ego, parts
    ego = estimate_ego_velocity(cloud, egocfg, generator=generator, hyp_idx=hyp_idx)
    parts = []
    if gscfg is not None:
        seg = estimate_ground(cloud, gscfg)
        parts = [torch.sum(seg.ground_mask).to(dtype)[None], seg.plane.to(dtype)]
    return cloud, ego, parts


def _register(source: PointCloud, target: PointCloud, guess, cfg: OdometryConfig):
    """The configured registration of `source` to `target` from `guess`."""
    if cfg.registration == "ndt":
        return ndt_align(source, target, init_T=guess, cfg=cfg.ndt)
    return gicp_align(source, target, init_T=guess, cfg=cfg.gicp._replace(mode=cfg.registration))


def _ego_parts(ego, dtype):
    return [ego.v.to(dtype), ego.sigma.to(dtype), ego.zero_velocity.to(dtype)[None]]


def fused_frontend_step(packed, host_state, kf_cloud: PointCloud, cfg: OdometryConfig,
                        gscfg: Optional[GroundSegConfig] = None,
                        ppcfg: Optional[PreprocessConfig] = None,
                        generator: Optional[torch.Generator] = None,
                        hyp_idx=None) -> FusedStepOut:
    """[full preprocessing ->] Doppler ego-velocity RANSAC -> cumulative
    motion guess (`guess = prev_trans * egovel_cum`, `:458-462`) ->
    registration to the keyframe (or submap) cloud. `host_state` (on the packed frame's
    device) = [prev_trans.ravel() (16), count, dt, seed, frame_idx, omega
    (3)] (23,), optionally with the external MSF pose delta at [23:39]."""
    dtype = packed.dtype
    prev_trans = host_state[:16].reshape(4, 4)
    cloud, ego, ground_parts = _fused_ingest_core(packed, host_state, cfg.egovel, gscfg, ppcfg,
                                                  generator, hyp_idx)
    eye = torch.eye(4, dtype=dtype, device=packed.device)
    step_T = eye.clone()
    step_T[:3, 3] = ego.v.to(dtype) * host_state[17]
    # guard (`:364`): runaway cumulative motion falls back to identity
    egovel_cum = torch.where(torch.linalg.norm(step_T[:3, 3]) <= cfg.max_egovel_cum, step_T, eye)
    guess = prev_trans @ egovel_cum
    if host_state.shape[0] >= 39:
        guess = guess @ host_state[23:39].reshape(4, 4)
    res = _register(cloud, kf_cloud, guess, cfg)
    parts = [res.T.reshape(-1).to(dtype),
             res.converged.to(dtype=dtype, device=packed.device)[None],
             res.error.to(dtype)[None]] + _ego_parts(ego, dtype) + ground_parts
    if cfg.compute_inlier_fraction:
        frac = _inlier_fraction(cloud.xyz, cloud.mask, kf_cloud.xyz, kf_cloud.mask, res.T,
                                cfg.inlier_max_correspondence_dist)
        parts.append(frac.to(dtype)[None])
    return FusedStepOut(host=torch.cat(parts), cloud=cloud, iterations=int(res.iterations))


def fused_ingest(packed, host_state, egocfg: EgoVelConfig,
                 gscfg: Optional[GroundSegConfig] = None,
                 ppcfg: Optional[PreprocessConfig] = None,
                 generator: Optional[torch.Generator] = None, hyp_idx=None) -> FusedStepOut:
    """First-frame path: build (and preprocess) the cloud and estimate the
    ego-velocity only (no registration target yet)."""
    dtype = packed.dtype
    cloud, ego, ground_parts = _fused_ingest_core(packed, host_state, egocfg, gscfg, ppcfg,
                                                  generator, hyp_idx)
    eye = torch.eye(4, dtype=dtype, device=packed.device).reshape(-1)
    one = torch.ones(1, dtype=dtype, device=packed.device)
    parts = [eye, one, torch.zeros_like(one)] + _ego_parts(ego, dtype) + ground_parts
    return FusedStepOut(host=torch.cat(parts), cloud=cloud)


class OdometryStatus(NamedTuple):
    """`ScanMatchingStatus.msg` (filled at `:666-703`)."""

    converged: bool
    matching_error: float
    inlier_fraction: float  # NaN if off
    relative_pose: np.ndarray
    prediction_error: Optional[np.ndarray]
    used_prediction: bool
    prediction_label: str = ""
    iterations: int = 0  # outer LM iterations of the align


@dataclass
class ScanMatchingOdometry:
    cfg: OdometryConfig = OdometryConfig()
    odom: np.ndarray = field(default_factory=lambda: np.eye(4))
    keyframe_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    keyframe_cloud: Optional[PointCloud] = None
    keyframe_stamp: float = 0.0
    prev_trans_s2s: np.ndarray = field(default_factory=lambda: np.eye(4))
    egovel_cum: np.ndarray = field(default_factory=lambda: np.eye(4))
    last_stamp: Optional[float] = None
    statuses: list = field(default_factory=list)
    # IMU attitude queue [(t, roll, pitch, R)] + world->map rotation
    _imu_rp: list = field(default_factory=list)
    _global_orient: Optional[np.ndarray] = None
    _msf_pose: Optional[tuple] = None
    _msf_pose_after_update: Optional[tuple] = None
    _prev_frame_stamp: Optional[float] = None
    _last_radar_delta: np.ndarray = field(default_factory=lambda: np.eye(4))
    # the full preprocessing chain, run inside `step_fused` when set
    preprocess_cfg: Optional[PreprocessConfig] = None
    # the fused step's ground fit of the last frame (`ground=True` or
    # preprocessing with ground segmentation)
    last_ground_count: int = 0
    last_plane: Optional[np.ndarray] = None
    last_cloud: Optional[PointCloud] = None
    _frame_idx: int = -1
    # scan-to-map state: (pose, cloud) of the last keyframes
    _submap_frames: list = field(default_factory=list)

    def push_msf_pose(self, t: float, T: np.ndarray, after_update: bool = False) -> None:
        """Feed an externally fused pose (`/msf_core/pose[_after_update]`)."""
        if after_update:
            self._msf_pose_after_update = (float(t), np.asarray(T, np.float64))
        else:
            self._msf_pose = (float(t), np.asarray(T, np.float64))

    def _msf_delta(self) -> tuple:
        """delta = pose_after_update^-1 @ pose, valid only when both stamps
        postdate the current keyframe; returns (4x4, label)."""
        if (
            not self.cfg.enable_imu_frontend
            or self._msf_pose is None
            or self._msf_pose_after_update is None
        ):
            return np.eye(4), ""
        t1, pose = self._msf_pose
        t0, pose0 = self._msf_pose_after_update
        if t1 <= self.keyframe_stamp or t0 <= self.keyframe_stamp:
            return np.eye(4), ""
        return np.linalg.inv(pose0) @ pose, "imu"

    def push_imu(self, t: float, quat_wxyz) -> None:
        """Feed an IMU orientation sample (world frame, [w,x,y,z])."""
        w, x, y, z = (float(v) for v in quat_wxyz)
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        _, pitch, roll = _r2ypr(R)
        if self._global_orient is None:
            self._global_orient = _rpy_to_mat(roll, pitch, 0.0)
        self._imu_rp.append((t, roll, pitch, R))
        if len(self._imu_rp) > 200:  # imuQueLength
            del self._imu_rp[: len(self._imu_rp) - 200]

    def _transform_update(self, T: np.ndarray, stamp: float) -> np.ndarray:
        """Loose IMU roll/pitch fusion (`transformUpdate`, `:288-342`)."""
        if not self._imu_rp or self._global_orient is None:
            return T
        t_q = stamp + self.cfg.scan_period
        ts = [s[0] for s in self._imu_rp]
        i = int(np.searchsorted(ts, t_q))
        if i >= len(ts):
            roll_i, pitch_i = self._imu_rp[-1][1], self._imu_rp[-1][2]
        elif i == 0:
            roll_i, pitch_i = self._imu_rp[0][1], self._imu_rp[0][2]
        else:
            t0, r0, p0 = self._imu_rp[i - 1][:3]
            t1, r1, p1 = self._imu_rp[i][:3]
            a = (t_q - t0) / max(t1 - t0, 1e-9)
            roll_i = (1 - a) * r0 + a * r1
            pitch_i = (1 - a) * p0 + a * p1
        yaw_o, pitch_o, roll_o = _r2ypr(T[:3, :3])
        imu_rot = _rpy_to_mat(roll_i, pitch_i, yaw_o)
        _, pitch_t, roll_t = _r2ypr(self._global_orient.T @ imu_rot)
        k = self.cfg.imu_fusion_ratio
        fused = _rpy_to_mat((1 - k) * roll_o + k * roll_t, (1 - k) * pitch_o + k * pitch_t, yaw_o)
        out = T.copy()
        out[:3, :3] = fused
        return out

    def _imu_R_at(self, t: float):
        """Orientation sample nearest to stamp `t` (`get_closest_imu`)."""
        ts = [s[0] for s in self._imu_rp]
        i = int(np.searchsorted(ts, t))
        if i >= len(ts):
            i = len(ts) - 1
        elif i > 0 and abs(ts[i - 1] - t) < abs(ts[i] - t):
            i -= 1
        return self._imu_rp[i][3]

    def _imu_fallback_delta(self, stamp: float, egovel_trans: np.ndarray):
        """IMU-rotation + egovel-translation replacement for a rejected
        transform (`:511-550`); None without an IMU orientation stream."""
        if not self.cfg.enable_imu_thresholding or len(self._imu_rp) < 2:
            return None
        if self._prev_frame_stamp is None:
            return None
        rot_imu = self._imu_R_at(self._prev_frame_stamp).T @ self._imu_R_at(stamp)
        # Eigen eulerAngles(0,1,2): R = Rx(a) Ry(b) Rz(c)
        roll_imu = np.arctan2(-rot_imu[1, 2], rot_imu[2, 2])
        pitch_imu = np.arcsin(np.clip(rot_imu[0, 2], -1.0, 1.0))
        rd = self._last_radar_delta
        yaw_rd = np.arctan2(-rd[0, 1], rd[0, 0])
        mat_est = np.eye(4)
        mat_est[:3, :3] = _rpy_to_mat(roll_imu, pitch_imu, yaw_rd)
        mat_est[:3, 3] = egovel_trans
        return mat_est

    def _rebuild_submap(self):
        """Merge the last keyframe clouds into the current keyframe's frame
        (`:602-618`) on their device: moved in float64 and cast back to the
        clouds' dtype, voxel-downsampled, the valid voxels packed into a
        cloud of `submap_capacity` (the first ones in key order)."""
        ref_pose_inv = np.linalg.inv(self.keyframe_pose)
        pts = []
        for pose, cloud in self._submap_frames[-self.cfg.max_submap_frames:]:
            T = torch.as_tensor(ref_pose_inv @ pose, device=cloud.xyz.device)
            xyz = cloud.xyz[cloud.mask]
            pts.append((xyz.to(T.dtype) @ T[:3, :3].T + T[:3, 3]).to(xyz.dtype))
        allpts = torch.cat(pts)
        merged = voxel_downsample(make_cloud(allpts, capacity=max(allpts.shape[0], 1)),
                                  self.cfg.submap_resolution)
        xyz = merged.xyz[merged.mask][: self.cfg.submap_capacity]
        self.keyframe_cloud = make_cloud(xyz, capacity=self.cfg.submap_capacity)

    def _align(self, source: PointCloud, target: PointCloud, guess):
        return _register(source, target, torch.as_tensor(guess, device=source.xyz.device),
                         self.cfg)

    def step_fused(self, stamp: float, packed: torch.Tensor, count: int, seed: int = 0,
                   ground: bool = False, omega=None, generator: Optional[torch.Generator] = None,
                   hyp_idx=None):
        """Fused frontend step (see `fused_frontend_step`) on the padded
        (capacity, 5) [x, y, z, intensity, doppler] frame `packed`, a tensor
        on the device to run on (padding rows arbitrary). Returns (pose
        (4, 4), ego velocity (3,)). The sanity gates and the keyframe refresh
        of `step` run on the host on the pulled vector; the keyframe target
        swap reuses the cloud built on the device. `ground=True` (or a
        `preprocess_cfg` with ground segmentation) exposes the frame's
        ground fit as `last_ground_count` / `last_plane` for the floor
        constraint; `omega` is the latest gyro sample, for deskew.
        `generator` draws the RANSAC hypotheses (`hyp_idx` passes them in);
        `seed` fills the state vector's slot, as in the JAX package, whose
        hypotheses it keys."""
        self._frame_idx += 1
        state = np.zeros(39, dtype=str(packed.dtype).removeprefix("torch."))  # packed's dtype
        state[:16] = self.prev_trans_s2s.ravel()
        state[16] = count
        state[17] = 0.0 if self.last_stamp is None else stamp - self.last_stamp
        state[18] = seed
        state[19] = self._frame_idx
        if omega is not None:
            state[20:23] = np.asarray(omega)  # latest gyro sample, for deskew
        msf_delta, msf_label = self._msf_delta()
        state[23:39] = msf_delta.ravel()
        state_dev = torch.as_tensor(state, device=packed.device)

        ppcfg = self.preprocess_cfg
        gscfg = self.cfg.groundseg if (ground and ppcfg is None) else None
        has_ground = gscfg is not None or (ppcfg is not None and ppcfg.enable_ground_seg)
        if self.keyframe_cloud is None:
            out = fused_ingest(packed, state_dev, self.cfg.egovel, gscfg, ppcfg, generator,
                               hyp_idx)
            host = out.host.cpu().numpy()
            if has_ground:
                self.last_ground_count = int(host[25])
                self.last_plane = host[26:30].astype(np.float64)
            self.keyframe_cloud = self.last_cloud = out.cloud
            self.keyframe_stamp = self.last_stamp = stamp
            if self.cfg.enable_scan_to_map:
                self._submap_frames.append((self.keyframe_pose.copy(), out.cloud))
            return self.odom.copy(), host[18:21]

        self._prev_frame_stamp = self.last_stamp
        self.last_stamp = stamp
        out = fused_frontend_step(packed, state_dev, self.keyframe_cloud, self.cfg, gscfg, ppcfg,
                                  generator, hyp_idx)
        self.last_cloud = out.cloud
        host = out.host.cpu().numpy()  # the frame's one device->host pull
        if has_ground:
            self.last_ground_count = int(host[25])
            self.last_plane = host[26:30].astype(np.float64)
        T = host[:16].reshape(4, 4).astype(np.float64)
        converged = host[16] > 0.5
        v = host[18:21]
        if not np.isfinite(v).all():
            # degenerate scan (no gated Doppler returns): zero velocity keeps
            # the motion-prediction fallback finite (`:427-430`)
            v = np.zeros(3, host.dtype)

        delta = np.linalg.inv(self.prev_trans_s2s) @ T
        dx = float(np.linalg.norm(delta[:3, 3]))
        da = _rot_angle(delta[:3, :3])
        step_T = np.eye(4)
        step_T[:3, 3] = v * state[17]
        if np.linalg.norm(step_T[:3, 3]) > self.cfg.max_egovel_cum:
            step_T = np.eye(4)
        pred = self.prev_trans_s2s @ step_T
        diff = np.linalg.inv(pred) @ T
        ddx = float(np.linalg.norm(diff[:3, 3]))
        dda = _rot_angle(diff[:3, :3])
        used_prediction = False
        # NaN-safe: a non-finite T must not pass the threshold checks
        if (
            not converged
            or not np.isfinite(T).all()
            or dx > self.cfg.max_acceptable_trans
            or da > self.cfg.max_acceptable_angle
            or ddx > self.cfg.max_diff_trans
            or dda > self.cfg.max_diff_angle
        ):
            fb = self._imu_fallback_delta(stamp, step_T[:3, 3])
            T = self.prev_trans_s2s @ fb if fb is not None else pred
            used_prediction = True
        self._last_radar_delta = delta

        self.statuses.append(
            OdometryStatus(
                converged=bool(converged),
                matching_error=float(host[17]),
                inlier_fraction=(float(host[-1]) if self.cfg.compute_inlier_fraction
                                 else float("nan")),
                relative_pose=delta,
                prediction_error=diff,
                used_prediction=used_prediction,
                prediction_label=msf_label,
                iterations=out.iterations,
            )
        )
        self.prev_trans_s2s = T
        self.odom = self.keyframe_pose @ T
        self._refresh_keyframe(T, stamp, out.cloud)
        return self.odom.copy(), v

    def _refresh_keyframe(self, T, stamp, cloud):
        """Keyframe refresh on the delta gates (`:578-600`)."""
        if (
            float(np.linalg.norm(T[:3, 3])) > self.cfg.keyframe_delta_trans
            or _rot_angle(T[:3, :3]) > self.cfg.keyframe_delta_angle
            or stamp - self.keyframe_stamp > self.cfg.keyframe_delta_time
        ):
            if self.cfg.enable_imu_fusion:
                self.odom = self._transform_update(self.odom, stamp)
            self.keyframe_pose = self.odom.copy()
            self.keyframe_stamp = stamp
            self.prev_trans_s2s = np.eye(4)
            if self.cfg.enable_scan_to_map:
                self._submap_frames.append((self.keyframe_pose.copy(), cloud))
                self._rebuild_submap()
            else:
                self.keyframe_cloud = cloud

    def step(self, stamp: float, cloud: PointCloud, ego_vel: np.ndarray) -> np.ndarray:
        """Process one frame; returns the 4x4 odometry pose (map<-body)."""
        if self.keyframe_cloud is None:
            self.keyframe_cloud = cloud
            self.keyframe_stamp = stamp
            self.last_stamp = stamp
            if self.cfg.enable_scan_to_map:
                self._submap_frames.append((self.keyframe_pose.copy(), cloud))
            return self.odom.copy()

        # cumulative ego-velocity delta since the last frame (`:356-365`)
        dt = stamp - self.last_stamp
        self._prev_frame_stamp = self.last_stamp
        self.last_stamp = stamp
        step_T = np.eye(4)
        step_T[:3, 3] = np.asarray(ego_vel) * dt
        egovel_cum = self.egovel_cum @ step_T
        if np.linalg.norm(egovel_cum[:3, 3]) > self.cfg.max_egovel_cum:
            egovel_cum = self.egovel_cum  # guard (`:364`)
        self.egovel_cum = egovel_cum

        msf_delta, msf_label = self._msf_delta()
        guess = self.prev_trans_s2s @ self.egovel_cum @ msf_delta
        res = self._align(cloud, self.keyframe_cloud, guess)
        T = res.T.cpu().numpy()
        if self.cfg.compute_inlier_fraction:
            inlier_frac = float(
                _inlier_fraction(
                    cloud.xyz, cloud.mask, self.keyframe_cloud.xyz, self.keyframe_cloud.mask,
                    res.T, self.cfg.inlier_max_correspondence_dist,
                )
            )
        else:
            inlier_frac = float("nan")

        # sanity thresholding vs the ego-velocity prediction (`:497-570`)
        delta = np.linalg.inv(self.prev_trans_s2s) @ T
        dx = float(np.linalg.norm(delta[:3, 3]))
        da = _rot_angle(delta[:3, :3])
        pred = self.prev_trans_s2s @ self.egovel_cum
        diff = np.linalg.inv(pred) @ T
        ddx = float(np.linalg.norm(diff[:3, 3]))
        dda = _rot_angle(diff[:3, :3])
        used_prediction = False
        converged = bool(res.converged)
        # NaN-safe: a non-finite T must not pass the threshold checks
        if (
            not converged
            or not np.isfinite(T).all()
            or dx > self.cfg.max_acceptable_trans
            or da > self.cfg.max_acceptable_angle
            or ddx > self.cfg.max_diff_trans
            or dda > self.cfg.max_diff_angle
        ):
            fb = self._imu_fallback_delta(stamp, self.egovel_cum[:3, 3])
            T = self.prev_trans_s2s @ fb if fb is not None else pred
            used_prediction = True
        self._last_radar_delta = delta

        self.statuses.append(
            OdometryStatus(
                converged=converged,
                matching_error=float(res.error),
                inlier_fraction=inlier_frac,
                relative_pose=delta,
                prediction_error=diff,
                used_prediction=used_prediction,
                prediction_label=msf_label,
                iterations=int(res.iterations),
            )
        )

        self.prev_trans_s2s = T
        self.egovel_cum = np.eye(4)
        self.odom = self.keyframe_pose @ T
        self._refresh_keyframe(T, stamp, cloud)
        return self.odom.copy()
