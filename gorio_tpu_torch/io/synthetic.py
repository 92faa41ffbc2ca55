"""Synthetic radar-inertial sequences for tests, the CLI and chip_smoke.

JAX-free counterpart of `gorio_tpu/io/synthetic.py` (which imports the JAX
`make_cloud` at module level): the same host-side float64 numpy generators,
returning bit-identical arrays for the same seeds; `render_radar_scan`
returns a port `PointCloud`. A smooth SE(3) trajectory, gyro + Doppler
ego-velocity streams, and radar scans of a fixed world point set with
per-point Doppler; ground truth is exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.pointcloud import make_cloud


@dataclass
class Trajectory:
    """Dense ground-truth trajectory sampled at `t` (body frame FLU)."""

    t: np.ndarray  # (T,)
    R: np.ndarray  # (T, 3, 3) world_R_body
    p: np.ndarray  # (T, 3) world position
    omega: np.ndarray  # (T, 3) body angular velocity
    v_body: np.ndarray  # (T, 3) body-frame linear velocity

    def interp_pose(self, tq: np.ndarray):
        """Piecewise pose interpolation (slerp within cells)."""
        from scipy.spatial.transform import Rotation, Slerp

        slerp = Slerp(self.t, Rotation.from_matrix(self.R))
        tq = np.clip(tq, self.t[0], self.t[-1])
        Rq = slerp(tq).as_matrix()
        pq = np.stack([np.interp(tq, self.t, self.p[:, i]) for i in range(3)], axis=-1)
        return Rq, pq


def _smooth_signal(rng, t, n_harmonics, amp, base=0.0):
    """Sum of random low-frequency sinusoids, (T, 3)."""
    out = np.full((t.shape[0], 3), base, dtype=np.float64)
    for _ in range(n_harmonics):
        freq = rng.uniform(0.05, 0.6, size=3)
        phase = rng.uniform(0, 2 * np.pi, size=3)
        a = rng.normal(scale=amp, size=3)
        out += a * np.sin(2 * np.pi * freq * t[:, None] + phase)
    return out


def simulate_trajectory(
    seed: int = 0,
    duration: float = 10.0,
    rate: float = 1000.0,
    omega_amp: float = 0.25,
    vel_amp: float = 1.0,
    forward_speed: float = 2.0,
    circuit: bool = False,
    stops: int = 0,
    stop_duration: float = 1.5,
    max_tilt: float = 0.1,
    laps: float = 1.0,
    figure8: bool = False,
    elev_amp: float = 0.0,
) -> Trajectory:
    """Smooth random ground-vehicle trajectory sampled at `rate` Hz: yaw
    integrates a smooth random rate, roll/pitch are bounded smooth signals,
    and the body rates are derived from R(t) so the left-endpoint gyro
    integration reproduces R exactly. `circuit`/`figure8` close the loop,
    `stops` inserts zero-velocity dwells."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    t = np.arange(0.0, duration + 0.5 / rate, 1.0 / rate)
    sig = _smooth_signal(rng, t, 3, omega_amp)
    tilt = _smooth_signal(rng, t, 3, max_tilt * 0.5)
    tilt = tilt - tilt[0]  # start level: R[0] = I
    v_body = _smooth_signal(rng, t, 3, vel_amp)
    yaw_rate = sig[:, 2]
    if figure8:
        seg = duration / (2.0 * laps)
        sign = np.where((t // seg).astype(int) % 2 == 0, 1.0, -1.0)
        yaw_rate = 0.15 * yaw_rate + sign * 2.0 * np.pi / seg
        tilt = tilt * 0.15
        v_body = v_body * 0.3
    elif circuit:
        yaw_rate = 0.15 * yaw_rate + laps * 2.0 * np.pi / duration
        tilt = tilt * 0.15
        v_body = v_body * 0.3
    v_body[:, 0] += forward_speed
    v_body[:, 2] *= 0.2  # mostly planar, like a ground robot
    if elev_amp > 0.0:
        v_body[:, 2] += elev_amp * np.sin(2.0 * np.pi * 2.0 * t / duration)
    gate = np.ones_like(t)
    if stops > 0:
        centers = np.linspace(duration * 0.25, duration * 0.75, stops)
        for c in centers:
            d = np.abs(t - c)
            half = stop_duration / 2.0
            ramp = np.clip((d - half) / 0.5, 0.0, 1.0)
            gate = np.minimum(gate, 0.5 - 0.5 * np.cos(np.pi * ramp))
        v_body = v_body * gate[:, None]
        yaw_rate = yaw_rate * gate
        tilt = tilt * gate[:, None]

    dt = 1.0 / rate
    yaw = np.concatenate([[0.0], np.cumsum(yaw_rate[:-1]) * dt])
    roll, pitch = tilt[:, 0], np.clip(tilt[:, 1], -max_tilt, max_tilt)
    R = Rotation.from_euler("zyx", np.stack([yaw, pitch, roll], axis=-1)).as_matrix()
    # exact body rates for the left-endpoint convention: R_{i+1} = R_i exp(w_i dt)
    omega = np.zeros((t.shape[0], 3))
    rel = Rotation.from_matrix(np.einsum("nji,njk->nik", R[:-1], R[1:])).as_rotvec()
    omega[:-1] = rel / dt
    omega[-1] = omega[-2]
    p = np.zeros((t.shape[0], 3))
    p[1:] = np.cumsum(np.einsum("nij,nj->ni", R[:-1], v_body[:-1]) * dt, axis=0)
    return Trajectory(t=t, R=R, p=p, omega=omega, v_body=v_body)


@dataclass
class GyroVelData:
    """Measurement container (`VelInt/types.h:75-224` GyroVelData)."""

    gyr_t: np.ndarray  # (G,)
    gyr: np.ndarray  # (G, 3)
    vel_t: np.ndarray  # (V,)
    vel: np.ndarray  # (V, 3)
    gyr_var: float
    vel_var: float


def sample_imu(
    traj: Trajectory,
    gyr_rate: float = 200.0,
    vel_rate: float = 10.0,
    gyr_std: float = 0.005,
    vel_std: float = 0.02,
    gyr_bias=(0.0, 0.0, 0.0),
    vel_bias=(0.0, 0.0, 0.0),
    seed: int = 1,
) -> GyroVelData:
    rng = np.random.default_rng(seed)
    gyr_t = np.arange(traj.t[0], traj.t[-1], 1.0 / gyr_rate)
    vel_t = np.arange(traj.t[0], traj.t[-1], 1.0 / vel_rate)
    gyr = np.stack([np.interp(gyr_t, traj.t, traj.omega[:, i]) for i in range(3)], axis=-1)
    vel = np.stack([np.interp(vel_t, traj.t, traj.v_body[:, i]) for i in range(3)], axis=-1)
    gyr = gyr + np.asarray(gyr_bias) + rng.normal(scale=gyr_std, size=gyr.shape)
    vel = vel + np.asarray(vel_bias) + rng.normal(scale=vel_std, size=vel.shape)
    return GyroVelData(
        gyr_t=gyr_t, gyr=gyr, vel_t=vel_t, vel=vel, gyr_var=gyr_std**2, vel_var=vel_std**2
    )


def make_world(seed: int = 2, n_landmarks: int = 4000, extent: float = 60.0) -> np.ndarray:
    """Static world: ground plane points + wall/box clusters; the cluster
    count scales with the world area (30 per ±60 m tile)."""
    rng = np.random.default_rng(seed)
    n_ground = n_landmarks // 3
    gx = rng.uniform(-extent, extent, size=(n_ground, 2))
    ground = np.concatenate([gx, -1.8 + 0.05 * rng.normal(size=(n_ground, 1))], axis=1)
    n_rest = n_landmarks - n_ground
    n_clusters = max(8, round(30 * (extent / 60.0) ** 2))
    centers = rng.uniform(-extent, extent, size=(n_clusters, 3))
    centers[:, 2] = np.abs(centers[:, 2]) * 0.1
    assign = rng.integers(0, n_clusters, size=n_rest)
    local = rng.normal(size=(n_rest, 3)) * np.array([3.0, 0.15, 1.5])
    rest = centers[assign] + local
    return np.concatenate([ground, rest], axis=0)


@dataclass
class DynamicObjects:
    """Moving scatterer clusters whose Doppler is inconsistent with the ego
    motion."""

    centers0: np.ndarray  # (M, 3) world position at t=0
    vel: np.ndarray  # (M, 3) world velocity
    local: np.ndarray  # (M, P, 3) per-object scatter

    def points_at(self, t: float):
        """((M*P, 3) world points, (M*P, 3) world velocities) at time t."""
        c = self.centers0 + self.vel * t
        pts = (c[:, None, :] + self.local).reshape(-1, 3)
        vel = np.repeat(self.vel, self.local.shape[1], axis=0)
        return pts, vel


def make_dynamic_objects(
    seed: int = 5,
    n_objects: int = 4,
    points_per_object: int = 40,
    extent: float = 40.0,
    speed: float = 3.0,
) -> DynamicObjects:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(n_objects, 3))
    centers[:, 2] = 0.2 + 0.3 * rng.uniform(size=n_objects)
    vel = rng.normal(size=(n_objects, 3)) * speed
    vel[:, 2] = 0.0
    local = rng.normal(size=(n_objects, points_per_object, 3)) * np.array([1.5, 0.7, 0.5])
    return DynamicObjects(centers0=centers, vel=vel, local=local)


def sample_gps(
    traj: Trajectory,
    rate: float = 2.0,
    noise_xy: float = 0.5,
    noise_z: float = 1.0,
    dropout_windows=((0.35, 0.55),),
    outlier_prob: float = 0.02,
    outlier_scale: float = 15.0,
    seed: int = 9,
):
    """GPS fixes with noise, dropout windows and occasional outliers.
    Returns (stamps (F,), xyz (F, 3), cov (F, 3))."""
    rng = np.random.default_rng(seed)
    dur = traj.t[-1] - traj.t[0]
    stamps = np.arange(traj.t[0] + 0.3, traj.t[-1] - 0.3, 1.0 / rate)
    keep = np.ones(len(stamps), bool)
    for lo, hi in dropout_windows:
        keep &= ~((stamps > traj.t[0] + lo * dur) & (stamps < traj.t[0] + hi * dur))
    stamps = stamps[keep]
    _, p = traj.interp_pose(stamps)
    noise = rng.normal(size=p.shape) * np.array([noise_xy, noise_xy, noise_z])
    out = rng.uniform(size=len(stamps)) < outlier_prob
    noise[out] += rng.normal(size=(out.sum(), 3)) * outlier_scale
    cov = np.tile(np.array([noise_xy**2, noise_xy**2, noise_z**2]), (len(stamps), 1))
    return stamps, p + noise, cov


def render_radar_scan(
    world: np.ndarray,
    R_wb: np.ndarray,
    p_w: np.ndarray,
    v_body: np.ndarray,
    max_range: float = 40.0,
    noise_xyz: float = 0.02,
    noise_doppler: float = 0.02,
    dropout: float = 0.3,
    capacity: int = 2048,
    seed: int = 3,
    dtype=np.float64,
    dynamic_points: np.ndarray | None = None,
    dynamic_vel: np.ndarray | None = None,
    azimuth_fov_deg: float | None = None,
    elevation_fov_deg: float | None = None,
    device=None,
):
    """Render one radar scan in the sensor (body) frame with per-point
    Doppler y_i = r_hat_i . (v_body - R^T u_i) (u_i = 0 for the static
    world). `azimuth_fov_deg`/`elevation_fov_deg` restrict returns to the
    radar's field of view; None keeps the omnidirectional render. Returns a
    port `PointCloud` on `device`."""
    rng = np.random.default_rng(seed)
    if dynamic_points is not None and len(dynamic_points):
        world = np.concatenate([world, dynamic_points], axis=0)
        u = np.concatenate(
            [np.zeros((world.shape[0] - len(dynamic_points), 3)), dynamic_vel], axis=0
        )
    else:
        u = np.zeros_like(world)
    local = (world - p_w) @ R_wb  # world -> body
    u_body = u @ R_wb
    r = np.linalg.norm(local, axis=-1)
    keep = (r > 0.5) & (r < max_range)
    if azimuth_fov_deg is not None:
        keep &= np.abs(np.arctan2(local[:, 1], local[:, 0])) < np.deg2rad(azimuth_fov_deg)
    if elevation_fov_deg is not None:
        rho = np.sqrt(local[:, 0] ** 2 + local[:, 1] ** 2)
        keep &= np.abs(np.arctan2(local[:, 2], np.maximum(rho, 1e-9))) < np.deg2rad(
            elevation_fov_deg
        )
    keep &= rng.uniform(size=keep.shape) > dropout
    pts = local[keep]
    u_body = u_body[keep]
    r = r[keep]
    order = rng.permutation(pts.shape[0])[:capacity]
    pts = pts[order]
    u_body = u_body[order]
    r = r[order]
    doppler = np.einsum("ni,ni->n", pts / r[:, None], v_body[None, :] - u_body)
    pts = pts + rng.normal(scale=noise_xyz, size=pts.shape)
    doppler = doppler + rng.normal(scale=noise_doppler, size=doppler.shape)
    intensity = 10.0 + 20.0 * rng.uniform(size=pts.shape[0])
    return make_cloud(
        pts.astype(dtype),
        intensity=intensity.astype(dtype),
        doppler=doppler.astype(dtype),
        capacity=capacity,
        device=device,
    )
