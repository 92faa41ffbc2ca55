"""Keyframe records and the keyframe-decision gate.

Port of `KeyFrame` and `KeyframeUpdater` from `gorio_tpu/pipeline/keyframes.py`
(`keyframe.hpp:27`, `keyframe_updater.hpp:16-90`). Keyframes carry host-side
metadata plus the device-resident cloud; the decision runs on the host in
numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.pointcloud import PointCloud


@dataclass
class KeyFrame:
    index: int
    stamp: float
    odom_scan2scan: np.ndarray  # (4,4) odometry estimate at creation
    accum_distance: float
    cloud: PointCloud
    odom_scan2map: Optional[np.ndarray] = None
    utm_coord: Optional[np.ndarray] = None
    altitude: Optional[float] = None
    floor_coeffs: Optional[np.ndarray] = None
    acceleration: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None
    trans_integrated: Optional[np.ndarray] = None  # preintegrated delta
    preint_cov: Optional[np.ndarray] = None
    optimized_pose: Optional[np.ndarray] = None  # filled after graph solve
    edge_info: Optional[np.ndarray] = None  # cached odometry-edge information


@dataclass
class KeyframeUpdater:
    """Delta-gated keyframe decision (`keyframe_updater.hpp:37-70`)."""

    delta_trans: float = 0.25
    delta_angle: float = 0.15
    delta_time: float = 1.0
    accum_distance: float = 0.0
    _prev_pose: Optional[np.ndarray] = None
    _prev_time: float = 0.0

    def decide(self, pose: np.ndarray, stamp: float) -> bool:
        if self._prev_pose is None:
            self._prev_pose = np.asarray(pose)
            self._prev_time = stamp
            return True
        delta = np.linalg.inv(self._prev_pose) @ np.asarray(pose)
        dx = float(np.linalg.norm(delta[:3, 3]))
        da = float(np.arccos(np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
        dt = stamp - self._prev_time
        if dx < self.delta_trans and da < self.delta_angle and dt < self.delta_time:
            return False
        self.accum_distance += dx
        self._prev_pose = np.asarray(pose)
        self._prev_time = stamp
        return True
