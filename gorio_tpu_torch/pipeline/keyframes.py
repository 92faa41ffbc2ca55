"""Keyframe records and the keyframe-decision gate.

Port of `KeyFrame` and `KeyframeUpdater` from `gorio_tpu/pipeline/keyframes.py`
(`keyframe.hpp:27`, `keyframe_updater.hpp:16-90`). Keyframes carry host-side
metadata plus the device-resident cloud; the decision runs on the host in
numpy. `save` / `load` write and read the JAX package's per-keyframe
directory (`keyframe.cpp:22-146`): a `data` text file and the cloud as a
compressed npz.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.pointcloud import PointCloud

_VECTORS = ("floor_coeffs", "utm_coord", "acceleration", "orientation")


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

    def save(self, directory: str):
        """`KeyFrame::save` (`keyframe.cpp:22-59`); the cloud is copied off
        its device."""
        os.makedirs(directory, exist_ok=True)
        est = self.optimized_pose if self.optimized_pose is not None else self.odom_scan2scan
        lines = [f"stamp {self.stamp}", "estimate"]
        lines += [" ".join(map(str, row)) for row in np.asarray(est)]
        lines.append("odom")
        lines += [" ".join(map(str, row)) for row in np.asarray(self.odom_scan2scan)]
        lines.append(f"accum_distance {self.accum_distance}")
        for name in ("floor_coeffs", "utm_coord", "altitude", "acceleration", "orientation"):
            value = getattr(self, name)
            if value is not None:
                text = str(value) if name == "altitude" else " ".join(map(str, value))
                lines.append(f"{name} {text}")
        lines.append(f"id {self.index}")
        with open(os.path.join(directory, "data"), "w") as fh:
            fh.write("".join(line + "\n" for line in lines))
        np.savez_compressed(os.path.join(directory, "cloud.npz"),
                            **{k: v.cpu().numpy() for k, v in self.cloud._asdict().items()})

    @classmethod
    def load(cls, directory: str, device="cuda") -> "KeyFrame":
        """`KeyFrame::load` (`keyframe.cpp:61-146`); the cloud goes onto
        `device`, the card unless the caller names the CPU. The estimate
        becomes `optimized_pose`."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"KeyFrame.load(device={device}): no CUDA device is available "
                               "(pass device='cpu' to load onto the CPU)")
        kf = cls(index=0, stamp=0.0, odom_scan2scan=np.eye(4), accum_distance=0.0, cloud=None)
        est = np.eye(4)
        with open(os.path.join(directory, "data")) as fh:
            lines = fh.read().splitlines()
        i = 0
        while i < len(lines):
            tok = lines[i].split()
            if tok[0] in ("estimate", "odom"):
                mat = np.array([[float(v) for v in lines[i + r + 1].split()] for r in range(4)])
                if tok[0] == "estimate":
                    est = mat
                else:
                    kf.odom_scan2scan = mat
                i += 4
            elif tok[0] in ("stamp", "accum_distance", "altitude"):
                setattr(kf, tok[0], float(tok[1]))
            elif tok[0] in _VECTORS:
                setattr(kf, tok[0], np.array([float(v) for v in tok[1:]]))
            elif tok[0] == "id":
                kf.index = int(tok[1])
            i += 1
        d = np.load(os.path.join(directory, "cloud.npz"))
        kf.cloud = PointCloud(*(torch.as_tensor(d[k], device=device) for k in PointCloud._fields))
        kf.optimized_pose = est
        return kf


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
