"""Dataset presets: sensor topics, IMU noise, calibration chains, UTM frames.

The port's copy of `gorio_tpu/io/presets.py`: the per-dataset settings of
the reference's `config/params_ntu.yaml` / `params_msc.yaml` (topics, IMU
noise), the NTU radar extrinsic chain (`preprocessing_nodelet_ntu.cpp:
107-130`: Radar_to_livox = RGB_to_livox * Thermal_to_RGB *
Radar_to_Thermal * Change_Radarframe) and the per-sequence `utm_to_world`
matrices (`radar_graph_slam_nodelet.cpp:187-198`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class DatasetPreset:
    name: str
    pointcloud_topic: str
    imu_topic: str
    gps_topic: str
    # IMU noise (params_*.yaml "IMU Settings")
    imu_acc_noise: float
    imu_gyr_noise: float
    imu_acc_bias_noise: float
    imu_gyr_bias_noise: float
    imu_gravity: float
    imu_rpy_weight: float
    # radar -> body extrinsic (4x4)
    T_body_radar: np.ndarray = field(default_factory=lambda: np.eye(4))
    # UTM -> world alignment for GPS priors (4x4), per sequence
    utm_to_world: Optional[np.ndarray] = None


def _ntu_radar_to_livox() -> np.ndarray:
    """The NTU calibration chain (`preprocessing_nodelet_ntu.cpp:107-130`)."""
    livox_to_rgb = np.array(
        [
            [-0.006878330000, -0.999969000000, 0.003857230000, 0.029164500000],
            [-7.737180000000e-05, -0.003856790000, -0.999993000000, 0.045695200000],
            [0.999976000000, -0.006878580000, -5.084110000000e-05, -0.19018000000],
            [0, 0, 0, 1],
        ]
    )
    thermal_to_rgb = np.array(
        [
            [0.9999526089706319, 0.008963747151337641, -0.003798822163962599, 0.18106962419014],
            [-0.008945181135788245, 0.9999481006917174, 0.004876439015823288, -0.04546324090016857],
            [0.00384233617405678, -0.004842226763999368, 0.999980894463835, 0.08046453079998771],
            [0, 0, 0, 1],
        ]
    )
    radar_to_thermal = np.array(
        [
            [0.999665, 0.00925436, -0.0241851, -0.0248342],
            [-0.00826999, 0.999146, 0.0404891, 0.0958317],
            [0.0245392, -0.0402755, 0.998887, 0.0268037],
            [0, 0, 0, 1],
        ]
    )
    change_radarframe = np.array(
        [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1.0]]
    )
    return np.linalg.inv(livox_to_rgb) @ thermal_to_rgb @ radar_to_thermal @ change_radarframe


# `radar_graph_slam_nodelet.cpp:187-198`
_UTM_TO_WORLD = {
    "loop3": np.array(
        [
            [-0.057621, 0.996222, -0.064972, -128453.624105],
            [-0.998281, -0.058194, -0.006954, 361869.958099],
            [-0.010708, 0.064459, 0.997863, -5882.237973],
            [0.0, 0.0, 0.0, 1.0],
        ]
    ),
    "loop2": np.array(
        [
            [-0.085585, 0.995774, -0.033303, -117561.214476],
            [-0.996323, -0.085401, 0.006904, 364927.287181],
            [0.004031, 0.033772, 0.999421, -6478.377842],
            [0.0, 0.0, 0.0, 1.0],
        ]
    ),
}


def ntu_preset(sequence: str = "cp") -> DatasetPreset:
    """NTU4DRadLM (`params_ntu.yaml`): Oculii Eagle radar + VectorNav IMU."""
    return DatasetPreset(
        name=f"ntu_{sequence}",
        pointcloud_topic="/radar_enhanced_pcl",
        imu_topic="/vectornav/imu",
        gps_topic="/ublox/fix",
        imu_acc_noise=0.0022281160035059417,
        imu_gyr_noise=0.00011667951042710442,
        imu_acc_bias_noise=0.00011782392708033614,
        imu_gyr_bias_noise=2.616129872371749e-06,
        imu_gravity=9.80511,
        imu_rpy_weight=0.01,
        T_body_radar=_ntu_radar_to_livox(),
        utm_to_world=_UTM_TO_WORLD.get(sequence),
    )


def msc_preset() -> DatasetPreset:
    """MSC dataset (`params_msc.yaml`): Oculii radar on `/oculii_radar/...`."""
    return DatasetPreset(
        name="msc",
        pointcloud_topic="/oculii_radar/point_cloud",
        imu_topic="/imu/data",
        gps_topic="/ublox/fix",
        imu_acc_noise=0.0022281160035059417,
        imu_gyr_noise=0.00011667951042710442,
        imu_acc_bias_noise=0.00011782392708033614,
        imu_gyr_bias_noise=2.616129872371749e-06,
        imu_gravity=9.80511,
        imu_rpy_weight=0.01,
    )


PRESETS = {
    "ntu_cp": lambda: ntu_preset("cp"),
    "ntu_nyl": lambda: ntu_preset("nyl"),
    "ntu_loop2": lambda: ntu_preset("loop2"),
    "ntu_loop3": lambda: ntu_preset("loop3"),
    "msc": msc_preset,
}


def get_preset(name: str) -> DatasetPreset:
    return PRESETS[name.lower()]()
