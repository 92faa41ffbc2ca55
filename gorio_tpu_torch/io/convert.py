"""Dataset conversion into the `.grf` sequence layout.

The port's copy of `gorio_tpu/io/convert.py` (the reference's dataset
tooling, `src/ford2bag.py`): a directory of `.grf` radar frames written by
the native runtime (`io/native.write_frame`), plus `imu.npz` (gyro and
ego-velocity streams) and an optional `groundtruth.tum`.

Accepted frame inputs per file:
  *.csv  — a header row naming at least x,y,z (intensity/doppler/power/
           velocity aliases recognised); extra columns ignored
  *.npz  — keys `xyz` (N,3) [+ `intensity`, `doppler`]
  *.npy  — (N,>=3) array, columns x y z [intensity [doppler]]
  *.pcd  — x y z [intensity] through `io/pcd.read_pcd` (doppler 0); the
           JAX package's copy does not read PCD

Frame timestamps come from the file stem when it parses as a float (e.g.
`1715000123.456.csv`), else from `rate`.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

_ALIASES = {
    "x": ("x",),
    "y": ("y",),
    "z": ("z",),
    "intensity": ("intensity", "power", "snr", "rcs"),
    "doppler": ("doppler", "velocity", "v_doppler", "radial_speed", "vr"),
}


def _read_csv_frame(path: Path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = [h.strip().lower() for h in next(reader)]
        rows = [r for r in reader if r]
    data = np.asarray(rows, dtype=np.float64)

    def col(name, default=None):
        for alias in _ALIASES[name]:
            if alias in header:
                return data[:, header.index(alias)]
        if default is None:
            raise ValueError(f"{path}: no column for '{name}' (header: {header})")
        return np.full(data.shape[0], default)

    xyz = np.stack([col("x"), col("y"), col("z")], axis=1)
    return xyz, col("intensity", 0.0), col("doppler", 0.0)


def _read_frame(path: Path):
    if path.suffix == ".csv":
        return _read_csv_frame(path)
    if path.suffix == ".npz":
        d = np.load(path)
        xyz = d["xyz"]
        n = xyz.shape[0]
        inten = d["intensity"] if "intensity" in d else np.zeros(n)
        dop = d["doppler"] if "doppler" in d else np.zeros(n)
        return xyz, inten, dop
    if path.suffix == ".npy":
        d = np.load(path)
        n, c = d.shape
        inten = d[:, 3] if c > 3 else np.zeros(n)
        dop = d[:, 4] if c > 4 else np.zeros(n)
        return d[:, :3], inten, dop
    if path.suffix == ".pcd":
        from .pcd import read_pcd

        xyz, inten = read_pcd(path)
        n = xyz.shape[0]
        return xyz, (inten if inten is not None else np.zeros(n)), np.zeros(n)
    raise ValueError(f"unsupported frame file: {path}")


def _stamp_from_stem(path: Path):
    try:
        return float(path.stem)
    except ValueError:
        return None


def convert_sequence(
    frame_paths,
    out_dir,
    *,
    imu_csv=None,
    gt_tum=None,
    rate: float = 10.0,
    t0: float = 0.0,
    min_range: float = 0.0,
    max_range: float = float("inf"),
) -> int:
    """Convert raw frames (+ optional IMU CSV `t,wx,wy,wz[,vx,vy,vz]`) into a
    .grf sequence directory. Returns the number of frames written."""
    from . import native as gn

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    frame_paths = sorted(Path(p) for p in frame_paths)
    n_written = 0
    for i, p in enumerate(frame_paths):
        xyz, inten, dop = _read_frame(p)
        r = np.linalg.norm(xyz, axis=1)
        keep = np.isfinite(r) & (r >= min_range) & (r <= max_range)
        stamp = _stamp_from_stem(p)
        if stamp is None:
            stamp = t0 + i / rate
        gn.write_frame(out / f"{i:06d}.grf", stamp, xyz[keep], inten[keep], dop[keep])
        n_written += 1

    if imu_csv is not None:
        raw = np.loadtxt(imu_csv, delimiter=",", skiprows=1, ndmin=2)
        gyr_t, gyr = raw[:, 0], raw[:, 1:4]
        if raw.shape[1] >= 7:  # ego-velocity samples alongside
            vel_t, vel = raw[:, 0], raw[:, 4:7]
        else:
            vel_t, vel = np.zeros((0,)), np.zeros((0, 3))
        np.savez(
            out / "imu.npz",
            gyr_t=gyr_t, gyr=gyr, vel_t=vel_t, vel=vel,
            gyr_var=np.asarray(1e-4), vel_var=np.asarray(1e-2),
        )

    if gt_tum is not None:
        import shutil

        shutil.copy(gt_tum, out / "groundtruth.tum")
    return n_written
