"""Minimal PCD reader / writer (binary and ascii, xyz [+ intensity]).

A numpy copy of `gorio_tpu/io/pcd.py`: the files interoperate with PCL
tools and with the JAX package's reader and writer.
"""

from __future__ import annotations

import numpy as np


def write_pcd(path, xyz, intensity=None, binary: bool = True):
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    extra = intensity is not None
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS x y z{' intensity' if extra else ''}\n"
        f"SIZE 4 4 4{' 4' if extra else ''}\n"
        f"TYPE F F F{' F' if extra else ''}\n"
        f"COUNT 1 1 1{' 1' if extra else ''}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = xyz if not extra else np.concatenate(
        [xyz, np.asarray(intensity, np.float32)[:, None]], axis=1)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(fh, data, fmt="%.6f")


def read_pcd(path):
    """Returns (xyz (N, 3), intensity (N,) or None), float32."""
    with open(path, "rb") as fh:
        header = {}
        while True:
            line = fh.readline().decode("ascii", "ignore").strip()
            key = line.split(" ", 1)[0].upper()
            header[key] = line.split(" ", 1)[1] if " " in line else ""
            if key == "DATA":
                break
        n = int(header["POINTS"])
        fields = header["FIELDS"].split()
        nf = len(fields)
        if header["DATA"].startswith("binary"):
            data = np.frombuffer(fh.read(n * 4 * nf), dtype=np.float32).reshape(n, nf)
        else:
            data = np.loadtxt(fh, dtype=np.float32, max_rows=n).reshape(n, nf)
    inten = data[:, fields.index("intensity")] if "intensity" in fields else None
    return data[:, :3], inten


def voxel_centroid_downsample(xyz, res=0.1):
    """Host-side voxel-centroid downsample, the reference align apps'
    `pcl::VoxelGrid` preprocessing (`ndt_omp/apps/align.cpp:58-70`). On the
    device: `core.pointcloud.voxel_downsample`."""
    xyz = np.asarray(xyz)
    origin = xyz.min(axis=0) - 1.0
    key = np.floor((xyz - origin) / res).astype(np.int64)
    key = (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    head = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    seg = np.cumsum(head) - 1
    sums = np.zeros((seg[-1] + 1, 3))
    np.add.at(sums, seg, xyz[order])
    return (sums / np.bincount(seg)[:, None]).astype(np.float32)
