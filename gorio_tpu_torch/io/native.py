"""ctypes binding of the native `.grf` runtime (`native/src/*.cc`).

The port's own copy of the parts of `gorio_tpu/io/native.py` that its CLI
calls: `write_frame` (one `.grf` radar frame), `NativeDataset` (the
prefetching single-stage reader), `NativePipelineDataset` (the two-thread
decode -> pack reader) and `NativeKDTree` (exact k-NN on the host, the 1-NN
kernels' oracle). The C++ sources stay where they are;
`load()` compiles them with g++ at first use into `gorio_tpu_torch/_build/`
(gitignored, file name tagged by the sources' content) and binds them;
`NativeUnavailable` (a `RuntimeError`, as in the JAX package) says that the
library is not built (`load(auto_build=False)`) or that its build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FIELDS = 5  # x y z intensity doppler
_LIB = None


class NativeUnavailable(RuntimeError):
    """The native runtime is not built and may not be, or its build failed."""


def _library_path() -> Path:
    """Where the library of the current sources lives, built or not."""
    if not any(_SRC.glob("*.cc")):
        raise NativeUnavailable(f"no native sources under {_SRC}")
    digest = hashlib.sha1()
    for p in sorted(_SRC.iterdir()):
        digest.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"libgorio_native_{digest.hexdigest()[:12]}.so"


def _compiler():
    return shutil.which("g++") or shutil.which("c++")


def build_native(force: bool = False) -> Path:
    """Compile `native/src/*.cc` into `_build/` (once per source content,
    again with `force`) and return the shared library's path."""
    lib = _library_path()
    if lib.exists() and not force:
        return lib
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("building the native .grf runtime needs g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fopenmp",
         "-o", str(tmp), *map(str, sorted(_SRC.glob("*.cc")))],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ build of the native runtime failed:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(auto_build: bool = True):
    """Bind the runtime, building it first unless `auto_build` is false;
    cached per process. Raises `NativeUnavailable` where the library is
    not built and `auto_build` is false, or where its build fails."""
    global _LIB
    if _LIB is None:
        lib_path = _library_path()
        if not lib_path.exists():
            if not auto_build:
                raise NativeUnavailable(f"{lib_path.name} is not built")
            try:
                lib_path = build_native()
            except (RuntimeError, OSError) as e:
                raise NativeUnavailable(f"native build failed: {e}") from e
        lib = ctypes.CDLL(str(lib_path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gorio_write_frame.restype = I
        lib.gorio_write_frame.argtypes = [
            ctypes.c_char_p, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.gorio_pipeline_dataset_open.restype = P
        lib.gorio_pipeline_dataset_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), I, I, I, I,
        ]
        lib.gorio_pipeline_dataset_next.restype = I
        lib.gorio_pipeline_dataset_next.argtypes = [
            P, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ]
        lib.gorio_pipeline_dataset_backlog.restype = I
        lib.gorio_pipeline_dataset_backlog.argtypes = [P, I]
        lib.gorio_pipeline_dataset_close.argtypes = [P]
        lib.gorio_dataset_open.restype = P
        lib.gorio_dataset_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), I, I]
        lib.gorio_dataset_next.restype = I
        lib.gorio_dataset_next.argtypes = [
            P, ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.gorio_dataset_close.argtypes = [P]
        lib.gorio_kdtree_create.restype = P
        lib.gorio_kdtree_create.argtypes = [ctypes.POINTER(ctypes.c_float), I, I]
        lib.gorio_kdtree_knn.argtypes = [
            P, ctypes.POINTER(ctypes.c_float), I, I, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.gorio_kdtree_destroy.argtypes = [P]
        _LIB = lib
    return _LIB


def write_frame(path, stamp: float, xyz, intensity=None, doppler=None):
    """Write one .grf radar frame."""
    lib = load()
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    cols = [xyz]
    for extra in (intensity, doppler):
        cols.append(np.asarray(extra if extra is not None else np.zeros(n), np.float32)[:, None])
    data = np.ascontiguousarray(np.concatenate(cols, axis=1), np.float32)
    rc = lib.gorio_write_frame(
        str(path).encode(), float(stamp), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, FIELDS,
    )
    if rc != 0:
        raise IOError(f"failed to write {path}")


class NativeDataset:
    """Prefetching single-stage reader yielding (stamp, xyz (n, 3),
    intensity (n,), doppler (n,)), float32 copies of the frame's rows."""

    def __init__(self, paths, capacity: int = 4096, queue_depth: int = 4):
        lib = load()
        self._lib = lib
        self.capacity = capacity
        enc = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._handle = lib.gorio_dataset_open(arr, len(enc), queue_depth)
        self._buf = np.empty((capacity, FIELDS), np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        stamp = ctypes.c_double()
        while True:
            n = self._lib.gorio_dataset_next(
                self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.capacity, FIELDS, ctypes.byref(stamp),
            )
            if n == 0:
                raise StopIteration
            if n == -2:  # valid frame, zero returns (sensor dropout) — skip
                continue
            if n < 0:
                raise IOError("corrupt frame")
            data = self._buf[:n].copy()
            return stamp.value, data[:, :3], data[:, 3], data[:, 4]

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.gorio_dataset_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativePipelineDataset:
    """Two-stage native reader (decode thread -> pack thread) yielding
    (stamp, n_valid, padded), where `padded` is a reused zero-padded
    (capacity, FIELDS) float32 array: copy it if you keep it."""

    def __init__(self, paths, capacity: int = 4096, queue_depth: int = 4):
        lib = load()
        self._lib = lib
        self.capacity = capacity
        enc = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._handle = lib.gorio_pipeline_dataset_open(arr, len(enc), queue_depth, capacity,
                                                       FIELDS)
        self._buf = np.empty((capacity, FIELDS), np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        stamp = ctypes.c_double()
        while True:
            n = self._lib.gorio_pipeline_dataset_next(
                self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(stamp),
            )
            if n == 0:
                raise StopIteration
            if n == -2:  # valid frame, zero returns (sensor dropout) — skip
                continue
            if n < 0:
                raise IOError("corrupt frame")
            return stamp.value, n, self._buf

    def backlog(self, stage: int = 0) -> int:
        """Items waiting in the native pipeline's bounded queue `stage`."""
        return int(self._lib.gorio_pipeline_dataset_backlog(self._handle, stage))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.gorio_pipeline_dataset_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeKDTree:
    """Exact kd-tree k-NN over float32 points on the host (`native/src/
    kdtree.cc`): the oracle the brute-force 1-NN kernels are held to."""

    def __init__(self, points, leaf_size: int = 16):
        self._lib = load()
        pts = np.ascontiguousarray(points, dtype=np.float32)
        self._handle = self._lib.gorio_kdtree_create(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0], leaf_size)

    def knn(self, queries, k: int):
        """(idx (n, k) int32, d2 (n, k) float32), nearest first."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        n = q.shape[0]
        idx = np.empty((n, k), np.int32)
        d2 = np.empty((n, k), np.float32)
        self._lib.gorio_kdtree_knn(
            self._handle, q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return idx, d2

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gorio_kdtree_destroy(self._handle)
            self._handle = None
