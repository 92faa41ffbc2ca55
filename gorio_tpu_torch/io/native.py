"""Access to the shared native `.grf` runtime (`gorio_tpu.io.native`).

The port reads and writes sequences through the JAX package's numpy-only
`gorio_tpu.io.native` and its C++ library (`native/`), without copying
them. That module builds the library with CMake on first use; on a machine
without CMake, `native()` compiles the same sources with g++ into the same
path first.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from gorio_tpu.io import native as _native


def native():
    """The `gorio_tpu.io.native` module, with its library present or
    buildable."""
    lib = _native._BUILD / "libgorio_native.so"
    if lib.exists() or shutil.which("cmake") is not None:
        return _native
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("building the native .grf runtime needs cmake or g++")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    srcs = sorted(str(p) for p in (_native._NATIVE / "src").glob("*.cc"))
    proc = subprocess.run(
        [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fopenmp",
         "-o", str(tmp), *srcs],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ build of the native runtime failed:\n{proc.stderr}")
    os.replace(tmp, lib)
    return _native
