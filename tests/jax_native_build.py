"""Build the JAX package's native library (`native/build/libgorio_native.so`)
once per tree, safely from many processes at once.

The JAX package builds it on first use (`gorio_tpu/io/native.py`
`build_native`): `cmake` and `cmake --build` in the fixed directory
`native/build/`, with no lock and nothing written atomically. Under
`pytest -n 6` every xdist worker imports every test module while it
collects, so `tests/test_native.py` (which calls `load()` at import) runs
six configures in that one directory at once; they fail, leave a cache that
no later configure there gets past, and every test that reaches the JAX
package's reader then fails with its `NativeUnavailable`.

`ensure_built()` builds under an exclusive `flock` instead, in a private
directory, with the reference's own cmake commands (its `_BUILD` points
there for the length of one `build_native()` call), and moves the finished
library into the build directory with `os.replace`. A build directory that a
lost race left broken is never configured again: only its `.so` is written.

The port's test modules that reach the JAX native runtime call it at module
level. A conftest hook would be the usual place, but the repo's
`conftest.py` and `pytest.ini` belong to the JAX reference and stay as they
are; and since every xdist worker imports every test module before the first
test runs, a call at import has the library in place before any test of any
worker, the JAX package's own `test_streaming.py` and `test_rosbag.py`
included. A failed build prints cmake's stderr and returns, so that a
collection error does not throw whole modules away: the tests that need the
library then fail with the reference's `NativeUnavailable`.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import sys
import tempfile
import traceback
from pathlib import Path

from gorio_tpu.io import native as jnative

LIB = "libgorio_native.so"
LOCK_DIR = Path(__file__).resolve().parents[1] / "gorio_tpu_torch" / "_build"


def ensure_built(build_dir=None, lock_dir=None) -> Path | None:
    """Return the path of `<build_dir>/libgorio_native.so` once it exists,
    building it if need be (`build_dir` defaults to the JAX package's
    `native/build/`, `lock_dir` to the port's gitignored `_build/`); None
    if the build failed."""
    build_dir = Path(build_dir or jnative._BUILD)
    lock_dir = Path(lock_dir or LOCK_DIR)
    lib = build_dir / LIB
    if lib.exists():
        return lib
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = Path(tempfile.mkdtemp(prefix="jax_native_", dir=lock_dir))
        saved = jnative._BUILD
        try:
            jnative._BUILD = tmp
            try:
                built = jnative.build_native()
            finally:
                jnative._BUILD = saved
            build_dir.mkdir(parents=True, exist_ok=True)
            os.replace(built, lib)
        except Exception as e:  # noqa: BLE001 - reported, never raised at import
            err = getattr(e, "stderr", None) or b""
            print(f"building {lib} failed:\n{traceback.format_exc()}"
                  f"{err.decode(errors='replace')}", file=sys.stderr)
            return None
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return lib
