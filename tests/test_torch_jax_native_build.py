"""`tests/jax_native_build.py::ensure_built` against the race it exists
for: four processes calling it and two running the JAX package's unlocked
`gorio_tpu.io.native.load()` on the same build directory, all started at
once, in a fresh directory and in one that a lost race left with a
`CMakeCache.txt` of another source directory and no library. Every helper
process must return the library's path, whatever the unlocked builds do to
the directory around it (their own exit codes are not held: losing is theirs
to do), and the library must load once all six have ended. (Not before: an
unlocked build that wins relinks the library in place, and a load during
its link reads a short file.)"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import pytest

from jax_native_build import LIB

ROOT = Path(__file__).resolve().parents[1]

HELPER = """
import sys
from pathlib import Path
sys.path.insert(0, {tests!r})
from jax_native_build import ensure_built
assert ensure_built(build_dir={build!r}, lock_dir={lock!r}) == Path({build!r}) / {lib!r}
"""

UNLOCKED = """
from pathlib import Path
from gorio_tpu.io import native as gn
gn._BUILD = Path({build!r})
gn.load()
"""


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale cache"])
def test_concurrent_builds_all_load(tmp_path, stale):
    build, lock = tmp_path / "build", tmp_path / "lock"
    if stale:
        build.mkdir()
        (build / "CMakeCache.txt").write_text(
            f"CMAKE_CACHEFILE_DIR:INTERNAL={build}\n"
            f"CMAKE_HOME_DIRECTORY:INTERNAL={tmp_path / 'elsewhere'}\n")
    args = dict(tests=str(ROOT / "tests"), build=str(build), lock=str(lock), lib=LIB)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code.format(**args)], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in [HELPER] * 4 + [UNLOCKED] * 2]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs[:4], outs):
        assert p.returncode == 0, err[-3000:]
    assert ctypes.CDLL(str(build / LIB)).gorio_kdtree_create
    assert not list(lock.glob("jax_native_*"))
