"""Port parity: the port's own copies of the JAX package's numpy-only
helpers — `gorio_tpu_torch.io.tum` against `gorio_tpu.io.tum` on the same
numpy trajectories, `gorio_tpu_torch.utils.profiling.StageTimer` against
`gorio_tpu.utils.profiling.StageTimer` — and the port's own build of the
native `.grf` runtime.

Tolerance: the copies run the same numpy arithmetic on the same inputs, so
the metrics agree to 1e-12 (in practice bit for bit)."""

import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.io import native as jnative
from gorio_tpu.io import tum as jtum
from gorio_tpu.utils.profiling import StageTimer as JStageTimer
from gorio_tpu_torch.io import native as tnative
from gorio_tpu_torch.io import tum as ttum
from gorio_tpu_torch.utils.profiling import StageTimer, trace

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock


def _trajectory(seed, n, noise=0.0, stamp_jitter=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.2 + stamp_jitter * rng.uniform(size=n)
    rot = Rotation.from_euler("zyx", np.cumsum(0.05 * rng.normal(size=(n, 3)), axis=0))
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = rot.as_matrix()
    poses[:, :3, 3] = np.cumsum(rng.normal(size=(n, 3)), axis=0) + noise * rng.normal(size=(n, 3))
    return t, poses


@pytest.fixture(scope="module")
def trajectories():
    gt_t, gt = _trajectory(0, 60)
    est_t, est = _trajectory(0, 60, noise=0.05, stamp_jitter=0.05)
    # a rigid offset, so that the alignment has work to do
    offset = np.eye(4)
    offset[:3, :3] = Rotation.from_euler("z", 0.3).as_matrix()
    offset[:3, 3] = [2.0, -1.0, 0.5]
    return gt_t, gt, est_t[5:], offset @ est[5:]


def test_save_and_load_tum_match_jax(trajectories, tmp_path):
    gt_t, gt, _, _ = trajectories
    ttum.save_tum(tmp_path / "t.tum", gt_t, gt)
    jtum.save_tum(tmp_path / "j.tum", gt_t, gt)
    assert (tmp_path / "t.tum").read_text() == (tmp_path / "j.tum").read_text()
    ts, tp = ttum.load_tum(tmp_path / "j.tum")
    js, jp = jtum.load_tum(tmp_path / "j.tum")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp, gt, atol=1e-12)


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches_jax(trajectories, with_scale):
    _, gt, _, est = trajectories
    src, dst = est[:, :3, 3], gt[5:, :3, 3]
    for a, b in zip(ttum.umeyama_alignment(src, dst, with_scale),
                    jtum.umeyama_alignment(src, dst, with_scale)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("align", [True, False])
def test_ate_matches_jax(trajectories, align):
    gt_t, gt, est_t, est = trajectories
    t = ttum.ate_rmse(est_t, est, gt_t, gt, align=align)
    j = jtum.ate_rmse(est_t, est, gt_t, gt, align=align)
    assert abs(t - j) <= 1e-12 * max(1.0, abs(j))
    assert t > 0


@pytest.mark.parametrize("delta", [1, 10, 100])
def test_rte_matches_jax(trajectories, delta):
    gt_t, gt, est_t, est = trajectories
    t = ttum.rte(est_t, est, gt_t, gt, delta=delta)
    j = jtum.rte(est_t, est, gt_t, gt, delta=delta)
    assert abs(t - j) <= 1e-12 * max(1.0, abs(j))
    assert (t == 0.0) == (delta >= len(est_t))


def test_stage_timer_reports_like_jax():
    t, j = StageTimer(), JStageTimer()
    for timer in (t, j):
        for name, xs in (("a", [0.001, 0.003, 0.002]), ("b", [0.5])):
            timer.samples[name].extend(xs)
    assert t.report() == j.report()
    with t.stage("c"):
        pass
    t.tic("d")
    t.toc("d")
    assert len(t.samples["c"]) == len(t.samples["d"]) == 1
    assert not t._sync


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    """`trace` profiles its block with torch.profiler and writes a Chrome
    trace into `log_dir`, as the JAX package's `trace` wraps its profiler;
    the program's spans of the block (here `run_hmc`'s) lie in it as host
    events on the profiler's clock, around the operations they enclosed."""
    from gorio_tpu_torch.inference.hmc import run_hmc

    with trace(str(tmp_path / "trace")) as log_dir:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        run_hmc(lambda q: -0.5 * torch.sum(q * q, dim=-1), torch.zeros((2, 3)), n_samples=2,
                n_leapfrog=2, adapt=False, generator=torch.Generator().manual_seed(0))
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert log_dir == str(tmp_path / "trace")
    assert any(e.get("name") == "aten::mm" for e in events)
    (run,) = [e for e in events if e.get("name") == "hmc.run"]
    assert run["cat"] == "gorio_span" and run["args"]["leapfrog_steps"] == 4
    mm = next(e for e in events if e.get("name") == "aten::mm")
    inside = [e for e in events if e.get("cat") == "cpu_op" and e["ts"] >= run["ts"]
              and e["ts"] + e["dur"] <= run["ts"] + run["dur"]]
    assert inside and mm["ts"] + mm["dur"] <= run["ts"]


def test_native_unavailable_auto_build_and_force(tmp_path, monkeypatch):
    """The JAX package's semantics (`gorio_tpu/io/native.py:25-61`) with a
    fake compiler and build directory: `load(auto_build=False)` of a
    library not built raises `NativeUnavailable`, a failed build raises it
    from its cause, `build_native` skips a built library and `force=True`
    rebuilds it. Callers catching `RuntimeError` still catch it."""
    assert issubclass(tnative.NativeUnavailable, RuntimeError)
    assert issubclass(jnative.NativeUnavailable, RuntimeError)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(tnative.NativeUnavailable, match="not built"):
        tnative.load(auto_build=False)
    monkeypatch.setattr(tnative, "_compiler", lambda: None)
    with pytest.raises(RuntimeError, match="native build failed") as err:
        tnative.load()
    assert isinstance(err.value, tnative.NativeUnavailable)
    assert "needs g++" in str(err.value.__cause__)
    calls, fake = tmp_path / "calls", tmp_path / "fakecxx"
    fake.write_text(f'#!/bin/sh\necho call >> "{calls}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(tnative, "_compiler", lambda: str(fake))
    lib = tnative.build_native()
    assert lib.exists() and lib.parent == tmp_path / "build"
    assert tnative.build_native() == lib
    assert calls.read_text().split() == ["call"]
    assert tnative.build_native(force=True) == lib
    assert calls.read_text().split() == ["call", "call"]


def test_native_runtime_builds_in_the_port_and_reads_jax_frames(tmp_path):
    """The port builds `native/src` into its own `_build/`, and its reader
    gives back, padded, what the JAX package's writer wrote."""
    lib = tnative.build_native()
    assert lib.parent == tnative.BUILD_DIR and lib.exists()
    assert jnative._BUILD not in lib.parents
    rng = np.random.default_rng(0)
    frames = []
    for i, n in enumerate((7, 40, 1)):
        xyz = rng.normal(size=(n, 3)).astype(np.float32)
        inten, dop = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
        jnative.write_frame(tmp_path / f"{i:06d}.grf", 0.5 * i, xyz, inten, dop)
        tnative.write_frame(tmp_path / f"t{i:06d}.grf", 0.5 * i, xyz, inten, dop)
        assert (tmp_path / f"{i:06d}.grf").read_bytes() == (tmp_path / f"t{i:06d}.grf").read_bytes()
        frames.append((0.5 * i, np.concatenate([xyz, inten[:, None], dop[:, None]], axis=1)))
    paths = [tmp_path / f"{i:06d}.grf" for i in range(3)]
    ds = tnative.NativePipelineDataset(paths, capacity=64)
    got = [(stamp, n, buf.copy()) for stamp, n, buf in ds]
    ds.close()
    assert len(got) == 3
    for (stamp, n, buf), (want_t, want) in zip(got, frames):
        assert stamp == want_t and n == want.shape[0]
        np.testing.assert_array_equal(buf[:n], want)
        assert not buf[n:].any()


def test_native_dataset_reads_frames_and_the_pipeline_reports_backlog(tmp_path):
    """The single-stage reader (`NativeDataset`, the stream CLI's warm-up)
    gives each frame's rows as float32 copies, as the JAX package's does;
    the two-stage reader's `backlog` counts queued items."""
    rng = np.random.default_rng(1)
    frames = []
    for i, n in enumerate((5, 33, 2, 0, 9)):
        xyz = rng.normal(size=(n, 3)).astype(np.float32)
        inten, dop = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
        tnative.write_frame(tmp_path / f"{i:06d}.grf", 0.25 * i, xyz, inten, dop)
        frames.append((0.25 * i, xyz, inten, dop))
    paths = sorted(tmp_path.glob("*.grf"))
    got = list(tnative.NativeDataset(paths, capacity=64))
    want = [f for f in frames if len(f[1])]  # an empty frame (sensor dropout) is skipped
    assert len(got) == len(want) == 4
    for (stamp, xyz, inten, dop), w in zip(got, want):
        assert stamp == w[0] and xyz.dtype == np.float32 and xyz.shape == w[1].shape
        for a, b in zip((xyz, inten, dop), w[1:]):
            np.testing.assert_array_equal(a, b)
    ds = tnative.NativePipelineDataset(paths, capacity=64, queue_depth=2)
    assert all(isinstance(ds.backlog(k), int) and 0 <= ds.backlog(k) <= 2 for k in (0, 1))
    assert len(list(ds)) == 4 and ds.backlog(0) == ds.backlog(1) == 0
    ds.close()
