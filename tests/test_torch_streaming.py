"""Port parity: `pipeline/streaming.py` (`StreamReport`, `stream_sequence`)
and the `stream` CLI, on `tests/test_streaming.py`'s 26-frame sequence at
capacity 512, on the CPU. No test waits on the wall clock: replays run at
>= 10x the recording's rate.

- Block mode runs the same calls as a plain loop over the frames, and as
  the port's `slam --fused`: the keyframes' odometry poses and the final
  trajectory equal theirs to the bit.
- The `stream` CLI in block mode gives the same keyframe stamps as the JAX
  CLI's `stream`, and the trajectory of the JAX CLI's `slam --fused`
  within 5 mm / 5 mrad (as `test_torch_slice.py`: the RANSAC hypotheses
  come from torch's generator, not `jax.random`, and the LM stops anywhere
  inside its convergence box). The JAX CLI's own `stream` pushes each
  frame's ego velocity on top of the dataset's twist stream, whose
  unsorted stamps then break the preintegration windows: its trajectory
  ends far from its `slam --fused` one (ROADMAP Queue C); the port pushes
  them only where the dataset ships no twist, as `slam` does. The JAX runs
  get their reader's frames as float64, as the port uploads them: on
  float32 frames the JAX fused LM ends millimetres from its own float64
  run (ROADMAP Queue C).
- The counterparts of `tests/test_streaming.py`: drop-mode invariants (and
  the frames a drop run kept, through a plain loop, give its keyframes to
  the bit), the report's JSON keys (the JAX package's), producer errors
  reaching the consumer, async optimize cycles.
- `stream --floor` fits the ground only, as the JAX CLI's does; a GPS fix
  pushed while `_flush_gps_queue` reads the queue survives."""

import json

import numpy as np
import pytest
import torch

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io.tum import load_tum
from gorio_tpu.pipeline.streaming import StreamReport as JReport
from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.io.native import write_frame
from gorio_tpu_torch.io.synthetic import (make_world, render_radar_scan, sample_imu,
                                          simulate_trajectory)
from gorio_tpu_torch.pipeline.odometry import OdometryConfig, ScanMatchingOdometry
from gorio_tpu_torch.pipeline.slam import RadarGraphSLAM, SLAMConfig
from gorio_tpu_torch.pipeline.streaming import StreamReport, stream_sequence

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock

CAP = 512
STREAM = ["--rate-multiplier", "10", "--capacity", str(CAP), "--no-loops", "--no-warmup"]
SLAM = ["--fused", "--capacity", str(CAP), "--no-loops"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small tensors run fastest on one CPU thread, and the test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def tiny_sequence(tmp_path_factory):
    """`tests/test_streaming.py`'s sequence, through the port's generator."""
    out = tmp_path_factory.mktemp("stream_seq")
    traj = simulate_trajectory(seed=3, duration=3.0)
    imu = sample_imu(traj, seed=4)
    world = make_world(seed=5, n_landmarks=3000)
    for i, t in enumerate(np.arange(0.2, 2.8, 0.1)):
        R, p = traj.interp_pose(np.array([t]))
        v = np.stack([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        cloud = render_radar_scan(world, R[0], p[0], v, capacity=CAP, seed=100 + i)
        m = cloud.mask.numpy()
        write_frame(out / f"{i:06d}.grf", float(t), cloud.xyz.numpy()[m],
                    cloud.intensity.numpy()[m], cloud.doppler.numpy()[m])
    np.savez(out / "imu.npz", gyr_t=imu.gyr_t, gyr=imu.gyr, vel_t=imu.vel_t, vel=imu.vel,
             gyr_var=imu.gyr_var, vel_var=imu.vel_var)
    return out


@pytest.fixture(scope="module")
def cli_runs(tiny_sequence, tmp_path_factory):
    """Both `stream` CLIs in block mode with `--output` and `--report-out`,
    and both `slam --fused` CLIs."""
    import gorio_tpu.io.native as jnative

    d = tmp_path_factory.mktemp("stream_cli")

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        jax_cli(["stream", "--dataset", str(tiny_sequence), *STREAM, "--output",
                 str(d / "jax.tum"), "--report-out", str(d / "jax.json")])
        jax_cli(["slam", "--dataset", str(tiny_sequence), *SLAM, "--output",
                 str(d / "jax_slam.tum")])
    report, slam, odo = torch_cli(["stream", "--dataset", str(tiny_sequence), *STREAM,
                                   "--output", str(d / "torch.tum"), "--report-out",
                                   str(d / "torch.json"), "--device", "cpu"])
    torch_cli(["slam", "--dataset", str(tiny_sequence), *SLAM, "--output",
               str(d / "torch_slam.tum"), "--device", "cpu"])
    return d, report, slam


def _backend(seq):
    imu = np.load(seq / "imu.npz")
    slam = RadarGraphSLAM(SLAMConfig(enable_loop_closure=False, enable_preintegration=False),
                          device="cpu")
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        slam.push_imu(t, g)
    return imu, slam


def _stream(seq, frames=None, **kw):
    imu, slam = _backend(seq)
    frames = sorted(seq.glob("*.grf")) if frames is None else frames
    report = stream_sequence(frames, slam, ScanMatchingOdometry(OdometryConfig()),
                             imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]}, capacity=CAP, **kw)
    return report, slam


def test_stream_cli_block_mode(cli_runs):
    """Block mode loses nothing and accounts every frame's deadline."""
    _, report, _ = cli_runs
    assert report.n_frames == report.n_processed == 26 and report.n_dropped == 0
    assert report.mode == "block" and report.n_keyframes > 10
    assert report.latency_p50_ms > 0 and 0.0 <= report.on_time_frac <= 1.0
    assert report.recording_s > 2.0 and report.realtime_factor > 0
    assert report.period_ms == pytest.approx(10.0)  # 0.1 s frames replayed 10x


def _gap(a, b):
    dpos = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", b[:, :3, :3], a[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    return dpos.max(), dang.max()


def test_stream_cli_matches_jax(cli_runs):
    d, report, slam = cli_runs
    jrep = json.loads((d / "jax.json").read_text())
    trep = json.loads((d / "torch.json").read_text())
    assert list(trep) == list(jrep) == list(JReport().__dict__)
    for key in ("n_frames", "n_processed", "n_dropped", "n_keyframes", "n_loops", "mode",
                "recording_s", "period_ms"):
        assert trep[key] == jrep[key], key
    js, jp = load_tum(d / "jax_slam.tum")
    ts, tp = load_tum(d / "torch.tum")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ts, load_tum(d / "jax.tum")[0])
    assert len(ts) == len(slam.keyframes) == report.n_keyframes
    dpos, dang = _gap(tp, jp)
    assert dpos < 5e-3 and dang < 5e-3, (dpos, dang)
    # the JAX CLI's stream, twists pushed twice, ends far from its slam
    assert _gap(load_tum(d / "jax.tum")[1], jp)[0] > 0.05


def test_block_stream_equals_a_plain_loop(tiny_sequence, cli_runs):
    """The CLI's block-mode stream against the same calls in a plain loop
    (frames uploaded as float64, `step_fused` with the same seeded
    generator, `add_frame`, then the final `optimize`) and against the
    port's `slam --fused`."""
    from gorio_tpu_torch.io.native import NativePipelineDataset

    d, _, slam = cli_runs
    imu = np.load(tiny_sequence / "imu.npz")
    ref = RadarGraphSLAM(slam.cfg, device="cpu")
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        ref.push_imu(t, g)
    for t, v in zip(imu["vel_t"], imu["vel"]):
        ref.push_twist(t, v)
    odo = ScanMatchingOdometry(OdometryConfig())
    gen = torch.Generator()
    gen.manual_seed(0)
    gyr_t, gyr = np.asarray(imu["gyr_t"]), np.asarray(imu["gyr"])
    for stamp, n, packed in NativePipelineDataset(sorted(tiny_sequence.glob("*.grf")),
                                                  capacity=CAP):
        omega = gyr[np.clip(np.searchsorted(gyr_t, stamp) - 1, 0, gyr_t.size - 1)]
        pose, _ = odo.step_fused(float(stamp), torch.tensor(packed, dtype=torch.float64), n,
                                 omega=omega, generator=gen)
        ref.add_frame(float(stamp), odo.last_cloud, pose)  # the dataset ships twists
    assert len(ref.keyframes) == len(slam.keyframes)
    for a, b in zip(ref.keyframes, slam.keyframes):
        assert a.stamp == b.stamp
        np.testing.assert_array_equal(a.odom_scan2scan, b.odom_scan2scan)
    ref.optimize()
    np.testing.assert_array_equal(ref.trajectory()[1], slam.trajectory()[1])
    np.testing.assert_array_equal(load_tum(d / "torch_slam.tum")[1], load_tum(d / "torch.tum")[1])


def test_stream_drop_mode_under_pressure(tiny_sequence):
    """At 50x the recording's rate the drop-mode producer never stalls:
    every frame is processed or counted as dropped. The frames it kept, fed
    through a plain loop of the same calls, give its keyframes to the bit:
    each reaches the frontend with its own stamp and points."""
    from gorio_tpu_torch.io.native import NativePipelineDataset

    frames = sorted(tiny_sequence.glob("*.grf"))
    imu, slam = _backend(tiny_sequence)
    odo = ScanMatchingOdometry(OdometryConfig())
    stamps = []
    step_fused = odo.step_fused

    def recording_step(stamp, *args, **kwargs):
        stamps.append(float(stamp))
        return step_fused(stamp, *args, **kwargs)

    odo.step_fused = recording_step
    gen = torch.Generator()
    gen.manual_seed(0)
    report = stream_sequence(frames, slam, odo, imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]},
                             capacity=CAP, rate_multiplier=50.0, mode="drop", generator=gen)
    assert report.n_frames == 26 and report.mode == "drop"
    assert report.n_processed + report.n_dropped == 26 and report.n_dropped > 0
    assert len(stamps) == report.n_processed and stamps == sorted(stamps)

    imu, ref = _backend(tiny_sequence)
    odo = ScanMatchingOdometry(OdometryConfig())
    gen.manual_seed(0)
    gyr_t, gyr = np.asarray(imu["gyr_t"]), np.asarray(imu["gyr"])
    for stamp, n, packed in NativePipelineDataset(frames, capacity=CAP):
        if float(stamp) not in stamps:
            continue
        omega = gyr[np.clip(np.searchsorted(gyr_t, stamp) - 1, 0, gyr_t.size - 1)]
        pose, v = odo.step_fused(float(stamp), torch.tensor(packed, dtype=torch.float64), n,
                                 omega=omega, generator=gen)
        ref.push_twist(float(stamp), v)  # `_backend` pushes no twist stream
        ref.add_frame(float(stamp), odo.last_cloud, pose)
    assert [kf.stamp for kf in ref.keyframes] == [kf.stamp for kf in slam.keyframes]
    for a, b in zip(ref.keyframes, slam.keyframes):
        np.testing.assert_array_equal(a.odom_scan2scan, b.odom_scan2scan)


def test_stream_report_json_roundtrip():
    report = StreamReport(n_frames=3, n_processed=2, n_dropped=1, latency_p95_ms=12.5,
                          mode="drop")
    d = json.loads(report.to_json())
    assert list(d) == list(JReport().__dict__)
    assert StreamReport(**d) == report


def test_stream_producer_error_propagates(tiny_sequence, tmp_path):
    """A corrupt frame mid-stream surfaces in the consumer, not a hang."""
    frames = sorted(tiny_sequence.glob("*.grf"))[:5]
    bad = tmp_path / "bad.grf"
    bad.write_bytes(b"\x00" * 16)  # invalid magic, truncated
    with pytest.raises(IOError, match="corrupt frame"):
        _stream(tiny_sequence, frames[:2] + [bad] + frames[2:], rate_multiplier=50.0)


def test_stream_async_optimize(tiny_sequence):
    """Optimize cycles run on the worker thread beside the ingest, counted
    and timed, and their poses land on the keyframes they covered."""
    frames = sorted(tiny_sequence.glob("*.grf"))[:14]
    report, slam = _stream(tiny_sequence, frames, rate_multiplier=10.0, optimize_every=3,
                           optimize_async=True)
    assert report.n_processed == 14
    assert report.n_opt_cycles >= 1 and report.opt_max_ms > 0
    assert report.n_opt_cycles + report.n_opt_skipped >= 1
    assert any(kf.optimized_pose is not None for kf in slam.keyframes)


def test_stream_floor_fits_the_ground_only(tiny_sequence, tmp_path):
    """`stream --floor` fits the ground in each frame and leaves the back
    end's floor constraint off, as the JAX CLI's `stream` does
    (`gorio_tpu/cli.py` `cmd_stream` builds its `SLAMConfig` without it)."""
    for f in sorted(tiny_sequence.glob("*.grf"))[:4]:
        (tmp_path / f.name).symlink_to(f)
    (tmp_path / "imu.npz").symlink_to(tiny_sequence / "imu.npz")
    report, slam, odo = torch_cli(["stream", "--dataset", str(tmp_path), "--floor", *STREAM,
                                   "--device", "cpu"])
    assert report.n_processed == 4
    assert not slam.cfg.enable_floor_constraint
    assert odo.last_ground_count > 0
    assert any(kf.floor_coeffs is not None for kf in slam.keyframes)


def test_gps_fix_pushed_during_flush_survives():
    """A `push_gps` from another thread that lands while `_flush_gps_queue`
    reads the queue: every fix newer than the newest keyframe stays queued.
    Each read of the queue starts one push on a second thread and gives it
    0.5 s to land (where a lock guards the queue, the push waits for the
    lock instead), so the push falls inside the flush's read every time."""
    import threading

    from gorio_tpu_torch.pipeline.keyframes import KeyFrame

    slam = RadarGraphSLAM(SLAMConfig(enable_loop_closure=False), device="cpu")
    kfs = [KeyFrame(index=k, stamp=float(k), odom_scan2scan=np.eye(4), accum_distance=0.0,
                    cloud=None) for k in range(3)]
    pushers = []

    class PushWhileRead(list):
        def __iter__(self):
            items = list(list.__iter__(self))
            th = threading.Thread(target=slam.push_gps, args=(10.0 + len(pushers), np.zeros(3)))
            pushers.append(th)
            th.start()
            th.join(timeout=0.5)
            return iter(items)

    slam.push_gps(1.0, np.zeros(3))
    slam.push_gps(5.0, np.zeros(3))
    slam.gps_queue = PushWhileRead(slam.gps_queue)
    slam._flush_gps_queue(lambda kf: np.eye(4), kfs)
    for th in pushers:
        th.join()
    assert len(pushers) >= 2
    assert sorted(g.stamp for g in slam.gps_queue) == [5.0] + [10.0 + k for k in
                                                             range(len(pushers))]
