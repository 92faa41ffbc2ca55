"""Port parity: `io/rosbag.py` and the rosbag -> `slam` path, against the
JAX package on the same bags, on the CPU.

- The reader on `tests/test_rosbag.py`'s `write_test_bag` in its three
  compressions, and on the fire drill's independent writer (chunks
  alternating bz2 / greedy LZ4 / none, index and chunk-info records): the
  same messages, field for field, and the same `topics_summary`; the
  PointCloud2 decoder on plain and row-padded clouds, and its big-endian
  refusal.
- `convert_rosbag` of a bag built by `tests/tool_inputs.build_slice_bag`
  from `tests/test_streaming.py`'s 26-frame sequence (stamps from 1.6e9 s):
  byte-equal `.grf` files and equal `imu.npz` / `gps.npz` arrays; against
  the frames the bag came from, the same point counts, doppler and
  intensity to the bit, points within two float32 roundings (2^-22 of
  their range) and stamps within 1e-6 s.
- `convert-bag` -> `slam --device cpu --preint ugpm --capacity 512` with a
  `--config` tree that lowers the GPS drift gate to 0 (so the fixes become
  GPS edges), against the JAX CLI on the same converted directory (its
  reader's frames as float64, the port's RANSAC hypotheses JAX's own draws,
  as `tests/test_torch_cg.py` does): the same keyframe stamps, the
  trajectories within 1e-6 m, the same GPS gate counts and edges. The port
  on the same bag with stamps from 0 gives the same keyframes (shifted) and
  odometry, and the trajectory within 5e-5 m (the stamps' float64 quantum
  at 1.6e9 s moves the preintegration windows).
- `visualize` of the port's `export_markers` JSON, trajectory, ground truth
  and `--map` writes the PNG the JAX package's `render_run` writes.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io import rosbag as jbag
from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.io import rosbag as tbag
from gorio_tpu_torch.io.tum import load_tum

import tool_inputs as ti
from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock

CAP = 512
GPS_PERIOD = 0.5  # s: six fixes over the 2.5 s between the first and last frames


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_value(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_value(a[k], b[k])
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for f in a.__dataclass_fields__:
            _same_value(getattr(a, f), getattr(b, f))
    else:
        assert a == b


def _same_messages(bag, topics=None):
    want = list(jbag.RosbagReader(bag, topics=topics))
    got = list(tbag.RosbagReader(bag, topics=topics))
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert (a.topic, a.msgtype, a.stamp) == (b.topic, b.msgtype, b.stamp)
        _same_value(a.msg, b.msg)
    assert tbag.RosbagReader(bag).topics_summary() == jbag.RosbagReader(bag).topics_summary()
    return got


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_reader_matches_jax(tmp_path, compression):
    from test_rosbag import write_test_bag

    write_test_bag(tmp_path / "t.bag", compression=compression, n_frames=6)
    msgs = _same_messages(tmp_path / "t.bag")
    assert {m.topic for m in msgs} == {"/radar_enhanced_pcl", "/imu/data", "/twist", "/fix"}
    assert [m.topic for m in _same_messages(tmp_path / "t.bag", ["/imu/data"])] == \
        ["/imu/data"] * 6


def _pc2(h, w, pad=0, bigendian=False, seed=7):
    from test_rosbag import _ros_header, _string

    pts = np.random.default_rng(seed).normal(size=(h * w, 4)).astype(np.float32)
    point_step = 16
    row_step = w * point_step + pad
    rows = b"".join(pts[r * w:(r + 1) * w].tobytes() + b"\xee" * pad for r in range(h))
    payload = _ros_header(2.0) + struct.pack("<II", h, w) + struct.pack("<I", 4)
    for i, name in enumerate(["x", "y", "z", "doppler"]):
        payload += _string(name) + struct.pack("<IBI", i * 4, 7, 1)
    payload += bytes([bigendian]) + struct.pack("<II", point_step, row_step)
    return payload + struct.pack("<I", len(rows)) + rows + b"\x01"


def test_pointcloud2_matches_jax():
    for h, w, pad in ((1, 10, 0), (3, 4, 8)):
        _same_value(jbag.decode_pointcloud2(_pc2(h, w, pad)),
                    tbag.decode_pointcloud2(_pc2(h, w, pad)))
    with pytest.raises(ValueError, match="big-endian"):
        tbag.decode_pointcloud2(_pc2(1, 4, bigendian=True))
    np.testing.assert_array_equal(tbag.radar_to_livox_extrinsic(),
                                  jbag.radar_to_livox_extrinsic())


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """`tests/test_streaming.py`'s 26-frame sequence with its ground truth,
    written as the fire drill's bag with stamps from 1.6e9 s and from 0,
    each converted by both CLIs."""
    from gorio_tpu_torch.io.native import write_frame
    from gorio_tpu_torch.io.synthetic import (make_world, render_radar_scan, sample_imu,
                                              simulate_trajectory)
    from gorio_tpu_torch.io.tum import save_tum

    d = tmp_path_factory.mktemp("bag")
    seq = d / "seq"
    seq.mkdir()
    traj = simulate_trajectory(seed=3, duration=3.0)
    imu = sample_imu(traj, seed=4)
    world = make_world(seed=5, n_landmarks=3000)
    for i, t in enumerate(np.arange(0.2, 2.8, 0.1)):
        R, p = traj.interp_pose(np.array([t]))
        v = np.stack([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        cloud = render_radar_scan(world, R[0], p[0], v, capacity=CAP, seed=100 + i)
        m = cloud.mask.numpy()
        write_frame(seq / f"{i:06d}.grf", float(t), cloud.xyz.numpy()[m],
                    cloud.intensity.numpy()[m], cloud.doppler.numpy()[m])
    np.savez(seq / "imu.npz", gyr_t=imu.gyr_t, gyr=imu.gyr, vel_t=imu.vel_t, vel=imu.vel,
             gyr_var=imu.gyr_var, vel_var=imu.vel_var)
    gt = np.zeros((traj.t.shape[0], 4, 4))
    gt[:, :3, :3], gt[:, :3, 3], gt[:, 3, 3] = traj.R, traj.p, 1.0
    save_tum(seq / "groundtruth.tum", traj.t, gt)
    info = {}
    for name, t_base in (("epoch", ti.T_BASE), ("zero", 0.0)):
        (d / name).mkdir()
        info[name] = ti.build_slice_bag(seq, d / name / "slice.bag", t_base=t_base,
                                        gps_period=GPS_PERIOD)
        jax_cli(["convert-bag", str(d / name / "slice.bag"), "--output",
                 str(d / name / "jax"), *ti.CONVERT_FLAGS])
        assert torch_cli(["convert-bag", str(d / name / "slice.bag"), "--output",
                          str(d / name / "torch"), *ti.CONVERT_FLAGS]) == 26
    return d, info


def test_fire_drill_bag_reads_as_jax(bags):
    d, info = bags
    msgs = _same_messages(d / "epoch" / "slice.bag")
    assert len(msgs) == 26 + info["epoch"]["imu"] + info["epoch"]["twist"] + info["epoch"]["gps"]
    summary = torch_cli(["convert-bag", str(d / "epoch" / "slice.bag"), "--list-topics"])
    assert summary[ti.TOPICS["radar"]] == ("sensor_msgs/PointCloud", 26)
    assert summary[ti.TOPICS["gps"]] == ("sensor_msgs/NavSatFix", info["epoch"]["gps"])


@pytest.mark.parametrize("name", ["epoch", "zero"])
def test_convert_bag_matches_jax(bags, name):
    d, info = bags
    a, b = d / name / "jax", d / name / "torch"
    fa, fb = sorted(a.glob("*.grf")), sorted(b.glob("*.grf"))
    assert [p.name for p in fa] == [p.name for p in fb] and len(fb) == 26
    for x, y in zip(fa, fb):
        assert x.read_bytes() == y.read_bytes(), x.name
    for side in ("imu.npz", "gps.npz"):
        za, zb = np.load(a / side), np.load(b / side)
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    gaps = ti.frame_gaps(d / "seq", b, t_base=ti.T_BASE if name == "epoch" else 0.0)
    assert gaps["counts_equal"] and gaps["bits_equal"] and gaps["frames"] == 26
    assert gaps["xyz_rel_gap"] <= 2.0 ** -22 and gaps["stamp_gap_s"] <= 1e-6, gaps
    # the fixes, zeroed at the first, are the ground truth in the first frame's pose
    gps = np.load(b / "gps.npz")
    assert len(gps["t"]) == info[name]["gps"] == 6
    np.testing.assert_array_equal(gps["xyz"][0], 0.0)


@pytest.fixture(scope="module")
def slam_runs(bags):
    """Both CLIs' `slam --preint ugpm` on the converted epoch bag, with
    JAX's RANSAC draws in the port, and the port on the zero-stamp bag."""
    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as jslam
    from gorio_tpu.core.pointcloud import PointCloud as JCloud
    from gorio_tpu.estimators import egovel as je
    from gorio_tpu_torch.estimators import egovel as te
    from test_torch_egovel import _jax_hypotheses

    d, _ = bags
    ti.write_bag_config(torch_cli, d / "config.json")
    args = ["--capacity", str(CAP), "--preint", "ugpm", "--config", str(d / "config.json")]
    made = []

    class Caught(jslam.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    estimate = te.estimate_ego_velocity

    def with_jax_draws(cloud, ecfg, generator=None, hyp_idx=None):
        """The JAX CLI's draw for this frame: its key chain, its gate."""
        keys[0], sub = jax.random.split(keys[0])
        jcloud = JCloud(*(jnp.asarray(x.cpu().numpy()) for x in cloud))
        hyp = _jax_hypotheses(jcloud, je.EgoVelConfig(**ecfg._asdict()), sub)
        return estimate(cloud, ecfg, hyp_idx=torch.as_tensor(np.array(hyp)))

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        mp.setattr(jslam, "RadarGraphSLAM", Caught)
        mp.setattr(te, "estimate_ego_velocity", with_jax_draws)
        jax_cli(["slam", "--dataset", str(d / "epoch" / "jax"), "--output",
                 str(d / "jax.tum"), *args])
        runs["jax"] = made[0]
        for name in ("epoch", "zero"):
            keys = [jax.random.PRNGKey(0)]
            runs[name] = torch_cli(["slam", "--dataset", str(d / name / "torch"), "--output",
                                    str(d / f"{name}.tum"), "--map", str(d / f"{name}.npz"),
                                    *args, "--device", "cpu"])[0]
    return d, runs


def test_bag_slam_matches_jax(slam_runs):
    d, runs = slam_runs
    js, jp = load_tum(d / "jax.tum")
    ts, tp = load_tum(d / "epoch.tum")
    np.testing.assert_array_equal(ts, js)
    assert ts[0] >= ti.T_BASE
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    fix_t = np.load(d / "epoch" / "torch" / "gps.npz")["t"]
    gates = ti.gps_gates(runs["epoch"], fix_t)
    assert gates == ti.gps_gates(runs["jax"], fix_t) and gates["gps_edges"] >= 2, gates


def test_bag_slam_epoch_equals_zero_stamps(slam_runs):
    """The same frames with stamps from 1.6e9 s and from 0: the same
    keyframes (stamps within one float64 quantum at 1.6e9 s, 2^-22 s) and
    GPS edges, the odometry within 1e-9 m. The preintegration windows move
    with the stamps' quantum, and UGPM's deltas with them by up to ~1e-5 m,
    so the optimised trajectories agree within 5e-5 m only (both packages
    alike: ROADMAP Queue C)."""
    d, runs = slam_runs
    es, ep = load_tum(d / "epoch.tum")
    zs, zp = load_tum(d / "zero.tum")
    np.testing.assert_allclose(es - ti.T_BASE, zs, rtol=0, atol=2.0 ** -22)
    for a, b in zip(runs["epoch"].keyframes, runs["zero"].keyframes, strict=True):
        np.testing.assert_allclose(a.odom_scan2scan, b.odom_scan2scan, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ep, zp, rtol=0, atol=5e-5)
    assert ti.gps_gates(runs["epoch"]) == ti.gps_gates(runs["zero"])


def test_visualize_matches_jax(slam_runs):
    """`visualize` with every layer writes the PNG of the JAX package's
    `render_run` on the same files."""
    import matplotlib.image as mpimg

    from gorio_tpu.utils.viz import render_run as jrender

    d, runs = slam_runs
    runs["epoch"].export_markers(str(d / "markers.json"))
    layers = dict(markers_json=str(d / "markers.json"), trajectory_tum=str(d / "epoch.tum"),
                  groundtruth_tum=str(d / "epoch" / "groundtruth.tum"),
                  map_npz=str(d / "epoch.npz"))
    out = torch_cli(["visualize", "--output", str(d / "torch.png"), "--markers",
                     layers["markers_json"], "--trajectory", layers["trajectory_tum"],
                     "--groundtruth", layers["groundtruth_tum"], "--map", layers["map_npz"],
                     "--title", "bag"])
    assert out == str(d / "torch.png")
    jrender(str(d / "jax.png"), title="bag", **layers)
    a, b = mpimg.imread(d / "torch.png"), mpimg.imread(d / "jax.png")
    assert a.shape == b.shape and a.shape[0] > 500
    np.testing.assert_array_equal(a, b)
