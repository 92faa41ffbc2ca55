"""Port parity: the JAX CLI's remaining tools and the modules under them,
against the JAX package on the same inputs, on the CPU.

- `io/lz4dec.py`: the same bytes out (or the same error) on the JAX tests'
  block and frame vectors and on the fire drill's greedy-encoded frames;
  `compress_frame` gives the JAX copy's bytes.
- `io/gps.py`: `tests/test_gps.py`'s sentences and a grid of lat / lon to
  the bit; `RadarGraphSLAM.push_nmea` gives the JAX package's `gps_queue`.
- `io/presets.py`: every preset's fields equal.
- `io/convert.py` and the `convert` CLI: CSV / NPZ / NPY frames give the
  JAX package's `.grf` bytes and `imu.npz`; PCD frames (which the JAX copy
  does not read) the bytes of the same points through it as NPZ.
- `io/native.NativeKDTree`: the JAX binding's answers (d2 within 1e-6
  relative: the two libraries' compile flags differ), and the port's
  `nn1_plain` within 1e-5 relative (indices equal but at near-ties).
- The CLI: `align-traj` prints the JAX CLI's JSON; `gt-adjust` and
  `utm-align` with `--device cpu` on `tests/test_cli_tools.py`'s cases give
  its poses within 1e-6 m, chi2 within 1e-9 relative (1e-20 absolute: the
  small circuit converges to round-off, ~1e-27) and the same iterations,
  and its T_world_utm within 1e-6 m / 1e-7 rad; a bad loop index exits;
  without a card both default to cuda and raise.
"""

import contextlib
import io
import json
import struct

import numpy as np
import pytest
import torch

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io import lz4dec as jlz4
from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.io import lz4dec as tlz4
from gorio_tpu_torch.io.tum import load_tum, save_tum

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock


def _jax_json(argv):
    """Run the JAX CLI and parse its last stdout line as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_cli(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# ---- lz4 -------------------------------------------------------------------

_MATCH = bytes([0x44]) + b"abcd" + struct.pack("<H", 4)


def _content_size_frame():
    f = struct.pack("<I", jlz4.MAGIC_FRAME) + bytes([(1 << 6) | (1 << 5) | (1 << 3), 4 << 4])
    f += struct.pack("<Q", 15) + b"\x00" + struct.pack("<I", len(_MATCH)) + _MATCH
    return f + struct.pack("<I", 0x80000000 | 3) + b"xyz" + struct.pack("<I", 0)


def _greedy_frames():
    from tool_inputs import fire_drill

    rng = np.random.default_rng(0)
    fd = fire_drill()
    payloads = [b"abcabcabcabc" * 500 + bytes(rng.integers(0, 4, 2000, dtype=np.uint8)),
                bytes(rng.integers(0, 256, 3000, dtype=np.uint8)), b"x", b"",
                np.arange(20000, dtype=np.int32).tobytes(),
                b"The quick brown fox jumps over the lazy dog. " * 4000]
    return [fd.lz4_frame(p) for p in payloads]


LZ4_BLOCKS = {
    "literals": bytes([0x50]) + b"hello",
    "match": _MATCH,
    "overlap": bytes([0x13]) + b"x" + struct.pack("<H", 1),
    "extended": bytes([0xFF, 255, 0]) + bytes(range(256)) + b"A" * 14
    + struct.pack("<H", 270) + bytes([0]),
    "bad offset": bytes([0x14]) + b"x" + struct.pack("<H", 9),
    "zero offset": bytes([0x14]) + b"x" + struct.pack("<H", 0),
    "truncated literals": bytes([0x90]) + b"shrt",
    "truncated offset": bytes([0x14]) + b"x" + b"\x01",
}
LZ4_FRAMES = {
    "own compressor": lambda: jlz4.compress_frame(
        np.random.default_rng(0).integers(0, 256, 200_000, dtype=np.uint8).tobytes()),
    "empty": lambda: jlz4.compress_frame(b""),
    "content size": _content_size_frame,
    "legacy": lambda: struct.pack("<I", jlz4.MAGIC_LEGACY) + struct.pack("<I", len(_MATCH))
    + _MATCH,
    "bad magic": lambda: struct.pack("<I", 0xDEADBEEF) + b"\x00" * 8,
    "no end mark": lambda: jlz4.compress_frame(b"data!")[:-4],
    "greedy": lambda: _greedy_frames()[0],
}


def _same_outcome(fn_j, fn_t, data):
    try:
        want = fn_j(data)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_t(data)
        assert str(got.value) == str(e)
        return None
    got = fn_t(data)
    assert got == want
    return got


@pytest.mark.parametrize("name", sorted(LZ4_BLOCKS))
def test_lz4_block_matches_jax(name):
    _same_outcome(jlz4.decompress_block, tlz4.decompress_block, LZ4_BLOCKS[name])


@pytest.mark.parametrize("name", sorted(LZ4_FRAMES))
def test_lz4_frame_matches_jax(name):
    _same_outcome(jlz4.decompress_frame, tlz4.decompress_frame, LZ4_FRAMES[name]())


def test_lz4_greedy_frames_and_compressor_match_jax():
    """The fire drill's greedy encoder's frames (match, offset and overlap
    paths) decode to the same bytes, and `compress_frame` writes the JAX
    copy's bytes."""
    for frame in _greedy_frames():
        assert tlz4.decompress_frame(frame) == jlz4.decompress_frame(frame)
    content = bytes(range(256)) * 700
    assert tlz4.compress_frame(content) == jlz4.compress_frame(content)


# ---- gps -------------------------------------------------------------------

def _with_checksum(body):
    cs = 0
    for ch in body:
        cs ^= ord(ch)
    return f"${body}*{cs:02X}"


SENTENCES = [
    _with_checksum("GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,"),
    _with_checksum("GPGGA,123520,4807.138,N,01131.100,E,1,08,0.9,,M,46.9,M,,"),
    _with_checksum("GPGGA,123521,0120.790,S,10340.848,W,0,08,0.9,12.0,M,46.9,M,,"),
    _with_checksum("GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W"),
    _with_checksum("GPRMC,123519,V,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W"),
    "$GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,*00",
    "garbage",
]


def test_gps_matches_jax():
    """`parse_nmea`, `latlon_to_utm` over both hemispheres and `GPSConverter`
    with a `utm_to_world` give the JAX copy's values to the bit."""
    from gorio_tpu.io import gps as jg
    from gorio_tpu_torch.io import gps as tg

    for s in SENTENCES:
        a, b = jg.parse_nmea(s), tg.parse_nmea(s)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.lat, a.lon, a.alt, a.quality) == (b.lat, b.lon, b.alt, b.quality)
    for lat in np.linspace(-80.0, 84.0, 9):
        for lon in np.linspace(-179.0, 179.0, 9):
            assert jg.latlon_to_utm(lat, lon) == tg.latlon_to_utm(lat, lon)
    T = np.eye(4)
    T[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]
    T[:3, 3] = [1.0, 2.0, 3.0]
    cj, ct = jg.GPSConverter(utm_to_world=T), tg.GPSConverter(utm_to_world=T)
    for lat, lon, alt, q in ((48.0, 11.0, 500.0, 1), (48.001, 11.002, None, 2),
                             (48.0, 11.0, 1.0, 0)):
        a = cj.convert(jg.GPSFix(lat, lon, alt, q))
        b = ct.convert(tg.GPSFix(lat, lon, alt, q))
        assert (a is None and b is None) or np.array_equal(a, b)


def test_push_nmea_matches_jax():
    """Both packages' `push_nmea` over the same sentences: the same return
    values and the same `gps_queue` (stamp, zeroed UTM, has_z, cov)."""
    from gorio_tpu.pipeline.slam import RadarGraphSLAM as JSlam
    from gorio_tpu_torch.pipeline.slam import RadarGraphSLAM, SLAMConfig

    js = JSlam()
    ts = RadarGraphSLAM(SLAMConfig(enable_loop_closure=False), device="cpu")
    for k, s in enumerate(SENTENCES):
        assert js.push_nmea(0.5 * k, s) == ts.push_nmea(0.5 * k, s)
    assert len(ts.gps_queue) == len(js.gps_queue) == 3
    for a, b in zip(js.gps_queue, ts.gps_queue):
        assert (a.stamp, a.has_z, a.cov) == (b.stamp, b.has_z, b.cov)
        np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(ts.gps_queue[0].xyz, 0.0)  # zeroed at the first fix


# ---- presets -----------------------------------------------------------------

def test_presets_match_jax():
    from gorio_tpu.io.presets import PRESETS as JP, get_preset as jget
    from gorio_tpu_torch.io.presets import PRESETS, get_preset

    assert sorted(PRESETS) == sorted(JP)
    for name in PRESETS:
        a, b = jget(name), get_preset(name.upper())
        for f in type(a).__dataclass_fields__:
            va, vb = getattr(a, f), getattr(b, f)
            if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, (name, f)


# ---- convert ---------------------------------------------------------------

def _frames_and_sidecars(d, rng):
    d.mkdir()
    paths = []
    for i in range(3):
        xyz = rng.normal(0.0, 20.0, (50 + i, 3))
        inten, dop = rng.uniform(0.0, 5.0, 50 + i), rng.normal(0.0, 2.0, 50 + i)
        p = d / f"{1715000000.25 + 0.1 * i:.2f}.csv"
        np.savetxt(p, np.column_stack([xyz, dop, inten]), delimiter=",",
                   header="x,y,z,velocity,power", comments="")
        paths.append(p)
    np.savez(d / "f3.npz", xyz=rng.normal(0.0, 9.0, (40, 3)), doppler=rng.normal(size=40))
    np.save(d / "f4.npy", rng.normal(0.0, 9.0, (30, 5)))
    imu = d / "imu.csv"
    np.savetxt(imu, rng.normal(size=(20, 7)) + np.arange(20)[:, None] * [1, 0, 0, 0, 0, 0, 0],
               delimiter=",", header="t,wx,wy,wz,vx,vy,vz", comments="")
    return imu


def _same_sequence(a, b):
    fa, fb = sorted(a.glob("*.grf")), sorted(b.glob("*.grf"))
    assert [p.name for p in fa] == [p.name for p in fb] and fa
    for x, y in zip(fa, fb):
        assert x.read_bytes() == y.read_bytes(), x.name
    if (a / "imu.npz").exists():
        ia, ib = np.load(a / "imu.npz"), np.load(b / "imu.npz")
        assert sorted(ia.files) == sorted(ib.files)
        for k in ia.files:
            np.testing.assert_array_equal(ia[k], ib[k])


def test_convert_cli_matches_jax(tmp_path):
    """`convert` of CSV (stamps from the stems), NPZ and NPY frames with an
    IMU CSV, a ground truth and a range gate: the JAX CLI's bytes."""
    rng = np.random.default_rng(4)
    imu = _frames_and_sidecars(tmp_path / "raw", rng)
    gt = tmp_path / "gt.tum"
    save_tum(gt, np.arange(3.0), np.tile(np.eye(4), (3, 1, 1)))
    args = [str(tmp_path / "raw" / "*"), "--imu", str(imu), "--gt", str(gt), "--rate", "4",
            "--min-range", "2.0", "--max-range", "45.0"]
    jax_cli(["convert", *args, "--output", str(tmp_path / "jax")])
    assert torch_cli(["convert", *args, "--output", str(tmp_path / "torch")]) == 5
    _same_sequence(tmp_path / "jax", tmp_path / "torch")
    assert (tmp_path / "torch" / "groundtruth.tum").read_bytes() == gt.read_bytes()
    with pytest.raises(SystemExit):
        torch_cli(["convert", str(tmp_path / "none*.csv"), "--output", str(tmp_path / "x")])


def test_convert_pcd_frames(tmp_path):
    """PCD frames (binary and ascii, with and without intensity) through
    the port give the `.grf` bytes of the same points (as the PCD reader
    gives them: ascii keeps 6 decimals) through the JAX package as NPZ
    frames."""
    from gorio_tpu.io.convert import convert_sequence as jconvert
    from gorio_tpu_torch.io.convert import convert_sequence
    from gorio_tpu_torch.io.pcd import read_pcd, write_pcd

    rng = np.random.default_rng(5)
    (tmp_path / "pcd").mkdir()
    (tmp_path / "npz").mkdir()
    for i, (binary, with_i) in enumerate(((True, True), (False, True), (True, False))):
        xyz = rng.normal(0.0, 10.0, (64, 3)).astype(np.float32)
        inten = rng.uniform(0.0, 3.0, 64).astype(np.float32) if with_i else None
        write_pcd(tmp_path / "pcd" / f"{i}.pcd", xyz, inten, binary=binary)
        xyz, inten = read_pcd(tmp_path / "pcd" / f"{i}.pcd")
        np.savez(tmp_path / "npz" / f"{i}.npz", xyz=xyz,
                 **({"intensity": inten} if with_i else {}))
    assert convert_sequence(sorted((tmp_path / "pcd").glob("*.pcd")), tmp_path / "a",
                            min_range=1.0) == 3
    jconvert(sorted((tmp_path / "npz").glob("*.npz")), tmp_path / "b", min_range=1.0)
    for x, y in zip(sorted((tmp_path / "a").glob("*.grf")), sorted((tmp_path / "b").glob("*"))):
        assert x.read_bytes() == y.read_bytes()


# ---- NativeKDTree ----------------------------------------------------------

def test_kdtree_matches_jax_binding_and_nn1_plain():
    """The port's binding answers as the JAX package's (k = 1 and 4), and
    its 1-NN is `nn1_plain`'s at float32: d2 within 1e-5 relative, indices
    equal except where two refs tie within 1e-6 relative."""
    from gorio_tpu.io.native import NativeKDTree as JTree
    from gorio_tpu_torch.io.native import NativeKDTree
    from gorio_tpu_torch.ops.nn import nn1_plain

    rng = np.random.default_rng(6)
    ref = rng.uniform(-40.0, 40.0, (3000, 3)).astype(np.float32)
    ref[1500:1600] = ref[:100]  # exact duplicates: ties
    q = (ref[rng.integers(0, 3000, 2000)] + rng.normal(0.0, 0.3, (2000, 3))).astype(np.float32)
    q[:50] = ref[:50]  # zero distances
    tree, jtree = NativeKDTree(ref), JTree(ref)
    for k in (1, 4):
        (ia, da), (ib, db) = tree.knn(q, k), jtree.knn(q, k)
        # the two libraries are built with other flags (cmake's may contract
        # the squares into FMAs): d2 within an ulp
        np.testing.assert_allclose(da, db, rtol=1e-6, atol=1e-12)
        differ = ia != ib
        np.testing.assert_allclose(((q[:, None] - ref[ib]) ** 2).sum(-1)[differ],
                                   da[differ], rtol=1e-6, atol=1e-12)
    idx, d2 = tree.knn(q, 1)
    pidx, pd2 = nn1_plain(torch.as_tensor(q), torch.as_tensor(ref))
    pidx, pd2 = pidx.numpy(), pd2.numpy()
    np.testing.assert_allclose(d2[:, 0], pd2, rtol=1e-5, atol=1e-12)
    differ = idx[:, 0] != pidx
    alt = ((q[differ] - ref[pidx[differ]]) ** 2).sum(axis=1)
    np.testing.assert_allclose(alt, d2[differ, 0], rtol=1e-6, atol=1e-12)
    assert differ.sum() > 0  # the duplicates tie


# ---- the CLI tools ---------------------------------------------------------

def test_align_traj_matches_jax(tmp_path):
    from test_cli_tools import _drifty_circuit

    poses = _drifty_circuit(40)
    stamps = np.arange(40.0)
    save_tum(tmp_path / "a.tum", stamps, poses)
    moved = poses.copy()
    moved[:, :3, 3] = 1.3 * moved[:, :3, 3] + [4.0, -2.0, 0.5]
    save_tum(tmp_path / "b.tum", stamps + 1e-4, moved)
    for scale in ([], ["--scale"]):
        args = ["align-traj", str(tmp_path / "a.tum"), str(tmp_path / "b.tum"), *scale]
        want = _jax_json([*args, "--output", str(tmp_path / "ja.tum")])
        got = torch_cli([*args, "--output", str(tmp_path / "ta.tum")])
        assert json.loads(json.dumps(got)) == want
        assert (tmp_path / "ja.tum").read_bytes() == (tmp_path / "ta.tum").read_bytes()


def test_gt_adjust_matches_jax(tmp_path):
    """`tests/test_cli_tools.py::test_gt_adjust_closes_loop`'s case."""
    from test_cli_tools import _drifty_circuit

    poses = _drifty_circuit()
    n = len(poses)
    save_tum(tmp_path / "in.tum", np.arange(n) * 0.1, poses)
    args = [str(tmp_path / "in.tum"), "--loop", f"0:{n - 1}", "--iters", "48"]
    want = _jax_json(["gt-adjust", args[0], str(tmp_path / "j.tum"), *args[1:]])
    got = torch_cli(["gt-adjust", args[0], str(tmp_path / "t.tum"), *args[1:],
                     "--device", "cpu"])
    assert (got["n_poses"], got["n_loops"], got["iterations"]) == \
        (want["n_poses"], want["n_loops"], want["iterations"])
    assert abs(got["chi2"] - want["chi2"]) <= max(1e-9 * abs(want["chi2"]), 1e-20)
    _, jp = load_tum(tmp_path / "j.tum")
    _, tp = load_tum(tmp_path / "t.tum")
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], rtol=0, atol=1e-7)
    with pytest.raises(SystemExit):
        torch_cli(["gt-adjust", args[0], str(tmp_path / "o.tum"), "--loop", "0:99",
                   "--device", "cpu"])


def _utm_case(tmp_path):
    """`tests/test_cli_tools.py::test_utm_align_recovers_transform`'s input."""
    from test_cli_tools import _rotz

    rng = np.random.default_rng(3)
    n = 40
    stamps = np.arange(n, dtype=np.float64) * 0.5
    poses = np.tile(np.eye(4), (n, 1, 1))
    t = np.linspace(0, 4 * np.pi, n)
    poses[:, 0, 3] = 30 * np.cos(t / 4)
    poses[:, 1, 3] = 20 * np.sin(t / 4)
    poses[:, 2, 3] = 0.5 * np.sin(t)
    save_tum(tmp_path / "traj.tum", stamps, poses)
    T_true = np.eye(4)
    T_true[:3, :3] = _rotz(0.7)
    T_true[:3, 3] = [385000.0, 5820000.0, 30.0]
    T_inv = np.linalg.inv(T_true)
    p_utm = (T_inv[:3, :3] @ poses[:, :3, 3].T).T + T_inv[:3, 3]
    p_utm += rng.normal(scale=0.05, size=p_utm.shape)
    with open(tmp_path / "gps.txt", "w") as f:
        f.write("# stamp east north alt var_x var_y var_z\n")
        for k in range(n):
            var = (9.0, 9.0, 9.0) if k == 5 else (0.01, 0.01, 0.02)
            f.write(f"{stamps[k]:.3f},{p_utm[k, 0]:.4f},{p_utm[k, 1]:.4f},{p_utm[k, 2]:.4f} "
                    f"{var[0]} {var[1]} {var[2]}\n" if k % 2 else
                    f"{stamps[k]:.3f} {p_utm[k, 0]:.4f} {p_utm[k, 1]:.4f} {p_utm[k, 2]:.4f}\n")
    return tmp_path / "traj.tum", tmp_path / "gps.txt"


def test_utm_align_matches_jax(tmp_path):
    traj, gps = _utm_case(tmp_path)
    args = ["utm-align", str(traj), str(gps), "--iters", "96", "--default-var", "0.02"]
    want = _jax_json(args)
    got = torch_cli([*args, "--device", "cpu", "--output", str(tmp_path / "T.txt")])
    assert got["n_pairs"] == want["n_pairs"] == 39
    assert abs(got["chi2"] - want["chi2"]) <= 1e-9 * abs(want["chi2"])
    Tg, Tw = np.asarray(got["T_world_utm"]), np.asarray(want["T_world_utm"])
    np.testing.assert_allclose(Tg[:3, 3], Tw[:3, 3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(Tg[:3, :3], Tw[:3, :3], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "T.txt"), Tg)
    (tmp_path / "few.txt").write_text("0.0 1 2 3\n0.5 1 2 3\n")
    with pytest.raises(SystemExit):
        torch_cli(["utm-align", str(traj), str(tmp_path / "few.txt"), "--device", "cpu"])


def test_tools_default_to_the_card(tmp_path, monkeypatch):
    """`gt-adjust` and `utm-align` run on cuda unless told otherwise, and
    raise where there is no card (no fallback to the CPU)."""
    from test_cli_tools import _drifty_circuit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_tum(tmp_path / "in.tum", np.arange(10.0), _drifty_circuit(10))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["gt-adjust", str(tmp_path / "in.tum"), str(tmp_path / "o.tum")])
    traj, gps = _utm_case(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["utm-align", str(traj), str(gps)])
