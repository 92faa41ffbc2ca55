"""Dependency-free rosbag (v2.0) reader and NTU4DRadLM-style converter.

The port's copy of `gorio_tpu/io/rosbag.py` (stdlib struct / bz2 and
numpy). The reference validates on NTU4DRadLM rosbags
(`launch/rosbag_play_ntu.launch:10-22`); its preprocessing nodelet reads
`sensor_msgs/PointCloud` messages whose channels carry Doppler (channel 0)
and power (channel 2) (`apps/preprocessing_nodelet_ntu.cpp:370-412`) and
rotates each point through the `Radar_to_livox` extrinsic chain (`:107-130`,
translation zeroed at `:389-394`). `convert_rosbag` writes such a bag as a
`.grf` sequence (plus `imu.npz` / `gps.npz`) through the port's
`io/native.write_frame` and `io/gps`.

Format notes (rosbag V2.0): the file is a sequence of records
  u32 header_len | header | u32 data_len | data
where `header` is a list of fields `u32 len | name=value(binary)`. Record
kinds are identified by the `op` field: 0x03 bag header, 0x05 chunk (whose
data is itself a record stream, possibly bz2/lz4-compressed), 0x07
connection, 0x02 message data, 0x04 index, 0x06 chunk info. Records are
scanned in order, descending into chunks: no index is needed, and
truncated bags read up to the cut. LZ4 chunks always go through the
pure-Python `io/lz4dec.py` (the JAX package's copy prefers the `lz4`
binding when it is installed; the content is the same).
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .lz4dec import decompress_frame

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1 :]
    return fields


class _Cursor:
    """Little-endian binary cursor over a ROS-serialized message."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def i8(self):
        (v,) = struct.unpack_from("<b", self.buf, self.off)
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def time(self) -> float:
        s = self.u32()
        ns = self.u32()
        return s + ns * 1e-9

    def string(self) -> str:
        n = self.u32()
        v = self.buf[self.off : self.off + n]
        self.off += n
        return v.decode(errors="replace")

    def array(self, dtype, count) -> np.ndarray:
        a = np.frombuffer(self.buf, dtype=dtype, count=count, offset=self.off)
        self.off += a.nbytes
        return a

    def skip_header(self):
        """std_msgs/Header: u32 seq, time, string frame_id. Returns stamp."""
        self.u32()
        t = self.time()
        self.string()
        return t


# ---------------------------------------------------------------------------
# Message decoders (hand-rolled for the types the reference subscribes to)
# ---------------------------------------------------------------------------


@dataclass
class PointCloudMsg:
    stamp: float
    xyz: np.ndarray  # (N, 3) float32
    channels: dict  # name -> (N,) float32


def decode_pointcloud(data: bytes) -> PointCloudMsg:
    """sensor_msgs/PointCloud (the eagle radar topic: channels
    [0]=doppler, [1]=range?, [2]=power — `preprocessing_nodelet_ntu.cpp:
    383,401-402` reads channels[2] as intensity, channels[0] as doppler)."""
    c = _Cursor(data)
    stamp = c.skip_header()
    n = c.u32()
    pts = c.array(np.float32, n * 3).reshape(n, 3)
    n_ch = c.u32()
    channels = {}
    for k in range(n_ch):
        name = c.string()
        m = c.u32()
        channels[name or f"ch{k}"] = c.array(np.float32, m)
    return PointCloudMsg(stamp=stamp, xyz=pts.astype(np.float32), channels=channels)


_PF_DTYPE = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def decode_pointcloud2(data: bytes) -> PointCloudMsg:
    """sensor_msgs/PointCloud2 -> xyz + named scalar channels (x/y/z plus
    any of intensity/doppler/velocity/power/snr... fields)."""
    c = _Cursor(data)
    stamp = c.skip_header()
    height = c.u32()
    width = c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        off = c.u32()
        dt = c.u8()
        cnt = c.u32()
        fields.append((name, off, dt, cnt))
    is_bigendian = c.u8()
    if is_bigendian:
        # every known radar/lidar driver writes little-endian; decoding BE
        # data with LE views would silently produce garbage coordinates
        raise ValueError("decode_pointcloud2: big-endian PointCloud2 not supported")
    point_step = c.u32()
    row_step = c.u32()
    nbytes = c.u32()
    raw = np.frombuffer(c.buf, np.uint8, count=nbytes, offset=c.off)
    n = height * width
    if height > 1 and row_step != width * point_step:
        # organized cloud with per-row padding: slice the payload row-wise
        # and strip the padding before the (n, point_step) view
        rows = raw[: height * row_step].reshape(height, row_step)
        raw = rows[:, : width * point_step].reshape(n, point_step)
    else:
        raw = raw[: n * point_step].reshape(n, point_step)
    cols = {}
    for name, off, dt, cnt in fields:
        dtype = _PF_DTYPE.get(dt)
        if dtype is None or cnt != 1:
            continue
        w = np.dtype(dtype).itemsize
        cols[name] = raw[:, off : off + w].copy().view(dtype).reshape(n)
    xyz = np.stack(
        [cols.get(k, np.zeros(n, np.float32)).astype(np.float32) for k in ("x", "y", "z")],
        axis=1,
    )
    channels = {
        k: v.astype(np.float32) for k, v in cols.items() if k not in ("x", "y", "z")
    }
    return PointCloudMsg(stamp=stamp, xyz=xyz, channels=channels)


@dataclass
class ImuMsg:
    stamp: float
    orientation: np.ndarray  # (4,) [x, y, z, w]
    angular_velocity: np.ndarray  # (3,)
    linear_acceleration: np.ndarray  # (3,)


def decode_imu(data: bytes) -> ImuMsg:
    c = _Cursor(data)
    stamp = c.skip_header()
    quat = c.array(np.float64, 4)
    c.array(np.float64, 9)
    gyr = c.array(np.float64, 3)
    c.array(np.float64, 9)
    acc = c.array(np.float64, 3)
    return ImuMsg(stamp=stamp, orientation=quat, angular_velocity=gyr,
                  linear_acceleration=acc)


@dataclass
class TwistMsg:
    stamp: float
    linear: np.ndarray  # (3,)
    angular: np.ndarray  # (3,)
    covariance: Optional[np.ndarray] = None  # (36,) when WithCovariance


def decode_twist_stamped(data: bytes) -> TwistMsg:
    c = _Cursor(data)
    stamp = c.skip_header()
    lin = c.array(np.float64, 3)
    ang = c.array(np.float64, 3)
    return TwistMsg(stamp=stamp, linear=lin, angular=ang)


def decode_twist_with_cov_stamped(data: bytes) -> TwistMsg:
    c = _Cursor(data)
    stamp = c.skip_header()
    lin = c.array(np.float64, 3)
    ang = c.array(np.float64, 3)
    cov = c.array(np.float64, 36)
    return TwistMsg(stamp=stamp, linear=lin, angular=ang, covariance=cov)


@dataclass
class NavSatFixMsg:
    stamp: float
    latitude: float
    longitude: float
    altitude: float
    position_covariance: np.ndarray  # (9,)
    status: int


def decode_navsatfix(data: bytes) -> NavSatFixMsg:
    c = _Cursor(data)
    stamp = c.skip_header()
    status = c.i8()
    c.u16()  # service
    lat = c.f64()
    lon = c.f64()
    alt = c.f64()
    cov = c.array(np.float64, 9)
    c.u8()  # covariance_type
    return NavSatFixMsg(stamp=stamp, latitude=lat, longitude=lon, altitude=alt,
                        position_covariance=cov, status=status)


_DECODERS = {
    "sensor_msgs/PointCloud": decode_pointcloud,
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "sensor_msgs/Imu": decode_imu,
    "geometry_msgs/TwistStamped": decode_twist_stamped,
    "geometry_msgs/TwistWithCovarianceStamped": decode_twist_with_cov_stamped,
    "sensor_msgs/NavSatFix": decode_navsatfix,
}


@dataclass
class BagMessage:
    topic: str
    msgtype: str
    stamp: float  # bag receive time
    msg: object  # decoded message, or raw bytes if no decoder is registered


class RosbagReader:
    """Sequential rosbag v2.0 reader. Iterates `BagMessage`s in file order
    (≈ time order for normally-recorded bags)."""

    def __init__(self, path, topics=None, decode: bool = True):
        self.path = Path(path)
        self.topics = set(topics) if topics else None
        self.decode = decode
        self._connections = {}  # conn id -> (topic, type)

    def _records(self, buf: bytes, off: int, end: int):
        while off + 4 <= end:
            (hlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            header = _parse_header(buf[off : off + hlen])
            off += hlen
            (dlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            data = buf[off : off + dlen]
            off += dlen
            yield header, data

    def __iter__(self) -> Iterator[BagMessage]:
        buf = self.path.read_bytes()
        if not buf.startswith(_MAGIC):
            raise IOError(f"{self.path}: not a rosbag v2.0 file")
        yield from self._iter_stream(buf, len(_MAGIC), len(buf))

    def _iter_stream(self, buf, off, end) -> Iterator[BagMessage]:
        for header, data in self._records(buf, off, end):
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                conn = struct.unpack("<I", header["conn"])[0]
                topic = header["topic"].decode()
                sub = _parse_header(data)
                msgtype = sub.get("type", b"").decode()
                self._connections[conn] = (topic, msgtype)
            elif op == OP_CHUNK:
                compression = header.get("compression", b"none").decode()
                if compression == "bz2":
                    data = bz2.decompress(data)
                elif compression == "lz4":
                    data = decompress_frame(data)
                yield from self._iter_stream(data, 0, len(data))
            elif op == OP_MSG:
                conn = struct.unpack("<I", header["conn"])[0]
                topic, msgtype = self._connections.get(conn, ("?", "?"))
                if self.topics is not None and topic not in self.topics:
                    continue
                s, ns = struct.unpack("<II", header["time"])
                stamp = s + ns * 1e-9
                msg = data
                if self.decode:
                    dec = _DECODERS.get(msgtype)
                    if dec is not None:
                        msg = dec(data)
                yield BagMessage(topic=topic, msgtype=msgtype, stamp=stamp, msg=msg)
            # index/chunkinfo/bag header records carry no messages

    def topics_summary(self) -> dict:
        """{topic: (msgtype, count)} over the whole bag."""
        out = {}
        for m in self.__class__(self.path, decode=False):
            t, c = out.get(m.topic, (m.msgtype, 0))
            out[m.topic] = (m.msgtype, c + 1)
        return out


# ---------------------------------------------------------------------------
# NTU4DRadLM-style conversion
# ---------------------------------------------------------------------------

# `Radar_to_livox` extrinsic chain (`preprocessing_nodelet_ntu.cpp:107-130`):
# Radar_to_livox = RGB_to_livox @ Thermal_to_RGB @ Radar_to_Thermal @ Change_Radarframe
_LIVOX_TO_RGB = np.array([
    [-0.006878330000, -0.999969000000, 0.003857230000, 0.029164500000],
    [-7.737180000000e-05, -0.003856790000, -0.999993000000, 0.045695200000],
    [0.999976000000, -0.006878580000, -5.084110000000e-05, -0.19018000000],
    [0, 0, 0, 1],
])
_THERMAL_TO_RGB = np.array([
    [0.9999526089706319, 0.008963747151337641, -0.003798822163962599, 0.18106962419014],
    [-0.008945181135788245, 0.9999481006917174, 0.004876439015823288, -0.04546324090016857],
    [0.00384233617405678, -0.004842226763999368, 0.999980894463835, 0.08046453079998771],
    [0, 0, 0, 1],
])
_RADAR_TO_THERMAL = np.array([
    [0.999665, 0.00925436, -0.0241851, -0.0248342],
    [-0.00826999, 0.999146, 0.0404891, 0.0958317],
    [0.0245392, -0.0402755, 0.998887, 0.0268037],
    [0, 0, 0, 1],
])
_CHANGE_RADARFRAME = np.array([
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [1, 0, 0, 0],
    [0, 0, 0, 1.0],
])


def radar_to_livox_extrinsic() -> np.ndarray:
    """The 4x4 Radar_to_livox transform of the NTU sensor rig."""
    return (
        np.linalg.inv(_LIVOX_TO_RGB) @ _THERMAL_TO_RGB @ _RADAR_TO_THERMAL
        @ _CHANGE_RADARFRAME
    )


def convert_rosbag(
    bag_path,
    out_dir,
    radar_topic: str = "/radar_enhanced_pcl",
    imu_topic: str = "/imu/data",
    twist_topic: Optional[str] = None,
    gps_topic: Optional[str] = None,
    power_threshold: float = 0.0,
    apply_ntu_extrinsic: bool = True,
    doppler_channel: int = 0,
    power_channel: int = 2,
    gyr_std: float = 0.01,
    vel_std: float = 0.04,
    max_frames: Optional[int] = None,
) -> int:
    """Convert a rosbag to a .grf sequence + imu.npz (+ gps.npz).

    Mirrors the preprocessing nodelet's ingest exactly
    (`preprocessing_nodelet_ntu.cpp:370-412`): power gate on the power
    channel, non-finite rejection, and the ROTATION-ONLY Radar_to_livox
    transform (the reference zeroes the translation, `:389-394`)."""
    from . import native as gn

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    R = radar_to_livox_extrinsic()[:3, :3] if apply_ntu_extrinsic else np.eye(3)

    topics = {radar_topic, imu_topic}
    if twist_topic:
        topics.add(twist_topic)
    if gps_topic:
        topics.add(gps_topic)

    n_frames = 0
    gyr_t, gyr, vel_t, vel = [], [], [], []
    gps_rows = []
    for m in RosbagReader(bag_path, topics=topics):
        if m.topic == radar_topic and isinstance(m.msg, PointCloudMsg):
            if max_frames is not None and n_frames >= max_frames:
                continue
            pc = m.msg
            chans = list(pc.channels.values())
            doppler = (
                chans[doppler_channel]
                if len(chans) > doppler_channel
                else pc.channels.get("doppler", pc.channels.get("velocity"))
            )
            power = (
                chans[power_channel]
                if len(chans) > power_channel
                else pc.channels.get("power", pc.channels.get("intensity"))
            )
            if doppler is None:
                doppler = np.zeros(len(pc.xyz), np.float32)
            if power is None:
                power = np.zeros(len(pc.xyz), np.float32)
            keep = np.isfinite(pc.xyz).all(axis=1) & (power > power_threshold)
            xyz = pc.xyz[keep] @ R.T
            gn.write_frame(
                out / f"{n_frames:06d}.grf",
                pc.stamp or m.stamp,
                xyz,
                power[keep],
                doppler[keep],
            )
            n_frames += 1
        elif m.topic == imu_topic and isinstance(m.msg, ImuMsg):
            gyr_t.append(m.msg.stamp or m.stamp)
            gyr.append(m.msg.angular_velocity)
        elif twist_topic and m.topic == twist_topic and isinstance(m.msg, TwistMsg):
            vel_t.append(m.msg.stamp or m.stamp)
            vel.append(m.msg.linear)
        elif gps_topic and m.topic == gps_topic and isinstance(m.msg, NavSatFixMsg):
            g = m.msg
            if g.status >= 0 and np.isfinite(g.latitude):
                gps_rows.append(
                    [g.stamp or m.stamp, g.latitude, g.longitude, g.altitude]
                    + list(g.position_covariance[[0, 4, 8]])
                )

    np.savez(
        out / "imu.npz",
        gyr_t=np.asarray(gyr_t), gyr=np.asarray(gyr).reshape(-1, 3),
        vel_t=np.asarray(vel_t), vel=np.asarray(vel).reshape(-1, 3),
        gyr_var=gyr_std**2, vel_var=vel_std**2,
    )
    if gps_rows:
        g = np.asarray(gps_rows)
        # latitude/longitude -> local UTM-style meters via the io.gps converter
        from .gps import GPSFix, GPSConverter

        conv = GPSConverter()
        xyz = []
        for row in g:
            p = conv.convert(GPSFix(lat=row[1], lon=row[2], alt=row[3], quality=1))
            xyz.append(p if p is not None else [np.nan] * 3)
        np.savez(out / "gps.npz", t=g[:, 0], xyz=np.asarray(xyz), cov=g[:, 4:7])
    return n_frames
