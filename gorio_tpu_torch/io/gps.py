"""GPS ingestion: NMEA sentence parsing, UTM conversion, world alignment.

The port's copy of `gorio_tpu/io/gps.py` (numpy only). The reference's GPS
path (`radar_graph_slam_nodelet.cpp:187-198, 1248-1327`) converts NMEA /
NavSat fixes to UTM, shifts them by the first fix (`zero_utm`), applies an
optional per-dataset `utm_to_world` matrix, and gates them before they
become XY(Z) priors. `parse_nmea` mirrors `NmeaSentenceParser`
(`nmea_sentence_parser.hpp`): $GPGGA / $GPRMC with checksum validation.
`latlon_to_utm` is a series transverse Mercator (sub-mm in-zone).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2 - _F)
_EP2 = _E2 / (1 - _E2)


def latlon_to_utm(lat_deg: float, lon_deg: float):
    """(lat, lon) -> (easting, northing, zone, hemisphere). Series-based
    transverse Mercator (Krueger), accurate to < 1 mm in-zone."""
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    zone = int((lon_deg + 180) // 6) + 1
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)

    N = _A / math.sqrt(1 - _E2 * math.sin(lat) ** 2)
    T = math.tan(lat) ** 2
    C = _EP2 * math.cos(lat) ** 2
    Aq = (lon - lon0) * math.cos(lat)
    # meridional arc
    M = _A * (
        (1 - _E2 / 4 - 3 * _E2**2 / 64 - 5 * _E2**3 / 256) * lat
        - (3 * _E2 / 8 + 3 * _E2**2 / 32 + 45 * _E2**3 / 1024) * math.sin(2 * lat)
        + (15 * _E2**2 / 256 + 45 * _E2**3 / 1024) * math.sin(4 * lat)
        - (35 * _E2**3 / 3072) * math.sin(6 * lat)
    )
    easting = _K0 * N * (
        Aq + (1 - T + C) * Aq**3 / 6 + (5 - 18 * T + T**2 + 72 * C - 58 * _EP2) * Aq**5 / 120
    ) + 500000.0
    northing = _K0 * (
        M
        + N
        * math.tan(lat)
        * (
            Aq**2 / 2
            + (5 - T + 9 * C + 4 * C**2) * Aq**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * _EP2) * Aq**6 / 720
        )
    )
    hemisphere = "N"
    if lat_deg < 0:
        northing += 10000000.0
        hemisphere = "S"
    return easting, northing, zone, hemisphere


def _nmea_checksum_ok(sentence: str) -> bool:
    if "*" not in sentence or not sentence.startswith("$"):
        return False
    body, _, cs = sentence[1:].partition("*")
    calc = 0
    for ch in body:
        calc ^= ord(ch)
    try:
        return calc == int(cs.strip()[:2], 16)
    except ValueError:
        return False


def _dm_to_deg(dm: str, hemi: str) -> Optional[float]:
    """ddmm.mmmm -> decimal degrees."""
    if not dm:
        return None
    v = float(dm)
    deg = int(v / 100)
    minutes = v - 100 * deg
    out = deg + minutes / 60.0
    if hemi in ("S", "W"):
        out = -out
    return out


@dataclass
class GPSFix:
    lat: float
    lon: float
    alt: Optional[float]
    quality: int  # 0 = invalid


def parse_nmea(sentence: str) -> Optional[GPSFix]:
    """Parse $--GGA / $--RMC; parity with `NmeaSentenceParser::parse`."""
    sentence = sentence.strip()
    if not _nmea_checksum_ok(sentence):
        return None
    fields = sentence[1:].split("*")[0].split(",")
    typ = fields[0][2:]
    try:
        if typ == "GGA" and len(fields) >= 10:
            lat = _dm_to_deg(fields[2], fields[3])
            lon = _dm_to_deg(fields[4], fields[5])
            quality = int(fields[6] or 0)
            alt = float(fields[9]) if fields[9] else None
            if lat is None or lon is None:
                return None
            return GPSFix(lat=lat, lon=lon, alt=alt, quality=quality)
        if typ == "RMC" and len(fields) >= 7:
            if fields[2] != "A":  # status: A=active, V=void
                return None
            lat = _dm_to_deg(fields[3], fields[4])
            lon = _dm_to_deg(fields[5], fields[6])
            if lat is None or lon is None:
                return None
            return GPSFix(lat=lat, lon=lon, alt=None, quality=1)
    except (ValueError, IndexError):
        return None
    return None


@dataclass
class GPSConverter:
    """Stateful fix -> world-position converter (zero_utm + utm_to_world).

    Parity: the zero-utm capture and `utm_to_world` application in
    `flush_gps_queue` (`radar_graph_slam_nodelet.cpp:1248-1327`)."""

    utm_to_world: np.ndarray = None  # (4,4); identity if None
    zero_utm: Optional[np.ndarray] = None

    def convert(self, fix: GPSFix) -> Optional[np.ndarray]:
        if fix.quality <= 0:
            return None
        e, n, _, _ = latlon_to_utm(fix.lat, fix.lon)
        p = np.array([e, n, fix.alt if fix.alt is not None else 0.0])
        if self.zero_utm is None:
            self.zero_utm = p.copy()
        p = p - self.zero_utm
        if self.utm_to_world is not None:
            p = self.utm_to_world[:3, :3] @ p + self.utm_to_world[:3, 3]
        return p
