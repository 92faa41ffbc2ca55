"""Single typed configuration tree.

Port of `gorio_tpu/config.py`: one dataclass tree that aggregates the
modules' NamedTuple configs (frames, preprocessing, odometry, the back end,
Scan Context), in place of the reference's three parameter tiers (global
YAML, per-nodelet launch parameters, compile-time constants). It is written
to and read from JSON, or YAML where PyYAML imports; without PyYAML a
`.yaml` path holds JSON, as in the JAX package. The port's NamedTuples have
the JAX package's field names and defaults, so `dump-config` writes the
same file and each package reads the other's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

from .loopclosure.scancontext import ScanContextConfig
from .pipeline.odometry import OdometryConfig
from .pipeline.preprocessing import PreprocessConfig
from .pipeline.slam import SLAMConfig


@dataclass
class FrameConfig:
    """Frames and the radar -> base extrinsic (`params_ntu.yaml:28-50`)."""

    base_frame: str = "base_link"
    odom_frame: str = "odom"
    map_frame: str = "map"
    # 4x4 row-major extrinsic radar -> base (the reference's Radar_to_livox chain)
    T_base_radar: list = field(default_factory=lambda: [float(x) for x in
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]])


@dataclass
class GorioConfig:
    frames: FrameConfig = field(default_factory=FrameConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    slam: SLAMConfig = field(default_factory=SLAMConfig)
    scan_context: ScanContextConfig = field(default_factory=ScanContextConfig)
    dtype: str = "float32"  # kept for the file format; neither CLI reads it


def _to_plain(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if hasattr(obj, "_asdict"):  # NamedTuple
        return {k: _to_plain(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    return obj


def _rebuild_namedtuple(nt_cls, data: dict):
    """`nt_cls()` with the fields `data` names replaced, nested configs
    rebuilt and lists turned back into tuples; unknown keys are ignored."""
    defaults = nt_cls()
    kwargs = {}
    for name, default in defaults._asdict().items():
        if name not in data:
            continue
        val = data[name]
        if hasattr(default, "_asdict") and isinstance(val, dict):
            kwargs[name] = _rebuild_namedtuple(type(default), val)
        elif isinstance(default, tuple) and isinstance(val, list):
            kwargs[name] = tuple(val)
        else:
            kwargs[name] = val
    return defaults._replace(**kwargs)


def to_dict(cfg: GorioConfig) -> dict:
    return _to_plain(cfg)


def from_dict(data: dict) -> GorioConfig:
    cfg = GorioConfig()
    kwargs = {}
    if "frames" in data:
        kwargs["frames"] = FrameConfig(**data["frames"])
    for name in ("preprocess", "odometry", "slam", "scan_context"):
        if name in data:
            kwargs[name] = _rebuild_namedtuple(type(getattr(cfg, name)), data[name])
    if "dtype" in data:
        kwargs["dtype"] = data["dtype"]
    return dataclasses.replace(cfg, **kwargs)


def save_config(cfg: GorioConfig, path: str):
    """YAML for a `.yaml` / `.yml` path where PyYAML imports, else JSON."""
    text = None
    data = to_dict(cfg)
    if str(path).endswith((".yaml", ".yml")):
        try:
            import yaml

            text = yaml.safe_dump(data, sort_keys=False)
        except ImportError:
            pass
    if text is None:
        text = json.dumps(data, indent=2)
    with open(path, "w") as fh:
        fh.write(text)


def load_config(path: str) -> GorioConfig:
    with open(path) as fh:
        text = fh.read()
    data = None
    if str(path).endswith((".yaml", ".yml")):
        try:
            import yaml

            data = yaml.safe_load(text)
        except ImportError:
            pass
    if data is None:
        data = json.loads(text)
    return from_dict(data)
