"""Carry the JAX package's state into the port.

This system has no weights: its state is configs, clouds and graphs. Each
converter takes the JAX object as numpy arrays or `._asdict()` dicts (a JAX
NamedTuple of arrays works as is) and returns the port's counterpart, so a
parity test can hand both sides the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.pointcloud import PointCloud
from .registration.ndt import VoxelGaussianMap
from .registration.vgicp import GaussianVoxelMap
from .loopclosure.scancontext import ScanContextDB
from .graph.factors import (
    BetweenFactors,
    GraphData,
    GroundPlaneFactors,
    PlaneGraphData,
    PlanePlaneFactors,
    PlanePriorFactors,
    PointPriorFactors,
    PriorFactors,
    QuatPriorFactors,
    SE3PlaneFactors,
    UTMAlignFactors,
    VecPriorFactors,
    ZBetweenFactors,
)

_FAMILIES = {  # the factor families of each graph type, in field order
    GraphData: (BetweenFactors, PriorFactors, PointPriorFactors, QuatPriorFactors,
                VecPriorFactors, GroundPlaneFactors),
    PlaneGraphData: (PlanePriorFactors, PlanePlaneFactors, SE3PlaneFactors, ZBetweenFactors,
                     UTMAlignFactors),
}
_INDEX_FIELDS = ("i", "j", "kind")


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def cloud_from_numpy(cloud, device=None) -> PointCloud:
    """JAX `PointCloud` (or a dict of its arrays) -> port `PointCloud`."""
    d = _fields(cloud)
    return PointCloud(**{k: torch.as_tensor(np.array(d[k]), device=device)
                         for k in PointCloud._fields})


def graph_from_numpy(graph, device=None, kind=GraphData):
    """A frozen JAX `GraphData` (or `PlaneGraphData` with
    `kind=PlaneGraphData`; or nested dicts of their arrays) -> the port's;
    factor indices and plane-plane kinds become int64."""
    g = _fields(graph)
    families = []
    for name, cls in zip(kind._fields, _FAMILIES[kind]):
        fam = _fields(g[name])
        families.append(cls(**{
            k: torch.as_tensor(
                np.array(fam[k], dtype=np.int64 if k in _INDEX_FIELDS else None), device=device)
            for k in cls._fields
        }))
    return kind(*families)


def plane_graph_from_numpy(planes, plane_graph, device=None):
    """The JAX `freeze_planes()` pair (planes (M, 4), `PlaneGraphData`) ->
    the port's."""
    return (torch.as_tensor(np.array(planes), device=device),
            graph_from_numpy(plane_graph, device, kind=PlaneGraphData))


def config_from_dict(cls, data):
    """A JAX config (NamedTuple or dict, nested configs included) -> the
    port's config class `cls` (`SLAMConfig`, `LoopConfig`,
    `ScanContextConfig`, `SolveConfig`, `UGPMConfig`, `PreprocessConfig`,
    `GroundSegConfig`, `DBSCANConfig`, `OdometryConfig`, `NDTConfig`,
    `VGICPConfig`, ...), nested configs converted recursively. Unknown
    field names raise."""
    d = _fields(data)
    unknown = set(d) - set(cls._fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        default = cls._field_defaults.get(k)
        if isinstance(default, tuple) and hasattr(default, "_fields"):
            kw[k] = config_from_dict(type(default), v)
        elif isinstance(default, tuple) and isinstance(v, list):
            kw[k] = tuple(v)  # tuple fields (ring / sector counts) read back from JSON
        else:
            kw[k] = v
    return cls(**kw)


def voxel_map_from_numpy(vmap, device=None):
    """A JAX `VoxelGaussianMap` (NDT) or `GaussianVoxelMap` (VGICP), or a
    dict of its arrays, -> the port's, told apart by their fields; keys,
    tables and table dims stay int32."""
    d = _fields(vmap)
    cls = VoxelGaussianMap if "packed" in d else GaussianVoxelMap
    return cls(**{k: torch.as_tensor(np.array(d[k]), device=device) for k in cls._fields})


def scancontext_db_from_numpy(db, device=None) -> ScanContextDB:
    """A JAX `ScanContextDB` (or a dict of its arrays) -> the port's, with
    the same capacity, dtype and count."""
    d = _fields(db)
    return ScanContextDB(descs=torch.as_tensor(np.array(d["descs"]), device=device),
                         ring_keys=torch.as_tensor(np.array(d["ring_keys"]), device=device),
                         count=int(d["count"]))
