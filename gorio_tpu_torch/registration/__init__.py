"""Registration back ends and the method factory.

`select_registration` is the port of the JAX package's factory
(`select_registration_method`, `registrations.cpp:23-139`): a method name
from the reference's launch files -> an align callable
`(source, target, init_T=None) -> LMResult`. The CUDA spellings alias the
same code as their plain names, as in the JAX package.
"""

from __future__ import annotations

from .lsq import LMConfig, LMResult, gn_optimize, lm_optimize  # noqa: F401

_METHODS = {
    "FAST_GICP": ("gicp", "gicp"),
    "FAST_APDGICP": ("gicp", "apdgicp"),
    "FAST_VGICP": ("vgicp", None),
    # FastVGICPCuda's default neighbour method is the CPU kd-tree kNN
    # (`fast_vgicp_cuda.hpp:41`); covariance_method="rbf" picks GPU_RBF_KERNEL
    "FAST_VGICP_CUDA": ("vgicp", None),
    "GICP": ("gicp", "gicp"),
    "GICP_OMP": ("gicp", "gicp"),
    "ICP": ("gicp", "icp"),  # point-to-point ICP: identity covariances
    "NDT": ("ndt", None),
    "NDT_OMP": ("ndt", None),
    "NDT_CUDA": ("ndt", None),  # P2D mode (`NDTDistanceMode::P2D`)
    "NDT_CUDA_D2D": ("ndt_d2d", None),  # D2D mode (`ndt_compute_derivatives.cu`)
    "NDT_MULTIRES": ("ndt_cf", None),  # coarse-to-fine (`ndt.ndt_align_multires`)
}


def select_registration(method: str = "FAST_APDGICP", **overrides):
    """`align(source, target, init_T=None) -> LMResult` for the named method.
    For NDT_MULTIRES, `coarse_iterations` / `fine_iterations` set the stage
    budgets and `max_iterations` only lowers the fine one."""
    # imported here: `ops.nn` imports `registration.knn`, and `gicp` imports
    # `ops.nn`, so this package must not import `gicp` when it loads
    from .gicp import GICPConfig, gicp_align
    from .ndt import NDTConfig, ndt_align, ndt_align_cf, ndt_d2d_align
    from .vgicp import VGICPConfig, vgicp_align

    kind, mode = _METHODS[method.upper()]
    if kind == "gicp":
        cfg = GICPConfig(mode=mode, **overrides)
        return lambda s, t, init_T=None: gicp_align(s, t, init_T=init_T, cfg=cfg)
    if kind == "vgicp":
        cfg = VGICPConfig(**overrides)
        return lambda s, t, init_T=None: vgicp_align(s, t, init_T=init_T, cfg=cfg)
    cfg = NDTConfig(**overrides)
    align = {"ndt": ndt_align, "ndt_d2d": ndt_d2d_align, "ndt_cf": ndt_align_cf}[kind]
    return lambda s, t, init_T=None: align(s, t, init_T=init_T, cfg=cfg)
