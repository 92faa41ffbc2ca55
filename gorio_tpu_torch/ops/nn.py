"""Exact brute-force 1-NN and 1-NN + payload select: CUDA kernels and their
plain PyTorch versions.

Port of `gorio_tpu/ops/nn_pallas.py`. `nn1_best` and `nn1_select` keep the
JAX names. For a CPU tensor they run the plain version (the semantics of
`registration.knn.nn1` plus a gather); for any other tensor they launch the
hand-written kernel in `csrc/nn1.cu` or raise. There is no fallback from the
kernel to the plain version.

The kernel library is built by `nvcc` for sm_90a at first use, from the
source in this package, into `gorio_tpu_torch/_build/`, and bound with
`ctypes`. The kernel reads the caller's tensors as they are (query, ref and
payload in float32 or float64, the mask as bool) and computes in float32, as
`nn_pallas.py` does; `d2` and the payload come back in the query's dtype,
the index as int32. A call is one launch: the wrapper only checks the
tensors and allocates the outputs.

Every function takes an optional leading batch axis: query (B, N, 3), ref
(B, M, 3), ref_mask (B, M), payload (B, M, P <= 16).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from ..registration.knn import nn1

PAYLOAD = 16  # payload columns (xyz 3 + cov6 + cluster 1 + mask 1 + pad)
QUERIES = 128  # queries per CTA (`nn1.cu`)
MAX_CLUSTER = 8  # the portable thread-block cluster size
SMS = 132  # streaming multiprocessors of an H100 SXM
_DTYPES = {torch.float32: 0, torch.float64: 1}  # the kernel's dtype codes

_SRC = Path(__file__).resolve().parent / "csrc" / "nn1.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Launches of each kernel, counted by the wrappers where they launch it and
# nowhere else (chip_smoke.py reads them to prove the main path ran them),
# and of those the launches over a batch of more than one lane.
launch_counts = {"nn1": 0, "nn1_select": 0}
batched_launch_counts = {"nn1": 0, "nn1_select": 0}
_lib = None


def reset_launch_counts():
    for counts in (launch_counts, batched_launch_counts):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Build + bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the 1-NN kernels need the CUDA toolkit")
    return found


def build_library(src: Path = _SRC) -> Path:
    """Compile `src` (default `csrc/nn1.cu`) into `_build/` (once per source
    content) and return the shared library's path. The compiler's `-Xptxas
    -v` report (registers, shared memory, spills) is kept beside it as
    `<lib>.log`."""
    src = Path(src)
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libgorio_nn1_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    (BUILD_DIR / f"{lib.name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def bind(path: Path):
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gorio_nn1.argtypes = [P, I, P, I, P, I, I, I, I, P, P, P]
    lib.gorio_nn1.restype = I
    lib.gorio_nn1_select.argtypes = [P, I, P, I, P, P, I, I, I, I, I, I, I, P, P, P, P]
    lib.gorio_nn1_select.restype = I
    return lib


def load_library():
    """Build (if needed) and bind the kernel library; cached per process."""
    global _lib
    if _lib is None:
        _lib = bind(build_library())
    return _lib


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


def _shapes(query, ref, ref_mask, payload):
    """Check the shapes (with or without the batch axis) and return
    (B, N, M, squeeze); creates no tensor."""
    squeeze = query.dim() == 2
    lead = 0 if squeeze else 1
    if query.dim() not in (2, 3) or query.shape[-1] != 3:
        raise ValueError(f"query must be (N, 3) or (B, N, 3), got {tuple(query.shape)}")
    B = 1 if squeeze else query.shape[0]
    M = ref.shape[-2] if ref.dim() >= 2 else 0
    batch = tuple(query.shape[:lead])
    if ref.dim() != query.dim() or tuple(ref.shape[:lead]) != batch or ref.shape[-1] != 3:
        raise ValueError(f"ref must be (B, M, 3) with B = {B}, got {tuple(ref.shape)}")
    if M == 0:
        raise ValueError("ref must hold at least one point")
    if ref_mask is not None and tuple(ref_mask.shape) != (*batch, M):
        raise ValueError(f"ref_mask must be {(*batch, M)}, got {tuple(ref_mask.shape)}")
    if payload is not None and (
        payload.dim() != query.dim() or tuple(payload.shape[:-1]) != (*batch, M)
        or payload.shape[-1] > PAYLOAD
    ):
        raise ValueError(f"payload must be ({B}, {M}, P <= {PAYLOAD}), got {tuple(payload.shape)}")
    return B, query.shape[-2], M, squeeze


def _batched(query, ref, ref_mask, payload):
    """Check the shapes and add the batch axis where it is missing."""
    squeeze = _shapes(query, ref, ref_mask, payload)[3]
    if squeeze:
        query, ref = query[None], ref[None]
        ref_mask = None if ref_mask is None else ref_mask[None]
        payload = None if payload is None else payload[None]
    return query, ref, ref_mask, payload, squeeze


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def nn1_plain(query, ref, ref_mask=None, block: int = 1024, compute_dtype=None):
    """The kernels' plain version: `registration.knn.nn1` (d2 = |q - r|^2 +
    bias, bias 1e12 for masked refs, first index on ties) with the kernel's
    output types: idx int32, d2 in the query's dtype. The search runs in the
    promoted dtype of query and ref, or in `compute_dtype` (float32 is the
    kernel's arithmetic: it rounds both to float32 on load)."""
    _shapes(query, ref, ref_mask, None)
    q, r = query, ref
    if compute_dtype is not None:
        q, r = query.to(compute_dtype), ref.to(compute_dtype)
    idx, d2 = nn1(q, r, ref_mask=ref_mask, block=block)
    return idx.to(torch.int32), d2.to(query.dtype)


def nn1_select_plain(query, ref, payload, ref_mask=None, block: int = 1024,
                     compute_dtype=None):
    """1-NN + the winner's payload row (zero-padded to 16 columns):
    `nn1_plain` plus one gather."""
    _, _, _, pay, squeeze = _batched(query, ref, ref_mask, payload)
    idx, d2 = nn1_plain(query, ref, ref_mask, block, compute_dtype)
    idx_b = (idx[None] if squeeze else idx).long()
    pay = pay.to(query.dtype)
    sel = torch.gather(pay, 1, idx_b[..., None].expand(*idx_b.shape, pay.shape[-1]))
    sel = torch.cat([sel, sel.new_zeros(*sel.shape[:-1], PAYLOAD - pay.shape[-1])], dim=-1)
    return idx, d2, sel[0] if squeeze else sel


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


class KernelArgs(NamedTuple):
    """What one launch takes from the caller's tensors: pointers are the
    tensors' own `data_ptr()`s (nothing is cast, padded or copied), dtype
    codes follow `_DTYPES`."""

    query: int
    q_dtype: int
    ref: int
    r_dtype: int
    mask: Optional[int]
    payload: Optional[int]
    p_dtype: int
    P: int
    p_stride: int
    B: int
    N: int
    M: int
    S: int
    squeeze: bool


def cluster_size(B: int, N: int) -> int:
    """CTAs per cluster: the smallest power of two (<= 8, the portable
    cluster size) at which the B * ceil(N / 128) query blocks, each split
    over S CTAs, cover the card's SMs."""
    blocks = B * -(-N // QUERIES)
    S = 1
    while S < MAX_CLUSTER and blocks * S < SMS:
        S *= 2
    return S


def _dtype_code(name, t):
    if t.dtype not in _DTYPES:
        raise ValueError(f"the 1-NN kernels take a float32 or float64 {name}, got {t.dtype}")
    return _DTYPES[t.dtype]


def _kernel_args(query, ref, ref_mask=None, payload=None) -> KernelArgs:
    """Check the tensors against what `gorio_nn1[_select]` reads and return
    its arguments. Raises on anything the kernel does not take: a dtype
    other than float32/float64 (bool for the mask), a non-contiguous query,
    ref or mask, a payload whose columns are not unit-stride, P > 16. Makes
    no tensor, not even a view: a call's host time is mostly this wrapper."""
    B, N, M, squeeze = _shapes(query, ref, ref_mask, payload)
    for name, t in (("query", query), ("ref", ref), ("ref_mask", ref_mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the 1-NN kernels take a contiguous {name}")
    if ref_mask is not None and ref_mask.dtype != torch.bool:
        raise ValueError(f"ref_mask must be bool, got {ref_mask.dtype}")
    p_dtype, P, p_stride = _DTYPES[torch.float32], 0, 0
    if payload is not None:
        stride = payload.stride()
        p_dtype, P, p_stride = _dtype_code("payload", payload), payload.shape[-1], stride[-2]
        rows_ok = p_stride >= P and (B == 1 or stride[0] == M * p_stride)
        if (stride[-1] != 1 and P > 1) or not rows_ok:
            raise ValueError(f"the payload's rows must be unit-stride (B, M, P) rows of one "
                             f"stride, got strides {stride}")
    return KernelArgs(
        query=query.data_ptr(), q_dtype=_dtype_code("query", query),
        ref=ref.data_ptr(), r_dtype=_dtype_code("ref", ref),
        mask=None if ref_mask is None else ref_mask.data_ptr(),
        payload=None if payload is None else payload.data_ptr(), p_dtype=p_dtype, P=P,
        p_stride=p_stride, B=B, N=N, M=M, S=cluster_size(B, N), squeeze=squeeze,
    )


def _check_cuda(*tensors):
    """The kernels take CUDA tensors that all lie on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"the 1-NN kernels take CUDA tensors on one device, got {t.device} and {dev}"
            )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name, query, ref, ref_mask, payload):
    """One kernel launch on the caller's tensors; the only other work is
    allocating the outputs."""
    _check_cuda(*(t for t in (query, ref, ref_mask, payload) if t is not None))
    lib = load_library()
    a = _kernel_args(query, ref, ref_mask, payload)
    dev = query.device
    shape = (a.N,) if a.squeeze else (a.B, a.N)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    d2 = torch.empty(shape, dtype=query.dtype, device=dev)
    sel = None if payload is None else torch.empty((*shape, PAYLOAD), dtype=query.dtype,
                                                   device=dev)
    if a.N > 0:
        if sel is None:
            rc = lib.gorio_nn1(a.query, a.q_dtype, a.ref, a.r_dtype, a.mask, a.B, a.N, a.M,
                               a.S, idx.data_ptr(), d2.data_ptr(), _stream(dev))
        else:
            rc = lib.gorio_nn1_select(a.query, a.q_dtype, a.ref, a.r_dtype, a.mask, a.payload,
                                      a.p_dtype, a.P, a.p_stride, a.B, a.N, a.M, a.S,
                                      idx.data_ptr(), d2.data_ptr(), sel.data_ptr(),
                                      _stream(dev))
        if rc != 0:
            raise RuntimeError(f"gorio_{name} launch failed with cudaError_t {rc}")
        launch_counts[name] += 1
        batched_launch_counts[name] += a.B > 1
    return (idx, d2) if sel is None else (idx, d2, sel)


# ---------------------------------------------------------------------------
# Dispatch (the names of nn_pallas.py)
# ---------------------------------------------------------------------------


def nn1_best(query, ref, ref_mask=None, block: int = 1024):
    """1-NN of each query among the refs -> (idx int32, d2). Plain version for
    CPU tensors; the `gorio_nn1` kernel for anything else, or an error."""
    if query.device.type == "cpu":
        return nn1_plain(query, ref, ref_mask, block)
    return _launch("nn1", query, ref, ref_mask, None)


def nn1_select(query, ref, payload, ref_mask=None, block: int = 1024):
    """1-NN + the winner's payload row -> (idx int32, d2, sel (.., 16)).
    Plain version for CPU tensors; the `gorio_nn1_select` kernel for anything
    else, or an error."""
    if query.device.type == "cpu":
        return nn1_select_plain(query, ref, payload, ref_mask, block)
    return _launch("nn1_select", query, ref, ref_mask, payload)
