"""Exact brute-force 1-NN and 1-NN + payload select: CUDA kernels and their
plain PyTorch versions.

Port of `gorio_tpu/ops/nn_pallas.py`. `nn1_best` and `nn1_select` keep the
JAX names. For a CPU tensor they run the plain version (the semantics of
`registration.knn.nn1` plus a gather); for any other tensor they launch the
hand-written kernel in `csrc/nn1.cu` or raise. There is no fallback from the
kernel to the plain version.

The kernel library is built by `nvcc` for sm_90a at first use, from the
source in this package, into `gorio_tpu_torch/_build/`, and bound with
`ctypes`. Inputs go into the kernel as float32 (as `nn_pallas.py` casts);
`d2` and the payload come back in the query's dtype, the index as int32.

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

import torch

from ..registration.knn import _BIG, nn1

PAYLOAD = 16  # payload columns (xyz 3 + cov6 + cluster 1 + mask 1 + pad)

_SRC = Path(__file__).resolve().parent / "csrc" / "nn1.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Launches of each kernel, counted by the wrappers where they launch it and
# nowhere else (chip_smoke.py reads them to prove the main path ran them).
launch_counts = {"nn1": 0, "nn1_select": 0}
_lib = None


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


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


def build_library() -> Path:
    """Compile `csrc/nn1.cu` into `_build/` (once per source content) and
    return the shared library's path. The compiler's `-Xptxas -v` report
    (registers, shared memory, spills) is kept beside it as `<lib>.log`."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libgorio_nn1_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    (BUILD_DIR / f"{lib.name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load_library():
    """Build (if needed) and bind the kernel library; cached per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gorio_nn1.argtypes = [P, P, P, I, I, I, P, P, P]
        lib.gorio_nn1.restype = I
        lib.gorio_nn1_select.argtypes = [P, P, P, P, I, I, I, P, P, P, P]
        lib.gorio_nn1_select.restype = I
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


def _batched(query, ref, ref_mask, payload):
    """Add the batch axis where it is missing and check the shapes."""
    squeeze = query.dim() == 2
    if squeeze:
        query, ref = query[None], ref[None]
        ref_mask = None if ref_mask is None else ref_mask[None]
        payload = None if payload is None else payload[None]
    if query.dim() != 3 or query.shape[-1] != 3:
        raise ValueError(f"query must be (N, 3) or (B, N, 3), got {tuple(query.shape)}")
    B, M = query.shape[0], ref.shape[-2]
    if ref.dim() != 3 or ref.shape[0] != B or ref.shape[-1] != 3:
        raise ValueError(f"ref must be (B, M, 3) with B = {B}, got {tuple(ref.shape)}")
    if M == 0:
        raise ValueError("ref must hold at least one point")
    if ref_mask is not None and tuple(ref_mask.shape) != (B, M):
        raise ValueError(f"ref_mask must be {(B, M)}, got {tuple(ref_mask.shape)}")
    if payload is not None and (
        payload.dim() != 3 or payload.shape[:2] != (B, M) or payload.shape[2] > PAYLOAD
    ):
        raise ValueError(f"payload must be ({B}, {M}, P <= {PAYLOAD}), got {tuple(payload.shape)}")
    return query, ref, ref_mask, payload, squeeze


def _unbatch(squeeze, *outs):
    return tuple(o[0] for o in outs) if squeeze else outs


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def nn1_plain(query, ref, ref_mask=None, block: int = 1024):
    """The kernels' plain version: `registration.knn.nn1` (d2 = |q - r|^2 +
    bias, bias 1e12 for masked refs, first index on ties) with the kernel's
    output types: idx int32, d2 in the query's dtype."""
    _batched(query, ref, ref_mask, None)
    idx, d2 = nn1(query, ref, ref_mask=ref_mask, block=block)
    return idx.to(torch.int32), d2.to(query.dtype)


def nn1_select_plain(query, ref, payload, ref_mask=None, block: int = 1024):
    """1-NN + the winner's payload row (zero-padded to 16 columns):
    `nn1_plain` plus one gather."""
    _, _, _, pay, squeeze = _batched(query, ref, ref_mask, payload)
    idx, d2 = nn1_plain(query, ref, ref_mask, block)
    idx_b = (idx[None] if squeeze else idx).long()
    pay = pay.to(query.dtype)
    sel = torch.gather(pay, 1, idx_b[..., None].expand(*idx_b.shape, pay.shape[-1]))
    sel = torch.cat([sel, sel.new_zeros(*sel.shape[:-1], PAYLOAD - pay.shape[-1])], dim=-1)
    return idx, d2, sel[0] if squeeze else sel


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check_cuda(*tensors):
    """The kernels take CUDA tensors that all lie on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"the 1-NN kernels take CUDA tensors on one device, got {t.device} and {dev}"
            )


def _launch(name, query, ref, ref_mask, payload):
    q, r, mask, pay, squeeze = _batched(query, ref, ref_mask, payload)
    _check_cuda(*(t for t in (q, r, mask, pay) if t is not None))
    lib = load_library()
    q = q.to(torch.float32).contiguous()
    r = r.to(torch.float32).contiguous()
    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, _BIG).to(device=r.device, dtype=torch.float32).contiguous()
    B, N, M = q.shape[0], q.shape[1], r.shape[1]
    idx = torch.empty((B, N), dtype=torch.int32, device=q.device)
    d2 = torch.empty((B, N), dtype=torch.float32, device=q.device)
    sel = None
    if pay is not None:
        pay = pay.to(torch.float32)
        if pay.shape[-1] < PAYLOAD:
            pay = torch.cat([pay, pay.new_zeros(B, M, PAYLOAD - pay.shape[-1])], dim=-1)
        pay = pay.contiguous()
        sel = torch.empty((B, N, PAYLOAD), dtype=torch.float32, device=q.device)
    if N > 0:
        bias_ptr = None if bias is None else bias.data_ptr()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
        if pay is None:
            rc = lib.gorio_nn1(q.data_ptr(), r.data_ptr(), bias_ptr, B, N, M,
                               idx.data_ptr(), d2.data_ptr(), stream)
        else:
            rc = lib.gorio_nn1_select(q.data_ptr(), r.data_ptr(), bias_ptr, pay.data_ptr(),
                                      B, N, M, idx.data_ptr(), d2.data_ptr(),
                                      sel.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"gorio_{name} launch failed with cudaError_t {rc}")
        launch_counts[name] += 1
    d2 = d2.to(query.dtype)
    if sel is None:
        return _unbatch(squeeze, idx, d2)
    return _unbatch(squeeze, idx, d2, sel.to(query.dtype))


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
