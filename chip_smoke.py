#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`gorio_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (more for the tables):
  1. device  — the card (`nvidia-smi` name and power limit, torch's name);
               fails without CUDA.
  2. build   — builds the 1-NN kernels from `gorio_tpu_torch/ops/csrc/` with
               nvcc and the native `.grf` runtime with g++, side by side, and
               prints the build seconds and ptxas' report.
  3. kernels — holds both kernels (`nn1_best` <- `gorio_nn1`, `nn1_select` <-
               `gorio_nn1_select`) against their plain PyTorch versions, run
               at the kernel's float32 arithmetic, on the same CUDA inputs:
               the main path's call (N = M = 2048, f64 query, f32 ref, bool
               mask, f32 11-column payload), the same all-f32 and all-f64,
               refs that repeat every M / S so that each minimum ties across
               the cluster's CTAs (the lowest copy must win), M = 5 < S,
               N = 1, a ragged batch (B = 3, N = 1537, M = 1999, 30% masked,
               the payload a strided view) and a batch whose refs are all
               masked. Indices must agree except at near-ties (the two
               candidates' d2 within 1e-5 * max(1, d2)); d2 and the payload
               must be allclose (rtol 1e-5, atol 1e-6; the payload on rows
               whose indices agree). Then, at the main path's call: one call
               must put exactly one kernel on the card (torch.profiler);
               each kernel's time per launch (CUDA events around 100
               launches), alone (profiler) and per single call, the plain
               version's, the library's (`torch.cdist`, masked `min`, and a
               gather for `nn1_select`) and the bound.
  4. slice   — the port's CLI: `simulate` (seed 0, 20 s at 5 Hz, capacity
               2048, 9000 landmarks: 98 frames), `slam --no-loops --device
               cuda`, `evaluate`. Fails unless the `nn1_select` launches equal
               the total of the per-frame LM iterations, `nn1` launched too,
               every keyframe cloud lives on the card, the keyframe count is
               80 +- 4 and the ATE is <= 0.05 m.
Then the kernels' JSON line, the card line, and the last line
`{"ok": true, "device": {...}}`. Any failure exits non-zero with no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL, TIE = 1e-5, 1e-6, 1e-5
MAIN_N = 2048  # points per scan at the default capacity: N = M on the main path
MAIN = "main path: (2048, 3) f64 query, f32 ref, bool mask, f32 P=11 payload"
CALLS = 10  # calls profiled to show that one call is one kernel
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: FP32 FLOP/s off the tensor cores, HBM B/s
KEYFRAMES, KEYFRAME_TOL, ATE_MAX = 80, 4, 0.05


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check_pair(name, q, r, mask, got, want, split=None):
    """Hold a kernel's (idx, d2[, sel]) against the plain version's. With
    `split`, every ref block of that size repeats the first one, so each
    query's minimum is tied across the cluster's CTAs and the lowest copy,
    in the first block, must win."""
    import torch

    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}: kernel gives {g.dtype} {tuple(g.shape)}, "
                 f"plain {w.dtype} {tuple(w.shape)}")
    idx_k, d2_k = got[0].long(), got[1]
    idx_p, d2_p = want[0].long(), want[1]
    if split is not None and int(idx_k.max()) >= split:
        fail(f"{name}: a tie across the cluster split went to index {int(idx_k.max())} "
             f">= {split}, not to the lowest copy")
    agree = idx_k == idx_p
    if not bool(agree.all()):
        # a disagreement is allowed only at a near-tie: both candidates'
        # exact (float64) distances, on the float32 values the kernel
        # reads, within TIE * max(1, d2)
        q64, r64 = q.float().double(), r.float().double()
        if q64.dim() == 2:
            q64, r64, idx_k, idx_p = q64[None], r64[None], idx_k[None], idx_p[None]
            mask = None if mask is None else mask[None]
        bias = torch.zeros_like(r64[..., 0])
        if mask is not None:
            bias = torch.where(mask, 0.0, 1e12).double()

        def exact(idx):
            rr = torch.gather(r64, 1, idx[..., None].expand(*idx.shape, 3))
            return ((q64 - rr) ** 2).sum(-1) + torch.gather(bias, 1, idx)

        dk, dp = exact(idx_k), exact(idx_p)
        tie_ok = (dk - dp).abs() <= TIE * torch.clamp(dp.abs(), min=1.0)
        bad = int((~agree.reshape(tie_ok.shape) & ~tie_ok).sum())
        if bad:
            fail(f"{name}: {bad} indices disagree beyond a near-tie")
    if not torch.allclose(d2_k, d2_p, rtol=RTOL, atol=ATOL):
        fail(f"{name}: d2 differs, max abs err {float((d2_k - d2_p).abs().max())}")
    err = float((d2_k - d2_p).abs().max())
    if len(got) == 3:
        sk, sp = got[2][agree], want[2][agree]
        if not torch.allclose(sk, sp, rtol=RTOL, atol=ATOL):
            fail(f"{name}: payload differs, max abs err {float((sk - sp).abs().max())}")
        err = max(err, float((sk - sp).abs().max()) if sk.numel() else 0.0)
    return int((~agree).sum()), err


def call_ms(fn, repeats=50, warmup=5):
    """Median time of one call, CUDA events around each: the wrapper's host
    work between the events counts."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def per_launch_ms(fn, launches=100, warmup=10):
    """One pair of CUDA events around `launches` back-to-back calls, after a
    warm-up; the time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def device_kernels(fn, calls):
    """(name, device us) of every device activity (kernel, copy, memset)
    that `calls` calls of `fn` put on the card, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def bound(q, r, mask, payload, sel):
    """The least time the card could take for one call (ms) and what sets
    it: ~9 FP32 operations per (query, ref) pair at 67 TFLOP/s, against each
    input read once and each output written once at 3.35 TB/s."""
    B = q.shape[0] if q.dim() == 3 else 1
    N, M = q.shape[-2], r.shape[-2]
    ops = 9.0 * B * N * M
    nbytes = q.numel() * q.element_size() + r.numel() * r.element_size()
    nbytes += 0 if mask is None else mask.numel() * mask.element_size()
    nbytes += B * N * (4 + q.element_size())  # idx, d2
    if payload is not None:
        nbytes += B * M * payload.shape[-1] * payload.element_size()
        nbytes += sel.numel() * sel.element_size()
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(K):
    import torch

    f32, f64 = torch.float32, torch.float64
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def inputs(B, N, M, masked_frac, qdt=f64, rdt=f32, pdt=f32, P=11, split=None):
        ref = torch.rand(B, M, 3, generator=g, device=dev, dtype=f64) * 80.0 - 40.0
        if split is not None:  # every block of `split` refs repeats the first
            ref = ref[:, :split].repeat(1, M // split, 1)
        query = ref[:, torch.randint(0, M, (N,), generator=g, device=dev)]
        query = query + 0.3 * torch.randn(B, N, 3, generator=g, device=dev, dtype=f64)
        mask = torch.rand(B, M, generator=g, device=dev) >= masked_frac
        payload = torch.randn(B, M, P, generator=g, device=dev, dtype=f64)
        return query.to(qdt), ref.to(rdt), mask, payload.to(pdt)

    S_main = K.cluster_size(1, MAIN_N)
    split = MAIN_N // S_main
    cases = {
        # the main path's call: (N, 3) f64 moved source, f32 target, bool
        # mask, f32 11-column payload
        MAIN: tuple(t[0] for t in inputs(1, MAIN_N, MAIN_N, 0.1)),
        "all f32, N=M=2048": inputs(1, MAIN_N, MAIN_N, 0.1, f32, f32, f32),
        "all f64, N=M=2048": inputs(1, MAIN_N, MAIN_N, 0.1, f64, f64, f64),
        f"ties across the split: refs repeat every {split}, N=M=2048":
            inputs(1, MAIN_N, MAIN_N, 0.0, split=split),
        f"M=5 < S={S_main}, N=2048": inputs(1, MAIN_N, 5, 0.0),
        "N=1, M=2048": inputs(1, 1, MAIN_N, 0.1),
    }
    q, r, m, p = inputs(3, 1537, 1999, 0.3, f32, f32, f32, P=16)
    cases["ragged B=3 N=1537 M=1999 30% masked, payload the first 11 of 16 columns"] = (
        q, r, m, p[..., :11])
    q, r, m, p = inputs(2, 1024, 1500, 0.0)
    m[1] = False  # every ref of the second batch masked
    cases["all refs masked in one batch"] = (q, r, m, p)

    errs = {}
    for label, (q, r, m, p) in cases.items():
        tie_split = split if label.startswith("ties") else None
        ties1, e1 = check_pair(f"nn1 [{label}]", q, r, m, K.nn1_best(q, r, m),
                               K.nn1_plain(q, r, m, compute_dtype=f32), tie_split)
        ties2, e2 = check_pair(f"nn1_select [{label}]", q, r, m, K.nn1_select(q, r, p, m),
                               K.nn1_select_plain(q, r, p, m, compute_dtype=f32), tie_split)
        torch.cuda.synchronize()
        for name, e in (("nn1", e1), ("nn1_select", e2)):
            errs[name] = max(errs.get(name, 0.0), e)
        B = q.shape[0] if q.dim() == 3 else 1
        print(f"[kernels] {label} (S={K.cluster_size(B, q.shape[-2])}): nn1 ok (near-ties "
              f"{ties1}, max abs err {e1:.3g}), nn1_select ok (near-ties {ties2}, "
              f"max abs err {e2:.3g})", flush=True)

    q, r, m, p = cases[MAIN]
    qf, rf = q.float(), r.float()
    bias = torch.where(m, 0.0, 1e12).to(f32)

    def library_nn1():
        d2, idx = (torch.cdist(qf, rf).square_() + bias).min(dim=-1)
        return idx, d2

    def library_select():
        idx, d2 = library_nn1()
        return idx, d2, p[idx]

    fns = {
        "nn1": (lambda: K.nn1_best(q, r, m), lambda: K.nn1_plain(q, r, m, compute_dtype=f32),
                library_nn1),
        "nn1_select": (lambda: K.nn1_select(q, r, p, m),
                       lambda: K.nn1_select_plain(q, r, p, m, compute_dtype=f32),
                       library_select),
    }

    # one call at the main path's types is one launch: no cast, pad or copy.
    # The profiler can drop an activity but never adds one, so over CALLS
    # calls it must see nothing but the kernel, and at most CALLS of it.
    for name, (kernel, _, _) in fns.items():
        acts = device_kernels(kernel, CALLS)
        names = sorted({n for n, _ in acts})
        if not acts or len(acts) > CALLS or any("nn1_kernel" not in n for n in names):
            fail(f"{CALLS} {name} calls put {len(acts)} activities on the card: {names}")
        print(f"[kernels] {CALLS} {name} calls at the main path's types put {len(acts)} "
              f"activities on the card, all one kernel: {names[0]}", flush=True)

    stats = {}
    for name, (kernel, plain, library) in fns.items():
        acts = device_kernels(kernel, 20)
        kernel_us = statistics.mean(t for n, t in acts if "nn1_kernel" in n)  # kernel alone
        want = plain()
        stats[name] = {
            "ms": per_launch_ms(kernel), "plain_ms": per_launch_ms(plain),
            "library_ms": per_launch_ms(library), "kernel_ms": kernel_us / 1e3,
            "call_ms": call_ms(kernel),
        }
        stats[name]["bound_ms"], stats[name]["bound_by"] = bound(
            q, r, m, p if name == "nn1_select" else None,
            want[2] if name == "nn1_select" else None)
        st = stats[name]
        print(f"[kernels] {name} at {MAIN}: {st['ms']:.5f} ms per launch (events around 100), "
              f"kernel alone {st['kernel_ms']:.5f} ms (profiler, mean of 20), one call "
              f"{st['call_ms']:.5f} ms (median of 50); plain {st['plain_ms']:.5f} ms, library "
              f"(cdist + min{' + gather' if name == 'nn1_select' else ''}) "
              f"{st['library_ms']:.5f} ms; bound {st['bound_ms']:.6f} ms ({st['bound_by']}), "
              f"kernel alone at {100 * st['bound_ms'] / st['kernel_ms']:.1f}% of it",
              flush=True)
    return errs, stats, S_main


def slice_phase(K):
    import numpy as np
    import torch

    from gorio_tpu_torch.cli import main as cli

    with tempfile.TemporaryDirectory(prefix="gorio_smoke_") as tmp:
        seq, traj = Path(tmp) / "seq", Path(tmp) / "est.tum"
        t0 = time.perf_counter()
        cli(["simulate", "--output", str(seq)])  # the JAX CLI's defaults
        print(f"[slice] simulate {time.perf_counter() - t0:.1f} s", flush=True)
        n_frames = len(list(seq.glob("*.grf")))

        K.reset_launch_counts()
        t0 = time.perf_counter()
        slam, odo, timer = cli(["slam", "--dataset", str(seq), "--output", str(traj),
                                "--no-loops", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.launch_counts)
        result = cli(["evaluate", str(traj), str(seq / "groundtruth.tum")])

    lm_iters = sum(st.iterations for st in odo.statuses)
    n_kf = len(slam.keyframes)
    medians = {k: 1000 * statistics.median(v) for k, v in timer.samples.items()}
    print(f"[slice] frames {n_frames}, keyframes {n_kf}, LM iterations {lm_iters}, "
          f"launches {launches}, wall {wall:.2f} s ({n_frames / wall:.2f} frames/s), "
          f"ATE {result['ate_rmse_m']:.4f} m, RTE {result['rte_m']:.4f} m", flush=True)
    print("[slice] stage median ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(medians.items())), flush=True)

    if launches["nn1_select"] == 0 or launches["nn1_select"] != lm_iters:
        fail(f"nn1_select launches {launches['nn1_select']} != LM iterations {lm_iters}")
    if launches["nn1"] == 0:
        fail("the nn1 kernel was not launched by the slice")
    devices = {str(kf.cloud.xyz.device) for kf in slam.keyframes}
    devices |= {str(t.device) for kf in slam.keyframes for t in kf.cloud}
    if any(not d.startswith("cuda") for d in devices):
        fail(f"keyframe clouds live on {sorted(devices)}")
    if abs(n_kf - KEYFRAMES) > KEYFRAME_TOL:
        fail(f"{n_kf} keyframes, expected {KEYFRAMES} +- {KEYFRAME_TOL}")
    _, poses = slam.trajectory()
    if not np.isfinite(poses).all():
        fail("non-finite poses in the trajectory")
    if not result["ate_rmse_m"] <= ATE_MAX:
        fail(f"ATE {result['ate_rmse_m']} m > {ATE_MAX} m")
    return launches


def main():
    if not (ROOT / "gorio_tpu_torch" / "ops" / "csrc" / "nn1.cu").is_file():
        fail(f"no gorio_tpu_torch package beside {Path(__file__).name}: run from the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"{kind} | count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gorio_tpu_torch.io import native
    from gorio_tpu_torch.ops import nn as K

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
        kernels_lib, native_lib = pool.submit(K.build_library), pool.submit(native.build_native)
        lib = kernels_lib.result()
        print(f"[build] {native_lib.result().name} (g++)", flush=True)
    K.load_library()
    print(f"[build] {lib.name} (nvcc) and the native runtime in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = K.BUILD_DIR / f"{lib.name}.log"
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)

    errs, stats, S_main = kernel_phase(K)
    launches = slice_phase(K)

    replaces = {"nn1": "gorio_tpu/ops/nn_pallas.py:34",
                "nn1_select": "gorio_tpu/ops/nn_pallas.py:125"}
    kernels = [
        {"name": name, "route": "cuda", "source": "gorio_tpu_torch/ops/csrc/nn1.cu",
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": errs[name],
         **stats[name], "cluster": S_main, "shape": MAIN}
        for name in ("nn1", "nn1_select")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
