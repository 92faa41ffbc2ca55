#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`gorio_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (more for the tables):
  1. device  — the card (`nvidia-smi` name and power limit, torch's name);
               fails without CUDA.
  2. build   — builds the 1-NN kernels from `gorio_tpu_torch/ops/csrc/` with
               nvcc and prints the build seconds and ptxas' report.
  3. kernels — holds both kernels (`nn1_best` <- `gorio_nn1`, `nn1_select` <-
               `gorio_nn1_select`) against their plain PyTorch versions on the
               same CUDA inputs: the main path's shape (N = M = 2048, an
               11-column payload padded to 16), a ragged batch (B = 3,
               N = 1537, M = 1999, 30% of refs masked) and a batch whose refs
               are all masked. Indices must agree except at near-ties (the two
               candidates' d2 within 1e-5 * max(1, d2)); d2 and the payload
               must be allclose (rtol 1e-5, atol 1e-6; the payload on rows
               whose indices agree). Times both (CUDA events, median of 50).
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL, TIE = 1e-5, 1e-6, 1e-5
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


def check_pair(name, q, r, mask, got, want):
    """Hold a kernel's (idx, d2[, sel]) against the plain version's."""
    import torch

    idx_k, d2_k = got[0].long(), got[1]
    idx_p, d2_p = want[0].long(), want[1]
    agree = idx_k == idx_p
    if not bool(agree.all()):
        # a disagreement is allowed only at a near-tie: both candidates'
        # exact (float64) distances within TIE * max(1, d2)
        q64, r64 = q.double(), r.double()
        bias = torch.zeros_like(r64[..., 0])
        if mask is not None:
            bias = torch.where(mask, 0.0, 1e12).double()

        def exact(idx):
            rr = torch.gather(r64, 1, idx[..., None].expand(*idx.shape, 3))
            return ((q64 - rr) ** 2).sum(-1) + torch.gather(bias, 1, idx)

        dk, dp = exact(idx_k), exact(idx_p)
        tie_ok = (dk - dp).abs() <= TIE * torch.clamp(dp.abs(), min=1.0)
        bad = int((~agree & ~tie_ok).sum())
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


def median_ms(fn, repeats=50, warmup=5):
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


def kernel_phase(K):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def inputs(B, N, M, masked_frac):
        ref = torch.rand(B, M, 3, generator=g, device=dev) * 80.0 - 40.0
        query = ref[:, torch.randint(0, M, (N,), generator=g, device=dev)]
        query = query + 0.3 * torch.randn(B, N, 3, generator=g, device=dev)
        mask = torch.rand(B, M, generator=g, device=dev) >= masked_frac
        payload = torch.randn(B, M, 11, generator=g, device=dev)
        return query, ref, mask, payload

    cases = {
        "main N=M=2048": inputs(1, 2048, 2048, 0.0),
        "ragged B=3 N=1537 M=1999 30% masked": inputs(3, 1537, 1999, 0.3),
    }
    q, r, m, p = inputs(2, 1024, 1500, 0.0)
    m[1] = False  # every ref of the second batch masked
    cases["all refs masked in one batch"] = (q, r, m, p)

    errs = {"nn1": 0.0, "nn1_select": 0.0}
    for label, (q, r, m, p) in cases.items():
        ties1, e1 = check_pair(f"nn1 [{label}]", q, r, m,
                               K.nn1_best(q, r, m), K.nn1_plain(q, r, m))
        ties2, e2 = check_pair(f"nn1_select [{label}]", q, r, m,
                               K.nn1_select(q, r, p, m), K.nn1_select_plain(q, r, p, m))
        torch.cuda.synchronize()
        if label.startswith("main"):
            errs = {"nn1": e1, "nn1_select": e2}
        print(f"[kernels] {label}: nn1 ok (near-ties {ties1}, max abs err {e1:.3g}), "
              f"nn1_select ok (near-ties {ties2}, max abs err {e2:.3g})", flush=True)

    q, r, m, p = (t[0] for t in cases["main N=M=2048"])
    times = {
        "nn1": (median_ms(lambda: K.nn1_best(q, r, m)), median_ms(lambda: K.nn1_plain(q, r, m))),
        "nn1_select": (median_ms(lambda: K.nn1_select(q, r, p, m)),
                       median_ms(lambda: K.nn1_select_plain(q, r, p, m))),
    }
    for name, (tk, tp) in times.items():
        print(f"[kernels] {name} at N=M=2048: kernel {tk:.4f} ms, plain {tp:.4f} ms "
              f"(median of 50, CUDA events)", flush=True)
    return errs, times


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

    from gorio_tpu_torch.ops import nn as K

    t0 = time.perf_counter()
    lib = K.build_library()
    K.load_library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = K.BUILD_DIR / f"{lib.name}.log"
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)

    errs, times = kernel_phase(K)
    launches = slice_phase(K)

    replaces = {"nn1": "gorio_tpu/ops/nn_pallas.py:34",
                "nn1_select": "gorio_tpu/ops/nn_pallas.py:125"}
    kernels = [
        {"name": name, "route": "cuda", "source": "gorio_tpu_torch/ops/csrc/nn1.cu",
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("nn1", "nn1_select")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
