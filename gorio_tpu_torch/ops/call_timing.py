"""Time the 1-NN wrappers, and optionally the slice, of whichever
`gorio_tpu_torch` is first on the path, so that two trees compare in turns
on one card:

    PYTHONPATH=OTHER_TREE python gorio_tpu_torch/ops/call_timing.py [--slice DIR]
    PYTHONPATH=.          python gorio_tpu_torch/ops/call_timing.py [--slice DIR]

At the main path's call (N = M = 2048: f64 query, f32 ref, bool mask, f32
11-column payload) it prints, for `nn1_best` and `nn1_select`: the device
activities one call puts on the card and the kernel's own time
(torch.profiler, 20 calls), one call's time (median of 50, CUDA events
around each call) and the time per call over 100 back-to-back calls (one
pair of CUDA events). With `--slice DIR` it also runs `simulate` into DIR
(if DIR holds no sequence yet) and then `slam --no-loops --device cuda`
three times in this process: wall seconds and stage medians of each run.
One JSON line, with the card's `nvidia-smi` name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch


def _inputs():
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ref = torch.rand(2048, 3, generator=g, device="cuda", dtype=torch.float64) * 80.0 - 40.0
    query = ref[torch.randint(0, 2048, (2048,), generator=g, device="cuda")]
    query = query + 0.3 * torch.randn(2048, 3, generator=g, device="cuda", dtype=torch.float64)
    mask = torch.rand(2048, generator=g, device="cuda") >= 0.1
    payload = torch.randn(2048, 11, generator=g, device="cuda")
    return query, ref.float(), mask, payload


def _events_ms(fn, calls):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _time(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    acts = [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    kernel = [t for n, t in acts if "nn1_kernel" in n]
    return {
        "activities_per_call": len(acts) / 20,
        "kernel_us": statistics.mean(kernel) if kernel else None,
        "call_ms": statistics.median(_events_ms(fn, 1) for _ in range(50)),
        "per_launch_ms": _events_ms(fn, 100) / 100,
    }


def _slice(seq: Path):
    from gorio_tpu_torch.cli import main as cli

    if not any(seq.glob("*.grf")):
        cli(["simulate", "--output", str(seq)])
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(3):
            t0 = time.perf_counter()
            _, odo, timer = cli(["slam", "--dataset", str(seq), "--output", f"{tmp}/e.tum",
                                 "--no-loops", "--device", "cuda"])
            torch.cuda.synchronize()
            runs.append({"wall_s": time.perf_counter() - t0,
                         "stage_median_ms": {k: 1000 * statistics.median(v)
                                             for k, v in timer.samples.items()},
                         "lm_iterations": sum(st.iterations for st in odo.statuses)})
    return runs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--slice", default=None, help="sequence directory for the slice runs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("call_timing needs a CUDA device")
    from gorio_tpu_torch.ops import nn as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    q, r, m, pay = _inputs()
    out = {"tree": str(Path(K.__file__).resolve().parents[2]), "card": card,
           "nn1": _time(lambda: K.nn1_best(q, r, m)),
           "nn1_select": _time(lambda: K.nn1_select(q, r, pay, m))}
    if args.slice:
        out["slice"] = _slice(Path(args.slice))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
