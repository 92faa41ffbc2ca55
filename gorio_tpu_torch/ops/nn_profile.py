"""Where one 1-NN call spends its time on the card, at the main path's call
(N = M = 2048: f64 query, f32 ref, bool mask, f32 11-column payload).

    python -m gorio_tpu_torch.ops.nn_profile [--out FILE.json] [--baseline OTHER.cu ...]

Prints one JSON object (and writes it to FILE): the card's `nvidia-smi` name
and power limit; each kernel's device time alone (torch.profiler, mean of 50
launches) at every cluster size S in 1, 2, 4, 8, launched straight through
the library; and the host time of one `nn1_select` wrapper call and of its
parts (argument checks, the three output allocations, the stream lookup, the
ctypes launch), each the mean of 500 calls on the host's clock. With
`--baseline` (repeatable), another source of the same C interface (an
earlier version of `csrc/nn1.cu`) is built too and its kernels timed the
same way, in turns with this one's (this, the baselines, the baselines in
reverse, this), so that the versions compare on one card in one process. Needs a
CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from . import nn as K

N = M = 2048
CALLS = 500  # below the launch queue's depth, so the host clock reads host work


def _inputs():
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ref = torch.rand(M, 3, generator=g, device="cuda", dtype=torch.float64) * 80.0 - 40.0
    query = ref[torch.randint(0, M, (N,), generator=g, device="cuda")]
    query = query + 0.3 * torch.randn(N, 3, generator=g, device="cuda", dtype=torch.float64)
    mask = torch.rand(M, generator=g, device="cuda") >= 0.1
    payload = torch.randn(M, 11, generator=g, device="cuda")
    return query, ref.float(), mask, payload


def _device_us(fn, launches=50):
    """Mean device time (us) of the nn1 kernel over `launches` calls (the
    profiler may drop an activity: at least half must be seen)."""
    from ..utils.profiling import device_activities

    fn()
    times = [us for name, us in device_activities(lambda: [fn() for _ in range(launches)])
             if "nn1_kernel" in name]
    if not launches // 2 <= len(times) <= launches:
        raise RuntimeError(f"expected {launches} kernel activities, saw {len(times)}")
    return sum(times) / len(times)


def _host_us(fn, calls=CALLS):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / calls


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None)
    p.add_argument("--baseline", action="append", default=[],
                   help="another nn1.cu to time beside this one")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nn_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = K.load_library()
    q, r, m, p = _inputs()
    a = K._kernel_args(q, r, m, p)
    dev = q.device
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    d2 = torch.empty(N, dtype=q.dtype, device=dev)
    sel = torch.empty(N, K.PAYLOAD, dtype=q.dtype, device=dev)
    stream = K._stream(dev)

    def raw(select, S, lib=lib):
        if select:
            return lambda: lib.gorio_nn1_select(
                a.query, a.q_dtype, a.ref, a.r_dtype, a.mask, a.payload, a.p_dtype, a.P,
                a.p_stride, a.B, a.N, a.M, S, idx.data_ptr(), d2.data_ptr(), sel.data_ptr(),
                stream)
        return lambda: lib.gorio_nn1(a.query, a.q_dtype, a.ref, a.r_dtype, a.mask, a.B, a.N,
                                     a.M, S, idx.data_ptr(), d2.data_ptr(), stream)

    libs = {"this": lib}
    for src in args.baseline:
        libs[src] = K.bind(K.build_library(src))
    kernel_us = {}
    turns = ["this"]
    if args.baseline:
        turns += [*args.baseline, *reversed(args.baseline), "this"]
    for turn in turns:
        for name in ("nn1", "nn1_select"):
            for S in (1, 2, 4, 8):
                us = _device_us(raw(name == "nn1_select", S, libs[turn]))
                kernel_us.setdefault(turn, {}).setdefault(name, {}).setdefault(S, []).append(us)

    def empties():
        torch.empty(N, dtype=torch.int32, device=dev)
        torch.empty(N, dtype=q.dtype, device=dev)
        torch.empty(N, K.PAYLOAD, dtype=q.dtype, device=dev)

    host_us = {
        "nn1_select call": _host_us(lambda: K.nn1_select(q, r, p, m)),
        "checks (_check_cuda + _kernel_args)": _host_us(
            lambda: (K._check_cuda(q, r, m, p), K._kernel_args(q, r, m, p))),
        "three torch.empty": _host_us(empties),
        "stream lookup": _host_us(lambda: K._stream(dev)),
        "ctypes launch": _host_us(raw(True, a.S)),
    }
    out = {"card": card, "shape": "N=M=2048 f64 query, f32 ref, bool mask, f32 P=11",
           "kernel_us_by_cluster_size": kernel_us, "cluster_size_used": a.S,
           "host_us": host_us}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
