"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads `BENCHMARK.json` at the root of the checkout, the cell's configuration
(`benchmark/configs/<config>.json`, which names its driver) and traffic mix
(`benchmark/traffic/<traffic>.json`), and runs the driver
(`benchmark/drivers/<driver>.py`): set-up (inputs made from the seed,
warm-up), a window of `--seconds`, then the check of what the window
produced against the plain reference (`benchmark/reference/`). With
`--trace 0` it reports the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, each computed by its reader `benchmark/metrics/<name>.py`.

The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics`, `device` and, traced, `breakdown`, then `checks` (each
number compared with its limit, also printed last on standard error). The
run exits non-zero with no result line when there is no CUDA device or
fewer than the cell asks for, when the program (`gorio_tpu_torch`) is not
beside the benchmark, and when `jax`, `jaxlib`, `flax` or `gorio_tpu` were
imported by the end.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(l.split()[1]) for l in fh if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the program inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gorio_tpu")


def forbidden_modules() -> list:
    """Whole top-level names of loaded modules that the benchmark may not
    load (`gorio_tpu_torch` is not `gorio_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def few_threads():
    """One process with few threads: the host's math libraries keep to one
    thread each (set before any of them loads; torch's own in `execute`).
    The host loop is not pinned to cores: pinned to the first two, runs of
    one call sped up by ~25% from first to last (PERF.md, section 6)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def execute(workload: str, seed: int, seconds: float, trace: bool, device=None, log=None):
    """One run of a cell; returns the result object. `device` None means
    the card, which must be there; tests pass a CPU device to drive the
    rest of a run."""
    from benchmark.lib import manifest as mf

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    man = mf.load_manifest()
    entry, conf, config, traffic = mf.cell(man, workload)
    import torch

    if device is None:
        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            fail("no CUDA device is available; the benchmark runs only on the card")
        if torch.cuda.device_count() < entry["chips"]:
            fail(f"{workload} needs {entry['chips']} CUDA devices, "
                 f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    try:
        import gorio_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program gorio_tpu_torch is not importable beside the benchmark: {e}")

    drv = mf.driver(config["driver"])
    ctx = dict(workload=workload, seed=seed, seconds=seconds, trace=trace, device=device,
               config=config, traffic=traffic, log=log)
    state = drv.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - T_START
    log(f"[setup] {setup_s:.3f} s ({', '.join(f'{k} {v:.3f} s' for k, v in state.setup_parts)})")
    obs = drv.window(state, ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        mem = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        mem, kind = 0, "cpu"
    obs["setup_s"] = setup_s
    checks = drv.check(state, obs, ctx)
    del state
    gc.collect()

    metrics = {}
    for m in mf.metrics_of(man, workload, trace):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = mf.reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": entry["chips"], "memory_peak_bytes": mem}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks) and bool(checks),
              "attempted": int(obs["attempted"]), "failed": int(obs["failed"]),
              "metrics": metrics, "device": dev}
    if trace and obs.get("trace") is not None:
        busy_s, window_s, device_ops, idle_gaps = obs["trace"]
        dev["busy_s"] = busy_s
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": device_ops, "idle_gaps": idle_gaps}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    few_threads()
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        fail(f"the run imported {', '.join(found)}", 4)
    print(f"[card] {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
