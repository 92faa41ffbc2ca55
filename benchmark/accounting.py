"""Where each traced `run_hmc` call's time on the card goes, from the
program's own records (`lib/spans.py`): the call's device length (the
`hmc.run` span's CUDA events) against the capture, the density's replays
and the leapfrog steps' eager work, as `hmc_capture_ms`, `density_eval_ms`
and `leapfrog_overhead_ms` read them. The benchmark's own runs never run
it.

    python3 benchmark/accounting.py --workload NAME --seconds S --seeds N [N ...]

Each seed is one traced run of the cell in this process (`run.execute`:
set-up, a window of S seconds whose last `trace_seconds` are profiled, the
check). Prints one JSON line per seed: `correct`, the traced run's
per-layer metrics, and per traced call its counts, its device length, its
parts and the share of the length they leave out (`remainder_share`).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    from benchmark import run
    from benchmark.lib import spans

    run.few_threads()
    for seed in args.seeds:
        result = run.execute(args.workload, seed, args.seconds, trace=True)
        calls = [spans.accounting(c) for c in spans.hmc_calls()]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "calls": calls}), flush=True)
        gc.collect()  # the run's profiler, before the next window


if __name__ == "__main__":
    main()
