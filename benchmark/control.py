"""The control of a cell's `correct`: its plain reference computed one
precision below the configuration's, put in the program's place, and judged
by the same comparison. It has to come out not correct; its readings are
the upper readings from which the limits in the configuration files were
set (PERF.md). The benchmark's own runs never run it.

    python3 benchmark/control.py --workload NAME --seconds S --seeds N [N ...]

Each seed is one process-local run: set-up and a window of S seconds of
the program, then the cell's `check` in `benchmark/drivers/` twice: on the
program's own outputs (a sound run's readings, the lower ones) and with
`control=True` from the same states and draws (the upper ones). Prints one
JSON line per seed with both readings, and exits 1 if any seed's control
came out correct.
"""

from __future__ import annotations

import argparse
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

    import torch

    from benchmark.lib import manifest as mf

    if not torch.cuda.is_available():
        sys.exit("control: no CUDA device")
    man = mf.load_manifest()
    _, _, config, traffic = mf.cell(man, args.workload)
    drv = mf.driver(config["driver"])
    passed = []
    for seed in args.seeds:
        log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
        ctx = dict(workload=args.workload, seed=seed, seconds=args.seconds, trace=False,
                   device=torch.device("cuda", 0), config=config, traffic=traffic, log=log)
        st = drv.setup(ctx)
        obs = drv.window(st, ctx)
        program = drv.check(st, obs, ctx)
        checks = drv.check(st, obs, ctx, control=True)
        ok = all(c["value"] <= c["limit"] for c in checks)
        passed.append(ok)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": ok,
                          "program_correct": all(c["value"] <= c["limit"] for c in program),
                          "program": {c["name"]: c["value"] for c in program},
                          "readings": {c["name"]: c["value"] for c in checks},
                          "limits": {c["name"]: c["limit"] for c in checks}}), flush=True)
        del st
        torch.cuda.empty_cache()
    sys.exit(1 if any(passed) else 0)


if __name__ == "__main__":
    main()
