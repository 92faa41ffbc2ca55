"""Host and device time per call of one component, for the profilers
(`profile_linearize`, `profile_ndt`, `profile_graph_solve`, `profile_ugpm`)
and `dispatch`.

The JAX scripts chain a component inside one jitted `fori_loop`, so that
one dispatch covers n calls and the reading is the compute, not the
dispatch. The card has no such loop. Its counterpart here is n
back-to-back eager calls, each fed the previous one's output, with no host
read in between, between one pair of CUDA events, over n (`chain_ms`):
where the host launches slower than the card runs, that is host time.
Beside it, `device_ms` sums the card's activities (kernels, copies,
memsets) of one call of the chain under torch.profiler. A component
whose `chain_ms` is well above its `device_ms` is launch-bound: the card
waits for the host. A component that reads the host (an LM or Newton
loop's stop flag) synchronises inside the chain, and its `chain_ms`
includes those waits.

Off the card (`--device cpu`, the tests) `chain_ms` is the host clock and
`device_ms` is None.
"""

from __future__ import annotations

import time

import torch

from ..utils.profiling import device_activities, events_ms


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chain(step, x0, n):
    x = x0
    for _ in range(n):
        x = step(x)
    return x


def chain_ms(step, x0, n, reps, device):
    """Milliseconds per call of `x = step(x)`, n calls chained from x0,
    `reps` chains, after one warm-up call."""
    device = torch.device(device)
    step(x0)
    sync(device)
    if device.type == "cuda":
        return events_ms(lambda: _chain(step, x0, n), reps) / (reps * n)
    t0 = time.perf_counter()
    for _ in range(reps):
        _chain(step, x0, n)
    return 1e3 * (time.perf_counter() - t0) / (reps * n)


def device_ms(step, x0, device):
    """(device ms, device activities) of one call `step(x0)` under
    torch.profiler (warm: run after `chain_ms`); (None, None) off the card."""
    if torch.device(device).type != "cuda":
        return None, None
    acts = device_activities(lambda: step(x0))
    return sum(us for _, us in acts) / 1e3, len(acts)


def split(step, x0, n, reps, device) -> dict:
    """`chain_ms` and `device_ms` of one component, and the card's busy
    share of the chained calls (device / host)."""
    host = chain_ms(step, x0, n, reps, device)
    dev, acts = device_ms(step, x0, device)
    return {"host_ms": host, "device_ms": dev, "activities_per_call": acts,
            "busy_share": None if dev is None else dev / host}


def fmt(name, row, width=28) -> str:
    """One line of a split: host ms, device ms, activities, busy share."""
    if row["device_ms"] is None:
        return f"{name:<{width}}{row['host_ms']:10.4f} ms host"
    return (f"{name:<{width}}{row['host_ms']:10.4f} ms host {row['device_ms']:10.4f} ms device "
            f"({row['activities_per_call']:.1f} activities per call, busy "
            f"{100 * row['busy_share']:.1f}%)")


def profiler_cli(doc, main, argv=None):
    """The command line of a profiler: `--device` (default cuda) and
    `--out`; `main(device)` returns its readings, printed as one JSON line
    and written to `--out` where given."""
    import argparse
    import json
    import sys
    from pathlib import Path

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the readings here (JSON)")
    args = ap.parse_args(argv)
    res = main(args.device)
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=2) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return res
