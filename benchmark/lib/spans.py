"""The program's own records of the traced window (`gorio_tpu_torch`'s
`utils/profiling.read_spans`: the last profiler session's), gathered per
traced `run_hmc` call for the readers `hmc_capture_ms`, `density_eval_ms`
and `leapfrog_overhead_ms` and for `accounting.py`. A program that keeps
no records, or a window with none, gives no calls."""

from __future__ import annotations

import statistics


def records() -> list:
    try:
        from gorio_tpu_torch.utils.profiling import read_spans
    except ImportError:  # a program without its own spans
        return []
    spans = read_spans()
    return spans["records"] if spans else []


def hmc_calls(recs=None) -> list:
    """One dict per complete `hmc.run` record of `recs` (default the
    program's): `counts` (the run's), `run_ms` (device ms of its event pair,
    None off the card), `captures` and `capture_ms` (its `hmc.capture`
    spans and their host ms), `loop_ms` (device ms of its `hmc.loop`),
    `replays_ms` (device ms of every `hmc.replay` inside it) and
    `trajectories` ((device ms, device ms of the replays inside, leapfrog
    steps) of each `hmc.trajectory` with device times).
    A parent's row precedes its children's."""
    recs = records() if recs is None else recs
    calls, run_of, traj_of = {}, [], []
    for i, r in enumerate(recs):
        p = r["parent"]
        run_of.append(i if r["name"] == "hmc.run" else None if p is None else run_of[p])
        traj_of.append(i if r["name"] == "hmc.trajectory" else None if p is None else traj_of[p])
        if r["name"] == "hmc.run" and r["complete"] and r["end_ns"] is not None:
            calls[i] = dict(counts=r["counts"], run_ms=r["device_ms"], captures=0,
                            capture_ms=0.0, loop_ms=None, replays_ms=[], trajectories=[])
    inside = {}  # trajectory row -> device ms of its replays
    for i, r in enumerate(recs):
        call = calls.get(run_of[i])
        if call is None or r["end_ns"] is None:
            continue
        if r["name"] == "hmc.capture":
            call["captures"] += 1
            call["capture_ms"] += (r["end_ns"] - r["start_ns"]) * 1e-6
        elif r["name"] == "hmc.loop":
            call["loop_ms"] = r["device_ms"]
        elif r["name"] == "hmc.replay" and r["device_ms"] is not None:
            call["replays_ms"].append(r["device_ms"])
            if traj_of[i] is not None:
                inside[traj_of[i]] = inside.get(traj_of[i], 0.0) + r["device_ms"]
    for i, r in enumerate(recs):
        if r["name"] == "hmc.trajectory" and r["device_ms"] is not None and run_of[i] in calls:
            calls[run_of[i]]["trajectories"].append(
                (r["device_ms"], inside.get(i, 0.0), r["counts"].get("leapfrog_steps", 0)))
    return list(calls.values())


def overheads_ms(trajectories) -> list:
    """Device ms per leapfrog step outside the replays, one per trajectory."""
    return [(ms - replays) / steps for ms, replays, steps in trajectories if steps]


def accounting(call) -> dict:
    """One call's device length (`hmc.run`'s events) against its parts:
    the capture (host ms), every replay, and the call's median
    `leapfrog_overhead_ms` times its leapfrog steps; `remainder_share` is
    the share of the length they leave out. Two parts of the remainder
    are given: `between_ms`, the loop's time outside its trajectories, and
    `stall_ms`, the trajectories' time outside their replays above the
    median's share (a host stall lands there)."""
    over = overheads_ms(call["trajectories"])
    steps = call["counts"].get("leapfrog_steps", 0)
    parts = dict(capture_ms=call["capture_ms"], replays_ms=sum(call["replays_ms"]),
                 steps_ms=statistics.median(over) * steps if over else 0.0)
    total, run_ms, loop_ms = sum(parts.values()), call["run_ms"], call["loop_ms"]
    traj_ms = sum(ms for ms, _, _ in call["trajectories"])
    return dict(counts=call["counts"], run_device_ms=run_ms, **parts,
                replays=len(call["replays_ms"]), sum_ms=total,
                remainder_share=1.0 - total / run_ms if run_ms else None,
                between_ms=loop_ms - traj_ms if loop_ms is not None else None,
                stall_ms=traj_ms - sum(r for _, r, _ in call["trajectories"])
                - parts["steps_ms"])
