"""The traced run's device trace: `torch.profiler` over part of the window,
reduced to the device's busy seconds, the device operations by time and the
idle gaps by what the host was doing.

Busy time is the union of the intervals of every device activity (kernels,
copies, sets), so work of several streams that overlaps counts once. A gap
is named by the benchmark spans (`bench/...`) open on the host at its
middle, one per thread, joined with "+"; "none" where no span was open.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

TOP = 10  # entries of each list in the result line's `breakdown`


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """`start()` / `stop()` profile what runs between them; `reduce()` then
    gives (busy_s, window_s, device_ops, idle_gaps). The profiler's results are read raw (`kineto_results`), never parsed
    into function events, which would take minutes for a window of a
    frame loop."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_wall = time.perf_counter()

    def stop(self):
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0_wall
        self.prof.__exit__(None, None, None)

    def reduce(self):
        events = self.prof.profiler.kineto_results.events()
        dev, spans = [], []
        for ev in events:
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.name().startswith("bench/"):
                # a span's annotation is also drawn on the device's timeline:
                # only the host's copy counts, and as no device work
                if ev.device_type() != torch.autograd.DeviceType.CUDA:
                    spans.append((start, start + dur, ev.name()[6:], ev.start_thread_id()))
            elif ev.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, start + dur, ev.name()))
        if not dev:
            return None
        busy = _union([(s, e) for s, e, _ in dev])
        busy_s = sum(e - s for s, e in busy) * 1e-9
        by_name = defaultdict(float)
        for s, e, name in dev:
            by_name[name[:120]] += (e - s) * 1e-9
        device_ops = sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP]
        holes = [(0.5 * (e0 + s1), (s1 - e0) * 1e-9)
                 for (_, e0), (s1, _) in zip(busy, busy[1:])]
        labels = [[] for _ in holes]
        by_thread = defaultdict(list)
        for s, e, name, tid in spans:
            by_thread[tid].append((s, e, name))
        for tid_spans in by_thread.values():
            # one sweep per thread: spans of a thread nest, so the top of
            # the stack of open spans is the innermost at a gap's middle
            tid_spans.sort(key=lambda x: (x[0], -x[1]))
            stack, k = [], 0
            for h, (mid, _) in enumerate(holes):
                while k < len(tid_spans) and tid_spans[k][0] <= mid:
                    stack.append(tid_spans[k])
                    k += 1
                while stack and stack[-1][1] < mid:
                    stack.pop()
                # a span that ended below a still-open one: drop it lazily
                live = [x for x in stack if x[1] >= mid]
                if len(live) != len(stack):
                    stack = live
                if stack:
                    labels[h].append(stack[-1][2])
        gaps = defaultdict(float)
        for (_, sec), names in zip(holes, labels):
            gaps["+".join(sorted(names)) or "none"] += sec
        idle_gaps = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:TOP]
        return busy_s, self.window_s, device_ops, idle_gaps


def span(name: str):
    """A host span the trace can see (`bench/<name>`)."""
    return torch.profiler.record_function("bench/" + name)
