"""Per-stage timing statistics and device traces.

The port's own copy of `StageTimer` from `gorio_tpu/utils/profiling.py`:
wall times per named stage and a median/mean/max report, the counterpart of
the reference's `/command "time"` dump. On a CUDA device the timer
synchronises the device before it reads the clock at a stage's start and
end, so a stage's time is the device work it enqueued and not only the
enqueue, and excludes work enqueued before it. `trace()` is the counterpart
of the JAX package's `jax.profiler` wrapper, over `torch.profiler`.
`events_ms` and `device_activities` are the card's two clocks that the
port's timing tools read (`evaluation/timing.py`, `ops/nn_profile.py`,
`chip_smoke.py`). `graph/solve_timing.py` and `ops/call_timing.py` keep
their own copies: they time whichever tree is first on the path, which may
predate these two.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self, device=None):
        self.samples = defaultdict(list)
        device = torch.device("cpu") if device is None else torch.device(device)
        self._sync = device.type == "cuda"
        self._device = device

    def _now(self) -> float:
        if self._sync:
            torch.cuda.synchronize(self._device)
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = self._now()
        try:
            yield
        finally:
            self.samples[name].append(self._now() - t0)

    def tic(self, name: str):
        self._tics = getattr(self, "_tics", {})
        self._tics[name] = self._now()

    def toc(self, name: str):
        self.samples[name].append(self._now() - self._tics.pop(name))

    def report(self) -> str:
        """Median/mean/max per stage; parity with the `/command "time"` dump."""
        lines = [f"{'stage':<28}{'n':>6}{'median ms':>12}{'mean ms':>12}{'max ms':>12}"]
        for name, xs in sorted(self.samples.items()):
            ms = [1000 * x for x in xs]
            lines.append(
                f"{name:<28}{len(ms):>6}{statistics.median(ms):>12.2f}"
                f"{statistics.mean(ms):>12.2f}{max(ms):>12.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with `torch.profiler`: host activities, and the
    card's where one is present. On exit writes a Chrome trace
    (`trace.json`, view it in Perfetto or chrome://tracing) into `log_dir`
    (default `gorio_trace` under the temporary directory) and yields
    `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "gorio_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def events_ms(fn, calls=1) -> float:
    """Milliseconds between one pair of CUDA events around `calls` calls of
    `fn()` back to back, with no host read in between: where the host
    launches slower than the card runs, the host's time. Needs a card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_activities(fn) -> list:
    """(name, device us) of every activity (kernel, copy, memset) that `fn()`
    puts on the card, under torch.profiler, the card synchronised before and
    after. Profile few calls: the profiler's host-side event list grows with
    every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
