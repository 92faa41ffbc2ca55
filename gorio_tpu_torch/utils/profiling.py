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

`span` and `count` are the program's own tracing: records of named host
intervals, their parents and counts, and, on the card, a pair of CUDA
events around each, taken only while a `torch.profiler` session records
(`trace()` starts one), those of the newest session alone kept;
`read_spans` reads them.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import threading
import time
from array import array
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


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


# ---- the program's spans ---------------------------------------------------
#
# Tracing is on exactly while a torch.profiler session records. Spans are
# kept apart from the profiler's own events: a `record_function` range would
# also be drawn on the card's timeline as device work, and so hide the idle
# time between kernels that the records are there to place. A record is a
# row of flat columns allocated once, and its CUDA events come from a pool
# that later sessions reuse, so that a span leaves no Python object behind
# for the garbage collector to walk inside a traced window.

MAX_RECORDS = 1 << 16  # records kept of a session; later spans are dropped and counted
EVENT_CHUNK = 8192  # CUDA events the pool grows by


class _Store:
    """The records of the newest profiler session: row `i` holds a span's
    name (an index into `names`), parent row (-1 at the top), host start
    and end from `time.time_ns()` (0 while open), thread, first pool event
    of its CUDA pair (-1 for none) and whether it is complete (1); `counts`
    maps a row to its counts. `gen` numbers the sessions (0: none yet); the
    columns are allocated as the first opens, the events as spans need
    them, and both are reused by the sessions after."""

    COLUMNS = ("name", "parent", "start", "end", "tid", "event", "complete")

    def __init__(self):
        self.names, self.name_ids, self.events, self.counts = [], {}, [], {}
        self.gen = self.n = self.dropped = self.n_events = self.size = 0

    def reset(self):
        if self.size < MAX_RECORDS:
            for col in self.COLUMNS:
                setattr(self, col, array("q", bytes(8 * MAX_RECORDS)))
            self.size = MAX_RECORDS
        self.gen += 1
        self.n = self.dropped = self.n_events = 0
        self.counts = {}

    def take_events(self) -> int:
        """The pool index of a fresh event pair, the pool grown if needed."""
        k = self.n_events
        if k + 2 > len(self.events):
            self.events += [torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CHUNK)]
        self.n_events = k + 2
        return k


_store = _Store()
_local = threading.local()  # per thread: `stack` of open rows (-1: dropped), its `gen`, `tid`
_OFF = contextlib.nullcontext()


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    start()
    _store.reset()


# every torch.profiler session (and the legacy autograd profiler) calls this
# hook as it starts: it replaces the records of the session before
if not hasattr(_autograd_profiler._run_on_profiler_start, "opens_span_sessions"):
    _on_profiler_start.opens_span_sessions = True
    _autograd_profiler._run_on_profiler_start = _on_profiler_start


def _open_spans() -> list:
    """This thread's open rows of the current session."""
    if getattr(_local, "gen", None) != _store.gen:
        _local.stack, _local.gen = [], _store.gen
        _local.tid = threading.get_native_id()
    return _local.stack


class _Span:
    __slots__ = ("name", "device", "counts", "row", "gen")

    def __init__(self, name, device, counts):
        self.name, self.device, self.counts = name, device, counts

    def __enter__(self):
        st = _store
        if st.gen == 0:  # the profiler started before this module was imported
            st.reset()
        stack = _open_spans()
        self.gen, i = st.gen, st.n
        if i >= MAX_RECORDS:
            st.dropped += 1
            for j in stack:
                if j >= 0:
                    st.complete[j] = 0
            stack.append(-1)
            self.row = -1
            return None
        st.n = i + 1
        name_id = st.name_ids.get(self.name)
        if name_id is None:
            name_id = st.name_ids[self.name] = len(st.names)
            st.names.append(self.name)
        st.name[i], st.parent[i] = name_id, stack[-1] if stack else -1
        st.end[i], st.tid[i], st.complete[i], st.event[i] = 0, _local.tid, 1, -1
        if self.counts:
            st.counts[i] = self.counts
        stack.append(i)
        self.row = i
        if self.device is not None and self.device.type == "cuda":
            k = st.event[i] = st.take_events()
            st.events[k].record(torch.cuda.current_stream(self.device))
        st.start[i] = time.time_ns()
        return i

    def __exit__(self, *exc):
        st, i = _store, self.row
        if self.gen != st.gen:  # a later session replaced the one it began in
            return False
        _local.stack.pop()
        if i >= 0:
            st.end[i] = time.time_ns()
            if st.event[i] >= 0:
                st.events[st.event[i] + 1].record(torch.cuda.current_stream(self.device))
        return False


def span(name: str, device=None, **counts):
    """A traced interval of the program, `with span("hmc.loop", device=q.device):`.
    While a torch.profiler session records, keeps a record with the
    enclosing span as parent and `counts` (ints) as its first counts, and,
    where `device` is a CUDA device, a pair of CUDA events on its current
    stream around the block; yields the record's row. Otherwise it reads
    one flag and does nothing else (yields None)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, counts)


def count(name: str, n: int = 1):
    """Add `n` to the count `name` of every span open on this thread, where
    the work is done; nothing but a flag read while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    counts = _store.counts
    for i in _open_spans():
        if i >= 0:
            c = counts.get(i)
            if c is None:
                c = counts[i] = {}
            c[name] = c.get(name, 0) + n


def read_spans() -> dict | None:
    """The records of the newest profiler session as plain data, or None
    before the first: `{"records": [...], "dropped": n}`, each record a
    dict of `name`, `parent` (its index in `records`, None at the top),
    `start_ns`, `end_ns` (None while open), `tid`, `counts`, `device_ms`
    (the CUDA events' milliseconds, None off the card) and `complete`. Read
    after the spans' device work: each event pair is waited for here."""
    st = _store
    if st.gen == 0:
        return None
    out = []
    for i in range(st.n):
        k, end, device_ms = st.event[i], st.end[i] or None, None
        if k >= 0 and end is not None:
            st.events[k + 1].synchronize()
            device_ms = st.events[k].elapsed_time(st.events[k + 1])
        out.append(dict(name=st.names[st.name[i]], parent=st.parent[i] if st.parent[i] >= 0
                        else None, start_ns=st.start[i], end_ns=end, tid=st.tid[i],
                        counts=dict(st.counts.get(i, {})), device_ms=device_ms,
                        complete=bool(st.complete[i])))
    return dict(records=out, dropped=st.dropped)


def _span_trace_events(spans: dict, base_ns: int) -> list:
    """Chrome-trace events of `read_spans`'s records, on the clock of a
    kineto trace whose `baseTimeNanoseconds` is `base_ns`."""
    pid, out = os.getpid(), []
    for rec in spans["records"]:
        if rec["end_ns"] is None:
            continue
        args = dict(rec["counts"])
        if rec["device_ms"] is not None:
            args["device_ms"] = rec["device_ms"]
        out.append(dict(ph="X", cat="gorio_span", name=rec["name"], pid=pid, tid=rec["tid"],
                        ts=(rec["start_ns"] - base_ns) / 1e3,
                        dur=(rec["end_ns"] - rec["start_ns"]) / 1e3, args=args))
    return out


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with `torch.profiler`: host activities, and the
    card's where one is present. On exit writes a Chrome trace
    (`trace.json`, view it in Perfetto or chrome://tracing) into `log_dir`
    (default `gorio_trace` under the temporary directory) and yields
    `log_dir`. The trace also holds the program's spans of the block (host
    events of category `gorio_span`, each with its counts and, on the card,
    `device_ms` in its arguments) on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "gorio_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    doc["traceEvents"] += _span_trace_events(read_spans(),
                                             int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as fh:
        json.dump(doc, fh)


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
