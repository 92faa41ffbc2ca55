"""The readers of the program's spans (`metrics/hmc_capture_ms.py`,
`density_eval_ms.py`, `leapfrog_overhead_ms.py`) and the per-call
accounting (`lib/spans.py`) on hand-made records: the values they should
give, None with no records or a program without spans, and only the last
profiler session's records."""

import pytest

from benchmark.lib import manifest as mf
from benchmark.lib import spans
from gorio_tpu_torch.utils import profiling as P

READERS = ("hmc_capture_ms", "density_eval_ms", "leapfrog_overhead_ms")


def _records(rows, complete=True):
    """`read_spans`' records from (name, parent, host ms, device ms, counts)
    rows, every span starting at 0."""
    return [dict(name=name, parent=parent, start_ns=0, end_ns=int(host_ms * 1e6), tid=1,
                 counts=counts, device_ms=device_ms, complete=complete)
            for name, parent, host_ms, device_ms, counts in rows]


def _call(capture_ms, init_ms, trajectories, run_ms=1000.0, loop_ms=900.0, offset=0):
    """One `run_hmc` call's rows: the first replay in `hmc.init`, then one
    `hmc.trajectory` per (device ms, its replays' device ms, steps)."""
    steps = sum(s for _, _, s in trajectories)
    replays = 1 + sum(len(r) for _, r, _ in trajectories)
    rows = [("hmc.run", None, 1000.0, run_ms, {"leapfrog_steps": steps,
                                               "density_replays": replays}),
            ("hmc.capture", offset, capture_ms, None, {}),
            ("hmc.init", offset, 5.0, None, {}),
            ("hmc.replay", offset + 2, 4.0, init_ms, {}),
            ("hmc.loop", offset, 900.0, loop_ms, {"leapfrog_steps": steps})]
    for ms, replays_ms, n in trajectories:
        t = offset + len(rows)
        rows.append(("hmc.trajectory", offset + 4, ms, ms, {"leapfrog_steps": n}))
        rows += [("hmc.replay", t, 4.0, x, {}) for x in replays_ms]
    return rows


def _two_calls():
    # overheads per step: 1, 1, 1 ms (a); 0.5, 0.5 ms (b)
    a = _call(100.0, 4.0, [(4 * 4.0 + 4, [4.0] * 4, 4)] * 3)
    b = _call(140.0, 3.0, [(3 * 3.0 + 1.5, [3.0] * 3, 3)] * 2, offset=len(a))
    return a + b


def _feed(monkeypatch, rows, complete=True, dropped=0):
    monkeypatch.setattr(P, "read_spans",
                        lambda: dict(records=_records(rows, complete), dropped=dropped))


def _read(name):
    return mf.reader(name).read({})


def test_readers_on_hand_made_records(monkeypatch):
    _feed(monkeypatch, _two_calls())
    assert _read("hmc_capture_ms") == pytest.approx(120.0)
    # 1 + 12 replays at 4 ms, 1 + 6 at 3 ms
    assert _read("density_eval_ms") == pytest.approx((13 * 4.0 + 7 * 3.0) / 20)
    # the median of 1, 1, 1, 0.5, 0.5 ms a step
    assert _read("leapfrog_overhead_ms") == pytest.approx(1.0)


def test_leapfrog_overhead_is_a_median_over_trajectories(monkeypatch):
    """A host stall of 70 ms in one of 5 trajectories leaves the median."""
    trajs = [(4 * 4.0 + 2, [4.0] * 4, 4)] * 4 + [(4 * 4.0 + 72, [4.0] * 4, 4)]
    _feed(monkeypatch, _call(100.0, 4.0, trajs))
    assert _read("leapfrog_overhead_ms") == pytest.approx(0.5)


def test_accounting_of_a_call(monkeypatch):
    """The call's length against the capture, every replay, and its median
    overhead times its steps; what they leave out is the remainder, of which
    the loop's time outside its trajectories and the trajectories' above
    the median are given."""
    trajs = [(4 * 4.0 + 4, [4.0] * 4, 4)] * 2 + [(4 * 4.0 + 10, [4.0] * 4, 4)]
    rows = _call(100.0, 4.0, trajs, run_ms=250.0, loop_ms=80.0)
    _feed(monkeypatch, rows)
    (call,) = spans.hmc_calls()
    assert call["captures"] == 1 and len(call["trajectories"]) == 3
    acc = spans.accounting(call)
    assert acc["replays"] == call["counts"]["density_replays"] == 13
    assert (acc["capture_ms"], acc["replays_ms"], acc["steps_ms"]) == pytest.approx(
        (100.0, 52.0, 12.0))
    assert acc["sum_ms"] == pytest.approx(164.0)
    assert acc["remainder_share"] == pytest.approx(1 - 164.0 / 250.0)
    assert acc["between_ms"] == pytest.approx(80.0 - 66.0)
    assert acc["stall_ms"] == pytest.approx(6.0)


def test_incomplete_calls_are_left_out(monkeypatch):
    full = _records(_two_calls())
    cut = _records(_call(500.0, 9.0, [(99.0, [9.0], 1)], offset=len(full)), complete=False)
    monkeypatch.setattr(P, "read_spans", lambda: dict(records=full + cut, dropped=1))
    assert _read("hmc_capture_ms") == pytest.approx(120.0)
    assert _read("leapfrog_overhead_ms") == pytest.approx(1.0)
    assert len(spans.hmc_calls()) == 2


@pytest.mark.parametrize("name", READERS)
def test_no_records_no_value(monkeypatch, name):
    monkeypatch.setattr(P, "read_spans", lambda: None)
    assert _read(name) is None
    _feed(monkeypatch, [("other", None, 1.0, None, {})])
    assert _read(name) is None
    monkeypatch.delattr(P, "read_spans")  # a program without its own spans
    assert _read(name) is None


def test_off_the_card_only_the_capture_reads(monkeypatch):
    """Host records without device times (the CPU): the device readers give
    None."""
    _feed(monkeypatch, [(n, p, ms, None, c) for n, p, ms, _, c in _two_calls()])
    assert _read("hmc_capture_ms") == pytest.approx(120.0)
    assert _read("density_eval_ms") is None and _read("leapfrog_overhead_ms") is None


def test_only_the_last_session_is_read():
    """A profiler session with a traced call, then one with none: the
    readers read nothing of the first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("hmc.run"):
            with P.span("hmc.capture"):
                pass
    assert _read("hmc_capture_ms") is not None
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert spans.hmc_calls() == []
    assert all(_read(name) is None for name in READERS)


def test_only_the_last_real_session_is_read():
    """The same through torch.profiler sessions in this process: a
    `run_hmc`-shaped call under the first, one under the second."""
    from torch.profiler import ProfilerActivity, profile

    for n_captures in (3, 1):
        with profile(activities=[ProfilerActivity.CPU]):
            with P.span("hmc.run"):
                for _ in range(n_captures):
                    with P.span("hmc.capture"):
                        pass
    got = P.read_spans()
    (cap,) = [r for r in got["records"] if r["name"] == "hmc.capture"]
    assert _read("hmc_capture_ms") == pytest.approx((cap["end_ns"] - cap["start_ns"]) * 1e-6)
