"""The port's own tracing (`gorio_tpu_torch/utils/profiling.py` `span`,
`count`, `read_spans`) and `run_hmc`'s spans: records only while a
torch.profiler session records, nested with their parents, those of the
newest session alone kept, left behind as no Python objects, on kineto's
clock and invisible to kineto; `run_hmc`'s counts equal its work, and its
draws do not change with tracing on.

This file imports no JAX, so that its card test runs where there is none:
`python -m pytest --noconftest tests/test_torch_tracing.py -m cuda`."""

import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gorio_tpu_torch.inference import hmc as th
from gorio_tpu_torch.utils import profiling as P

SPAN_NAMES = ("hmc.run", "hmc.capture", "hmc.init", "hmc.loop", "hmc.trajectory",
              "hmc.replay")


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _gaussian(device="cpu"):
    prec = torch.linspace(0.5, 4.0, 6, dtype=torch.float64, device=device)
    return lambda q: -0.5 * torch.sum(prec * q * q, dim=-1)


def _draws(S, C=3, D=6, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((S, C, D), generator=gen, dtype=torch.float64)
    log_u = torch.log(torch.rand((S, C), generator=gen, dtype=torch.float64))
    return z.to(device), log_u.to(device)


def _run(adapt, n_samples=6, n_warmup=3, n_leapfrog=4, device="cpu"):
    S = (n_warmup if adapt else 0) + n_samples
    return th.run_hmc(_gaussian(device), 0.1 * torch.ones((3, 6), dtype=torch.float64,
                                                          device=device),
                      n_samples=n_samples, step_size=0.2, n_leapfrog=n_leapfrog, adapt=adapt,
                      n_warmup=n_warmup, draws=_draws(S, device=device))


def _by_name(spans, name):
    return [r for r in spans["records"] if r["name"] == name]


def test_spans_nest_record_parents_and_counts():
    with _profiled():
        with P.span("a", n=2) as a:
            with P.span("b"):
                P.count("k", 3)
                with P.span("c"):
                    P.count("k")
            with P.span("d"):
                pass
    spans = P.read_spans()
    assert a is not None and spans["dropped"] == 0
    recs = spans["records"]
    assert [r["name"] for r in recs] == ["a", "b", "c", "d"]
    assert [r["parent"] for r in recs] == [None, 0, 1, 0]
    assert [r["counts"] for r in recs] == [{"n": 2, "k": 4}, {"k": 4}, {"k": 1}, {}]
    for r in recs:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None and r["complete"]
    assert recs[0]["start_ns"] <= recs[1]["start_ns"] and recs[2]["end_ns"] <= recs[1]["end_ns"]


def test_without_a_profiler_nothing_is_recorded():
    with _profiled():
        with P.span("before"):
            pass
    held = P.read_spans()
    assert P.span("x", n=1) is P.span("y")  # one shared no-op context
    with P.span("x", n=1) as rec:
        P.count("k")
    assert rec is None
    _run(adapt=True)
    assert P.read_spans() == held


def test_sessions_are_kept_apart_and_bounded(monkeypatch):
    """A new profiler session replaces the records of the one before, and a
    span left open across the change writes nothing into the new one; a
    session keeps `MAX_RECORDS` records and counts the spans past them as
    dropped, their enclosing records marked incomplete."""
    with _profiled():
        with P.span("s0"):
            pass
        straddle = P.span("straddle")
        straddle.__enter__()
    with _profiled():
        with P.span("s1", n=1):
            pass
        straddle.__exit__(None, None, None)
        with P.span("s2"):
            pass
    assert [(r["name"], r["parent"], r["counts"]) for r in P.read_spans()["records"]] == [
        ("s1", None, {"n": 1}), ("s2", None, {})]
    monkeypatch.setattr(P, "MAX_RECORDS", 2)
    with _profiled():
        with P.span("top"):
            with P.span("kept"):
                pass
            with P.span("dropped"):
                with P.span("inner"):
                    pass
    spans = P.read_spans()
    assert [r["name"] for r in spans["records"]] == ["top", "kept"]
    assert spans["dropped"] == 2
    assert [r["complete"] for r in spans["records"]] == [False, True]


def test_records_leave_no_python_objects():
    """Spans are rows of flat columns: thousands of them, counted, leave no
    object behind for the garbage collector."""
    with _profiled():
        with P.span("warm"):
            P.count("k")
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(5000):
            with P.span("replay"):
                P.count("k")
        gc.collect()
        grown = len(gc.get_objects()) - before
    assert len(P.read_spans()["records"]) == 5001
    assert grown < 100


def test_records_lie_on_the_kineto_clock():
    """A span's start and a `record_function` opened right inside it agree
    to within a few ms, and every record falls inside the session's kineto
    events, give or take as much."""
    with _profiled() as prof:
        with P.span("outer"):
            with record_function("marker"):
                torch.ones(64).sum()
        _run(adapt=False)
    events = prof.profiler.kineto_results.events()
    marker = next(e for e in events if e.name() == "marker")
    first = min(e.start_ns() for e in events)
    last = max(e.start_ns() + e.duration_ns() for e in events)
    recs = P.read_spans()["records"]
    assert abs(recs[0]["start_ns"] - marker.start_ns()) < 5e6
    for r in recs:
        assert first - 5e6 <= r["start_ns"] <= r["end_ns"] <= last + 5e6


def test_no_kineto_event_carries_a_span_name():
    with _profiled() as prof:
        _run(adapt=True)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not names & set(SPAN_NAMES)
    assert _by_name(P.read_spans(), "hmc.run")


@pytest.mark.parametrize("adapt", [True, False])
def test_run_hmc_counts_equal_its_work(adapt):
    n_samples, n_warmup, n_leapfrog = 6, 3, 4
    with _profiled():
        samples, _ = _run(adapt, n_samples, n_warmup, n_leapfrog)
    spans = P.read_spans()
    recs = spans["records"]
    (run,) = _by_name(spans, "hmc.run")
    iters = n_samples + (n_warmup if adapt else 0)
    assert samples.shape == (3, n_samples, 6)
    assert run["counts"] == {"chains": 3, "warmup_draws": n_warmup if adapt else 0,
                             "draws": n_samples, "leapfrog_steps": n_leapfrog * iters,
                             "density_eager": 1 + n_leapfrog * iters}
    (init,) = _by_name(spans, "hmc.init")
    (loop,) = _by_name(spans, "hmc.loop")
    assert init["counts"] == {"density_eager": 1}
    assert loop["counts"] == {"leapfrog_steps": n_leapfrog * iters,
                              "density_eager": n_leapfrog * iters}
    assert init["parent"] == loop["parent"] == recs.index(run)
    trajectories = _by_name(spans, "hmc.trajectory")
    assert len(trajectories) == iters
    for t in trajectories:
        assert t["parent"] == recs.index(loop)
        assert t["counts"] == {"leapfrog_steps": n_leapfrog, "density_eager": n_leapfrog}
    assert not _by_name(spans, "hmc.capture") and not _by_name(spans, "hmc.replay")


@pytest.mark.parametrize("adapt", [True, False])
def test_run_hmc_bit_equal_with_tracing_on_and_off(adapt):
    off = _run(adapt)
    with _profiled():
        on = _run(adapt)
    assert _by_name(P.read_spans(), "hmc.run")
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_replay_events():
    """On the card: one `hmc.replay` record with device time per replay (the
    count `density_replays`), the capture's eager evaluations counted apart,
    one `hmc.trajectory` a draw, and the replays inside each trajectory take
    no more of the card's time than it, nor the trajectories than the loop;
    the draws equal those of an untraced run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_samples, n_leapfrog = 5, 3
    off = _run(False, n_samples, 0, n_leapfrog, device="cuda")
    with _profiled():
        on = _run(False, n_samples, 0, n_leapfrog, device="cuda")
    torch.cuda.synchronize()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    spans = P.read_spans()
    recs = spans["records"]
    (run,) = _by_name(spans, "hmc.run")
    (loop,) = _by_name(spans, "hmc.loop")
    (cap,) = _by_name(spans, "hmc.capture")
    replays = _by_name(spans, "hmc.replay")
    trajectories = _by_name(spans, "hmc.trajectory")
    steps = n_samples * n_leapfrog
    assert run["counts"] == {"chains": 3, "warmup_draws": 0, "draws": n_samples,
                             "leapfrog_steps": steps, "density_replays": 1 + steps,
                             "density_eager": 2, "captures": 1}
    assert cap["counts"] == {"density_eager": 2, "captures": 1}
    assert len(replays) == 1 + steps and all(r["device_ms"] > 0 for r in replays)
    assert len(trajectories) == n_samples
    for t in trajectories:
        i = recs.index(t)
        inner = [r["device_ms"] for r in replays if r["parent"] == i]
        assert t["parent"] == recs.index(loop) and len(inner) == n_leapfrog
        assert t["counts"] == {"leapfrog_steps": n_leapfrog, "density_replays": n_leapfrog}
        assert sum(inner) <= t["device_ms"]
    assert sum(t["device_ms"] for t in trajectories) <= loop["device_ms"] <= run["device_ms"]
