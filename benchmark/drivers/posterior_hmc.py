"""Driver: the trajectory posterior's HMC, as `RadarGraphSLAM.sample_posterior`
samples it after its GN solve.

Set-up: the configuration's pose graph (`reference/chain_graph.py`, drawn
from the seed) frozen by the program's `PoseGraph`, its dense LM solve
(`optimize_graph`), the Laplace-whitened `graph_logprob`
(`whitened_logprob`), and one short `run_hmc` call from the mode that
launches every kernel the window's calls launch. Window: `run_hmc(adapt=False)`
calls of `draws_per_call` draws at the configured step, each continuing the
chains from the last state, the draws (momenta, log uniforms) made by the
benchmark on the card from the seed. The stream is synchronised after each
call; the window runs calls until `--seconds` have passed and ends with the
call that crosses that mark, so its rate takes all the work and all the
time of whole calls. Traced, the profiler covers the calls of the window's
last `trace_seconds`, and only the calls before it are timed for
`leapfrog_ms`. Check: in calls drawn from the seed, the first and the last
transition and more drawn from the seed; the plain reference
(`reference/posterior.py`, its own mode and whitening) runs each from the
same state with the same draws, and the accept probabilities and the next
states are compared.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.lib.trace import DeviceTrace, span
from benchmark.reference.chain_graph import chain_graph
from benchmark.reference.posterior import GraphDensity, WhitenedPosterior

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _graph(config, seed):
    g = config["graph"]
    return chain_graph(g["n_poses"], g["n_loops"], seed=seed, radius=g["radius_m"],
                       odo_noise=g["odometry_noise_m"], odo_info=g["odometry_info"],
                       preint_info=g["preint_info"], loop_info=g["loop_info"],
                       loop_delta=g["loop_robust_delta"], anchor_info=g["anchor_info"])


def setup(ctx):
    from gorio_tpu_torch.graph.graph import PoseGraph
    from gorio_tpu_torch.graph.solver import SolveConfig, optimize_graph
    from gorio_tpu_torch.inference.hmc import run_hmc
    from gorio_tpu_torch.inference.laplace import graph_logprob, whitened_logprob

    t0 = time.time()
    cfg, tr, device = ctx["config"], ctx["traffic"], ctx["device"]
    s = cfg["sampler"]
    dtype = DTYPES[s["dtype"]]
    poses0, between, priors = _graph(cfg, ctx["seed"])
    g = PoseGraph(dtype=np.float64 if dtype == torch.float64 else np.float32)
    for T in poses0:
        g.add_pose(T)
    for i, T, info in priors:
        g.add_prior(i, T, info=info)
    for i, j, T, info, delta in between:
        g.add_between(i, j, T, info=info, robust_delta=delta)
    p0, graph = g.freeze(device=device)
    t1 = time.time()
    res = optimize_graph(p0, graph, SolveConfig(max_iterations=s["solve_max_iterations"]))
    lp_y, _ = whitened_logprob(graph_logprob(res.poses, graph), res.H)
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx["seed"])
    C, D = tr["chains"], p0.shape[0] * 6
    st = SimpleNamespace(cfg=cfg, tr=tr, device=device, dtype=dtype, gen=gen, lp_y=lp_y,
                         eps=float(s["step_size"]), y=torch.zeros((C, D), dtype=dtype,
                                                                   device=device),
                         C=C, D=D, run_hmc=run_hmc, graph_inputs=(poses0, between, priors),
                         solve_iterations=int(res.iterations))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.time()
    _call(st, tr["warmup_draws"])  # from the mode: every kernel the window launches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    st.setup_parts = [("graph", t1 - t0), ("solve_whiten", t2 - t1),
                      ("warmup_call", time.time() - t2)]
    return st


def _call(st, n):
    """One `run_hmc` call of `n` draws from the chains' last state."""
    like = dict(dtype=st.dtype, device=st.device)
    y_in = st.y
    z = torch.randn((n, st.C, st.D), generator=st.gen, **like)
    log_u = torch.log(torch.rand((n, st.C), generator=st.gen, **like))
    samples, accepts = st.run_hmc(st.lp_y, y_in, n_samples=n, step_size=st.eps,
                                  n_leapfrog=st.cfg["sampler"]["n_leapfrog"], adapt=False,
                                  draws=(z, log_u))
    st.y = samples[:, -1]
    return dict(y_in=y_in, z=z, log_u=log_u, samples=samples, accepts=accepts)


def window(st, ctx):
    cuda = st.device.type == "cuda"
    sync = torch.cuda.current_stream(st.device).synchronize if cuda else (lambda: None)
    tracer = DeviceTrace(ctx["trace"])
    n, n_leap = st.tr["draws_per_call"], st.cfg["sampler"]["n_leapfrog"]
    calls, timed = [], []
    sync()
    t_start = now = time.perf_counter()
    t_end = t_start + ctx["seconds"]
    trace_from = t_end - st.tr["trace_seconds"] if ctx["trace"] else math.inf
    tracing = False
    while now < t_end:
        if not tracing and now >= trace_from:
            tracer.start()
            tracing = True
        events = cuda and not tracing
        if events:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        with span("run_hmc"):
            calls.append(_call(st, n))
        if events:
            e1.record()
            timed.append((e0, e1))
        sync()
        now = time.perf_counter()
    if tracing:
        tracer.stop()
    window_s = now - t_start
    n_draws = len(calls) * n
    bad = sum(int((~torch.isfinite(r["samples"]).all(-1)).sum()) for r in calls)
    obs = dict(window_s=window_s, work={"samples": n_draws * st.C}, attempted=n_draws * st.C,
               failed=bad, spans={"run_hmc_ms": [e0.elapsed_time(e1) for e0, e1 in timed]},
               counters={"leapfrog_steps_timed": len(timed) * n * n_leap, "calls": len(calls)})
    obs["trace"] = tracer.reduce() if ctx["trace"] else None
    st.calls = calls
    ctx["log"](f"[window] {len(calls)} calls ({len(timed)} timed), {n_draws} draws x {st.C} "
               f"chains in {window_s:.3f} s")
    return obs


def transitions(st, rng, n_calls, n_random):
    """(call, step) pairs to check: `n_calls` calls drawn from the seed, in
    each its first and its last transition and `n_random` more drawn from
    those between."""
    picks = []
    for c in sorted(rng.choice(len(st.calls), size=min(n_calls, len(st.calls)), replace=False)):
        S = st.calls[c]["samples"].shape[1]
        inner = np.arange(1, S - 1)
        extra = rng.choice(inner, size=min(n_random, len(inner)), replace=False)
        picks += [(int(c), s) for s in sorted({0, S - 1} | {int(x) for x in extra})]
    return picks


def reference_posterior(st, dtype):
    poses0, between, priors = st.graph_inputs
    dens = GraphDensity(poses0, between, priors, dtype, st.device)
    mode, H = dens.solve(max_iterations=st.cfg["sampler"]["solve_max_iterations"])
    post = WhitenedPosterior(dens, mode, H)
    post.iterations = dens.iterations
    return post


def compare(st, ref, picks, produce):
    """Largest gaps of accept probability and of next state between what
    `produce(call, step, y_prev)` gave and the reference's transition."""
    n_leap = st.cfg["sampler"]["n_leapfrog"]
    eps = torch.full((st.C,), st.eps, dtype=torch.float64, device=st.device)
    acc_gap = state_gap = 0.0
    for c, s in picks:
        rec = st.calls[c]
        y_prev = rec["y_in"] if s == 0 else rec["samples"][:, s - 1]
        y_next, a = produce(c, s, y_prev)
        y_ref, a_ref = ref.transition(y_prev.to(torch.float64), eps,
                                      rec["z"][s].to(torch.float64),
                                      rec["log_u"][s].to(torch.float64), n_leap)
        acc_gap = max(acc_gap, float(torch.max(torch.abs(a.to(torch.float64) - a_ref))))
        state_gap = max(state_gap, float(torch.max(torch.abs(y_next.to(torch.float64) - y_ref))))
    return acc_gap, state_gap


def check(st, obs, ctx, control: bool = False):
    """The numbers compared, each with its limit. With `control`, the
    reference one precision down (float32) stands in the program's place."""
    lim = st.cfg["check"]
    rng = np.random.default_rng([ctx["seed"], 1])
    picks = transitions(st, rng, st.tr["check_calls"], st.tr["check_random_per_call"])
    st.lp_y = None  # the program's density is not needed past the window
    ref = reference_posterior(st, torch.float64)
    if control:
        low = reference_posterior(st, torch.float32)
        n_leap = st.cfg["sampler"]["n_leapfrog"]
        eps = torch.full((st.C,), st.eps, dtype=torch.float32, device=st.device)

        def produce(c, s, y_prev):
            rec = st.calls[c]
            return low.transition(y_prev.float(), eps, rec["z"][s].float(),
                                  rec["log_u"][s].float(), n_leap)
    else:
        def produce(c, s, y_prev):
            rec = st.calls[c]
            return rec["samples"][:, s], rec["accepts"][:, s]
    acc_gap, state_gap = compare(st, ref, picks, produce) if picks else (math.nan,) * 2
    ctx["log"](f"[check] {len(picks)} transitions x {st.C} chains; LM iterations of the mode: "
               f"program {st.solve_iterations}, reference {ref.iterations}")
    return [dict(name="accept_gap", value=acc_gap, limit=lim["accept_gap"]),
            dict(name="state_gap", value=state_gap, limit=lim["state_gap"])]
