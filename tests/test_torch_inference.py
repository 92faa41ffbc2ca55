"""Port parity: `gorio_tpu_torch.inference` (`laplace`, `hmc`, `smc`) and
`graph/solver.laplace_covariance` against `gorio_tpu.inference`, on the CPU
in float64.

`jax.random` cannot be reproduced, so each JAX draw is rebuilt from its key
with the JAX package's exact split / fold_in sequence and handed to the
port's functions as tensors (`z`, `log_u`, `u`, ...). With the same draws
the arithmetic is the same up to reduction order: log-densities, gradients
and the Laplace factors agree to 1e-10 relative; whole chains to atol 1e-8,
their accept probabilities to 1e-10 (1e-7 both after a dual-averaging
warmup, whose feedback amplifies rounding: `test_run_hmc_matches_jax`); the
diagnostics to 1e-12. Systematic resampling's parents are equal except where
a comb point lies within 1e-12 * N of a cumulative weight, where the two
cumsums may round to either side (none does on these draws). One statistical
check runs the port on its own generator (`test_hmc_samples_gaussian`'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gorio_tpu.graph.graph import PoseGraph as JPoseGraph
from gorio_tpu.graph.solver import SolveResult as JSolveResult
from gorio_tpu.graph.solver import laplace_covariance as j_laplace_cov
from gorio_tpu.inference import hmc as jh
from gorio_tpu.inference import laplace as jl
from gorio_tpu.inference import smc as jsmc
from gorio_tpu_torch.convert import graph_from_numpy
from gorio_tpu_torch.graph.solver import SolveConfig, laplace_covariance, optimize_graph
from gorio_tpu_torch.inference import hmc as th
from gorio_tpu_torch.inference import laplace as tl
from gorio_tpu_torch.inference import smc as tsmc
from gorio_tpu_torch.parallel.mesh import make_mesh
from test_graph import _chain_truth, _rel

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.asarray(x))


def close(a, b, rtol=0.0, atol=0.0):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def graph6():
    """A 6-pose chain with an anchor prior, odometry betweens, a Huber loop
    0 -> 5 pulled off its measurement, and the port's dense LM solution,
    handed to the JAX side as its `SolveResult` (the solvers' parity is
    `test_torch_graph.py`'s)."""
    rng = np.random.default_rng(0)
    truth = _chain_truth(6, rng)
    g = JPoseGraph()
    for T in truth:
        g.add_pose(T)
    for k in range(1, 6):
        g.add_between(k - 1, k, _rel(truth[k - 1], truth[k]), info=np.eye(6) * 400.0)
    g.add_prior(0, truth[0], info=np.eye(6) * 1e6)
    loop = _rel(truth[0], truth[5])
    loop[:3, 3] += [0.3, -0.2, 0.1]
    g.add_between(0, 5, loop, info=np.eye(6) * 100.0, robust_delta=1.0)
    poses0, graph = g.freeze()
    tgraph = graph_from_numpy(graph)
    tres = optimize_graph(t(poses0), tgraph, SolveConfig(max_iterations=30))
    jres = JSolveResult(*(jnp.asarray(x.numpy()) for x in tres))
    return poses0, graph, jres, tgraph, tres


def gauss2d():
    mean = np.array([1.0, -0.5])
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    prec = np.linalg.inv(cov)

    def jlp(x):
        d = x - mean
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tlp(x):
        d = x - t(mean)
        return -0.5 * torch.einsum("...i,ij,...j->...", d, t(prec), d)

    return jlp, tlp


def step_draws(keys, n):
    """`hmc_step`'s draws from each key: (z (B, n), log u (B,))."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (n,), F64), jnp.log(jax.random.uniform(k2, (), F64))

    z, lu = jax.vmap(one)(keys)
    return np.asarray(z), np.asarray(lu)


def run_hmc_draws(chain_keys, n, n_warm, n_samples):
    """`run_hmc`'s draws for each chain key: (z (S, C, n), log u (S, C))."""
    zs, lus = [], []
    for key in chain_keys:
        key_w, key_s = jax.random.split(key)
        keys = jax.random.split(key_s, n_samples)
        if n_warm:
            keys = jnp.concatenate([jax.random.split(key_w, n_warm), keys])
        z, lu = step_draws(keys, n)
        zs.append(z)
        lus.append(lu)
    return t(np.stack(zs, 1)), t(np.stack(lus, 1))


# ---- laplace ---------------------------------------------------------------


@pytest.mark.parametrize("at", ["zero", "random"])
def test_graph_logprob_matches_jax(graph6, at):
    poses0, graph, jres, tgraph, tres = graph6
    D = 36
    delta = np.zeros(D) if at == "zero" else 0.02 * np.random.default_rng(1).normal(size=D)
    jv, jg = jax.jit(jax.value_and_grad(jl.graph_logprob(poses0, graph)))(delta)
    lp = tl.graph_logprob(t(poses0), tgraph)
    tv, tg = th.value_and_grad(lp, t(delta))
    close(tv, jv, rtol=1e-10)
    close(tg, jg, rtol=1e-10, atol=1e-10 * np.abs(np.asarray(jg)).max())
    # the leading axis: a batch of 3 evaluates each row on its own
    batch = t(np.stack([delta, 2 * delta, -delta]))
    bv, bg = th.value_and_grad(lp, batch)
    for k in range(3):
        v, g = th.value_and_grad(lp, batch[k])
        close(bv[k], v, rtol=1e-12)
        close(bg[k], g, rtol=1e-12, atol=1e-12 * float(g.abs().max()))


def test_graph_logprob_gradient_finite_in_f32(graph6):
    poses0, graph, _, _, _ = graph6
    tgraph = graph_from_numpy(graph)
    tgraph = type(tgraph)(*(type(f)(*(x.float() if x.is_floating_point() else x for x in f))
                            for f in tgraph))
    lp = tl.graph_logprob(t(poses0).float(), tgraph)
    v, g = th.value_and_grad(lp, torch.zeros((4, 36), dtype=torch.float32))
    assert v.dtype == torch.float32 and torch.isfinite(v).all() and torch.isfinite(g).all()


def test_laplace_functions_match_jax(graph6):
    poses0, graph, jres, tgraph, tres = graph6
    jcov, tcov = j_laplace_cov(jres), laplace_covariance(tres)
    assert tcov.shape == (36, 36)
    close(tcov, jcov, rtol=1e-10, atol=1e-10 * float(np.abs(jcov).max()))
    # whitened density: lp_y and L
    jlp_y, jL = jl.whitened_logprob(jl.graph_logprob(jres.poses, graph), jres.H)
    tlp_y, tL = tl.whitened_logprob(tl.graph_logprob(tres.poses, tgraph), tres.H)
    close(tL, jL, rtol=1e-10, atol=1e-10 * float(np.abs(jL).max()))
    y = np.random.default_rng(2).normal(size=(2, 36))
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jlp_y)))(y)
    tv, tg = th.value_and_grad(tlp_y, t(y))
    close(tv, jv, rtol=1e-10)
    close(tg, jg, rtol=1e-10, atol=1e-10 * float(np.abs(jg).max()))
    # the triangular solve back: JAX's lower=True, trans=1 on each row
    jx = jax.vmap(lambda v: jax.scipy.linalg.solve_triangular(jL, v, lower=True, trans=1))(y)
    close(tl.unwhiten(tL, t(y)), jx, rtol=1e-10, atol=1e-12)
    # laplace_sample on JAX's standard normals
    key = jax.random.PRNGKey(5)
    z = jax.random.normal(key, (7, 36), F64)
    close(tl.laplace_sample(tres, 7, z=t(z)), jl.laplace_sample(key, jres, 7), rtol=1e-10,
          atol=1e-10)
    assert tl.laplace_sample(tres, 3, generator=torch.Generator().manual_seed(0)).shape == (3, 36)


# ---- hmc -------------------------------------------------------------------


def test_hmc_step_and_dual_averaging_match_jax():
    """Step by step on a correlated 2-D Gaussian: `_leapfrog`, `hmc_step`
    (accepted and rejected steps), `dual_averaging_update`."""
    jlp, tlp = gauss2d()
    q0 = np.array([0.3, 0.2])
    jq, jp, jg, jv = jh._leapfrog(jlp, q0, np.array([0.5, -1.0]), jax.grad(jlp)(q0), 0.3, 5,
                                  jnp.ones(2))
    tq, tp, tg, tv = th._leapfrog(tlp, t(q0), t([0.5, -1.0]), th.value_and_grad(tlp, t(q0))[1],
                                  0.3, 5, torch.ones(2, dtype=torch.float64))
    for a, b in ((tq, jq), (tp, jp), (tg, jg), (tv, jv)):
        close(a, b, rtol=1e-12, atol=1e-14)
    js, ts = jh.hmc_init(jlp, q0), th.hmc_init(tlp, t(q0))
    jda, tda = jh.dual_averaging_init(0.9), th.dual_averaging_init(0.9)
    keys = jax.random.split(jax.random.PRNGKey(3), 12)
    z, lu = step_draws(keys, 2)
    j_step = jax.jit(jh.hmc_step, static_argnames=("logprob_fn", "n_leapfrog"))
    accepted = []
    for k in range(12):
        eps = jnp.exp(jda.log_step)
        js, jinfo = j_step(keys[k], js, logprob_fn=jlp, step_size=eps, n_leapfrog=4)
        ts, tinfo = th.hmc_step(ts, tlp, torch.exp(tda.log_step), 4, z=t(z[k]), log_u=t(lu[k]))
        close(ts.position, js.position, atol=1e-12)
        close(ts.log_prob, js.log_prob, rtol=1e-12, atol=1e-12)
        close(ts.grad, js.grad, atol=1e-12)
        close(tinfo.accept_prob, jinfo.accept_prob, atol=1e-12)
        close(tinfo.energy, jinfo.energy, rtol=1e-12)
        assert bool(tinfo.accepted) == bool(jinfo.accepted)
        accepted.append(bool(jinfo.accepted))
        jda = jh.dual_averaging_update(jda, jinfo.accept_prob)
        tda = th.dual_averaging_update(tda, tinfo.accept_prob)
        for a, b in zip(tda, jda):
            close(a, b, rtol=1e-12, atol=1e-12)
    assert any(accepted) and not all(accepted)


def test_hmc_divergence_accepts_nothing():
    """A non-finite energy gives acceptance exactly 0 and keeps the chain;
    the chains of one batch are independent."""
    def lp(x):
        return torch.where(x[..., 0] > 2.0, torch.full_like(x[..., 0], float("nan")),
                           -0.5 * torch.sum(x * x, -1))

    state = th.hmc_init(lp, t([[0.0, 0.0], [1.9, 0.0]]))
    new, info = th.hmc_step(state, lp, 0.5, 4, z=t([[0.1, 0.0], [3.0, 0.0]]),
                            log_u=t([-10.0, -10.0]))
    assert float(info.accept_prob[1]) == 0.0 and not bool(info.accepted[1])
    close(new.position[1], [1.9, 0.0])
    assert bool(info.accepted[0])


@pytest.mark.parametrize("target,adapt", [("gauss2d", False), ("gauss2d", True),
                                          ("graph6", True)])
def test_run_hmc_matches_jax(graph6, target, adapt):
    """Whole runs, 3 chains in one batch, 30 draws, after 20 dual-averaging
    warmup iterations with `adapt`; on the Gaussian with a diagonal inverse
    mass, on the graph posterior with `sample_posterior`'s whitened kernel.
    Without adaptation the chains agree to rounding (samples atol 1e-8,
    accept probabilities 1e-10). Dual averaging feeds each accept
    probability back into the step size with a gain of sqrt(t) / gamma
    (20-90 here): a last-bit difference of the energy sums grows ~10x per
    early warmup iteration, and after 20 warmup iterations the adapted runs
    differ by ~2e-10 (Gaussian) and ~1.4e-8 (graph): they are held to atol
    1e-7, accept probabilities included. (Unwhitened, this stiff
    posterior's chains are chaotic as well: a 1e-15 difference grows ~3x per
    iteration.)"""
    if target == "gauss2d":
        jlp, tlp = gauss2d()
        D, inv_mass, step, L = 2, np.array([0.5, 2.0]), 0.5, 6
    else:
        poses0, graph, jres, tgraph, tres = graph6
        jlp, _ = jl.whitened_logprob(jl.graph_logprob(jres.poses, graph), jres.H)
        tlp, _ = tl.whitened_logprob(tl.graph_logprob(t(jres.poses), tgraph), t(jres.H))
        D, inv_mass, step, L = 36, None, 0.15, 8
    n_warm = 20 if adapt else 0
    x0 = 0.1 * np.random.default_rng(3).normal(size=(3, D))
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    jim = None if inv_mass is None else jnp.asarray(inv_mass)
    js, ja = jax.vmap(lambda k, x: jh.run_hmc(k, jlp, x, n_samples=30, step_size=step,
                                              n_leapfrog=L, adapt=adapt, inv_mass=jim,
                                              n_warmup=n_warm))(keys, x0)
    draws = run_hmc_draws(keys, D, n_warm, 30)
    ts, ta = th.run_hmc(tlp, t(x0), n_samples=30, step_size=step, n_leapfrog=L, adapt=adapt,
                        inv_mass=None if inv_mass is None else t(inv_mass), n_warmup=n_warm,
                        draws=draws)
    assert ts.shape == (3, 30, D) and ta.shape == (3, 30)
    close(ts, js, atol=1e-7 if adapt else 1e-8)
    close(ta, ja, atol=1e-7 if adapt else 1e-10)
    assert 0.2 < float(ta.mean()) <= 1.0


def test_multinomial_hmc_step_matches_jax():
    """5 transitions of 2 chains at max_depth 3."""
    jlp, tlp = gauss2d()
    x0 = np.array([[0.0, 0.0], [2.0, -1.0]])
    jstate = jax.vmap(lambda x: jh.hmc_init(jlp, x))(x0)
    tstate = th.hmc_init(tlp, t(x0))
    n_steps = 8
    for it in range(5):
        keys = jax.random.split(jax.random.PRNGKey(20 + it), 2)
        jstate = jax.vmap(lambda k, s: jh.multinomial_hmc_step(k, s, jlp, 0.3, max_depth=3))(
            keys, jstate)

        def draws(k):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            return (jax.random.normal(k1, (2,), F64), jax.random.randint(k2, (), 0, n_steps + 1),
                    jax.random.uniform(k3, (n_steps,), F64), jax.random.uniform(k4, (), F64))

        z, n_fwd, ug, u0 = (t(x) for x in jax.vmap(draws)(keys))
        tstate = th.multinomial_hmc_step(tstate, tlp, 0.3, max_depth=3, z=z, n_fwd=n_fwd,
                                         u_gumbel=ug, u_g0=u0)
        close(tstate.position, jstate.position, atol=1e-8)
        close(tstate.log_prob, jstate.log_prob, atol=1e-8)
        close(tstate.grad, jstate.grad, atol=1e-8)


def test_chain_diagnostics_match_jax():
    x = np.random.default_rng(4).normal(size=(4, 64, 3)).cumsum(axis=1) * 0.1
    close(th.chain_ess(t(x)), jh.chain_ess(x), rtol=1e-12)
    close(th.potential_scale_reduction(t(x)), jh.potential_scale_reduction(jnp.asarray(x)),
          rtol=1e-12)


def test_hmc_samples_gaussian():
    """The port on its own generator: mean and variance of a 3-D Gaussian
    (JAX `test_hmc_samples_gaussian`'s target and bounds), 4 chains at a
    fixed step of 0.2 x 8 leapfrog steps. (Dual averaging drives this
    target's step toward ~0.8, where 8 steps span one period of the unit-
    variance coordinate and a chain can stall on it: a property of
    fixed-length HMC, not of the port.)"""
    mean, var = t([1.0, -2.0, 0.5]), t([0.5, 2.0, 1.0])

    def lp(x):
        return -0.5 * torch.sum((x - mean) ** 2 / var, dim=-1)

    gen = torch.Generator().manual_seed(0)
    samples, accepts = th.run_hmc(lp, torch.zeros((4, 3), dtype=torch.float64), n_samples=300,
                                  step_size=0.2, n_leapfrog=8, adapt=False, generator=gen)
    post = samples[:, 50:].reshape(-1, 3)
    assert float(accepts.mean()) > 0.5
    close(post.mean(0), mean, atol=0.25)
    close(post.var(0), var, rtol=0.5)
    assert float(th.potential_scale_reduction(samples[:, 50:]).max()) < 1.2
    # a single chain (D,) runs too, adapting
    s1, a1 = th.run_hmc(lp, torch.zeros(3, dtype=torch.float64), n_samples=6, generator=gen)
    assert s1.shape == (6, 3) and a1.shape == (6,) and torch.isfinite(s1).all()


# ---- smc -------------------------------------------------------------------


def _parents_equal(tp, jp, lw, u, n):
    """Equal parents except where the comb point lies within 1e-12 * N of a
    cumulative weight (either cumsum may round to either side)."""
    tp, jp = np.asarray(tp), np.asarray(jp)
    cum = np.cumsum(np.exp(lw - np.logaddexp.reduce(lw)))
    us = u / n + np.arange(len(tp)) / n
    near = np.min(np.abs(cum[None, :] - us[:, None]), axis=1) <= 1e-12 * n
    assert np.array_equal(tp[~near], jp[~near])


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(5)
    for s in range(4):
        lw = rng.normal(size=300) * 3.0
        key = jax.random.PRNGKey(s)
        u = float(jax.random.uniform(key, (), F64))
        jp = jsmc.systematic_resample(key, jnp.asarray(lw), 300)
        tp = tsmc.systematic_resample(t(lw), 300, u=t(u))
        _parents_equal(tp, jp, lw, u, 300)
    assert tsmc.systematic_resample(t(lw), 300, generator=torch.Generator()).shape == (300,)


def _smc_target():
    mean, var = np.array([0.5, -1.0]), np.array([0.3, 0.3])
    return (lambda x: -0.5 * jnp.sum((x - mean) ** 2 / var),
            lambda x: -0.5 * torch.sum((x - t(mean)) ** 2 / t(var), dim=-1))


def test_smc_step_matches_jax():
    jlp, tlp = _smc_target()
    N = 256
    key = jax.random.PRNGKey(6)
    js = jsmc.smc_init(key, N, jnp.zeros(2), jnp.ones(2) * 4.0)
    ts = tsmc.smc_init(N, torch.zeros(2, dtype=torch.float64), torch.full((2,), 4.0,
                       dtype=torch.float64), z=t(jax.random.normal(key, (N, 2), F64)))
    close(ts.particles, js.particles, atol=1e-14)
    resampled = 0
    for i in range(6):
        k = jax.random.PRNGKey(100 + i)
        k1, k2 = jax.random.split(k)
        u = jax.random.uniform(k1, (), F64)
        lw = np.asarray(js.log_weights + jax.vmap(jlp)(js.particles))
        js, jess = jsmc.smc_step(k, js, jlp, proposal_std=0.05)
        ts, tess = tsmc.smc_step(ts, tlp, 0.05, u=t(u), z=t(jax.random.normal(k2, (N, 2), F64)))
        close(tess, jess, rtol=1e-10)
        resampled += int(float(tess) < 0.5 * N)
        close(ts.particles, js.particles, atol=1e-10)
        close(ts.log_weights, js.log_weights, rtol=1e-10, atol=1e-10)
        if float(tess) < 0.5 * N:  # this step's parents
            _parents_equal(tsmc.systematic_resample(t(lw), N, u=t(u)),
                           jsmc.systematic_resample(k1, jnp.asarray(lw), N), lw, float(u), N)
    assert resampled >= 1
    close(tsmc.smc_estimate(ts), jsmc.smc_estimate(js), rtol=1e-10)
    close(tsmc.effective_sample_size(ts.log_weights), jsmc.effective_sample_size(js.log_weights),
          rtol=1e-10)


def test_sharded_smc_step_matches_jax_on_one_shard():
    """The JAX sharded step on a one-device mesh against the port's
    `mesh=None` step: global normalisation, -log N after a resample. The
    port's mesh of one rank gives the `mesh=None` step to the bit (the
    mesh of four ranks: `test_torch_parallel_inference.py`)."""
    jlp, tlp = _smc_target()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    jstep = jax.jit(jsmc.sharded_smc_step(mesh, jlp))
    tstep = tsmc.sharded_smc_step(None, tlp)
    N = 128
    p0 = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (N, 2), F64)) * 3.0
    jp, jw = jnp.asarray(p0), jnp.zeros(N, F64)
    tp, tw = t(p0), torch.zeros(N, dtype=torch.float64)
    for i in range(5):
        key = jax.random.PRNGKey(200 + i)
        k_r, k_m = jax.random.split(jax.random.fold_in(key, 0))
        u = jax.random.uniform(k_r, (), F64)
        z = jax.random.normal(jax.random.fold_in(k_m, 0), (N, 2), F64)
        jp, jw, jess = jstep(key, jp, jw, jnp.asarray(0.05))
        one = tsmc.sharded_smc_step(make_mesh((1,), ("dp",), "cpu"), tlp)(
            tp, tw, 0.05, u=t(u), z=t(z))
        tp, tw, tess = tstep(tp, tw, 0.05, u=t(u), z=t(z))
        assert all(torch.equal(a, b) for a, b in zip(one, (tp, tw, tess)))
        close(tess, jess, rtol=1e-10)
        close(tp, jp, atol=1e-10)
        close(tw, jw, rtol=1e-10, atol=1e-10)


# ---- the card --------------------------------------------------------------


@pytest.mark.cuda
def test_run_hmc_card_matches_cpu(graph6):
    """The same draws on the card and on the CPU: the same chains (f64); a
    captured density refuses another shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    poses0, graph, jres, tgraph, tres = graph6
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((25, 2, 36), generator=gen, dtype=torch.float64)
    lu = torch.log(torch.rand((25, 2), generator=gen, dtype=torch.float64))
    runs = []
    for dev in ("cpu", "cuda"):
        g = graph_from_numpy(graph, device=dev)
        res = optimize_graph(t(poses0).to(dev), g, SolveConfig(max_iterations=30))
        lp_y, _ = tl.whitened_logprob(tl.graph_logprob(res.poses, g), res.H)
        runs.append(th.run_hmc(lp_y, torch.zeros((2, 36), dtype=torch.float64, device=dev),
                               n_samples=20, step_size=0.15, draws=(z.to(dev), lu.to(dev))))
    for a, b in zip(runs[1], runs[0]):
        close(a, b.numpy(), atol=1e-8)
    graphed = th.CudaGraphed(lp_y, torch.zeros((2, 36), dtype=torch.float64, device="cuda"))
    with pytest.raises(ValueError, match="captured at"):
        th.value_and_grad(graphed, torch.zeros((3, 36), dtype=torch.float64, device="cuda"))
