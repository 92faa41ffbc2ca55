"""Port parity: `gorio_tpu_torch.inference.smoother` and
`RadarGraphSLAM.sample_posterior` against the JAX package, on the CPU in
float64, with the JAX draws rebuilt from their keys (the JAX package's exact
split / fold_in sequence) and handed to the port.

- The smoother on `tests/test_smoother.py`'s 12-pose square graph (odometry
  with yaw drift and one loop): `split_loop_chi2` and `_mala_move` to 1e-10
  relative, and a whole `smc_loop_relaxation` run (64 particles, 3 stages,
  1 move, resampling at a stage; the JAX side on a one-device mesh) field
  by field within 1e-8.
  `loop_evidence_gate` on the port's own generator keeps the true loop and
  rejects the bogus one (`test_evidence_rejects_bogus_loop`'s 20 m offset).
- `sample_posterior` of both packages on the same keyframes (the 26-frame
  sequence at capacity 512 of the port's other tests, keyframes from the
  same odometry poses, LPM preintegration on): 2 chains x 16 draws after
  8 warmup iterations, the whole trajectory and `window=5`; samples within
  atol 1e-7, the Laplace covariance rtol 1e-8, R-hat 1e-8 (1e-6 for the
  whole trajectory, whose draws differ by ~3e-8), accept probabilities
  atol 1e-6. The two
  packages' graphs differ in their last bits (the edges' information
  agrees to 1e-10, the LM's optimum to ~1e-13: its stop rule fires at
  different iterations), and dual averaging multiplies a difference ~10x
  per early warmup iteration (`test_torch_inference.py::
  test_run_hmc_matches_jax`): after 8 warmup iterations the draws agree to
  ~3e-8, after 15 (30 draws) only to ~2e-5 on these keyframes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gorio_tpu.inference import smoother as js
from gorio_tpu.io.synthetic import make_world, render_radar_scan, sample_imu, simulate_trajectory
from gorio_tpu.pipeline import slam as jslam
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict, graph_from_numpy
from gorio_tpu_torch.inference import smoother as ts
from gorio_tpu_torch.parallel.mesh import make_mesh
from gorio_tpu_torch.pipeline import slam as tslam
from test_smoother import _ate, _square_graph
from test_torch_inference import F64, close, run_hmc_draws, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def square():
    poses_gt, poses0, data, loop_mask = _square_graph()
    return poses_gt, np.asarray(poses0), data, np.asarray(loop_mask), graph_from_numpy(data)


def smoother_draws(key, N, D, n_stages, n_moves):
    """`smc_loop_relaxation`'s draws on one shard (axis index 0)."""
    k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
    init_z = jax.random.normal(jax.random.fold_in(k_init, 0), (N, D), F64)
    u0, move_z, log_u = [], [], []

    def particle(kx):
        k1, k2 = jax.random.split(kx)
        return jax.random.normal(k1, (D,), F64), jnp.log(jax.random.uniform(k2, (), F64))

    for k in jax.random.split(k_scan, n_stages):
        k_r, k_mv = jax.random.split(jax.random.fold_in(k, 1))
        u0.append(jax.random.uniform(k_r, (), F64))
        zs, lus = zip(*(jax.vmap(particle)(jax.random.split(jax.random.fold_in(kk, 0), N))
                        for kk in jax.random.split(k_mv, n_moves)))
        move_z.append(np.stack(zs))
        log_u.append(np.stack(lus))
    return t(init_z), t(np.stack(u0)), t(np.stack(move_z)), t(np.stack(log_u))


def test_split_loop_chi2_and_mala_move_match_jax(square):
    poses_gt, poses0, data, loop_mask, tdata = square
    D = poses0.shape[0] * 6
    jfn = js.split_loop_chi2(poses0, data, jnp.asarray(loop_mask))
    tfn = ts.split_loop_chi2(t(poses0), tdata, loop_mask)
    d = 0.01 * np.random.default_rng(0).normal(size=(4, D))
    d[0] = 0.0
    jb, jl = jax.jit(jax.vmap(jfn))(d)
    tb, tl = tfn(t(d))
    close(tb, jb, rtol=1e-10, atol=1e-12)
    close(tl, jl, rtol=1e-10)
    assert float(tb[0]) < 1e-6 and float(tl[0]) > 1.0  # JAX `test_split_loop_chi2`
    mass = 1.0 / (np.arange(D) % 6 + 10.0)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jd, jacc = jax.jit(jax.vmap(lambda k, x: js._mala_move(k, x, jfn, 0.6, 0.5,
                                                          jnp.asarray(mass))))(keys, d)

    def draws(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (D,), F64), jnp.log(jax.random.uniform(k2, (), F64))

    z, lu = jax.vmap(draws)(keys)
    td, tacc = ts._mala_move(t(d), tfn, 0.6, 0.5, t(mass), z=t(z), log_u=t(lu))
    assert np.array_equal(tacc.numpy(), np.asarray(jacc))
    close(td, jd, atol=1e-12)


def test_smc_loop_relaxation_matches_jax(square, monkeypatch):
    """(The JAX function computes its preconditioner with an eager
    `build_normal_equations`, ~40 s of per-primitive compiles here; the test
    hands it the same function under `jax.jit`.)"""
    poses_gt, poses0, data, loop_mask, tdata = square
    monkeypatch.setattr(js, "build_normal_equations", jax.jit(js.build_normal_equations))
    N, S, M = 64, 3, 1
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    key = jax.random.PRNGKey(0)
    jres = js.smc_loop_relaxation(mesh, jnp.asarray(poses0), data, jnp.asarray(loop_mask),
                                  n_particles=N, n_stages=S, n_moves=M)(key)
    draws = smoother_draws(key, N, poses0.shape[0] * 6, S, M)
    run = ts.smc_loop_relaxation(None, t(poses0), tdata, loop_mask, n_particles=N, n_stages=S,
                                 n_moves=M)
    tres = run(draws=draws)
    for name in ts.SmootherResult._fields:
        close(getattr(tres, name), getattr(jres, name), rtol=1e-8, atol=1e-8)
    assert 0.0 < float(tres.accept_rate) < 1.0
    # the run covers a resample (ESS below N / 2 at a stage)
    assert bool((tres.ess_per_stage < 0.5 * N).any())
    # the port's mesh of one rank is the one-card run, to the bit (four
    # ranks: `test_torch_parallel_inference.py`)
    one = ts.smc_loop_relaxation(make_mesh((1,), ("dp",), "cpu"), t(poses0), tdata, loop_mask,
                                 n_particles=N, n_stages=S, n_moves=M)(draws=draws)
    assert all(torch.equal(a, b) for a, b in zip(one, tres))


def test_loop_evidence_gate_rejects_bogus_loop(square):
    """`test_smc_loop_relaxation_sharded`'s checks and
    `test_evidence_rejects_bogus_loop`'s on the port's own generator."""
    poses_gt, poses0, data, loop_mask, tdata = square
    kw = dict(n_particles=256, n_stages=5, n_moves=1)
    res = ts.smc_loop_relaxation(None, t(poses0), tdata, loop_mask, **kw)(
        torch.Generator().manual_seed(1))
    ess = res.ess_per_stage.numpy()
    assert np.isfinite(float(res.log_evidence)) and torch.isfinite(res.mean_delta).all()
    assert np.all(ess > 1.0) and np.all(ess <= 256 + 1e-6)
    assert float(res.accept_rate) > 0.05
    assert _ate(res.poses_mean.numpy(), poses_gt) < _ate(poses0, poses_gt)
    assert ts.loop_evidence_gate(res)
    idx = int(np.argmax(loop_mask))
    T_meas = tdata.between.T_meas.clone()
    T_meas[idx, :3, 3] += t([20.0, -15.0, 5.0])
    bad = tdata._replace(between=tdata.between._replace(T_meas=T_meas))
    res_bad = ts.smc_loop_relaxation(None, t(poses0), bad, loop_mask, **kw)(
        torch.Generator().manual_seed(1))
    assert float(res_bad.log_evidence) < float(res.log_evidence) - 50.0
    assert not ts.loop_evidence_gate(res_bad)


# ---- sample_posterior ------------------------------------------------------

CAP = 512


@pytest.fixture(scope="module")
def slams():
    """Both packages' `RadarGraphSLAM` (LPM preintegration, no loop
    closure) fed the 26-frame sequence's clouds with the same odometry
    poses."""
    traj = simulate_trajectory(seed=3, duration=3.0)
    imu = sample_imu(traj, seed=4)
    world = make_world(seed=5, n_landmarks=3000)
    cfg = jslam.SLAMConfig(enable_loop_closure=False, gyr_var=imu.gyr_var, vel_var=imu.vel_var)
    j = jslam.RadarGraphSLAM(cfg)
    p = tslam.RadarGraphSLAM(config_from_dict(tslam.SLAMConfig, cfg._asdict()), device="cpu")
    for s in (j, p):
        for tt, g in zip(imu.gyr_t, imu.gyr):
            s.push_imu(tt, g)
        for tt, v in zip(imu.vel_t, imu.vel):
            s.push_twist(tt, v)
    rng = np.random.default_rng(6)
    for i, stamp in enumerate(np.arange(0.2, 2.8, 0.1)):
        R, pos = traj.interp_pose(np.array([stamp]))
        v = np.stack([np.interp(stamp, traj.t, traj.v_body[:, k]) for k in range(3)])
        cloud = render_radar_scan(world, R[0], pos[0], v, capacity=CAP, seed=100 + i)
        odom = np.eye(4)
        odom[:3, :3], odom[:3, 3] = R[0], pos[0] + 0.01 * rng.normal(size=3)
        assert j.add_frame(float(stamp), cloud, odom) == p.add_frame(
            float(stamp), cloud_from_numpy(cloud), odom)
    assert len(p.keyframes) >= 6
    return j, p


@pytest.mark.parametrize("window", [None, 5])
def test_sample_posterior_matches_jax(slams, window):
    j, p = slams
    n_chains, n_samples = 2, 16
    key = jax.random.PRNGKey(7)
    jsamp, jacc, jrhat, jcov = j.sample_posterior(key, n_chains=n_chains, n_samples=n_samples,
                                                  window=window)
    D = jcov.shape[0]
    draws = run_hmc_draws(jax.random.split(key, n_chains), D, n_samples // 2, n_samples)
    samp, acc, rhat, cov = p.sample_posterior(n_chains=n_chains, n_samples=n_samples,
                                              window=window, draws=draws)
    K = len(p.keyframes) if window is None else window
    assert samp.shape == (n_chains, n_samples, 6 * K) and cov.shape == (6 * K, 6 * K)
    for a, b in zip(j.keyframes[1:], p.keyframes[1:]):  # the edges' information
        close(b.edge_info, a.edge_info, rtol=1e-10)
    close(cov, jcov, rtol=1e-8, atol=1e-8 * float(np.abs(jcov).max()))
    close(samp, jsamp, atol=1e-7)
    close(acc, jacc, atol=1e-6)  # exp of an energy difference: ~10x the draws' spread
    # R-hat is a variance ratio over 12-draw halves: it inherits the draws'
    # relative difference, ~1e-7 where the LM optima differ (the whole run)
    close(rhat, jrhat, rtol=1e-8 if window else 1e-6)
    assert 0.3 < float(acc.mean()) <= 1.0


def test_sample_posterior_refuses_other_methods(slams):
    with pytest.raises(ValueError, match="only 'hmc'"):
        slams[1].sample_posterior(method="nuts", n_samples=2)
    samp, acc, rhat, cov = slams[1].sample_posterior(torch.Generator().manual_seed(0),
                                                     n_chains=2, n_samples=4, window=3)
    assert samp.shape == (2, 4, 18) and torch.isfinite(samp).all()


def test_posterior_graph_is_the_sampled_graph(slams):
    """`posterior_graph` is the graph `sample_posterior` solves and samples:
    its dense solve gives the call's Laplace covariance to the bit."""
    from gorio_tpu_torch.graph.solver import laplace_covariance, optimize_graph

    p = slams[1]
    *_, cov = p.sample_posterior(torch.Generator().manual_seed(0), n_chains=2, n_samples=4,
                                 window=5)
    poses0, graph = p.posterior_graph(5)
    assert poses0.shape == (5, 4, 4) and poses0.device == cov.device
    assert torch.equal(laplace_covariance(optimize_graph(poses0, graph, p.cfg.solve)), cov)
