"""Port parity: `gorio_tpu_torch.core.gp` and `preintegration.ugpm` against
the JAX package in float64, and against the independent numpy oracle
(`tests/oracle_ugpm.py`).

Tolerances: the SE-kernel integrals are a few float64 operations, so they
agree to 1e-12 relative (absolute 1e-14 where an entry cancels to ~0). A
UGPM fit is 30 LM iterations on a 966 x 198 Jacobian plus dense inverses
of (6S)^2 matrices, done by LAPACK in both packages but in another order of
operations: `delta_R`, `delta_p` and `cov` must agree to 1e-8 of each
field's largest entry, the bias / time-shift Jacobians to 1e-7, the fitted
GP state's fields to 1e-6 (see `test_ugpm_fit_matches_jax`). Against the
oracle, the JAX package's own bounds (0.15 deg, 2 cm).

Window times sit off the 5 ms gyro lattice: where a state knot falls on a
sample time, the time-shift Jacobian of the linear interpolation has a
kink, and the two packages round the knot an ulp apart (ROADMAP Queue C).

Only float64 is held here, the dtype the SLAM back end runs UGPM in: in
float32, the forward-mode AD of torch 2.13 gives `tensor * python_float` a
float64 tangent, and the `jacfwd` calls of the fit then mix dtypes
(ROADMAP Queue C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.core import gp as jgp
from gorio_tpu.io.synthetic import sample_imu, simulate_trajectory
from gorio_tpu.preintegration import ugpm as ju
from gorio_tpu_torch.convert import config_from_dict
from gorio_tpu_torch.core import gp as tgp
from gorio_tpu_torch.preintegration import ugpm as tu

from oracle_ugpm import oracle_preint

L2 = (3.0 / 50.0) ** 2  # the UGPM length scale at 50 Hz states


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small tensors run fastest on one CPU thread, and the test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn_name, *args):
    """The same call on both packages; numpy arrays become each package's
    arrays, floats stay floats."""
    j = getattr(jgp, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args])
    t = getattr(tgp, fn_name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                for a in args])
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("fn_name", ["se_kernel", "se_kernel_integral", "se_kernel_integral_dt",
                                     "se_kernel_integral2"])
@pytest.mark.parametrize("batched", [False, True])
def test_kernel_integrals_match_jax(fn_name, batched):
    """Scalar hyperparameters, and the (6, 1, 1) per-channel `sf2` with a
    0-d `l2` tensor that the port broadcasts over UGPM's six channels (the
    JAX package calls these per channel with a scalar `sf2`, so the batched
    result is held against its channel-by-channel calls)."""
    rng = np.random.default_rng(0)
    a = 0.13
    b = np.sort(rng.uniform(0.0, 1.2, 9))
    x2 = np.linspace(-0.16, 1.16, 66)
    head = (b, x2) if fn_name == "se_kernel" else (a, b, x2)
    if batched:
        sf2 = rng.uniform(0.01, 2.0, (6, 1, 1))
        got = getattr(tgp, fn_name)(*[torch.as_tensor(x) if isinstance(x, np.ndarray) else x
                                      for x in head], torch.tensor(L2, dtype=torch.float64),
                                    torch.as_tensor(sf2)).numpy()
        want = np.stack([_both(fn_name, *head, L2, float(s))[1] for s in sf2.ravel()])
    else:
        got, want = _both(fn_name, *head, L2, 0.8)
    assert got.shape == want.shape == ((6,) if batched else ()) + (9, 66)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_kss_int_and_gp_inverse_match_jax():
    rng = np.random.default_rng(1)
    q = np.sort(rng.uniform(0.0, 1.0, 7))
    sf2 = rng.uniform(0.01, 2.0, (6, 1))
    got, want = _both("kss_int", 0.05, q, np.asarray(L2), sf2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-16)
    t = np.linspace(0.0, 1.3, 66)
    K = tgp.se_kernel(torch.as_tensor(t), torch.as_tensor(t), L2, torch.as_tensor(sf2[:, :, None]))
    sz2 = torch.full((6, 1, 1), 1e-4, dtype=torch.float64)
    bvec = rng.normal(size=(66, 2))
    inv = tgp.gp_inv(K, sz2).numpy()
    sol = tgp.cho_solve_lower(tgp.gp_fit_cholesky(K, sz2), torch.as_tensor(bvec)).numpy()
    assert inv.shape == (6, 66, 66) and sol.shape == (6, 66, 2)
    for c in range(6):  # the JAX package factors one channel at a time
        Kc = jnp.asarray(K[c].numpy())
        want = np.asarray(jgp.gp_inv(Kc, 1e-4))
        # (K + sz2 I)^-1 has entries ~1e4 and condition ~1e4: relative to its scale
        np.testing.assert_allclose(inv[c], want, rtol=0, atol=1e-11 * np.abs(want).max())
        want = np.asarray(jgp.cho_solve_lower(jgp.gp_fit_cholesky(Kc, 1e-4), jnp.asarray(bvec)))
        np.testing.assert_allclose(sol[c], want, rtol=0, atol=1e-11 * np.abs(want).max())


def test_unwrap_scan_matches_jax():
    """A rotation-vector sequence that crosses |r| = pi, plus r = 0 (the
    tie-break that keeps the unshifted candidate)."""
    rng = np.random.default_rng(2)
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    ang = np.linspace(0.0, 2.0 * np.pi, 40)
    r = (ang[:, None] * axis) + 1e-3 * rng.normal(size=(40, 3))
    # what so3_log returns: the same rotation, folded back into |r| <= pi
    n = np.linalg.norm(r, axis=1, keepdims=True)
    r = np.where(n > np.pi, r - 2 * np.pi * r / n, r)
    r[0] = 0.0
    got = tu._unwrap_scan(torch.as_tensor(r)).numpy()
    want = np.asarray(ju._unwrap_scan(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert np.abs(np.diff(got, axis=0)).max() < 0.3  # unwrapped: no 2 pi jump


def _imu(seed=0, duration=3.0, gyr_std=0.01, vel_std=0.03, gyr_rate=200.0, vel_rate=30.0):
    traj = simulate_trajectory(seed=seed, duration=duration)
    return sample_imu(traj, gyr_rate=gyr_rate, vel_rate=vel_rate, gyr_std=gyr_std,
                      vel_std=vel_std, seed=seed + 1)


def _window(imu, t0, t1, pad=0.3):
    sg = (imu.gyr_t >= t0 - pad) & (imu.gyr_t <= t1 + pad)
    sv = (imu.vel_t >= t0 - pad) & (imu.vel_t <= t1 + pad)
    return imu.gyr_t[sg], imu.gyr[sg], imu.vel_t[sv], imu.vel[sv]


def _slam_window(imu, t0, t1, n_gyr=256, n_vel=64):
    """The SLAM back end's window: streams read from 0.2 s before `t0`,
    padded to fixed sample budgets by repeating the last sample."""
    out = []
    for t, x, n in ((imu.gyr_t, imu.gyr, n_gyr), (imu.vel_t, imu.vel, n_vel)):
        sel = np.nonzero((t >= t0 - 0.2) & (t <= t1 + 0.2))[0][:n]
        pad = n - sel.size
        out += [np.concatenate([t[sel], np.full(pad, t[sel[-1]])]),
                np.concatenate([x[sel], np.repeat(x[sel[-1:]], pad, axis=0)])]
    return out


def _assert_meas(got, want, rtol=1e-8, jac_rtol=1e-7):
    """Each field within `rtol` (the Jacobians `jac_rtol`) of its largest
    entry: the covariances' off-diagonal entries sit ~1e-6 below their
    diagonals."""
    for f in ju.PreintMeas._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        tol = rtol if f in ("delta_R", "delta_p", "cov", "dt", "dt_sq_half") else jac_rtol
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(), err_msg=f)


CASES = {
    # (imu seed, t0, t1, window_duration, queries): a half-second window
    # queried inside it, and the SLAM back end's one-second window
    "half_second": (0, 1.0, 1.5, 0.5, [1.1, 1.25, 1.5]),
    "slam_window": (3, 0.9013, 1.7013, 1.0, [1.7013]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted(request):
    seed, t0, t1, wd, q = CASES[request.param]
    imu = _imu(seed=seed)
    if request.param == "slam_window":
        arrays = _slam_window(imu, t0, t1)
    else:
        arrays = _window(imu, t0, t1)
    jcfg = ju.UGPMConfig(window_duration=wd)
    tcfg = config_from_dict(tu.UGPMConfig, jcfg._asdict())
    jstate = ju.ugpm_fit(*[jnp.asarray(a) for a in arrays], t0, imu.gyr_var, imu.vel_var, jcfg)
    tstate = tu.ugpm_fit(*[torch.as_tensor(a) for a in arrays], t0, float(imu.gyr_var),
                         float(imu.vel_var), tcfg)
    return dict(arrays=arrays, t0=t0, q=np.asarray(q), imu=imu, jcfg=jcfg, tcfg=tcfg,
                jstate=jstate, tstate=tstate, name=request.param)


def test_ugpm_fit_matches_jax(fitted):
    """Every field of the fitted GP state: the LM's rotation states, the
    kriged velocity states, the kernel products, the Jacobian states and the
    correlation-rescaled state covariance, each within 1e-6 of its largest
    entry. The LM leaves the overlap knots outside the data in flat
    directions of its cost, where the last-bit differences of the two
    packages' LAPACK calls move the rotation states by ~1e-7; the queried
    moments below do not see them."""
    jstate, tstate = fitted["jstate"], fitted["tstate"]
    assert tstate.state_time.shape[0] == fitted["tcfg"].nb_state
    if fitted["name"] == "slam_window":
        assert fitted["tcfg"].nb_state == 66 and fitted["arrays"][0].shape == (256,)
    for f in ju._GPState._fields:
        a, b = getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max(), err_msg=f)


def test_ugpm_query_matches_jax(fitted):
    """`ugpm_query` on the port's fit against the JAX package's query of its
    own fit, and on the JAX fit carried across (the query alone)."""
    t0, q = fitted["t0"], fitted["q"]
    want = ju.ugpm_query(fitted["jstate"], t0, jnp.asarray(q))
    _assert_meas(tu.ugpm_query(fitted["tstate"], t0, torch.as_tensor(q)), want)
    carried = tu._GPState(**{f: torch.as_tensor(np.asarray(getattr(fitted["jstate"], f)))
                             for f in ju._GPState._fields})
    # (the projection cancels: kss_int - ks K^-1 ks^T with K^-1 entries ~1e4,
    # so the query alone keeps the fit's tolerances)
    _assert_meas(tu.ugpm_query(carried, t0, torch.as_tensor(q)), want)


def test_ugpm_preintegrate_matches_jax_and_skips_jacobians(fitted):
    """The one-call facade, and `with_jacobians=False` (the SLAM back end's
    call): the same `delta_R`, `delta_p` and `cov`, zero Jacobian fields."""
    arrays, t0, q, imu = fitted["arrays"], fitted["t0"], fitted["q"], fitted["imu"]
    targs = [torch.as_tensor(a) for a in arrays]
    got = tu.ugpm_preintegrate(*targs, t0, torch.as_tensor(q), float(imu.gyr_var),
                               float(imu.vel_var), fitted["tcfg"])
    want = ju.ugpm_preintegrate(*[jnp.asarray(a) for a in arrays], t0, jnp.asarray(q),
                                imu.gyr_var, imu.vel_var, fitted["jcfg"])
    _assert_meas(got, want)
    lean = tu.ugpm_preintegrate(*targs, t0, torch.as_tensor(q), float(imu.gyr_var),
                                float(imu.vel_var), fitted["tcfg"], with_jacobians=False)
    for f in ("delta_R", "delta_p", "cov"):
        np.testing.assert_allclose(getattr(lean, f).numpy(), getattr(got, f).numpy(),
                                   rtol=1e-12, atol=1e-15, err_msg=f)
    assert not lean.d_delta_R_d_bw.any() and not lean.d_delta_p_d_t.any()


def test_ugpm_query_keeps_the_reconditioning_guard():
    """A state covariance gone non-finite (what f32 ill-conditioning can
    produce) falls back to the decorrelated diagonal per query, as in the
    JAX package."""
    imu = _imu(seed=5)
    arrays = _window(imu, 1.0, 1.5)
    jcfg = ju.UGPMConfig(window_duration=0.5, lm_iters=5)
    jstate = ju.ugpm_fit(*[jnp.asarray(a) for a in arrays], 1.0, imu.gyr_var, imu.vel_var, jcfg)
    jstate = jstate._replace(state_cov=jstate.state_cov.at[3, 5].set(jnp.nan))
    carried = tu._GPState(**{f: torch.as_tensor(np.asarray(getattr(jstate, f)))
                             for f in ju._GPState._fields})
    q = np.array([1.2, 1.5])
    want = ju.ugpm_query(jstate, 1.0, jnp.asarray(q))
    got = tu.ugpm_query(carried, 1.0, torch.as_tensor(q))
    assert np.isfinite(got.cov.numpy()).all()
    assert not got.cov[:, 3:, :3].any()  # decorrelated: rotation-position blocks dropped
    _assert_meas(got, want)


@pytest.mark.parametrize("t0,t1,seed", [(0.5, 1.0, 2), (1.2, 1.7, 7)])
def test_ugpm_matches_numpy_oracle(t0, t1, seed):
    """The port's fit against the oracle that shares nothing with either
    package (scipy rotations, a hand-written kernel, dense quadrature), with
    the hyperparameters the port chose."""
    imu = _imu(seed=seed, duration=2.5, gyr_std=0.002, vel_std=0.005, vel_rate=50.0)
    gyr_t, gyr, vel_t, vel = _window(imu, t0, t1, pad=0.25)
    cfg = tu.UGPMConfig(window_duration=t1 - t0, lm_iters=20)
    state = tu.ugpm_fit(*[torch.as_tensor(a) for a in (gyr_t, gyr, vel_t, vel)], t0,
                        float(imu.gyr_var), float(imu.vel_var), cfg, with_jacobians=False)
    meas = tu.ugpm_query(state, t0, torch.tensor([t1], dtype=torch.float64))
    dR_o, dp_o = oracle_preint(gyr_t, gyr, vel_t, vel, t0, t1, l2=float(state.l2),
                               sf2_vel=state.sf2[3:].numpy(), sz2_vel=float(imu.vel_var),
                               grid_n=4000)
    dR, dp = meas.delta_R[0].numpy(), meas.delta_p[0].numpy()
    rot_err = np.rad2deg(np.arccos(np.clip((np.trace(dR.T @ dR_o) - 1) / 2, -1, 1)))
    assert rot_err < 0.15, rot_err
    assert np.linalg.norm(dp - dp_o) < 0.02, (dp, dp_o)


def test_ugpm_config_carries_over():
    jcfg = ju.UGPMConfig(window_duration=0.7, lm_iters=12, correlate=False)
    tcfg = config_from_dict(tu.UGPMConfig, jcfg._asdict())
    assert tcfg == tu.UGPMConfig(window_duration=0.7, lm_iters=12, correlate=False)
    assert tcfg.nb_state == jcfg.nb_state == 51
    assert tu.UGPMConfig().nb_state == 66
