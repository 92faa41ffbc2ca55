"""Port parity: the preintegration facade and algebra
(`gorio_tpu_torch.preintegration`: `preintegrate`, `combine_preints`,
`add_bias_cov`, `PreintPrior`) against `gorio_tpu.preintegration`, in
float64 on the CPU.

- `combine_preints` and `add_bias_cov` on random measurements with leading
  batch axes, one broadcast against another: within 1e-12 (a few dozen
  float64 products).
- `preintegrate` with one window and chunked (`quantum` > 0), LPM and a
  short UGPM, on noisy streams: the same chunks (margins, `overlap_s`
  padding, the whole-stream fallback of a chunk with too few samples), the
  same combination. LPM within 1e-9 of each field's largest entry; UGPM
  within the limits of `tests/test_torch_ugpm.py` (1e-8, its Jacobians
  1e-7): its LM runs 30 dense iterations in another summation order.
- The JAX package's `test_chunked_preintegration_matches_single` (a 4 s
  window, noiseless streams, one window against `quantum=1.0`: 2e-3 rad,
  2e-2 m) on the port. The JAX test is marked slow for its compiles; the
  port's LPM runs it in about a second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.io.synthetic import sample_imu, simulate_trajectory
from gorio_tpu.preintegration import preintegrate as j_preintegrate
from gorio_tpu.preintegration import types as jt
from gorio_tpu.preintegration.ugpm import UGPMConfig as JUGPMConfig
from gorio_tpu_torch.core import lie
from gorio_tpu_torch.preintegration import PreintMeas, PreintPrior, add_bias_cov, combine_preints
from gorio_tpu_torch.preintegration import preintegrate as t_preintegrate
from gorio_tpu_torch.preintegration.ugpm import UGPMConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_meas(rng, batch):
    def r(*shape):
        return rng.normal(size=batch + shape)

    A = r(6, 6)
    return jt.PreintMeas(
        delta_R=np.asarray(lie.so3_exp(torch.as_tensor(0.5 * r(3)))), delta_p=r(3),
        dt=np.abs(r()) + 0.1, dt_sq_half=r(), cov=A @ np.swapaxes(A, -1, -2) + np.eye(6),
        d_delta_R_d_bw=r(3, 3), d_delta_R_d_t=r(3), d_delta_p_d_bw=r(3, 3),
        d_delta_p_d_bv=r(3, 3), d_delta_p_d_t=r(3))


def _to_torch(m):
    return PreintMeas(*(torch.as_tensor(np.asarray(x)) for x in m))


def _assert_meas(got, want, rtol, jac_rtol=None):
    """Each field within `rtol` (the Jacobians `jac_rtol`) of its largest
    entry."""
    for f in jt.PreintMeas._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        tol = rtol if jac_rtol is None or f in ("delta_R", "delta_p", "cov", "dt",
                                                "dt_sq_half") else jac_rtol
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300),
                                   err_msg=f)


@pytest.mark.parametrize("prev_batch,curr_batch", [((4,), (4,)), ((), (3,)), ((2, 1), (1, 3))])
def test_combine_preints_matches_jax(prev_batch, curr_batch):
    rng = np.random.default_rng(len(prev_batch) + 3 * len(curr_batch))
    prev, curr = _random_meas(rng, prev_batch), _random_meas(rng, curr_batch)
    want = jt.combine_preints(jax.tree.map(jnp.asarray, prev), jax.tree.map(jnp.asarray, curr))
    got = combine_preints(_to_torch(prev), _to_torch(curr))
    _assert_meas(got, want, 1e-12)


def test_add_bias_cov_and_prior_match_jax():
    m = _random_meas(np.random.default_rng(5), (2, 3))
    want = jt.add_bias_cov(jax.tree.map(jnp.asarray, m), vel_bias_std=0.2, gyr_bias_std=0.05)
    got = add_bias_cov(_to_torch(m), vel_bias_std=0.2, gyr_bias_std=0.05)
    _assert_meas(got, want, 1e-12)
    _assert_meas(add_bias_cov(_to_torch(m)), jt.add_bias_cov(jax.tree.map(jnp.asarray, m)),
                 1e-12)
    assert PreintPrior()._fields == jt.PreintPrior()._fields
    np.testing.assert_array_equal(PreintPrior().gyr_bias, jt.PreintPrior().gyr_bias)


def _streams(gyr_rate=200.0, vel_rate=20.0, duration=2.0, noise=True):
    traj = simulate_trajectory(seed=12, duration=duration)
    imu = sample_imu(traj, gyr_rate=gyr_rate, vel_rate=vel_rate,
                     gyr_std=0.005 if noise else 0.0, vel_std=0.02 if noise else 0.0, seed=13)
    return imu, (imu.gyr_t, imu.gyr, imu.vel_t, imu.vel)


# Start, queries and chunk bounds lie off the sample grids: at a sample time
# the time-shift Jacobian of the linear interpolation has two one-sided
# values, and either package may take either.
CASES = {
    # method, quantum, start, queries, streams
    "lpm": ("lpm", -1.0, 0.3037, [0.4513, 1.1093, 1.7131], {}),
    "lpm_chunked": ("lpm", 0.5, 0.3037, [0.4513, 0.8071, 1.1093, 1.7131], {}),
    # 4 Hz streams: every 0.2 s chunk (+-0.1 s) holds < 4 gyro samples, the
    # whole streams stand in
    "lpm_chunked_fallback": ("lpm", 0.2, 0.3037, [0.4113, 0.7571],
                             dict(gyr_rate=4.0, vel_rate=4.0)),
    "ugpm": ("ugpm", -1.0, 0.4013, [0.6071, 0.9093], dict(duration=1.2)),
    "ugpm_chunked": ("ugpm", 0.3, 0.4013, [0.6071, 0.9093], dict(duration=1.2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preintegrate_matches_jax(case):
    method, quantum, start, queries, kw = CASES[case]
    imu, arrays = _streams(**kw)
    ucfg = dict(ugpm_cfg=None)
    want = j_preintegrate(*[jnp.asarray(a) for a in arrays], start, jnp.asarray(queries),
                          imu.gyr_var, imu.vel_var, method=method, quantum=quantum,
                          grid_n=256, **ucfg)
    got = t_preintegrate(*[torch.as_tensor(a) for a in arrays], start,
                         torch.as_tensor(np.asarray(queries)), float(imu.gyr_var),
                         float(imu.vel_var),
                         method=method, quantum=quantum, grid_n=256, **ucfg)
    if method == "lpm":
        _assert_meas(got, want, 1e-9)
    else:
        _assert_meas(got, want, 1e-8, jac_rtol=1e-7)


def test_preintegrate_ugpm_config_carries_over():
    """An explicit `ugpm_cfg` replaces the window-sized default."""
    imu, arrays = _streams(duration=1.2)
    jcfg = JUGPMConfig(window_duration=0.8, lm_iters=5)
    args = (0.4013, [0.6071, 1.0093], imu.gyr_var, imu.vel_var)
    want = j_preintegrate(*[jnp.asarray(a) for a in arrays], args[0], jnp.asarray(args[1]),
                          *args[2:], method="ugpm", ugpm_cfg=jcfg)
    got = t_preintegrate(*[torch.as_tensor(a) for a in arrays], args[0],
                         torch.as_tensor(np.asarray(args[1])), float(args[2]), float(args[3]),
                         method="ugpm", ugpm_cfg=UGPMConfig(**jcfg._asdict()))
    _assert_meas(got, want, 1e-8, jac_rtol=1e-7)


def test_chunked_preintegration_matches_single():
    imu, arrays = _streams(duration=4.0, noise=False)
    args = [torch.as_tensor(a) for a in arrays]
    queries = torch.tensor([1.1, 2.3, 3.4], dtype=torch.float64)
    single = t_preintegrate(*args, 0.5, queries, 1e-6, 1e-6, quantum=-1.0, grid_n=1024)
    chunked = t_preintegrate(*args, 0.5, queries, 1e-6, 1e-6, quantum=1.0, grid_n=1024)
    for i in range(3):
        ang = float(lie.rotation_geodesic_angle(single.delta_R[i], chunked.delta_R[i]))
        assert ang < 2e-3, (i, ang)
        np.testing.assert_allclose(chunked.delta_p[i].numpy(), single.delta_p[i].numpy(),
                                   atol=2e-2)
    np.testing.assert_allclose(chunked.dt.numpy(), single.dt.numpy(), atol=1e-9)
