"""Port parity: `gorio_tpu_torch.preintegration.lpm` and
`gorio_tpu_torch.loopclosure.information` against the JAX package, float64.

Tolerances: the port's log-depth prefix scans reassociate the 3x3 products
of JAX's associative scan, which in float64 moves results by ~1e-15; we hold
values and Jacobians to atol 1e-10. The time-shift Jacobian is not smooth
where a grid point falls exactly on a sample time (the interpolant has a
kink there, and the two frameworks round the grid differently by an ulp), so
the window and query times are chosen off the 5 ms sample lattice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.io.synthetic import make_world, render_radar_scan, sample_imu, simulate_trajectory
from gorio_tpu.loopclosure import information as ji
from gorio_tpu.preintegration.lpm import lpm_preintegrate as j_lpm
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict
from gorio_tpu_torch.loopclosure import information as ti
from gorio_tpu_torch.preintegration.lpm import lpm_preintegrate as t_lpm


@pytest.fixture(scope="module")
def imu():
    traj = simulate_trajectory(seed=0, duration=2.0)
    return traj, sample_imu(traj, gyr_rate=200.0, vel_rate=20.0, gyr_std=0.005, vel_std=0.02)


@pytest.mark.parametrize("start_t,queries", [
    (0.3037, [0.5013, 0.8071, 1.2093, 1.7131]),
    (1.0041, [0.6117, 1.0041, 1.4219]),  # a query before the start, one at it
])
def test_lpm_matches_jax_with_jacobians(imu, start_t, queries):
    _, m = imu
    queries = np.asarray(queries)
    args = (m.gyr_t, m.gyr, m.vel_t, m.vel)
    jm = j_lpm(*[jnp.asarray(a) for a in args], start_t, jnp.asarray(queries),
               m.gyr_var, m.vel_var, grid_n=256)
    tm = t_lpm(*[torch.as_tensor(a) for a in args], start_t, torch.as_tensor(queries),
               m.gyr_var, m.vel_var, grid_n=256)
    for f in jm._fields:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-9, atol=1e-10, err_msg=f)
    tn = t_lpm(*[torch.as_tensor(a) for a in args], start_t, torch.as_tensor(queries),
               m.gyr_var, m.vel_var, grid_n=256, with_jacobians=False)
    for f in ("delta_R", "delta_p", "dt", "cov"):
        assert torch.equal(getattr(tn, f), getattr(tm, f)), f


def test_lpm_matches_truth_noiseless():
    """`test_lpm.py::test_lpm_matches_truth_noiseless` on the port."""
    traj = simulate_trajectory(seed=0, duration=2.0)
    m = sample_imu(traj, gyr_rate=200.0, vel_rate=20.0, gyr_std=0.0, vel_std=0.0, seed=1)
    start_t, queries = 0.3, np.array([0.5, 0.8, 1.2, 1.7])
    meas = t_lpm(*[torch.as_tensor(a) for a in (m.gyr_t, m.gyr, m.vel_t, m.vel)], start_t,
                 torch.as_tensor(queries), 1e-8, 1e-8, grid_n=1024, with_jacobians=False)
    R0, p0 = traj.interp_pose(np.array([start_t]))
    for i, tq in enumerate(queries):
        R1, p1 = traj.interp_pose(np.array([tq]))
        dR = R0[0].T @ R1[0]
        ang = np.arccos(np.clip((np.trace(dR.T @ meas.delta_R[i].numpy()) - 1) / 2, -1, 1))
        assert ang < 2e-3
        np.testing.assert_allclose(meas.delta_p[i].numpy(), R0[0].T @ (p1[0] - p0[0]), atol=2e-2)


@pytest.mark.parametrize("const", [False, True])
def test_information_matrix_matches_jax(const):
    world = make_world(seed=4, n_landmarks=4000)
    v = np.array([2.0, 0.0, 0.0])
    a = render_radar_scan(world, np.eye(3), np.zeros(3), v, capacity=512, seed=5)
    b = render_radar_scan(world, np.eye(3), np.array([0.4, 0.05, 0.0]), v, capacity=512, seed=6)
    T = np.eye(4)
    T[:3, 3] = [0.38, 0.06, 0.01]
    jcfg = ji.InformationConfig(use_const_inf_matrix=const)
    j_inf, j_fit = ji.calc_information_matrix(b, a, jnp.asarray(T), jcfg)
    t_inf, t_fit = ti.calc_information_matrix(
        cloud_from_numpy(b), cloud_from_numpy(a), torch.as_tensor(T),
        config_from_dict(ti.InformationConfig, jcfg._asdict()),
    )
    np.testing.assert_allclose(t_inf.numpy(), np.asarray(j_inf), rtol=1e-10)
    np.testing.assert_allclose(float(t_fit), float(j_fit), rtol=1e-10, atol=1e-14)
