"""The port's JAX-free simulator gives bit-identical arrays to
`gorio_tpu.io.synthetic` for the same seeds (same numpy code paths)."""

import numpy as np
import pytest

from gorio_tpu.io import synthetic as js
from gorio_tpu_torch.io import synthetic as ts


@pytest.mark.parametrize("kw", [
    dict(seed=0, duration=4.0),
    dict(seed=3, duration=6.0, circuit=True, stops=1, laps=1.5),
    dict(seed=5, duration=5.0, figure8=True, elev_amp=0.2),
])
def test_trajectory_imu_gps_identical(kw):
    jt, tt = js.simulate_trajectory(**kw), ts.simulate_trajectory(**kw)
    for f in ("t", "R", "p", "omega", "v_body"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    q = np.linspace(0.1, kw["duration"] - 0.1, 7)
    for a, b in zip(jt.interp_pose(q), tt.interp_pose(q)):
        np.testing.assert_array_equal(b, a)
    ji, ti = js.sample_imu(jt, seed=kw["seed"] + 1), ts.sample_imu(tt, seed=kw["seed"] + 1)
    for f in ("gyr_t", "gyr", "vel_t", "vel", "gyr_var", "vel_var"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f), err_msg=f)
    for a, b in zip(js.sample_gps(jt, seed=4), ts.sample_gps(tt, seed=4)):
        np.testing.assert_array_equal(b, a)


def test_world_and_scans_identical():
    jw, tw = js.make_world(seed=2, n_landmarks=3000), ts.make_world(seed=2, n_landmarks=3000)
    np.testing.assert_array_equal(tw, jw)
    jd = js.make_dynamic_objects(seed=5, n_objects=3)
    td = ts.make_dynamic_objects(seed=5, n_objects=3)
    for a, b in zip(jd.points_at(1.5), td.points_at(1.5)):
        np.testing.assert_array_equal(b, a)
    R = np.eye(3)
    p = np.array([1.0, -2.0, 0.1])
    v = np.array([2.0, 0.2, 0.0])
    dpts, dvel = jd.points_at(0.5)
    for kw in (dict(azimuth_fov_deg=56.5, elevation_fov_deg=22.5),
               dict(dynamic_points=dpts, dynamic_vel=dvel)):
        jc = js.render_radar_scan(jw, R, p, v, capacity=512, seed=1000, **kw)
        tc = ts.render_radar_scan(tw, R, p, v, capacity=512, seed=1000, **kw)
        for f in jc._fields:
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                          err_msg=f)
