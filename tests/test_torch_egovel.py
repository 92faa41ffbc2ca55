"""Port parity: `gorio_tpu_torch.estimators.egovel` against
`gorio_tpu.estimators.egovel` on identical float64 scans.

`jax.random.choice` cannot be reproduced with torch's generators, so the
test draws the RANSAC hypothesis indices with JAX exactly as
`estimate_ego_velocity` does for its key and hands them to the port. With
the same hypotheses the computation is deterministic float64: v and sigma
agree to 1e-10, the masks exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.estimators import egovel as je
from gorio_tpu.io.synthetic import make_dynamic_objects, make_world, render_radar_scan
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict
from gorio_tpu_torch.estimators import egovel as te


def _scan(v_body, seed, dynamic=0):
    world = make_world(seed=2, n_landmarks=4000)
    dpts = dvel = None
    if dynamic:
        objects = make_dynamic_objects(seed=seed + 7, n_objects=dynamic, extent=15.0)
        dpts, dvel = objects.points_at(0.0)
    return render_radar_scan(world, np.eye(3), np.zeros(3), np.asarray(v_body), capacity=512,
                             seed=seed, dynamic_points=dpts, dynamic_vel=dvel,
                             azimuth_fov_deg=56.5, elevation_fov_deg=22.5)


def _jax_hypotheses(cloud, cfg, key):
    """The (iters, k) indices `estimate_ego_velocity` draws for `key`."""
    valid, _ = je._gate(cloud, cfg)
    w = valid.astype(cloud.xyz.dtype)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    return jax.random.choice(key, cloud.capacity, shape=(cfg.ransac_iter, cfg.n_ransac_points),
                             replace=True, p=p)


@pytest.mark.parametrize("mode", ["consensus", "reference"])
@pytest.mark.parametrize("scan", ["clean", "dynamic", "stopped"])
def test_ego_velocity_matches_jax(mode, scan):
    v_body, dynamic = {"clean": ([2.0, 0.3, 0.1], 0), "dynamic": ([1.5, -0.4, 0.0], 3),
                       "stopped": ([0.0, 0.0, 0.0], 0)}[scan]
    cloud = _scan(v_body, seed=len(scan), dynamic=dynamic)
    jcfg = je.EgoVelConfig(reinsert_mode=mode)
    key = jax.random.PRNGKey(7)
    hyp = np.asarray(_jax_hypotheses(cloud, jcfg, key))
    jr = je.estimate_ego_velocity(cloud, jcfg, key=key)
    tr = te.estimate_ego_velocity(cloud_from_numpy(cloud),
                                  config_from_dict(te.EgoVelConfig, jcfg._asdict()), hyp_idx=hyp)
    np.testing.assert_allclose(tr.v.numpy(), np.asarray(jr.v), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tr.sigma.numpy(), np.asarray(jr.sigma), rtol=1e-10, atol=1e-12)
    for f in ("inlier_mask", "valid_mask", "ok", "zero_velocity"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    if scan == "clean" or (scan == "dynamic" and mode == "consensus"):
        # reference mode's blanket reinsertion is poisoned by dynamic points
        # (see tests/test_egovel.py); parity above still holds there
        assert np.linalg.norm(tr.v.numpy() - np.asarray(v_body)) < 0.1


def test_drawn_hypotheses_recover_velocity():
    """Without injected indices the port draws its own from a generator:
    only valid points, and the same estimate to within the RANSAC noise."""
    cloud = cloud_from_numpy(_scan([2.0, 0.3, 0.1], seed=3, dynamic=2))
    cfg = te.EgoVelConfig()
    gen = torch.Generator().manual_seed(0)
    valid, _ = te._gate(cloud, cfg)
    idx = te.draw_hypotheses(valid, cfg.ransac_iter, cfg.n_ransac_points, gen)
    assert idx.shape == (cfg.ransac_iter, cfg.n_ransac_points) and bool(valid[idx].all())
    r = te.estimate_ego_velocity(cloud, cfg, generator=gen)
    assert bool(r.ok) and np.linalg.norm(r.v.numpy() - [2.0, 0.3, 0.1]) < 0.1
