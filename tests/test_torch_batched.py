"""Port parity: the batch axes of `estimate_ego_velocity` (B scans),
`ugpm_fit` / `ugpm_query` / `ugpm_preintegrate` (W windows) and
`ndt_align_with_map` / `ndt_align_multires` (B sources against one map
pair), in float64 on the CPU, each against the port's loop of single calls
on the same inputs and against `jax.vmap` of the JAX function.

- Ego velocity, 4 scans (clean, dynamic objects, stopped, another clean
  one) at capacity 512, the RANSAC hypotheses JAX's own draws for each
  lane's key (`tests/test_torch_egovel.py`): v and sigma within 1e-12 of
  the loop and 1e-9 of `jax.vmap`, the masks exact.
- UGPM, 4 windows of noisy streams (`tests/test_torch_ugpm.py`'s
  generator) with their Jacobians: the loop within 1e-10 of each field's
  largest entry, the covariances within 1e-8 (the batched products round
  their last bits otherwise than the single window's, the LM's dense
  solves carry that to ~1e-11 and the inverse of JtJ, conditioned ~1e5,
  to ~1e-9); `jax.vmap` within the single window's limits of
  `tests/test_torch_ugpm.py` (1e-8, the Jacobians 1e-7): the fixed LM runs
  its dense solves in another summation order.
- NDT coarse-to-fine, 3 sources (the scan of `tests/test_torch_ndt.py`
  jittered by a few centimetres), one lane started at another lane's
  result, so that it stops early: T within 1e-12 of the loop (H and the
  score 1e-12 relative) and 1e-8 of `jax.vmap`, the same iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.estimators import egovel as je
from gorio_tpu.io.synthetic import make_world, render_radar_scan
from gorio_tpu.preintegration import ugpm as ju
from gorio_tpu.registration import ndt as jn
from gorio_tpu_torch.convert import config_from_dict
from gorio_tpu_torch.core.pointcloud import PointCloud
from gorio_tpu_torch.estimators import egovel as te
from gorio_tpu_torch.preintegration import ugpm as tu
from gorio_tpu_torch.registration import ndt as tn
from test_torch_egovel import _jax_hypotheses, _scan
from test_torch_ugpm import _imu, _window


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(items):
    return type(items[0])(*(np.stack([np.asarray(x) for x in xs]) for xs in zip(*items)))


def _lane(tree, b):
    return type(tree)(*(None if x is None else x[b] for x in tree))


def _close(got, want, rtol, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=msg)


def test_ego_velocity_batch_matches_loop_and_vmap():
    scans = [_scan([2.0, 0.3, 0.1], 1), _scan([1.5, -0.4, 0.0], 2, dynamic=3),
             _scan([0.0, 0.0, 0.0], 3), _scan([-1.0, 0.5, 0.2], 4)]
    jcfg = je.EgoVelConfig()
    keys = jax.random.split(jax.random.PRNGKey(3), len(scans))
    hyp = np.stack([np.asarray(_jax_hypotheses(c, jcfg, k)) for c, k in zip(scans, keys)])
    batch = _stack(scans)
    tcfg = config_from_dict(te.EgoVelConfig, jcfg._asdict())
    tbatch = PointCloud(*(torch.as_tensor(x) for x in batch))
    got = te.estimate_ego_velocity(tbatch, tcfg, hyp_idx=torch.as_tensor(hyp))
    want = jax.vmap(lambda c, k: je.estimate_ego_velocity(c, jcfg, key=k))(
        jax.tree.map(jnp.asarray, batch), keys)
    for b in range(len(scans)):
        one = te.estimate_ego_velocity(_lane(tbatch, b), tcfg, hyp_idx=torch.as_tensor(hyp[b]))
        for f in te.EgoVelResult._fields:
            g, o = getattr(got, f)[b], getattr(one, f)
            if g.dtype == torch.bool:
                assert torch.equal(g, o), (b, f)
            else:
                np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-12, atol=1e-14)
    for f in te.EgoVelResult._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12, err_msg=f)
    assert bool(got.zero_velocity[2]) and not bool(got.zero_velocity[0])
    # one explicit generator draws every lane's hypotheses
    drawn = te.estimate_ego_velocity(tbatch, tcfg, generator=torch.Generator().manual_seed(0))
    assert drawn.v.shape == (4, 3) and bool(torch.isfinite(drawn.v).all())
    np.testing.assert_allclose(drawn.v.numpy(), got.v.numpy(), atol=0.05)


@pytest.fixture(scope="module")
def ugpm_windows():
    imu = _imu(seed=5, duration=3.0)
    starts = np.array([0.4013, 0.9071, 1.3093, 1.8131])
    wins = [_window(imu, t0, t0 + 0.5) for t0 in starts]
    n_g = min(len(w[0]) for w in wins)
    n_v = min(len(w[2]) for w in wins)
    arrays = [np.stack([w[i][: (n_g if i < 2 else n_v)] for w in wins]) for i in range(4)]
    queries = starts[:, None] + np.array([0.1013, 0.2571, 0.4993])[None]
    return imu, arrays, starts, queries


def test_ugpm_batch_matches_loop_and_vmap(ugpm_windows):
    imu, arrays, starts, queries = ugpm_windows
    jcfg = ju.UGPMConfig(window_duration=0.6, lm_iters=10)
    tcfg = config_from_dict(tu.UGPMConfig, jcfg._asdict())
    targs = [torch.as_tensor(a) for a in arrays]
    gv, vv = float(imu.gyr_var), float(imu.vel_var)
    state = tu.ugpm_fit(*targs, torch.as_tensor(starts), gv, vv, tcfg)
    got = tu.ugpm_query(state, torch.as_tensor(starts), torch.as_tensor(queries))
    again = tu.ugpm_preintegrate(*targs, torch.as_tensor(starts), torch.as_tensor(queries),
                                 gv, vv, tcfg)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    for w in range(len(starts)):
        one = tu.ugpm_fit(*[a[w] for a in targs], float(starts[w]), gv, vv, tcfg)
        for f in one._fields:
            _close(getattr(state, f)[w], getattr(one, f), 1e-8 if f == "state_cov" else 1e-10, f)
        q1 = tu.ugpm_query(one, float(starts[w]), torch.as_tensor(queries[w]))
        for f in q1._fields:
            _close(getattr(got, f)[w], getattr(q1, f), 1e-8 if f == "cov" else 1e-10, f)
    jstate = jax.vmap(lambda a, b, c, d, s: ju.ugpm_fit(a, b, c, d, s, imu.gyr_var, imu.vel_var,
                                                        jcfg))(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(starts))
    want = jax.vmap(ju.ugpm_query)(jstate, jnp.asarray(starts), jnp.asarray(queries))
    for f in want._fields:
        rtol = 1e-8 if f in ("delta_R", "delta_p", "cov", "dt", "dt_sq_half") else 1e-7
        _close(getattr(got, f), getattr(want, f), rtol, f)
    # without the Jacobians: the same moments, zero Jacobian fields
    lean = tu.ugpm_preintegrate(*targs, torch.as_tensor(starts), torch.as_tensor(queries), gv,
                                vv, tcfg, with_jacobians=False)
    for f in ("delta_R", "delta_p", "cov"):
        _close(getattr(lean, f), getattr(got, f), 1e-12, f)
    assert not bool(lean.d_delta_p_d_bw.any())


@pytest.fixture(scope="module")
def ndt_case():
    world = make_world(seed=21, n_landmarks=6000)
    R1 = Rotation.from_euler("ZYX", [0.04, 0.0, 0.0]).as_matrix()
    target = render_radar_scan(world, np.eye(3), np.zeros(3), np.zeros(3), capacity=512, seed=1)
    source = render_radar_scan(world, R1, np.array([0.5, 0.2, 0.0]), np.zeros(3), capacity=512,
                               seed=2)
    T0 = np.eye(4)
    T0[:3, :3] = R1
    T0[:3, 3] = [0.65, 0.1, 0.05]
    jcfg = jn.NDTConfig(resolution=2.0, min_points_per_voxel=3)
    return source, target, T0, jcfg


def test_ndt_multires_batch_matches_loop_and_vmap(ndt_case):
    source, target, T0, jcfg = ndt_case
    tcfg = config_from_dict(tn.NDTConfig, jcfg._asdict())
    jitter = np.array([[0.0, 0.0, 0.0], [0.05, -0.03, 0.02], [-0.04, 0.06, 0.0]])
    srcs = _stack([source] * 3)
    srcs = srcs._replace(xyz=srcs.xyz + jitter[:, None, :])
    tt = PointCloud(*(torch.as_tensor(np.asarray(x)) for x in target))
    vc = tn.build_voxel_map(tt, tn.coarse_cfg(tcfg))
    vf = tn.build_voxel_map(tt, tcfg)
    tsrc = PointCloud(*(torch.as_tensor(x) for x in srcs))
    # lane 2 starts where lane 0's align ends: its passes stop early
    first = tn.ndt_align_multires(_lane(tsrc, 0), vc, vf, torch.as_tensor(T0), tcfg)
    inits = torch.stack([torch.as_tensor(T0), torch.as_tensor(T0), first.T])
    srcs = srcs._replace(xyz=srcs.xyz[[0, 1, 0]])
    tsrc = PointCloud(*(torch.as_tensor(x) for x in srcs))
    got = tn.ndt_align_multires(tsrc, vc, vf, inits, tcfg)
    loop = [tn.ndt_align_multires(_lane(tsrc, b), vc, vf, inits[b], tcfg) for b in range(3)]
    assert got.iterations.tolist() == [int(r.iterations) for r in loop]
    assert int(got.iterations[2]) < int(got.iterations[0])
    for b, r in enumerate(loop):
        np.testing.assert_allclose(got.T[b].numpy(), r.T.numpy(), rtol=0, atol=1e-12)
        _close(got.H[b], r.H, 1e-12, "H")
        _close(got.error[b], r.error, 1e-12, "error")
    jc = jn.build_voxel_map(target, jn.coarse_cfg(jcfg))
    jf = jn.build_voxel_map(target, jcfg)
    want = jax.vmap(lambda s, T: jn.ndt_align_multires(s, jc, jf, T, jcfg))(
        jax.tree.map(jnp.asarray, srcs), jnp.asarray(inits.numpy()))
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0, atol=1e-8)
    _close(got.error, want.error, 1e-8, "error")
