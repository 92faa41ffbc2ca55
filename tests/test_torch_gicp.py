"""Port parity: `gorio_tpu_torch.registration` (GICP, LM) against
`gorio_tpu.registration` on identical float64 scan pairs.

Tolerance: the same float64 arithmetic up to summation order (the JAX
package reduces with XLA, the port with torch), so the linearization agrees
to ~1e-13 relative; we hold it to 1e-10. The LM loop must take the same
number of iterations and land on the same T (atol 1e-10) and H (rtol 1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.io.synthetic import make_world, render_radar_scan
from gorio_tpu.registration import gicp as jg
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict
from gorio_tpu_torch.registration import gicp as tg

MODES = ["apdgicp", "gicp", "icp"]


@pytest.fixture(scope="module")
def pair():
    world = make_world(seed=11, n_landmarks=5000)
    R1 = Rotation.from_euler("ZYX", [0.06, 0.01, -0.005]).as_matrix()
    p1 = np.array([0.6, 0.25, 0.02])
    v = np.array([2.0, 0.3, 0.0])
    tgt = render_radar_scan(world, np.eye(3), np.zeros(3), v, capacity=512, seed=1, dropout=0.15)
    src = render_radar_scan(world, R1, p1, v, capacity=512, seed=2, dropout=0.15)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("zyx", [0.05, -0.02, 0.01]).as_matrix()
    T[:3, 3] = [0.5, 0.2, 0.05]
    return src, tgt, cloud_from_numpy(src), cloud_from_numpy(tgt), T


def _cfgs(mode):
    jcfg = jg.GICPConfig(mode=mode)
    return jcfg, config_from_dict(tg.GICPConfig, jcfg._asdict())


def test_knn_covariances_match_jax(pair):
    src, _, tsrc, _, _ = pair
    j_cov, j_geo = jg.knn_covariances(src.xyz, src.mask, k=20)
    t_cov, t_geo = tg.knn_covariances(tsrc.xyz, tsrc.mask, k=20)
    np.testing.assert_allclose(t_cov.numpy(), np.asarray(j_cov), atol=1e-10)
    np.testing.assert_allclose(t_geo.numpy(), np.asarray(j_geo), atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_linearize_matches_jax(pair, mode):
    src, tgt, tsrc, ttgt, T = pair
    jcfg, tcfg = _cfgs(mode)
    j_lin, j_err = jg.make_gicp_callbacks(jg.prepare_gicp(src, tgt, jcfg), jcfg)
    t_lin, t_err = tg.make_gicp_callbacks(tg.prepare_gicp(tsrc, ttgt, tcfg), tcfg)
    jc, jH, jb, jaux = jax.jit(j_lin)(jnp.asarray(T))
    tc, tH, tb, taux = t_lin(torch.as_tensor(T))
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-10)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10, atol=1e-8)
    np.testing.assert_array_equal(taux[0].numpy(), np.asarray(jaux[0]))
    np.testing.assert_array_equal(taux[1].numpy(), np.asarray(jaux[1]))
    T2 = T.copy()
    T2[:3, 3] += [0.01, -0.02, 0.005]
    np.testing.assert_allclose(
        float(t_err(torch.as_tensor(T2), taux)), float(jax.jit(j_err)(jnp.asarray(T2), jaux)),
        rtol=1e-10,
    )


@pytest.mark.parametrize("mode", MODES)
def test_gicp_align_matches_jax(pair, mode):
    src, tgt, tsrc, ttgt, T = pair
    jcfg, tcfg = _cfgs(mode)
    jr = jg.gicp_align(src, tgt, init_T=jnp.asarray(T), cfg=jcfg)
    tr = tg.gicp_align(tsrc, ttgt, init_T=torch.as_tensor(T), cfg=tcfg)
    assert int(tr.iterations) == int(jr.iterations)
    assert bool(tr.converged) == bool(jr.converged)
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), atol=1e-10)
    np.testing.assert_allclose(tr.H.numpy(), np.asarray(jr.H), rtol=1e-8, atol=1e-6)
    np.testing.assert_allclose(float(tr.error), float(jr.error), rtol=1e-8)


@pytest.mark.parametrize("mode", ["apdgicp", "gicp"])
def test_gn_optimize_matches_jax(pair, mode):
    """Plain Gauss-Newton, 8 fixed iterations on the GICP callbacks (the
    plain 1-NN on the CPU): T within 1e-9, the last linearization's H and
    cost within 1e-8 relative."""
    from gorio_tpu.registration.lsq import gn_optimize as j_gn
    from gorio_tpu_torch.registration import gn_optimize as t_gn

    src, tgt, tsrc, ttgt, T = pair
    jcfg, tcfg = _cfgs(mode)
    j_lin, _ = jg.make_gicp_callbacks(jg.prepare_gicp(src, tgt, jcfg), jcfg)
    t_lin, _ = tg.make_gicp_callbacks(tg.prepare_gicp(tsrc, ttgt, tcfg), tcfg)
    jr = jax.jit(lambda T0: j_gn(j_lin, T0, iterations=8))(jnp.asarray(T))
    tr = t_gn(t_lin, torch.as_tensor(T), iterations=8)
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.H.numpy(), np.asarray(jr.H), rtol=1e-8, atol=1e-6)
    np.testing.assert_allclose(float(tr.error), float(jr.error), rtol=1e-8)
    assert int(tr.iterations) == 8 and bool(tr.converged)


@pytest.mark.parametrize("mode", ["apdgicp", "gicp"])
def test_component_linearize_matches_reference(pair, mode):
    """`test_registration.py::test_component_linearize_matches_reference`
    on the port: the component form (kernel payload select) equals the
    (N, 3, 3) einsum form over `nn1_best` correspondences."""
    _, _, tsrc, ttgt, T = pair
    cfg = tg.GICPConfig(mode=mode)
    prob = tg.prepare_gicp(tsrc, ttgt, cfg)
    lin_f, err_f = tg.make_gicp_callbacks(prob, cfg)
    lin_r, err_r = tg.make_gicp_callbacks_reference(prob, cfg)
    Tt = torch.as_tensor(T)
    c_f, H_f, b_f, aux_f = lin_f(Tt)
    c_r, H_r, b_r, aux_r = lin_r(Tt)
    np.testing.assert_allclose(float(c_f), float(c_r), rtol=1e-10)
    np.testing.assert_allclose(H_f.numpy(), H_r.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(b_f.numpy(), b_r.numpy(), rtol=1e-8, atol=1e-10)
    assert torch.equal(aux_f[0], aux_r[0])
    np.testing.assert_allclose(aux_f[2].numpy(), aux_r[2].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(err_f(Tt, aux_f)), float(err_r(Tt, aux_r)), rtol=1e-10)


def test_fitness_score_matches_jax(pair):
    src, tgt, tsrc, ttgt, T = pair
    jf, jn = jg.fitness_score(src, tgt, jnp.asarray(T))
    tf, tn = tg.fitness_score(tsrc, ttgt, torch.as_tensor(T))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-10)


def test_lm_without_correspondences_fails_like_jax():
    """A linearization with no correspondence (H = 0, b = 0: every point
    masked or out of range) makes the damped system singular. The JAX
    package's LU gives a non-finite step that every inner iteration rejects,
    so the align stops after one outer iteration at its initial transform,
    not converged; the port does the same instead of raising."""
    import functools

    from gorio_tpu.registration import lsq as jl
    from gorio_tpu_torch.registration import lsq as tl

    T0 = np.eye(4)
    T0[:3, 3] = [0.5, -0.2, 0.1]

    want = jl.lm_optimize(lambda T: (jnp.zeros(()), jnp.zeros((6, 6)), jnp.zeros(6), None),
                          lambda T, aux: jnp.zeros(()), jnp.asarray(T0))
    z = functools.partial(torch.zeros, dtype=torch.float64)
    got = tl.lm_optimize(lambda T: (z(()), z((6, 6)), z(6), None), lambda T, aux: z(()),
                         torch.as_tensor(T0))
    assert not bool(want.converged) and not bool(got.converged)
    assert int(got.iterations) == int(want.iterations) == 1
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(want.T))
    np.testing.assert_array_equal(got.T.numpy(), T0)
