"""Port parity: `gorio_tpu_torch.core` (lie, linalg, gp, pointcloud) against
`gorio_tpu.core` on the `tests/test_lie.py` cases, in float64.

Tolerance: the ops are the same closed forms evaluated in the same order, so
agreement is to a few ulps (atol 1e-12); the arccos-based log near pi is
ill-conditioned (d theta / d cos ~ 1/sin theta), hence 1e-7 there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from gorio_tpu.core import gp as jgp
from gorio_tpu.core import lie as jlie
from gorio_tpu.core import linalg as jlinalg
from gorio_tpu.core import pointcloud as jpc
from gorio_tpu_torch.core import gp as tgp
from gorio_tpu_torch.core import lie as tlie
from gorio_tpu_torch.core import linalg as tlinalg
from gorio_tpu_torch.core import pointcloud as tpc


@pytest.fixture(scope="module")
def rotvecs():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(64, 3))
    r[0] = 0.0
    r[1] = [1e-12, 0, 0]
    r[2] = np.array([1.0, 0.0, 0.0]) * (np.pi - 1e-7)
    r[3] = np.array([0.3, -0.4, 0.5]) / np.linalg.norm([0.3, -0.4, 0.5]) * (np.pi - 1e-4)
    return r


def _both(fn_name, *args, module=("lie",)):
    jm, tm = {"lie": (jlie, tlie), "linalg": (jlinalg, tlinalg)}[module[0]]
    j = getattr(jm, fn_name)(*[jnp.asarray(a) for a in args])
    t = getattr(tm, fn_name)(*[torch.as_tensor(a) for a in args])
    return j, t


@pytest.mark.parametrize(
    "fn", ["hat", "so3_exp", "so3_right_jacobian", "so3_right_jacobian_inv", "se3_exp_split"]
)
def test_rotvec_functions_match_jax(rotvecs, fn):
    arg = rotvecs if fn != "se3_exp_split" else np.concatenate([rotvecs, rotvecs[::-1]], 1)
    j, t = _both(fn, arg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12)


def test_so3_log_matches_jax_and_scipy(rotvecs):
    R = Rsc.from_rotvec(rotvecs).as_matrix()
    j, t = _both("so3_log", R)
    np.testing.assert_allclose(t.numpy()[4:], np.asarray(j)[4:], atol=1e-12)
    np.testing.assert_allclose(t.numpy()[:4], np.asarray(j)[:4], atol=1e-7)
    sel = np.linalg.norm(rotvecs, axis=-1) < 3.0
    np.testing.assert_allclose(t.numpy()[sel], Rsc.from_matrix(R[sel]).as_rotvec(), atol=1e-9)


def test_so3_log_float32_clip_keeps_jacobian_finite():
    """The dtype-aware clip: d log / dR at the identity is finite in float32
    (with a float64-sized margin the clip is a no-op there)."""
    from torch.func import jacfwd

    J = jacfwd(tlie.so3_log)(torch.eye(3, dtype=torch.float32))
    assert torch.isfinite(J).all()
    assert tlie._log_margins(torch.float32) == (1e-6, 3e-3)
    assert tlie._log_margins(torch.float64) == (1e-14, 1e-4)


def test_quaternions_match_jax(rotvecs):
    R = Rsc.from_rotvec(rotvecs).as_matrix()
    jq, tq = _both("mat_to_quat", R)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-12)
    jR, tR = _both("quat_to_mat", np.asarray(jq))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-12)
    q0, q1 = np.asarray(jq[5]), np.asarray(jq[6])
    js = jlie.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), 0.3)
    ts = tlie.quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1), 0.3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-12)


def test_se3_functions_match_jax():
    rng = np.random.default_rng(2)
    xi = rng.normal(size=(16, 6))
    jT, tT = _both("se3_exp", xi)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-12)
    for fn in ("se3_log", "se3_inverse"):
        j, t = _both(fn, np.asarray(jT))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-10)
    p = rng.normal(size=(16, 7, 3))
    j = jlie.se3_apply(jT, jnp.asarray(p))
    t = tlie.se3_apply(tT, torch.as_tensor(p))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-12)


def test_euler_and_geodesic_match_jax():
    angles = [torch.tensor(a, dtype=torch.float64) for a in (0.1, -0.2, 0.7)]
    R = tlie.rpy_to_mat(*angles)
    R_ref = Rsc.from_euler("ZYX", [0.7, -0.2, 0.1]).as_matrix()
    np.testing.assert_allclose(R.numpy(), R_ref, atol=1e-12)
    ypr = [float(v) for v in tlie.mat_to_ypr(R)]
    np.testing.assert_allclose(ypr, [float(v) for v in jlie.mat_to_ypr(jnp.asarray(R_ref))],
                               atol=1e-12)
    Rb = Rsc.from_rotvec([0.1, 0.2, -0.3]).as_matrix()
    j = jlie.rotation_geodesic_angle(jnp.asarray(R_ref), jnp.asarray(Rb))
    t = tlie.rotation_geodesic_angle(R, torch.as_tensor(Rb))
    assert abs(float(j) - float(t)) < 1e-12


def test_linalg_matches_jax():
    """`test_lie.py::test_sym_eigh3_vs_numpy` cases: plane-like,
    isotropic and rank-1 spectra included."""
    rng = np.random.default_rng(11)
    B = rng.normal(size=(200, 3, 3))
    A = B @ np.swapaxes(B, -1, -2)
    A[0] = np.diag([1.0, 1.0, 1e-3])
    A[1] = np.eye(3) * 2.0
    A[2] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    jl, jV = jlinalg.sym_eigh3(jnp.asarray(A))
    tl, tV = tlinalg.sym_eigh3(torch.as_tensor(A))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-12)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), atol=1e-9)
    Areg = A + 1e-3 * np.eye(3)
    j, t = _both("inv3", Areg, module=("linalg",))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-12)


def test_linear_interp_matches_jax():
    rng = np.random.default_rng(4)
    data_t = np.sort(rng.uniform(0.0, 2.0, 40))
    data = rng.normal(size=(40, 3))
    q = rng.uniform(-0.5, 2.5, size=(5, 17))  # extrapolates at both ends
    for extrapolate in (True, False):
        j = jgp.linear_interp(jnp.asarray(q), jnp.asarray(data_t), jnp.asarray(data), extrapolate)
        t = tgp.linear_interp(torch.as_tensor(q), torch.as_tensor(data_t), torch.as_tensor(data),
                              extrapolate)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-12)


def test_make_and_filter_cloud_match_jax():
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(37, 3)) * 10
    inten = rng.uniform(size=37)
    mask = rng.uniform(size=37) > 0.2
    for capacity in (64, 20):
        jc = jpc.make_cloud(jnp.asarray(xyz), intensity=jnp.asarray(inten),
                            mask=jnp.asarray(mask), capacity=capacity)
        tc = tpc.make_cloud(xyz, intensity=inten, mask=mask, capacity=capacity)
        keep = np.arange(capacity) % 3 != 0
        jf = jpc.filter_cloud(jc, jnp.asarray(keep))
        tf = tpc.filter_cloud(tc, torch.as_tensor(keep))
        for a, b in zip(list(jc) + list(jf), list(tc) + list(tf)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_random_cloud_is_the_jax_distribution_and_repeats_under_one_seed():
    """`random_cloud` draws the JAX package's scan (n // 3 ground points at
    z = -1.8 with 3 cm noise, the rest in 12 clusters or uniform, intensity
    in [10, 30), padding parked) from a torch.Generator: one seed gives one
    cloud, and its moments are JAX's draw's within sampling error."""
    import jax

    n, cap = 3000, 4096

    def draw(seed, **kw):
        return tpc.random_cloud(torch.Generator().manual_seed(seed), n, capacity=cap, **kw)

    c = draw(0)
    for a, b in zip(c, draw(0)):
        assert torch.equal(a, b)
    assert not torch.equal(c.xyz, draw(1).xyz)
    j = jax.jit(jpc.random_cloud, static_argnums=1, static_argnames=("capacity", "dtype"))(
        jax.random.PRNGKey(0), n, capacity=cap, dtype=jnp.float64)
    assert c.xyz.dtype == torch.float32 and draw(0, dtype=torch.float64).xyz.dtype == torch.float64
    assert int(c.mask.sum()) == int(np.asarray(j.mask).sum()) == n
    assert torch.all(c.xyz[n:] == tpc.PAD_COORD) and torch.all(c.intensity[n:] == 0)
    ground, jground = c.xyz[: n // 3].double().numpy(), np.asarray(j.xyz[: n // 3])
    for g in (ground, jground):
        assert abs(g[:, 2].mean() + 1.8) < 0.01 and 0.025 < g[:, 2].std() < 0.035
        assert np.abs(g[:, :2]).max() <= 30.0
    inten = c.intensity[:n]
    assert float(inten.min()) >= 10.0 and float(inten.max()) < 30.0
    # the clusters: walls 2 x 0.12 x 1.2 m around 12 centres, so sorted by
    # y the rest falls into at most 12 runs without a 6-sigma (0.72 m) gap
    for rest in (c.xyz[n // 3: n].double().numpy(), np.asarray(j.xyz[n // 3: n])):
        ys = np.sort(rest[:, 1])
        gaps = np.diff(ys) > 6 * 0.12
        assert int(gaps.sum()) + 1 <= 12
    flat = draw(0, structured=False).xyz[n // 3: n]
    assert float(flat.abs().max()) <= 30.0 and float(flat[:, 2].std()) > 10.0
