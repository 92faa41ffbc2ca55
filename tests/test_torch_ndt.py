"""Port parity: `gorio_tpu_torch.registration.ndt` and the voxel helpers of
`core/pointcloud.py` against the JAX package, in float64 on the CPU, on the
two radar scans of `tests/test_ndt.py` rendered at capacity 512 (NDT at
resolution 2.0 with 3 points per voxel, so that the scans fill voxels).

Tolerances: the voxel sets, keys, validity, tables and the key columns of
the packed payload are exact; means and inverse covariances differ only
in summation order (rtol 1e-10). Scores agree to rtol 1e-12; an align
makes the same accept / reject decisions, so it takes the same number of
iterations and ends within 1e-8 in T."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.core import pointcloud as jpc
from gorio_tpu.io.synthetic import make_world, render_radar_scan
from gorio_tpu.registration import ndt as jn
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict, voxel_map_from_numpy
from gorio_tpu_torch.core import pointcloud as tpc
from gorio_tpu_torch.registration import ndt as tn

NEIGHBORHOODS = ["direct1", "direct7", "direct27", "kdtree"]
JCFG = jn.NDTConfig(resolution=2.0, min_points_per_voxel=3)
INT_FIELDS = ("keys", "valid", "table", "table_dims")


def tcfg(cfg):
    return config_from_dict(tn.NDTConfig, cfg._asdict())


@pytest.fixture(scope="module")
def scans():
    world = make_world(seed=21, n_landmarks=6000)
    R1 = Rotation.from_euler("ZYX", [0.04, 0.0, 0.0]).as_matrix()
    target = render_radar_scan(world, np.eye(3), np.zeros(3), np.zeros(3), capacity=512, seed=1)
    source = render_radar_scan(world, R1, np.array([0.5, 0.2, 0.0]), np.zeros(3), capacity=512,
                               seed=2)
    T0 = np.eye(4)
    T0[:3, :3] = R1
    T0[:3, 3] = [0.65, 0.1, 0.05]  # 0.19 m off the truth
    return source, target, cloud_from_numpy(source), cloud_from_numpy(target), T0


def assert_map_equal(jmap, tmap):
    for f in jmap._fields:
        want, got = np.asarray(getattr(jmap, f)), getattr(tmap, f).numpy()
        assert got.shape == want.shape, f
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f)
        elif f == "packed":
            np.testing.assert_array_equal(got[:, 9:], want[:, 9:])
            np.testing.assert_allclose(got[:, :9], want[:, :9], rtol=1e-10, atol=1e-12)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("table_size", [1 << 21, 64])
def test_build_voxel_map_matches_jax(scans, table_size):
    """The default table, and a 64-cell one where voxels collide: the
    larger voxel index keeps the cell, as XLA's last write does."""
    _, target, _, tt, _ = scans
    cfg = JCFG._replace(table_size=table_size)
    jmap = jn.build_voxel_map(target, cfg)
    tmap = tn.build_voxel_map(tt, tcfg(cfg))
    assert_map_equal(jmap, tmap)
    n_valid = int(np.asarray(jmap.valid).sum())
    assert n_valid > 20
    filled = int((np.asarray(jmap.table)[:-1] >= 0).sum())
    if table_size == 64:
        assert filled < n_valid  # collisions happened
    else:
        assert filled == n_valid


def test_voxel_map_converts_from_jax(scans):
    _, target, _, _, _ = scans
    jmap = jn.build_voxel_map(target, JCFG)
    tmap = voxel_map_from_numpy(jmap)
    assert isinstance(tmap, tn.VoxelGaussianMap) and tmap.table.dtype == torch.int32
    assert_map_equal(jmap, tmap)


@pytest.mark.parametrize("neighborhood", NEIGHBORHOODS)
def test_ndt_score_matches_jax(scans, neighborhood):
    source, target, ts, tt, T0 = scans
    cfg = JCFG._replace(neighborhood=neighborhood)
    jmap = jn.build_voxel_map(target, cfg)
    want = float(jn.ndt_score(source, jmap, jnp.asarray(T0), cfg))
    got = float(tn.ndt_score(ts, tn.build_voxel_map(tt, tcfg(cfg)), torch.tensor(T0), tcfg(cfg)))
    assert want < -10.0
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("neighborhood", NEIGHBORHOODS)
def test_gather_correspondences_matches_jax(scans, neighborhood):
    source, target, ts, tt, T0 = scans
    cfg = JCFG._replace(neighborhood=neighborhood)
    jf, jmu, jc6 = jn._gather_correspondences(source, jn.build_voxel_map(target, cfg),
                                              jnp.asarray(T0), cfg)
    tf, tmu, tc6 = tn._gather_correspondences(ts, tn.build_voxel_map(tt, tcfg(cfg)),
                                              torch.tensor(T0), tcfg(cfg))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.shape == (512, len(tn._NEIGHBOR_OFFSETS[neighborhood])) and tf.any()
    ok = np.asarray(jf)
    np.testing.assert_allclose(tmu.numpy()[ok], np.asarray(jmu)[ok], rtol=1e-10)
    for a, b in zip(tc6, jc6):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-10, atol=1e-12)


def test_lookups_and_unpack_match_jax(scans):
    """The binary-search lookup, the dense-table lookup and the packed-row
    unpacking give the JAX package's results."""
    _, target, _, tt, _ = scans
    jmap = jn.build_voxel_map(target, JCFG)
    tmap = tn.build_voxel_map(tt, tcfg(JCFG))
    keys = np.asarray(jmap.keys)
    queries = np.concatenate([keys[:40], keys[:40] + 1, [0, 2**30 - 1]]).astype(np.int32)
    for a, b in zip(tn._lookup(tmap.keys, torch.tensor(queries)),
                    jn._lookup(jmap.keys, jnp.asarray(queries))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ijk = np.stack([keys[:40] >> 20, (keys[:40] >> 10) & 1023, keys[:40] & 1023], -1)
    ijk = np.concatenate([ijk, ijk + 1]).astype(np.int32)
    got = tn._table_lookup(tmap.keys, tmap.table, tmap.table_dims, JCFG.table_size,
                           torch.tensor(ijk))
    want = jn._table_lookup(jmap.keys, jmap.table, jmap.table_dims, JCFG.table_size,
                            jnp.asarray(ijk))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got[1][:40].all())
    for a, b in zip(tn._unpack(tmap.packed), jn._unpack(jmap.packed)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("neighborhood", ["direct7", "direct1"])
def test_ndt_align_with_map_matches_jax(scans, neighborhood):
    source, target, ts, tt, T0 = scans
    cfg = JCFG._replace(neighborhood=neighborhood)
    want = jn.ndt_align_with_map(source, jn.build_voxel_map(target, cfg), jnp.asarray(T0), cfg)
    got = tn.ndt_align_with_map(ts, tn.build_voxel_map(tt, tcfg(cfg)), torch.tensor(T0),
                                tcfg(cfg))
    assert int(got.iterations) == int(want.iterations) >= 2
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-8)
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-10)
    assert bool(got.converged) and float(got.error) < 0.0
    np.testing.assert_allclose(got.H.numpy(), np.asarray(want.H), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(want.H)).max())


def test_ndt_align_multires_matches_jax(scans):
    """Coarse-to-fine, with both maps built by the JAX package and carried
    over by `convert.voxel_map_from_numpy`."""
    source, target, ts, _, T0 = scans
    vc = jn.build_voxel_map(target, jn.coarse_cfg(JCFG))
    vf = jn.build_voxel_map(target, JCFG)
    want = jn.ndt_align_multires(source, vc, vf, jnp.asarray(T0), JCFG)
    got = tn.ndt_align_multires(ts, voxel_map_from_numpy(vc), voxel_map_from_numpy(vf),
                                torch.tensor(T0), tcfg(JCFG))
    assert tn.coarse_cfg(tcfg(JCFG)) == tcfg(jn.coarse_cfg(JCFG))
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-8)


def test_ndt_d2d_align_matches_jax(scans):
    source, target, ts, tt, T0 = scans
    want = jn.ndt_d2d_align(source, target, jnp.asarray(T0), JCFG)
    got = tn.ndt_d2d_align(ts, tt, torch.tensor(T0), tcfg(JCFG))
    assert int(got.iterations) == int(want.iterations) >= 2
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-8)
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-10)


def test_float32_cloud_with_float64_guess(scans):
    """What the unfused CLI hands NDT: a float32 scan and a float64 guess.
    The port computes in float64 and ends within 1e-4 of the JAX package's
    run on the same clouds cast to float64. The JAX package under x64
    raises here: its inner scan's carry starts in the cloud's dtype and
    the applied-step norm takes the guess's (`ndt.py:494-495`)."""
    source, target, _, _, T0 = scans
    src32 = source._replace(xyz=jnp.asarray(source.xyz, jnp.float32))
    tgt32 = target._replace(xyz=jnp.asarray(target.xyz, jnp.float32))
    want = jn.ndt_align(source._replace(xyz=jnp.asarray(src32.xyz, jnp.float64)),
                        target._replace(xyz=jnp.asarray(tgt32.xyz, jnp.float64)),
                        jnp.asarray(T0), JCFG)
    got = tn.ndt_align(cloud_from_numpy(src32), cloud_from_numpy(tgt32), torch.tensor(T0),
                       tcfg(JCFG))
    assert got.T.dtype == torch.float64
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    with pytest.raises(TypeError):
        jn.ndt_align(src32, tgt32, jnp.asarray(T0), JCFG)


def test_voxel_downsample_matches_jax(scans):
    """`voxel_downsample` (and the helpers under it) and `compact_cloud`."""
    source, _, ts, _, _ = scans
    for res, cap in ((0.25, None), (1.0, 200)):
        want = jpc.voxel_downsample(source, res, capacity=cap)
        got = tpc.voxel_downsample(ts, res, capacity=cap)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert 0 < int(got.mask.sum()) < int(ts.mask.sum())
        for f in ("xyz", "intensity", "doppler", "cluster"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-12, atol=1e-12, err_msg=f)
    origin = np.asarray(jpc.masked_min_corner(source.xyz, source.mask))
    np.testing.assert_array_equal(tpc.masked_min_corner(ts.xyz, ts.mask).numpy(), origin)
    np.testing.assert_array_equal(
        tpc.voxel_key(ts.xyz, 0.5, torch.tensor(origin)).numpy(),
        np.asarray(jpc.voxel_key(source.xyz, 0.5, jnp.asarray(origin))))
    holes = source._replace(mask=source.mask & (jnp.arange(512) % 3 != 0))
    want = jpc.compact_cloud(holes)
    got = tpc.compact_cloud(cloud_from_numpy(holes))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("shape", [(), (3,), (3, 3)])
def test_segment_sum_matches_a_row_by_row_sum(shape):
    """`segment_runs` + `segment_sum` against a plain row-by-row sum over the
    runs of equal keys: sorted order, padding rows (the sentinel key) in no
    segment, ids past the last run empty. Exact in float64 on integers."""
    rng = np.random.default_rng(5)
    n = 64
    key = rng.integers(0, 9, size=n).astype(np.int32)
    key[rng.random(n) < 0.25] = tpc.VOXEL_SENTINEL
    x = rng.integers(-50, 50, size=(n, *shape)).astype(np.float64)
    order, key_s, seg, bounds = tpc.segment_runs(torch.tensor(key))
    np.testing.assert_array_equal(key_s.numpy(), np.sort(key, kind="stable"))
    got = tpc.segment_sum(torch.tensor(x)[order], bounds).numpy()
    want = np.zeros((n, *shape))
    for i, k in enumerate(np.unique(key[key != tpc.VOXEL_SENTINEL])):
        want[i] = x[key == k].sum(axis=0)
    np.testing.assert_array_equal(got, want)
    assert int(seg[-1]) == len(np.unique(key)) - 1


@pytest.mark.cuda
def test_voxel_builds_repeat_to_the_bit_on_the_card(scans):
    """The segment sums are reductions in a fixed order, not atomics: two
    builds of one cloud's maps on the card are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gorio_tpu_torch.registration import vgicp as tv

    _, target, _, _, _ = scans
    cloud = cloud_from_numpy(target, device="cuda")
    for build in (lambda: tn.build_voxel_map(cloud, tcfg(JCFG)),
                  lambda: tv.build_gaussian_voxel_map(cloud, tv.VGICPConfig()),
                  lambda: tpc.voxel_downsample(cloud, 0.25)):
        first, again = build(), build()
        for f, a, b in zip(first._fields, first, again):
            assert a.device.type == "cuda" and torch.equal(a, b), f
