"""Port parity: `registration.knn.radius_count` and `estimators/outliers.py`
(statistical and radius outlier removal, `remove_outliers`) against the JAX
package, in float64 on the CPU.

The JAX package expands |q|^2 + |r|^2 - 2 q.r where the port sums squared
differences, so distances differ in the last bits; on point sets with no
pair distance within 1e-9 of the radius and no point's mean neighbour
distance within 1e-9 of the statistical threshold, every count and mask is
exact (asserted before the comparison)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.core.pointcloud import make_cloud as jmake
from gorio_tpu.estimators import outliers as jol
from gorio_tpu.registration.knn import knn as jknn
from gorio_tpu.registration.knn import radius_count as jradius
from gorio_tpu_torch.convert import cloud_from_numpy
from gorio_tpu_torch.estimators import outliers as tol
from gorio_tpu_torch.registration.knn import radius_count

MARGIN = 1e-9


def _patch(seed, n_dense=300, n_far=12, capacity=512):
    """A dense 4 m patch, far stragglers and padding (JAX `PointCloud`)."""
    rng = np.random.default_rng(seed)
    dense = rng.uniform(-2.0, 2.0, size=(n_dense, 3))
    far = rng.uniform(20.0, 60.0, size=(n_far, 3)) * rng.choice([-1.0, 1.0], size=(n_far, 3))
    return jmake(jnp.asarray(np.concatenate([dense, far])), capacity=capacity)


def _pair_dists(cloud):
    xyz, m = np.asarray(cloud.xyz), np.asarray(cloud.mask)
    p = xyz[m]
    return np.linalg.norm(p[:, None] - p[None], axis=-1)


def _stat_margin(cloud, mean_k, stddev_mul):
    """The smallest gap between a valid point's mean neighbour distance and
    the threshold, from the JAX package's kNN."""
    _, d2 = jknn(cloud.xyz, cloud.xyz, k=mean_k + 1, ref_mask=cloud.mask)
    md = np.mean(np.sqrt(np.maximum(np.asarray(d2)[:, 1:], 0.0)), axis=-1)[np.asarray(cloud.mask)]
    return float(np.min(np.abs(md - (md.mean() + stddev_mul * md.std(ddof=1)))))


@pytest.mark.parametrize("radius", [0.3, 0.75, 2.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_radius_count_matches_jax(seed, radius):
    """Exact int32 counts, the query counted among the refs, masked refs
    never; also for queries that are not refs, on both block paths."""
    cloud = _patch(seed)
    assert np.min(np.abs(_pair_dists(cloud) - radius)) > MARGIN
    want = np.asarray(jradius(cloud.xyz, cloud.xyz, radius, ref_mask=cloud.mask))
    tc = cloud_from_numpy(cloud)
    got = radius_count(tc.xyz, tc.xyz, radius, ref_mask=tc.mask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(radius_count(tc.xyz, tc.xyz, radius, ref_mask=tc.mask,
                                               block=100).numpy(), want)
    q = np.random.default_rng(seed + 7).uniform(-3.0, 3.0, size=(50, 3))
    want_q = np.asarray(jradius(jnp.asarray(q), cloud.xyz, radius, ref_mask=cloud.mask))
    np.testing.assert_array_equal(
        radius_count(torch.as_tensor(q), tc.xyz, radius, ref_mask=tc.mask).numpy(), want_q)
    assert (want[np.asarray(cloud.mask)] >= 1).all()  # itself


@pytest.mark.parametrize("mean_k,stddev_mul", [(20, 1.0), (8, 0.5), (30, 2.0)])
def test_statistical_mask_matches_jax(mean_k, stddev_mul):
    cloud = _patch(2)
    assert _stat_margin(cloud, mean_k, stddev_mul) > MARGIN
    want = np.asarray(jol.statistical_outlier_mask(cloud, mean_k, stddev_mul))
    got = tol.statistical_outlier_mask(cloud_from_numpy(cloud), mean_k, stddev_mul).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < np.asarray(cloud.mask).sum()  # some removed, some kept


@pytest.mark.parametrize("radius,min_neighbors", [(0.5, 2), (1.0, 5), (2.0, 2)])
def test_radius_mask_matches_jax(radius, min_neighbors):
    cloud = _patch(3)
    assert np.min(np.abs(_pair_dists(cloud) - radius)) > MARGIN
    want = np.asarray(jol.radius_outlier_mask(cloud, radius, min_neighbors))
    got = tol.radius_outlier_mask(cloud_from_numpy(cloud), radius, min_neighbors).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < np.asarray(cloud.mask).sum()


@pytest.mark.parametrize("method", ["statistical", "radius", "none"])
def test_remove_outliers_matches_jax(method):
    """The factory with its defaults: the same mask and coordinates (the
    removed points parked at the padding coordinate)."""
    cloud = _patch(4)
    if method == "statistical":
        assert _stat_margin(cloud, 20, 1.0) > MARGIN
    if method == "radius":
        assert np.min(np.abs(_pair_dists(cloud) - 2.0)) > MARGIN
    want = jol.remove_outliers(cloud, method)
    got = tol.remove_outliers(cloud_from_numpy(cloud), method)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown outlier removal method"):
        tol.remove_outliers(cloud_from_numpy(_patch(0)), "bogus")
