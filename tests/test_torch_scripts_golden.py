"""The port's UGPM golden record (`gorio_tpu_torch/evaluation/ugpm_golden.py`,
the port of `scripts/make_ugpm_golden.py`) against the committed fixture
`tests/golden/ugpm_golden.npz`, the JAX package's record. No JAX here.

The port's input streams equal the fixture's stored ones (to 1e-12); the
port's `ugpm_preintegrate`, run on the fixture's own inputs on the CPU in
float64, meets each of `tests/test_ugpm_golden.py`'s four checks with that
file's tolerances: delta_p rtol 1e-6 / atol 1e-8, each rotation within
1e-7 rad and dt rtol 1e-12; cov rtol 1e-5 / atol 1e-12; the Jacobians
rtol 1e-5 / atol 1e-9; and the truth bound (position within 4 sigma +
1 mm, rotation within 6 sigma + 1e-4 rad)."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu_torch.evaluation import ugpm_golden

GOLDEN = np.load(ugpm_golden.GOLDEN)


def angle(Ra, Rb):
    return Rotation.from_matrix(Ra.T @ Rb).magnitude()


@pytest.fixture(scope="module")
def out():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # ~2x faster at this size, the same values to rounding
    try:
        return ugpm_golden.run(GOLDEN, torch.device("cpu"))
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("key", ["gyr_t", "gyr", "vel_t", "vel", "queries", "gyr_var",
                                 "vel_var", "delta_R_true", "delta_p_true"])
def test_generated_inputs_equal_the_fixture(key):
    got = ugpm_golden.inputs()[key]
    assert np.shape(got) == GOLDEN[key].shape
    np.testing.assert_allclose(got, GOLDEN[key], rtol=1e-12, atol=1e-12)


def test_golden_moments(out):
    np.testing.assert_allclose(out["delta_p"], GOLDEN["delta_p"], rtol=1e-6, atol=1e-8)
    for i in range(GOLDEN["queries"].shape[0]):
        assert angle(out["delta_R"][i], GOLDEN["delta_R"][i]) < 1e-7, i
    np.testing.assert_allclose(out["dt"], GOLDEN["dt"], rtol=1e-12)


def test_golden_covariance(out):
    np.testing.assert_allclose(out["cov"], GOLDEN["cov"], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("name", ugpm_golden.JACOBIANS)
def test_golden_jacobians(out, name):
    np.testing.assert_allclose(out[name], GOLDEN[name], rtol=1e-5, atol=1e-9, err_msg=name)


def test_golden_accuracy_vs_truth(out):
    for i in range(GOLDEN["queries"].shape[0]):
        p_err = np.abs(out["delta_p"][i] - GOLDEN["delta_p_true"][i])
        sigma = np.sqrt(np.diag(GOLDEN["cov"][i])[3:])
        assert np.all(p_err < 4.0 * sigma + 1e-3), (i, p_err, sigma)
        sig_r = float(np.sqrt(np.trace(GOLDEN["cov"][i][:3, :3])))
        assert angle(out["delta_R"][i], GOLDEN["delta_R_true"][i]) < 6.0 * sig_r + 1e-4, i


def test_check_agrees_with_the_tests(out, tmp_path):
    """The module's `check` (chip_smoke.py's gate on the card) passes this
    run, and fails a record whose delta_p moved by 1e-6 relative."""
    gaps = ugpm_golden.check(out, GOLDEN)
    assert max(gaps.values()) <= 1.0, gaps
    bad = dict(out, delta_p=out["delta_p"] * (1.0 + 2e-6))
    assert ugpm_golden.check(bad, GOLDEN)["delta_p"] > 1.0


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ugpm_golden.main("cuda")
