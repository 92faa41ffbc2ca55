"""The slice with the paper's configuration: `python -m gorio_tpu_torch.cli
slam --fused --preprocess --floor --preint ugpm` (the fused preprocessing
frontend, UGPM and the floor plane) against `python -m gorio_tpu.cli` on
the CPU, on `tests/test_torch_slice.py`'s 4 s sequence. Kept apart from that
file so that the two files' CLI runs go to different workers.

End-to-end tolerance: as `tests/test_torch_slice.py`'s. Keyframe poses
must agree within 5 mm / 5 mrad, and the ATEs within 20% + 1 mm."""

import json

import numpy as np
import pytest
import torch

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io.tum import load_tum
from gorio_tpu_torch.cli import main as torch_cli

from jax_native_build import ensure_built
from test_torch_slice import SIM

ensure_built()  # the JAX package's native library, built once under a lock

FULL = ["--fused", "--preprocess", "--floor", "--preint", "ugpm"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's runs on one torch thread: at these sizes ~7x faster on
    the CPU than on the default threads, with the same poses to ~1e-11."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_runs(tmp_path_factory):
    """Both CLIs with the paper's four flags on the 4 s sequence. The JAX
    CLI's reader hands it the frames as float64, as the port's CLI uploads
    them: on its float32 frames the JAX package's fused LM ends millimetres
    from its own float64 run. Its back end is caught on construction for
    the floor plane."""
    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as jslam

    d = tmp_path_factory.mktemp("slice_full")
    torch_cli(["simulate", "--output", str(d / "seq"), *SIM])
    made = []

    class Caught(jslam.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jslam, "RadarGraphSLAM", Caught)
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        jax_cli(["slam", "--dataset", str(d / "seq"), "--output", str(d / "jax_full.tum"),
                 "--capacity", "512", *FULL, "--timing-out", str(d / "jax_full.json")])
    slam, odo, _ = torch_cli(["slam", "--dataset", str(d / "seq"), "--output",
                              str(d / "torch_full.tum"), "--capacity", "512", *FULL,
                              "--device", "cpu", "--timing-out", str(d / "torch_full.json")])
    return d, made[0], slam, odo


def test_full_configuration_matches_jax(full_runs):
    """`--fused --preprocess --floor --preint ugpm`, both CLIs on float64
    frames: the same keyframes and loops (none on this drive), the
    trajectory within 5 mm / 5 mrad, the floor plane within 1e-2 rad /
    0.05 m, the ATE within 20% + 1 mm; the fused stages timed under the JAX
    package's names, the floor plane solved jointly with the poses."""
    d, jslam, tslam, odo = full_runs
    jt = json.loads((d / "jax_full.json").read_text())
    tt = json.loads((d / "torch_full.json").read_text())
    assert tt["keyframe_stamps"] == jt["keyframe_stamps"]
    assert tt["loops"] == jt["loops"] == []
    assert set(tt["stage_median_ms"]) == set(jt["stage_median_ms"]) == {
        "frontend_fused", "backend", "final_optimize"}
    assert tt["solver_counts"]["dense_planes"] >= 1 and tt["solver_counts"]["dense"] == 0
    assert odo.preprocess_cfg is not None and odo.last_ground_count > 0
    assert str(odo.last_cloud.xyz.dtype) == "torch.float64"  # the frames go up as float64
    assert sum(kf.floor_coeffs is not None for kf in tslam.keyframes) == \
        sum(kf.floor_coeffs is not None for kf in jslam.keyframes) > 0
    n_t, n_j = tslam.floor_plane[:3], np.asarray(jslam.floor_plane)[:3]
    assert np.arccos(np.clip(n_t @ n_j, -1.0, 1.0)) < 1e-2
    assert abs(tslam.floor_plane[3] - float(jslam.floor_plane[3])) < 0.05
    np.testing.assert_allclose(tt["floor_plane"], tslam.floor_plane.tolist())
    _, jp = load_tum(d / "jax_full.tum")
    _, tp = load_tum(d / "torch_full.tum")
    dpos = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", jp[:, :3, :3], tp[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert dpos.max() < 5e-3 and dang.max() < 5e-3, (dpos.max(), dang.max())
    gt = str(d / "seq" / "groundtruth.tum")
    ej = torch_cli(["evaluate", str(d / "jax_full.tum"), gt])["ate_rmse_m"]
    et = torch_cli(["evaluate", str(d / "torch_full.tum"), gt])["ate_rmse_m"]
    assert abs(et - ej) <= 0.2 * ej + 1e-3, (et, ej)
