"""The fused frontend on the CLI's own frames: `ScanMatchingOdometry.step_fused`
of both packages, frame by frame, on `simulate`'s default world at full
width (capacity 2048), the JAX package's RANSAC hypotheses handed to the
port.

The reader yields float32 frames. On them the JAX package runs the fused
step in float32 (its state vector takes the frame's dtype), and its LM
stops where noise-level cost differences let it, millimetres from its own
float64 run; so the port's CLI uploads the frames as float64. Held here:
on float64 frames the two packages agree to 1e-9 m / the same masks,
cluster ids and ground counts, frame after frame.

Run as a script to print the per-frame pose gaps of both packages at both
dtypes over a sequence (`JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python
tests/test_torch_fused_frames.py DATASET_DIR [N_FRAMES]`)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.pipeline import odometry as jo
from gorio_tpu.pipeline import preprocessing as jpp
from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.io.native import NativePipelineDataset
from gorio_tpu_torch.pipeline import odometry as to
from gorio_tpu_torch.pipeline import preprocessing as tpp
from test_torch_frontend import _jax_pp_hypotheses


def _odometries():
    """(JAX, port) odometries with the default preprocessing chain."""
    j, t = jo.ScanMatchingOdometry(), to.ScanMatchingOdometry()
    j.preprocess_cfg, t.preprocess_cfg = jpp.PreprocessConfig(), tpp.PreprocessConfig()
    return j, t


def _frames(seq, n):
    """(stamp, count, float32 frame copy, gyro sample) of the first n frames."""
    imu = np.load(Path(seq) / "imu.npz")
    gyr_t, gyr = imu["gyr_t"], imu["gyr"]
    paths = sorted(Path(seq).glob("*.grf"))[:n]
    for stamp, count, packed in NativePipelineDataset(paths, capacity=2048):
        omega = gyr[np.clip(np.searchsorted(gyr_t, stamp) - 1, 0, gyr_t.size - 1)]
        yield float(stamp), count, np.array(packed), omega


def _step(j, t, idx, stamp, count, packed, omega):
    """One frame through both packages; returns (JAX pose, port pose)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), idx)
    hyp = _jax_pp_hypotheses(jo._cloud_from_packed(jnp.asarray(packed), count),
                             j.preprocess_cfg, key)
    jpose, _ = j.step_fused(stamp, packed, count, ground=True, omega=omega)
    tpose, _ = t.step_fused(stamp, torch.as_tensor(packed), count, ground=True, omega=omega,
                            hyp_idx=hyp)
    return jpose, tpose


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused") / "seq"
    torch_cli(["simulate", "--output", str(d), "--duration", "2"])
    return d


def test_fused_steps_on_cli_frames_match_jax_in_float64(seq):
    j, t = _odometries()
    n = 0
    for idx, (stamp, count, packed, omega) in enumerate(_frames(seq, 6)):
        jpose, tpose = _step(j, t, idx, stamp, count, packed.astype(np.float64), omega)
        np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-9, err_msg=f"frame {idx}")
        np.testing.assert_array_equal(t.last_cloud.mask.numpy(), np.asarray(j.last_cloud.mask))
        np.testing.assert_array_equal(t.last_cloud.cluster.numpy(),
                                      np.asarray(j.last_cloud.cluster))
        assert t.last_ground_count == j.last_ground_count
        np.testing.assert_allclose(t.last_plane, j.last_plane, rtol=0, atol=1e-9)
        n += 1
    assert n == 6 and len(t.statuses) == 5 and int(t.last_cloud.cluster.max()) >= 1


def test_float32_frames_move_the_jax_package_not_the_port(seq):
    """On the reader's float32 frames the JAX package's fused LM stops more
    than a millimetre from its own float64 run within six frames, while the
    port's stays within 0.5 mm of it: the float32 gap is the JAX package's
    float32 LM, and the port's records are held against the JAX package on
    float64 frames."""
    j32, t32 = _odometries()
    j64, _ = _odometries()
    gaps = []
    for idx, (stamp, count, packed, omega) in enumerate(_frames(seq, 6)):
        jpose32, tpose32 = _step(j32, t32, idx, stamp, count, packed, omega)
        jpose64, _ = j64.step_fused(stamp, packed.astype(np.float64), count, ground=True,
                                    omega=omega)
        gaps.append((float(np.abs(jpose32 - jpose64)[:3, 3].max()),
                     float(np.abs(tpose32 - jpose64)[:3, 3].max())))
    assert max(g[1] for g in gaps) < 5e-4, gaps
    assert gaps[-1][0] > 1e-3, gaps


def main(seq, n=40):
    """Per frame: the JAX package's float32-vs-float64 pose gap, and the
    port's gap to the JAX package at float32 and at float64 (m)."""
    j32, t32 = _odometries()
    j64, t64 = _odometries()
    print("frame  jax32-jax64  port32-jax32  port64-jax64")
    for idx, (stamp, count, packed, omega) in enumerate(_frames(seq, n)):
        a, c = _step(j32, t32, idx, stamp, count, packed, omega)
        b, d = _step(j64, t64, idx, stamp, count, packed.astype(np.float64), omega)
        gap = lambda x, y: float(np.abs(x - y)[:3, 3].max())  # noqa: E731
        print(f"{idx:5d}  {gap(a, b):11.3g}  {gap(c, a):12.3g}  {gap(d, b):12.3g}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 40)
