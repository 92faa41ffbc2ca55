"""The slice's loop circuit: `python -m gorio_tpu_torch.cli simulate / slam`
against `python -m gorio_tpu.cli` on the CPU, on a 20 s circuit at 2.5 Hz,
1.6 laps (capacity 512, 3000 landmarks), with loop closure on, optimized
every 10 keyframes over a 30-keyframe window and the dense solver capped at
96 stacked dimensions, so that it revisits its start, accepts a loop and
runs the block-sparse solver on both of its paths (block-Thomas at 32
padded poses, SPIKE at 64). Kept apart from `tests/test_torch_slice.py` so
that the two files' CLI runs go to different workers.

End-to-end tolerance: as `tests/test_torch_slice.py`'s. Keyframe poses
must agree within 5 mm / 5 mrad, and the ATEs within 20% + 1 mm."""

import functools
import json

import numpy as np
import pytest

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io.tum import load_tum
from gorio_tpu_torch.cli import main as torch_cli

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock

CIRCUIT = ["--circuit", "--duration", "20", "--rate", "2.5", "--laps", "1.6", "--seed", "5",
           "--capacity", "512", "--landmarks", "3000"]
# the loop gates of tests/test_loop_e2e.py: a 20 m accumulated distance
# instead of 50 m lets a 32 m lap close
LOOP = dict(accum_distance_thresh=20.0, min_loop_interval_dist=10.0,
            odom_check_trans_thresh=1.0, odom_check_rot_thresh=0.3)
LOOP_SLAM = ["--capacity", "512", "--optimize-every", "10", "--optimize-window", "30"]


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """Both CLIs with loop closure on the circuit, their `SLAMConfig` given
    the loop gates above and `solve_dense_max_dim=96`."""
    import gorio_tpu.pipeline.slam as jslam
    import gorio_tpu_torch.pipeline.slam as tslam
    from gorio_tpu.loopclosure.loop_detector import LoopConfig as JLoop
    from gorio_tpu_torch.loopclosure.loop_detector import LoopConfig as TLoop

    d = tmp_path_factory.mktemp("loops")
    seq = str(d / "seq")
    torch_cli(["simulate", "--output", seq, *CIRCUIT])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jslam, "SLAMConfig", functools.partial(
            jslam.SLAMConfig, loop=JLoop(**LOOP), solve_dense_max_dim=96))
        mp.setattr(tslam, "SLAMConfig", functools.partial(
            tslam.SLAMConfig, loop=TLoop(**LOOP), solve_dense_max_dim=96))
        jax_cli(["slam", "--dataset", seq, "--output", str(d / "jax.tum"), *LOOP_SLAM,
                 "--timing-out", str(d / "jax.json")])
        slam, _, _ = torch_cli(["slam", "--dataset", seq, "--output", str(d / "torch.tum"),
                                *LOOP_SLAM, "--device", "cpu", "--timing-out",
                                str(d / "torch.json")])
    return d, slam


def test_loops_match_jax(loop_runs):
    """The same keyframes, the same accepted loops and gate counts, the
    same trajectory within 5 mm / 5 mrad, the ATE within 20% + 1 mm; the
    sparse solver ran and verification launched `nn1_select` per outer LM
    iteration of each batch."""
    d, slam = loop_runs
    jt = json.loads((d / "jax.json").read_text())
    tt = json.loads((d / "torch.json").read_text())
    assert jt["n_loops"] >= 1, "the JAX CLI accepts no loop on this sequence"
    assert tt["keyframe_stamps"] == jt["keyframe_stamps"]
    assert [l[:2] for l in tt["loops"]] == [l[:2] for l in jt["loops"]]
    np.testing.assert_allclose([l[2] for l in tt["loops"]], [l[2] for l in jt["loops"]],
                               atol=1e-4)
    assert tt["loop_gate_counts"] == jt["loop_gate_counts"]
    assert tt["solver_counts"]["sparse"] >= 2 and tt["solver_counts"]["dense"] >= 1
    assert tt["verify_lm_iterations"] == slam.loop_detector.verify_iterations > 0
    _, jp = load_tum(d / "jax.tum")
    _, tp = load_tum(d / "torch.tum")
    dpos = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", jp[:, :3, :3], tp[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert dpos.max() < 5e-3 and dang.max() < 5e-3, (dpos.max(), dang.max())
    gt = str(d / "seq" / "groundtruth.tum")
    ej = torch_cli(["evaluate", str(d / "jax.tum"), gt])["ate_rmse_m"]
    et = torch_cli(["evaluate", str(d / "torch.tum"), gt])["ate_rmse_m"]
    assert abs(et - ej) <= 0.2 * ej + 1e-3, (et, ej)
