"""The port's `evaluation.accuracy.run_sequence` against the script's
(`scripts/accuracy_benchmark.py`, the JAX CLI) on a shortened straight: 6 s
with a zero-velocity dwell, 4 moving objects and GPS (its dropout window and
outliers), capacity 512, the straight's `slam` flags, on the CPU. The
script's `SEQUENCES` entry is patched for the length of the run.

Both runs are put on the same inputs, as `tests/test_torch_frontend.py`'s
`test_step_fused_matches_jax` does frame by frame: the JAX CLI's reader
hands it the frames as float64, as the port's CLI uploads them (on its
float32 frames the JAX package's fused LM ends millimetres from its own
float64 run, ROADMAP Queue C); the port's fused step takes the JAX CLI's
RANSAC hypotheses for each frame (`jax.random` cannot be reproduced); and
its ground fit takes LAPACK's eigenvector pick, the JAX package's rule,
in place of its basis-free pick (the two differ by design on degenerate
patches, ROADMAP Queue C).

Held, with the straight's flags: the same keys (the stage names included),
keyframes, loops and GPS gate counts, and ATE / RTE within the slice tests'
end-to-end tolerance (20% + 1 mm). Not within 2e-4 m: the floor fit of
frame 18 flips inside the JAX package itself (ROADMAP Queue C traits): its
preprocessed cloud, equal in both packages to 3.6e-15 m, gives 77 ground
points inside the JAX fused program and 106 in the JAX package's own
`jit(estimate_ground)` and in the port, and the two floor planes move the
trajectory after the dwell by ~2 cm. The same sequence without `--floor`
runs the rest of the stack (GPS, the dwell, the moving objects, UGPM) and
is held to ATE and RTE within 2e-4 m (both are rounded to 1e-4 m by the
harnesses)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gorio_tpu_torch.evaluation import accuracy

from jax_native_build import ensure_built
from tool_inputs import gps_gates

ensure_built()  # the JAX package's native library, built once under a lock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import accuracy_benchmark as j_accuracy  # noqa: E402

SHORT = {
    "simulate": ["--duration", "6", "--rate", "5", "--seed", "21", "--stops", "1",
                 "--dynamic", "4", "--gps", "--capacity", "512"],
    "slam": [*accuracy.SEQUENCES["straight"]["slam"], "--capacity", "512"],
}
CASES = {"straight": SHORT,
         "no-floor": {**SHORT, "slam": [a for a in SHORT["slam"] if a != "--floor"]}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as jslam
    from gorio_tpu.pipeline import odometry as jo
    from gorio_tpu.pipeline import preprocessing as jpp
    from gorio_tpu_torch.estimators import groundseg as tgs
    from gorio_tpu_torch.pipeline import odometry as to
    from test_torch_frontend import _jax_pp_hypotheses, _lapack_pick

    step_fused = to.ScanMatchingOdometry.step_fused
    jcfg = jpp.PreprocessConfig()

    def with_jax_draws(self, stamp, packed, n_points, **kw):
        """The JAX CLI's draw for this frame: key 0 folded with the frame's
        index, on its power- and distance-gated cloud."""
        self._jax_idx = getattr(self, "_jax_idx", -1) + 1
        key = jax.random.fold_in(jax.random.PRNGKey(0), self._jax_idx)
        jcloud = jo._cloud_from_packed(jnp.asarray(packed.cpu().numpy()), n_points)
        kw["hyp_idx"] = _jax_pp_hypotheses(jcloud, jcfg, key)
        return step_fused(self, stamp, packed, n_points, **kw)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    case = CASES[request.param]
    made = []

    class Caught(jslam.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    d = tmp_path_factory.mktemp("straight")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setitem(j_accuracy.SEQUENCES, "straight", case)
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        mp.setattr(jslam, "RadarGraphSLAM", Caught)
        want = j_accuracy.run_sequence("straight", workdir=str(d / "jax"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(to.ScanMatchingOdometry, "step_fused", with_jax_draws)
        mp.setattr(tgs, "_eigh_smallest", _lapack_pick)
        got = accuracy.run_sequence({**case, "name": "straight"}, workdir=str(d / "torch"),
                                    device="cpu", runs=made)
    return request.param, got, want, made


def test_shortened_straight_matches_the_script(runs):
    case, got, want, (jslam, run) = runs
    assert list(got) == list(want)
    assert set(got["stage_median_ms"]) == set(want["stage_median_ms"])
    assert got["n_keyframes"] == want["n_keyframes"]
    assert got["n_loops"] == want["n_loops"] == 0
    fix_t = np.load(run.ds / "gps.npz")["t"]
    gates = gps_gates(run.slam, fix_t)
    assert gates == gps_gates(jslam, fix_t) and gates["gps_utm_coords"] > 0, gates
    assert run.timing["n_frames"] == len(list(run.ds.glob("*.grf")))
    for key in ("ate_rmse_m", "rte_m"):
        tol = 2e-4 if case == "no-floor" else 0.2 * want[key] + 1e-3
        assert abs(got[key] - want[key]) <= tol, (key, got, want)
