"""Loop replay across the packages: the port's `evaluation.loop_replay`
and `scripts/loop_replay.py` (the JAX package) each record one real `slam`
of `tests/test_torch_slice_loops.py`'s small loop circuit (its loop gates,
on the CPU); each pickle then replays in both packages.

Held: the port's pickle holds only numpy arrays, lists and numbers under
the script's keys; each package's replay gives its own run's loops and gate
counts back; and on either recording both packages' replays accept the
same loops (key_new, key_old, fitness to 1e-6) with the same gate counts,
at the run's gates and with a `DEFAULT_COMBOS` override on top. `analyze`
of the recorded keyframes and loops equals the script's."""

import ast
import functools
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gorio_tpu_torch.evaluation import loop_replay, loop_sweep, recall

from jax_native_build import ensure_built
from test_torch_slice_loops import CIRCUIT, LOOP, LOOP_SLAM

ensure_built()  # the JAX package's native library, built once under a lock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import recall_benchmark as j_recall  # noqa: E402
from scripts import loop_replay as j_replay  # noqa: E402

# the run's gates, and one of the sweep's combos on top of them
CONFIGS = {"run": LOOP, "combo": {**LOOP, **loop_sweep.DEFAULT_COMBOS[4]}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """The port's recording of the loop circuit, loaded back from its pickle."""
    import gorio_tpu_torch.pipeline.slam as tslam
    from gorio_tpu_torch.loopclosure.loop_detector import LoopConfig

    d = tmp_path_factory.mktemp("replay")
    spec = {"name": "loops", "simulate": CIRCUIT, "slam": LOOP_SLAM}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tslam, "SLAMConfig", functools.partial(
            tslam.SLAMConfig, loop=LoopConfig(**LOOP), solve_dense_max_dim=96))
        loop_replay.record(spec, d / "rec.pkl", workdir=d, device="cpu")
    with open(d / "rec.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def jrec(tmp_path_factory):
    """The script's recording of the same circuit (the JAX CLI), loaded back."""
    import gorio_tpu.pipeline.slam as jslam
    import scripts.recall_benchmark as jrb
    from gorio_tpu.loopclosure.loop_detector import LoopConfig

    d = tmp_path_factory.mktemp("replay_jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setitem(jrb.SEQUENCES, "loops", {"simulate": CIRCUIT})
        mp.setattr(jrb, "SLAM_ARGS", LOOP_SLAM)
        mp.setattr(jslam, "SLAMConfig", functools.partial(
            jslam.SLAMConfig, loop=LoopConfig(**LOOP), solve_dense_max_dim=96))
        j_replay.record("loops", str(d / "rec.pkl"))
    with open(d / "rec.pkl", "rb") as fh:
        return pickle.load(fh)


RECORDINGS = {"port": "rec", "jax": "jrec"}


def _script_keys():
    """The keys of the dict the script's `record` pickles."""
    tree = ast.parse((ROOT / "scripts" / "loop_replay.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "record")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "rec")
    return [k.value for k in node.value.keys]


def _plain(x, path="rec"):
    """Where `x` holds anything but dicts, lists, tuples, numbers, strings,
    None and numpy arrays of a numeric or bool dtype."""
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in _plain(v, f"{path}[{k!r}]")]
    if isinstance(x, (list, tuple)):
        return [p for i, v in enumerate(x) for p in _plain(v, f"{path}[{i}]")]
    if isinstance(x, np.ndarray):
        return [] if x.dtype.kind in "biuf" else [path]
    return [] if x is None or isinstance(x, (bool, int, float, str)) else [path]


def test_recording_is_plain_numpy_under_the_script_keys(rec):
    assert list(rec) == _script_keys()
    assert _plain(rec) == []
    assert rec["descs"].dtype == np.float32 and rec["ring_keys"].dtype == np.float32
    assert isinstance(rec["count"], int) and rec["count"] == len(rec["kf_stamps"])
    cloud = next(iter(rec["clouds"].values()))
    # the unfused CLI's keyframe clouds keep the reader's float32, as in a JAX recording
    assert cloud["mask"].dtype == np.bool_ and cloud["xyz"].dtype == np.float32
    assert rec["cycles"] and rec["loops_real"], "the run accepted no loop"


def _as_run(loops):
    return [[int(l.key_new), int(l.key_old), round(float(l.fitness), 4)] for l in loops]


def test_port_replay_gives_the_run_back(rec):
    det, loops = loop_replay.replay(rec, LOOP, device="cpu")
    assert _as_run(loops) == rec["loops_real"]
    assert det.gate_counts == rec["gate_counts_real"]


def test_jax_replay_gives_the_run_back(jrec):
    """The JAX package's replay reproduces its own run on this circuit: what
    makes a replay's loops comparable with the run it recorded."""
    assert jrec["loops_real"], "the JAX run accepted no loop"
    det, loops = j_replay.replay(jrec, LOOP)
    assert _as_run(loops) == jrec["loops_real"]
    assert det.gate_counts == jrec["gate_counts_real"]


@pytest.mark.parametrize("recording", list(RECORDINGS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_both_packages_replay_alike(request, recording, config):
    rec = request.getfixturevalue(RECORDINGS[recording])
    overrides = CONFIGS[config]
    jdet, jloops = j_replay.replay(rec, overrides)
    tdet, tloops = loop_replay.replay(rec, overrides, device="cpu")
    assert [(l.key_new, l.key_old) for l in tloops] == [(int(l.key_new), int(l.key_old))
                                                        for l in jloops]
    np.testing.assert_allclose([float(l.fitness) for l in tloops],
                               [float(l.fitness) for l in jloops], atol=1e-6)
    assert tdet.gate_counts == jdet.gate_counts
    assert loop_replay.classify(rec, tloops) == j_replay.classify(rec, jloops)


def test_analyze_matches_the_script_on_the_recorded_keyframes(rec):
    args = (rec["kf_stamps"], rec["loops_real"], rec["gt_stamps"], rec["gt_pos"])
    assert recall.analyze(*args) == j_recall.analyze(*args)
    assert recall.analyze(*args, accum_gate=20.0) == j_recall.analyze(*args, accum_gate=20.0)
