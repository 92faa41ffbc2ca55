"""The port's whole slice in a process where `jax`, `jaxlib` and the JAX
package cannot be imported, held to the port's own runs in this process,
the ones that `tests/test_torch_slice.py` and
`tests/test_torch_slice_full.py` hold to the JAX CLI. A file of its own, so
that `--dist loadfile` gives the long files to different workers."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.io.tum import load_tum

from test_torch_slice import SIM
from test_torch_slice_full import FULL

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's runs on one torch thread: at these sizes ~7x faster on
    the CPU than on the default threads, with the same poses to ~1e-11."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's `simulate` of the 4 s sequence and its two `slam` runs of
    the slice files on it: loops off, and the paper's four flags."""
    d = tmp_path_factory.mktemp("slice")
    torch_cli(["simulate", "--output", str(d / "seq"), *SIM])
    torch_cli(["slam", "--dataset", str(d / "seq"), "--output", str(d / "torch.tum"),
               "--no-loops", "--capacity", "512", "--device", "cpu"])
    torch_cli(["slam", "--dataset", str(d / "seq"), "--output", str(d / "torch_full.tum"),
               "--capacity", "512", *FULL, "--device", "cpu"])
    return d


def test_port_runs_without_jax(runs, tmp_path):
    """A process in which `import jax`, `import jaxlib` and `import
    gorio_tpu` (and every submodule) fail runs the port's whole slice, loop
    closure on: simulate, slam (the default path, the paper's four flags
    with `--config` of `dump-config`'s tree, `--dump` and `--map`, and
    `--registration ndt`), stream, evaluate, align, `sample_posterior`,
    the loop smoother and CG solves (and imports `preintegrate` and
    `gn_optimize`), the slice written as a rosbag through `convert-bag`,
    and `gt-adjust` — with the same results as this process (with loops off: the 4 s sequence never passes the 50 m
    gate; the config tree's defaults are the flags').
    (An import hook blocks them: a `sys.modules['jax'] = None` entry trips
    scipy's array-API helper, which looks the module up by name.)"""
    d = runs
    code = (
        "import sys\n"
        "class NoJax:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'gorio_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "from gorio_tpu_torch.cli import main\n"
        f"main(['simulate', '--output', 'seq', *{SIM!r}])\n"
        f"slam = main(['slam', '--dataset', 'seq', '--output', {str(tmp_path / 'e.tum')!r},"
        " '--capacity', '512', '--device', 'cpu'])[0]\n"
        f"r = main(['evaluate', {str(tmp_path / 'e.tum')!r}, 'seq/groundtruth.tum'])\n"
        "assert r['ate_rmse_m'] < 0.05\n"
        "import numpy as np, torch\n"
        "s, a, rh, c = slam.sample_posterior(torch.Generator().manual_seed(0), n_chains=2,"
        " n_samples=4, window=4)\n"
        "assert s.shape == (2, 4, 24) and bool(torch.isfinite(s).all()) and c.shape == (24, 24)\n"
        "from gorio_tpu_torch.graph.graph import PoseGraph\n"
        "from gorio_tpu_torch.inference import smc, smoother\n"
        "P, g = slam.trajectory()[1][:6], PoseGraph()\n"
        "for T in P: g.add_pose(T)\n"
        "g.add_prior(0, P[0], np.eye(6) * 1e6)\n"
        "for k in range(6): g.add_between(k, (k + 1) % 6, np.linalg.inv(P[k]) @ P[(k + 1) % 6],"
        " np.eye(6) * 100.0)\n"
        "p0, gd = g.freeze()\n"
        "m = np.arange(gd.between.mask.shape[0]) == 5\n"
        "res = smoother.smc_loop_relaxation(None, p0, gd, m, n_particles=16, n_stages=2,"
        " n_moves=1)(torch.Generator().manual_seed(0))\n"
        "assert np.isfinite(float(res.log_evidence)) and smoother.loop_evidence_gate(res)\n"
        "from gorio_tpu_torch.graph import solver as gs, sparse as gsp\n"
        "for fn in (gs.optimize_graph, gsp.optimize_graph_sparse):\n"
        "    assert np.isfinite(fn(p0, gd, gs.SolveConfig(solver='cg')).poses.numpy()).all()\n"
        "from gorio_tpu_torch.preintegration import combine_preints, preintegrate\n"
        "from gorio_tpu_torch.registration import gn_optimize\n"
        "main(['dump-config', '--output', 'c.json'])\n"
        f"main(['slam', '--dataset', 'seq', '--output', {str(tmp_path / 'f.tum')!r},"
        f" '--capacity', '512', '--device', 'cpu', *{FULL!r}, '--config', 'c.json',"
        " '--dump', 'dump', '--map', 'map.npz'])\n"
        "r = main(['stream', '--dataset', 'seq', '--capacity', '512', '--device', 'cpu',"
        " '--rate-multiplier', '20', '--no-loops', '--output', 's.tum'])[0]\n"
        "assert r.n_processed == r.n_frames > 0 and r.n_dropped == 0\n"
        f"main(['slam', '--dataset', 'seq', '--output', {str(tmp_path / 'n.tum')!r},"
        " '--capacity', '512', '--device', 'cpu', '--registration', 'ndt'])\n"
        "from gorio_tpu_torch.io.pcd import write_pcd\n"
        "import numpy as np\n"
        "xyz = np.random.default_rng(0).uniform(-5, 5, (300, 3))\n"
        "write_pcd('a.pcd', xyz)\n"
        "rows = main(['align', 'a.pcd', 'a.pcd', '--repeat', '0', '--device', 'cpu',"
        " '--methods', 'NDT_OMP,FAST_VGICP'])\n"
        "assert len(rows) == 2 and all(np.isfinite(r['T'].numpy()).all() for r in rows)\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import tool_inputs as ti\n"
        "ti.build_slice_bag('seq', 'slice.bag')\n"
        "n = main(['convert-bag', 'slice.bag', '--output', 'bag', *ti.CONVERT_FLAGS])\n"
        "import pathlib\n"
        "assert n == len(list(pathlib.Path('seq').glob('*.grf'))) > 0\n"
        f"r = main(['gt-adjust', {str(tmp_path / 'e.tum')!r}, 'adj.tum', '--loop', '0:3',"
        " '--device', 'cpu'])\n"
        "assert r['n_loops'] == 1 and np.isfinite(r['chi2'])\n"
        "assert not [m for m, v in sys.modules.items() if v is not None\n"
        "            and m.split('.')[0] in ('jax', 'jaxlib', 'gorio_tpu')]\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_allclose(load_tum(tmp_path / "e.tum")[1], load_tum(d / "torch.tum")[1],
                               atol=1e-7)
    # the fused path draws its hypotheses from the same seeded generator
    np.testing.assert_allclose(load_tum(tmp_path / "f.tum")[1],
                               load_tum(d / "torch_full.tum")[1], atol=1e-7)
    assert np.isfinite(load_tum(tmp_path / "n.tum")[1]).all()
    assert np.isfinite(load_tum(tmp_path / "s.tum")[1]).all()
    assert len(list((tmp_path / "dump").glob("0*"))) == len(load_tum(tmp_path / "f.tum")[0])
    assert len(np.load(tmp_path / "map.npz")["xyz"]) > 0
