"""`gorio_tpu_torch/evaluation/scaling.py` (the port of
`scripts/bench_scaling.py`) and `evaluation/dispatch.py` (of
`scripts/diagnose_dispatch_poison.py`) on the CPU at tiny widths.

The scripts are read with `ast`, never imported (they import JAX at the
top and set its flags). Scaling runs worlds 1 and 2 (gloo ranks of
`mesh.spawn`, one group at a time): every row carries exactly the keys of
the script's row of its workload plus the post-processing keys the script
adds; the efficiency and speedup arithmetic matches hand-computed values;
`north_star` carries the `hmc_*` keys over from a bench line. Dispatch
probes under exactly the script's tags. `cublas_workspace` alternates its
processes' settings in balanced pairs and sets or removes the variable in
each one's environment."""

import ast
import json

import pytest
import torch

from gorio_tpu_torch.evaluation import cublas_workspace, dispatch, scaling
from gorio_tpu_torch.evaluation.sequence import REPO

SCRIPTS = REPO / "scripts"
TINY = scaling.Sizes(ppd=64, d=4, wpd=2, g=16, v=8, pairs=1, npts=128, npts_s=256, graph_k=8,
                     fpd=8)


def script_rows():
    """{workload: its row's keys} of the dict literals in bench_scaling.py,
    and the keys its post-processing assigns to a row (`r[...] = `)."""
    tree = ast.parse((SCRIPTS / "bench_scaling.py").read_text())
    rows, post = {}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "workload" in keys:
                rows[node.values[keys.index("workload")].value] = set(keys)
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "r"):
            post.add(node.targets[0].slice.value)
    return rows, post


@pytest.fixture(scope="module")
def run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return scaling.main(ns=(1, 2), device="cpu", reps={k: 1 for k in scaling.REPS},
                            sizes=TINY, log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(n)


def test_rows_carry_the_script_keys(run):
    results, cores, what = run
    rows, post = script_rows()
    assert set(rows) == set(scaling.REPS) and len(rows) == 5
    assert post == {"speedup_vs_1dev", "host_ideal_speedup", "weak_scaling_efficiency",
                    "host_ideal_efficiency"}
    assert sorted((r["workload"], r["n_devices"]) for r in results) == sorted(
        (w, n) for w in rows for n in (1, 2))
    for r in results:
        extra = ({"speedup_vs_1dev", "host_ideal_speedup"} if "align_ms" in r
                 else {"weak_scaling_efficiency", "host_ideal_efficiency"})
        assert set(r) == rows[r["workload"]] | extra, r
        json.dumps(r)
    assert set(what["launches"]) == {1, 2} and what["backend"][2] == "gloo on cpu"


def test_work_per_rank_is_the_script_s():
    assert scaling.Sizes() == (4096, 60, 16, 128, 32, 2, 2048, 8192, 48, 128)
    src = (SCRIPTS / "bench_scaling.py").read_text()
    for text in ("PPD, D = 4096, 60", "W = 16 * n", "G, V = 128, 32", "PAIRS_PER_DEV = 2",
                 "NPTS = 2048", "NPTS_S = 8192", "K = 48", "F = 128 * n", "reps=5"):
        assert text in src, text
    assert scaling.REPS == {"smc_step": 20, "ugpm_fit": 20, "apdgicp_pairs_dp": 5,
                            "apdgicp_mp_strong": 5, "graph_solve": 5}


def test_efficiency_arithmetic():
    rows = [{"workload": "smc_step", "n_devices": 1, "particle_steps_per_s": 1000.0},
            {"workload": "smc_step", "n_devices": 4, "particle_steps_per_s": 2000.0},
            {"workload": "graph_solve", "n_devices": 1, "factors_per_s": 300.0},
            {"workload": "graph_solve", "n_devices": 8, "factors_per_s": 1200.0},
            {"workload": "apdgicp_mp_strong", "n_devices": 1, "align_ms": 30.0},
            {"workload": "apdgicp_mp_strong", "n_devices": 4, "align_ms": 40.0}]
    out = scaling.postprocess(rows, cores=2)
    assert [r.get("weak_scaling_efficiency") for r in out] == [1.0, 0.5, 1.0, 0.5, None, None]
    assert [r.get("host_ideal_efficiency") for r in out] == [1.0, 0.5, 1.0, 0.25, None, None]
    assert [r.get("speedup_vs_1dev") for r in out[4:]] == [1.0, 0.75]
    assert [r.get("host_ideal_speedup") for r in out[4:]] == [1, 2]


def test_efficiency_of_a_zero_rate():
    """A rate of 0 is a rate: its row's efficiency is 0 (the script's
    `or` chain skipped it and divided None)."""
    rows = [{"workload": "ugpm_fit", "n_devices": 1, "windows_per_s": 0.5},
            {"workload": "ugpm_fit", "n_devices": 2, "windows_per_s": 0.0}]
    out = scaling.postprocess(rows, cores=8)
    assert [r["weak_scaling_efficiency"] for r in out] == [1.0, 0.0]


def test_north_star_carries_the_bench_keys():
    keys = ("hmc_samples_per_s", "hmc_ess_min_per_s", "hmc_ess_median_per_s", "hmc_rhat_max",
            "hmc_accept_mean")
    line = {k: float(i) for i, k in enumerate(keys)} | {"value": 261.0, "platform": "cuda"}
    ns = scaling.north_star(line)
    assert all(ns[k] == line[k] for k in keys) and "quality_note" in ns
    assert "value" not in ns
    assert set(scaling.north_star(None)) == {"definition", "reference_equivalent"}
    method = scaling.METHOD.format(card="H100", cores=8, cards="1 card")
    assert "TPU" not in method and "v5e" not in method


def test_update_needs_out():
    with pytest.raises(SystemExit):
        scaling.main_cli(["--update", "--device", "cpu"])


def script_tags():
    """The tags of the script's `t_gicp(...)` calls, in order."""
    tree = ast.parse((SCRIPTS / "diagnose_dispatch_poison.py").read_text())
    return [n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "t_gicp"]


def test_dispatch_probes_under_the_script_tags(monkeypatch):
    assert script_tags() == list(dispatch.TAGS)
    for name, value in (("B2", 2), ("N_PTS", 64),
                        ("HMC", dict(n_samples=2, step_size=0.02, n_leapfrog=2))):
        monkeypatch.setattr(dispatch, name, value)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = dispatch.main("cpu", reps=1, log=lambda *a: None)
    finally:
        torch.set_num_threads(n)
    assert list(res["probes"]) == script_tags()
    assert all(p["aligns_per_s"] > 0 for p in res["probes"].values())
    assert res["hmc"]["finite"] and res["launches"] == {"nn1": 0, "nn1_select": 0}


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (lambda: scaling.main(device="cuda"), lambda: dispatch.main("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_cublas_workspace_alternates_the_setting(monkeypatch):
    from gorio_tpu_torch.parallel.mesh import CUBLAS_WORKSPACE

    assert cublas_workspace.order(3) == ["off", "on", "on", "off", "off", "on"]
    for pairs in (1, 2, 4):
        turns = cublas_workspace.order(pairs)
        assert len(turns) == 2 * pairs and turns.count("on") == pairs
    monkeypatch.setenv(cublas_workspace.VAR, ":16:8")
    assert cublas_workspace.child_env("on")[cublas_workspace.VAR] == CUBLAS_WORKSPACE
    assert cublas_workspace.VAR not in cublas_workspace.child_env("off")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cublas_workspace.main(device="cuda")
